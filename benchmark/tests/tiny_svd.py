"""A tiny Stable Video Diffusion configuration and cell for the CPU tests:
the shipped topology at small widths (5 frames of 32 x 48, latents 16 x
24), float32."""
import copy
import json

from benchmark import harness

CONFIG = json.loads((harness.BENCH / "configs" / "svd_xt_1024.json").read_text())
CONFIG["resolution"], CONFIG["frames"] = [32, 48], 5
_P = CONFIG["model"]["params"]
_P["network_config"]["params"].update(
    model_channels=32, channel_mult=[1, 2], attention_resolutions=[2, 1], num_res_blocks=1,
    num_head_channels=16, context_dim=24, adm_in_channels=12)
for _e in _P["conditioner_config"]["params"]["emb_models"]:
    if _e["input_key"] == "cond_frames_without_noise":
        _e["params"]["clip_vision_config"] = dict(width=32, heads=2, layers=1, patch_size=8,
                                                  image_size=32, output_dim=24)
    elif _e["input_key"] == "cond_frames":
        _e["params"]["encoder_config"]["params"]["ddconfig"].update(
            ch=32, ch_mult=[1, 2], num_res_blocks=1)
    else:
        _e["params"]["outdim"] = 4
for _k in ("encoder_config", "decoder_config"):
    _P["first_stage_config"]["params"][_k]["params"].update(ch=32, ch_mult=[1, 2],
                                                            num_res_blocks=1)


def cell(name: str = "svdxt1024.euler25", **over) -> harness.Cell:
    """The cell on the tiny configuration, its parameters overridden by `over`."""
    real = harness.load_cell(name)
    params = copy.deepcopy(real.params)
    params.update({"frames": CONFIG["frames"], **over})
    return harness.Cell(name, real.entry, params, copy.deepcopy(CONFIG), real.end_to_end,
                        real.per_layer)


def program(config: dict, device="cpu"):
    """The port's pipeline at the tiny size, float32 on the CPU."""
    import torch
    from dynamicrafter_tpu_torch.config import SVDConfig
    from dynamicrafter_tpu_torch.svd_pipeline import StableVideoDiffusionPipeline
    return lambda: StableVideoDiffusionPipeline(SVDConfig(json.loads(json.dumps(config))),
                                                device, torch.float32)
