"""A tiny configuration and cell for the CPU tests: the shipped topology
at small widths (4 frames of 32 x 32, latents 16 x 16)."""
import copy
import json

from benchmark import harness

_UNET = {"in_channels": 8, "out_channels": 4, "model_channels": 32,
         "attention_resolutions": [2, 1], "num_res_blocks": 1, "channel_mult": [1, 2],
         "num_head_channels": 16, "transformer_depth": 1, "context_dim": 48,
         "use_checkpoint": True, "temporal_conv": True, "temporal_attention": True,
         "temporal_length": 4, "addition_attention": True, "image_cross_attention": True,
         "default_fs": 3, "fs_condition": True, "dropout": 0.0}

CONFIG = {
    "resolution": [32, 32], "frames": 4,
    "training": {"model_params": {"uncond_prob": 0.05, "rand_cond_frame": True,
                                  "image_proj_model_trainable": True, "use_ema": False},
                 "base_learning_rate": 1.0e-05, "accumulate_grad_batches": 2,
                 "gradient_clip_val": 0.5},
    "model": {"target": "LatentVisualDiffusion", "params": {
        "linear_start": 0.00085, "linear_end": 0.012, "timesteps": 1000,
        "parameterization": "v", "rescale_betas_zero_snr": True,
        "use_dynamic_rescale": True, "base_scale": 0.7, "conditioning_key": "hybrid",
        "scale_factor": 0.18215, "uncond_type": "empty_seq", "perframe_ae": True,
        "unet_config": {"params": _UNET},
        "first_stage_config": {"params": {"embed_dim": 4, "ddconfig": {
            "double_z": True, "z_channels": 4, "resolution": 16, "in_channels": 3,
            "out_ch": 3, "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
            "attn_resolutions": [], "dropout": 0.0}}},
        "cond_stage_config": {"target": "FrozenOpenCLIPEmbedder",
                              "params": {"layer": "penultimate"}},
        "img_cond_stage_config": {"target": "FrozenOpenCLIPImageEmbedderV2"},
        "image_proj_stage_config": {"params": {
            "dim": 32, "depth": 1, "dim_head": 8, "heads": 4, "num_queries": 4,
            "embedding_dim": 40, "output_dim": 48, "ff_mult": 2, "video_length": 4}},
        "clip_text_config": {"params": {"vocab_size": 49408, "width": 48, "heads": 4,
                                        "layers": 2, "context_length": 77}},
        "clip_vision_config": {"params": {"width": 40, "heads": 4, "layers": 2,
                                          "patch_size": 8, "image_size": 32}},
    }},
}


def cell(name: str, **over) -> harness.Cell:
    """The cell `name` of BENCHMARK.json on the tiny configuration, its
    parameters overridden by `over`."""
    real = harness.load_cell(name)
    params = copy.deepcopy(real.params)
    params.update({"frames": CONFIG["frames"], **over})
    return harness.Cell(name, real.entry, params, copy.deepcopy(CONFIG),
                        real.end_to_end, real.per_layer)


def train_program(config: dict, device="cpu"):
    """The port's training pipeline at the tiny size on the CPU."""
    import torch
    from benchmark.traffic.generate import Tokenizer
    from benchmark.traffic.finetune import _model_node
    from dynamicrafter_tpu_torch.config import ModelConfig
    from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline
    return lambda: DynamiCrafterPipeline.for_training(
        ModelConfig(json.loads(json.dumps(_model_node(config)))), device,
        frozen_dtype=torch.bfloat16, tokenizer=Tokenizer(), train_resampler=True)


def program(config: dict, device="cpu"):
    """The port's pipeline at the tiny size, float32 on the CPU."""
    import torch
    from benchmark.traffic.generate import Tokenizer
    from dynamicrafter_tpu_torch.config import ModelConfig
    from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline
    return lambda: DynamiCrafterPipeline(ModelConfig(json.loads(json.dumps(config["model"]))),
                                         device, torch.float32, tokenizer=Tokenizer())
