"""Stable Video Diffusion on the port (`models/video_unet.py`, the temporal
decoder of `models/vae.py`, `sampling/edm.py`, `svd_pipeline.py`) held to
the plain float32 reference `benchmark/reference/svd.py` on seeded random
weights at a tiny size: 5 frames (odd, not 16), two UNet levels, every
weight nonzero. The shipped YAML parses to the published widths."""
import copy
import os

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import svd as ref_svd
from dynamicrafter_tpu_torch.config import SVDConfig, load_yaml
from dynamicrafter_tpu_torch.models.blocks import ResBlock, SpatialTransformer, _from_clip, _to_clip
from dynamicrafter_tpu_torch.models.vae import ResnetBlock, VideoResnetBlock
from dynamicrafter_tpu_torch.models.video_unet import (
    SpatialVideoTransformer,
    VideoResBlock,
    VideoUNet,
    VideoUNetConfig,
)
from dynamicrafter_tpu_torch.sampling import edm
from dynamicrafter_tpu_torch.svd_pipeline import StableVideoDiffusionPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs", "inference_svd_xt.yaml")
T, HW, LAT = 5, (32, 48), (16, 24)
VALUES = {"fps_id": 6, "motion_bucket_id": 127, "cond_aug": 0.02}


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_config() -> dict:
    """The shipped YAML at tiny widths: UNet 32 channels over two levels,
    KL VAE 32 channels over two, a one-layer vision tower of width 32."""
    raw = copy.deepcopy(load_yaml(YAML))
    p = raw["model"]["params"]
    p["network_config"]["params"].update(
        model_channels=32, channel_mult=[1, 2], attention_resolutions=[2, 1], num_res_blocks=1,
        num_head_channels=16, context_dim=24, adm_in_channels=12)
    for e in p["conditioner_config"]["params"]["emb_models"]:
        if e["input_key"] == "cond_frames_without_noise":
            e["params"]["clip_vision_config"] = dict(width=32, heads=2, layers=1, patch_size=8,
                                                     image_size=32, output_dim=24)
        elif e["input_key"] == "cond_frames":
            e["params"]["encoder_config"]["params"]["ddconfig"].update(
                ch=32, ch_mult=[1, 2], num_res_blocks=1)
        else:
            e["params"]["outdim"] = 4
    for k in ("encoder_config", "decoder_config"):
        p["first_stage_config"]["params"][k]["params"].update(ch=32, ch_mult=[1, 2],
                                                              num_res_blocks=1)
    return raw


@pytest.fixture(scope="module")
def pair():
    """(port pipeline, reference) holding the same weights: the benchmark's
    draw (N(0, 0.02) in bf16) times 2.5, so no layer is near zero."""
    raw = tiny_config()
    sd = {k: v.float() * 2.5 for k, v in
          weights.draw(ref_svd.param_shapes(raw), 2**33 + 5, "cpu").items()}
    pipe = StableVideoDiffusionPipeline(SVDConfig(raw), "cpu")
    pipe.load_state_dict(sd)
    return pipe, ref_svd.build(raw, "cpu", sd)


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


def test_yaml_parses_to_the_published_widths():
    c = SVDConfig.from_yaml(YAML)
    u = VideoUNetConfig.from_dict(c.unet)
    assert (u.in_channels, u.out_channels, u.model_channels, u.channel_mult) == (8, 4, 320,
                                                                                 (1, 2, 4, 4))
    assert (u.num_res_blocks, u.attention_resolutions, u.num_head_channels) == (2, (4, 2, 1), 64)
    assert (u.context_dim, u.adm_in_channels, u.num_classes) == (1024, 768, "sequential")
    assert u.extra_ff_mix_layer and u.use_spatial_context and u.use_linear_in_transformer
    assert (u.merge_strategy, u.video_kernel_size) == ("learned_with_images", (3, 1, 1))
    assert c.decoder["ch"] == 128 and c.decoder["ch_mult"] == [1, 2, 4, 4]
    assert c.decoder["video_kernel_size"] == [3, 1, 1] and c.encoder["z_channels"] == 4
    assert [(r, k) for r, k, _ in c.embedders] == [
        ("clip_image_prediction", "cond_frames_without_noise"), ("timestep_vector", "fps_id"),
        ("timestep_vector", "motion_bucket_id"), ("video_encoder_concat", "cond_frames"),
        ("timestep_vector", "cond_aug")]
    assert (c.sigma_min, c.sigma_max, c.rho) == (0.002, 700.0, 7.0)
    assert (c.num_frames, c.num_steps, c.min_cfg, c.max_cfg) == (25, 25, 1.0, 3.0)
    assert c.scale_factor == 0.18215


def test_unet_parameter_count_on_meta():
    with torch.device("meta"):
        unet = VideoUNet(VideoUNetConfig.from_dict(SVDConfig.from_yaml(YAML).unet))
    assert sum(p.numel() for p in unet.parameters()) == 1_524_623_082


def _case(name, pipe, ref):
    """(port, reference, tolerance) of one comparison."""
    gen = torch.Generator().manual_seed(7)
    rand = lambda *s: torch.randn(*s, generator=gen)
    img = torch.rand(1, *HW, 3, generator=gen) * 2 - 1
    noise = rand(1, *HW, 3)
    if name == "unet":
        args = (rand(2, T, *LAT, 8), rand(2), rand(2, 1, 24), rand(2, 12))
        return pipe.unet(*args), ref.unet(*args), 1e-5
    if name == "decoder":
        z = rand(1, T, *LAT, 4)
        return pipe.decode_latents(z), ref.decode(z), 1e-5
    if name == "conditioning":
        c = pipe.build_conditioning(img, noise, VALUES)
        want = ref.conditioning(img, noise, VALUES)
        got = (c.context[1:], c.concat[1:], c.vector[1:])
        zeros = float(c.context[0].abs().sum() + c.concat[0].abs().sum())
        return (torch.cat([g.flatten() for g in got]) + zeros,
                torch.cat([w.flatten() for w in want]), 1e-5)
    if name == "sigmas":
        return (torch.as_tensor(edm.edm_sigmas(25, 0.002, 700.0, 7.0)),
                torch.as_tensor(ref_svd.sigmas(25, 0.002, 700.0, 7.0)), 1e-14)
    if name == "guidance":
        return (torch.as_tensor(edm.frame_scales(T, 1.0, 3.0)),
                torch.as_tensor(ref_svd.frame_scales(T, 1.0, 3.0)), 1e-14)
    if name == "euler_step":
        x, d_u, d_c = rand(1, T, *LAT, 4), rand(1, T, *LAT, 4), rand(1, T, *LAT, 4)
        sig = edm.edm_sigmas(4)
        got = edm.euler_edm_sample(lambda x_, s: (d_u, d_c), x, sig[1:3],
                                   edm.frame_scales(T, 1.0, 3.0))
        x0 = x * (1.0 + sig[1] ** 2) ** 0.5
        want = ref_svd.euler_step(x0.double(), d_u.double(), d_c.double(), sig[1], sig[2],
                                  ref_svd.frame_scales(T, 1.0, 3.0))
        return got, want, 1e-5
    if name == "sample":
        x_T = rand(1, T, *LAT, 4)
        out = pipe.sample(img.numpy(), frames=T, steps=3, min_cfg=1.0, max_cfg=3.0,
                          x_T=x_T.numpy(), cond_noise=noise.numpy(), **VALUES)
        lat, frames = ref.sample(img, x_T, noise, 3, 1.0, 3.0, VALUES)
        return (torch.cat([torch.as_tensor(out.latents[:, 0]).flatten(),
                           torch.as_tensor(out.videos[:, 0]).flatten()]),
                torch.cat([lat.flatten(), frames.flatten()]), 1e-4)
    raise ValueError(name)


@pytest.mark.parametrize("name", ["unet", "decoder", "conditioning", "sigmas", "guidance",
                                  "euler_step", "sample"])
def test_port_matches_the_reference(name, pair):
    with torch.no_grad():
        got, want, tol = _case(name, *pair)
    assert got.shape == want.shape
    assert _rel(got, want) < tol, _rel(got, want)


@pytest.mark.parametrize("block", ["unet_resblock", "unet_transformer", "decoder_resblock"])
def test_blend_convention(block, pair):
    """With a large mix_factor the UNet's blocks return their spatial
    branch and the decoder's its temporal one."""
    pipe, _ = pair
    gen = torch.Generator().manual_seed(3)
    unet, dec = pipe.unet, pipe.vae.decoder
    with torch.no_grad():
        if block == "unet_resblock":
            blk = next(m for m in unet.modules() if isinstance(m, VideoResBlock))
            x = torch.randn(T, blk.in_layers[2].in_channels, 8, 12, generator=gen)
            emb = torch.randn(1, blk.emb_layers[1].in_features, generator=gen)
            blk.time_mixer.mix_factor.fill_(30.0)
            got, spatial = blk(x, emb, T), ResBlock.forward(blk, x, emb, T)
            blk.time_mixer.mix_factor.fill_(-30.0)
            temporal = blk(x, emb, T)
        elif block == "unet_transformer":
            blk = next(m for m in unet.modules() if isinstance(m, SpatialVideoTransformer))
            x = torch.randn(T, blk.proj_in.in_features, 8, 12, generator=gen)
            ctx = torch.randn(1, 1, 24, generator=gen)
            blk.time_mixer.mix_factor.fill_(30.0)
            got = blk(x, ctx, T)
            spatial = SpatialTransformer.forward(blk, x, (ctx, None), T)
            blk.time_mixer.mix_factor.fill_(-30.0)
            temporal = blk(x, ctx, T)
        else:
            blk = next(m for m in dec.modules() if isinstance(m, VideoResnetBlock))
            x = torch.randn(T, blk.conv1.in_channels, 8, 12, generator=gen)
            blk.mix_factor.fill_(30.0)
            got = blk(x, T)
            s = ResnetBlock.forward(blk, x)
            spatial = _from_clip(blk.time_stack(_to_clip(s, T)))     # the temporal branch
            blk.mix_factor.fill_(-30.0)
            temporal = blk(x, T)
    assert _rel(got, spatial) < 1e-6
    assert _rel(temporal, spatial) > 1e-3


def test_inference_cli_runs_an_svd_config(tmp_path):
    """`inference.main` dispatches an sgm DiffusionEngine YAML to the SVD
    pipeline and writes every image's clip."""
    import shutil

    import yaml

    from dynamicrafter_tpu_torch import inference

    config = tmp_path / "svd_tiny.yaml"
    config.write_text(yaml.safe_dump(tiny_config()))
    prompts = tmp_path / "prompts"
    prompts.mkdir()
    shutil.copy(os.path.join(REPO, "prompts", "512", "example.png"), prompts / "still.png")
    out = inference.main(["--config", str(config), "--prompt_dir", str(prompts),
                          "--savedir", str(tmp_path / "out"), "--random_init", "--device", "cpu",
                          "--height", str(HW[0]), "--width", str(HW[1]), "--video_length", str(T),
                          "--ddim_steps", "2", "--min_cfg", "1.0", "--max_cfg", "2.0"])
    assert [os.path.basename(p) for p in out["paths"]] == ["still.npy"]
    assert np.load(out["paths"][0]).shape == (T, *HW, 3)
    assert set(out["timings"][0]) == {"conditioning", "sampler", "decode"}
