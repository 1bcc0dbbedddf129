"""The 320x512 image-to-video slice of the PyTorch package against the JAX
package, end to end at TINY_MODEL_CONFIG size, fp32 on the CPU.

Both packages get the same weights (one random Flax param tree exported to
reference keys) and the same random numbers (x_T, DDIM step noise and the
VAE encode noise are drawn once and handed to both). The port's attention
runs its plain versions here (CPU tensors).
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402

from dynamicrafter_tpu import schedule as jsched  # noqa: E402
from dynamicrafter_tpu.config import ModelConfig as JModelConfig  # noqa: E402
from dynamicrafter_tpu.pipeline import DynamiCrafterPipeline as JPipeline  # noqa: E402
from dynamicrafter_tpu.sampling import ddim as jddim  # noqa: E402
from dynamicrafter_tpu.testing import TINY_MODEL_CONFIG  # noqa: E402
from dynamicrafter_tpu.utils.export import export_state_dict  # noqa: E402
from dynamicrafter_tpu_torch import inference  # noqa: E402
from dynamicrafter_tpu_torch import schedule as tsched  # noqa: E402
from dynamicrafter_tpu_torch.config import ModelConfig  # noqa: E402
from dynamicrafter_tpu_torch.pipeline import DynamiCrafterPipeline  # noqa: E402
from dynamicrafter_tpu_torch.sampling import ddim as tddim  # noqa: E402
from dynamicrafter_tpu_torch.utils import video as tvideo  # noqa: E402
from test_torch_modules import randn, random_params, rel_l2  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE_PNG = os.path.join(REPO, "prompts", "512", "example.png")
T, HW, LAT = 4, 16, 8           # frames, frame size, latent size (VAE factor 2)


@pytest.fixture(scope="module")
def pipes():
    """The JAX pipeline with random params and the port loaded from them."""
    jp = JPipeline(JModelConfig(TINY_MODEL_CONFIG))
    u = jp.unet_config
    params = {
        "unet": random_params(
            jp.unet, np.zeros((1, T, LAT, LAT, u.in_channels), np.float32),
            np.zeros((1,), np.int32), context_text=np.zeros((1, 77, 48), np.float32),
            context_img=np.zeros((1, T, 4, 48), np.float32),
            fs=np.zeros((1,), np.int32), seed=1),
        "vae": random_params(jp.vae, np.zeros((1, HW, HW, 3), np.float32), seed=2),
        "clip_text": random_params(jp.text_encoder, np.zeros((1, 77), np.int32), seed=3),
        "clip_vision": random_params(jp.vision_encoder,
                                     np.zeros((1, 32, 32, 3), np.float32), seed=4),
        "resampler": random_params(jp.resampler, np.zeros((1, 17, 40), np.float32), seed=5),
    }
    jp.params = params
    tp = DynamiCrafterPipeline(ModelConfig(TINY_MODEL_CONFIG), "cpu")
    tp.load_state_dict(export_state_dict(params, unet_config=u))
    return jp, tp


def _cond_arrays(rng, p=2, b=1):
    return dict(context_text=randn(rng, p, b, 77, 48),
                context_img=randn(rng, p, b, T, 4, 48),
                concat=randn(rng, p, b, T, LAT, LAT, 4, scale=0.5),
                fs=np.full((b,), 24, np.int32))


def test_tiny_unet_forward(pipes):
    jp, tp = pipes
    rng = np.random.default_rng(10)
    x = randn(rng, 2, T, LAT, LAT, 8)
    ts = np.array([999, 17], np.int32)
    ct, ci = randn(rng, 2, 77, 48), randn(rng, 2, T, 4, 48)
    fs = np.array([3, 24], np.int32)
    ref = np.asarray(jax.jit(lambda p, *a: jp.unet.apply(
        {"params": p}, a[0], a[1], context_text=a[2], context_img=a[3], fs=a[4]))(
            jp.params["unet"], x, ts, ct, ci, fs))
    with torch.no_grad():
        out = tp.unet(*(torch.from_numpy(a) for a in (x, ts.astype(np.int64), ct, ci,
                                                      fs.astype(np.int64))))
    assert out.shape == ref.shape
    assert rel_l2(out.numpy(), ref) <= 1e-4


def test_ddim_eta1_with_predrawn_noise(pipes):
    """3 DDIM steps, eta 1, 2-pass batched CFG, guidance rescale, v-param,
    zero-terminal SNR, dynamic rescale, uniform_trailing."""
    jp, tp = pipes
    rng = np.random.default_rng(11)
    steps = 3
    arrs = _cond_arrays(rng)
    x_T = randn(rng, 1, T, LAT, LAT, 4)
    noise = randn(rng, steps, 1, T, LAT, LAT, 4)
    kw = dict(steps=steps, discretize="uniform_trailing", eta=1.0, cfg_scale=7.5,
              guidance_rescale=0.7, parameterization="v")
    jset, tset = jddim.SamplerSettings(**kw), tddim.SamplerSettings(**kw)
    jtab = jsched.build_ddim_table(jp.schedule, num_steps=steps,
                                   discretize="uniform_trailing", eta=1.0)
    ttab = tsched.build_ddim_table(tp.schedule, num_steps=steps,
                                   discretize="uniform_trailing", eta=1.0)

    def unet_apply(p, x, ts, context_text, context_img, fs):
        return jp.unet.apply({"params": p}, x, ts, context_text=context_text,
                             context_img=context_img, fs=fs)

    @jax.jit
    def run(params, x_T, cond, noise):
        fn = jddim.make_cfg_denoiser(unet_apply, params, cond, jset)
        return jddim.ddim_sample(fn, x_T, jp.schedule, jtab, jset, noise=noise)

    ref = np.asarray(run(jp.params["unet"], x_T,
                         jddim.CFGConditioning(**{k: jnp.asarray(v) for k, v in arrs.items()}),
                         noise))
    tcond = tddim.CFGConditioning(**{k: torch.from_numpy(v) for k, v in arrs.items()})
    tcond = tcond._replace(fs=tcond.fs.long())
    out = tddim.ddim_sample(tddim.make_cfg_denoiser(tp.unet, tcond, tset),
                            torch.from_numpy(x_T), tp.schedule, ttab, tset,
                            noise=torch.from_numpy(noise)).numpy()
    assert rel_l2(out, ref) <= 1e-4


def test_pipeline_sample_end_to_end(pipes):
    """pipeline.sample: conditioning (CLIP text/vision, Resampler, VAE
    encode), eta-0 DDIM with 2-pass CFG and guidance rescale, VAE decode."""
    jp, tp = pipes
    rng = np.random.default_rng(12)
    seed = 123
    videos = np.repeat(randn(rng, 1, 1, HW, HW, 3, scale=0.5).clip(-1, 1), T, axis=1)
    x_T = randn(rng, 1, T, LAT, LAT, 4)
    enc_noise = np.asarray(jax.random.normal(
        jax.random.split(jax.random.PRNGKey(seed))[1], (T, LAT, LAT, 4)))
    kw = dict(steps=3, cfg_scale=7.5, eta=0.0, timestep_spacing="uniform_trailing",
              guidance_rescale=0.7, fs=[3], seed=seed, x_T=x_T)
    prompts = ["a red fox running through snow"]
    j_lat = np.asarray(jp.sample(prompts, videos, decode=False, **kw))
    j_frames = np.asarray(jp.decode_latents(jnp.asarray(j_lat[:, 0])))
    t_lat = tp.sample(prompts, videos, decode=False, encode_noise=enc_noise, **kw)
    t_frames = tp.sample(prompts, videos, encode_noise=enc_noise, **kw).videos[:, 0]
    assert t_lat.shape == j_lat.shape == (1, 1, T, LAT, LAT, 4)
    assert rel_l2(t_lat, j_lat) <= 1e-3
    assert t_frames.shape == j_frames.shape == (1, T, HW, HW, 3)
    assert np.abs(t_frames - j_frames).max() <= 1e-3


def test_png_loader_matches_pillow():
    """No resize at the slice's own size: bit-identical to the JAX
    package's Pillow loader."""
    from dynamicrafter_tpu.utils.video import load_image as pil_load_image

    ours = tvideo.load_image(EXAMPLE_PNG, (320, 512))
    ref = pil_load_image(EXAMPLE_PNG, (320, 512))
    assert ours.shape == (320, 512, 3) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("size", [(256, 256), (96, 160), (576, 1024)])
def test_png_loader_resize_close_to_pillow(size):
    """Downscaled and upscaled: Pillow's BILINEAR filter, to within 2 uint8
    levels (Pillow rounds its fixed-point filter taps)."""
    from dynamicrafter_tpu.utils.video import load_image as pil_load_image

    ours = tvideo.load_image(EXAMPLE_PNG, size)
    ref = pil_load_image(EXAMPLE_PNG, size)
    assert ours.shape == ref.shape == (*size, 3)
    assert np.abs(ours - ref).max() <= 2 * 2.0 / 255 + 1e-6


def test_png_decoder_filters(tmp_path):
    """Every PNG row filter type (Pillow's encoder picks them adaptively)."""
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(13)
    img = (rng.integers(0, 256, (24, 40, 3)) // 17 * 17).astype(np.uint8)
    img[:, :20] = np.cumsum(img[:, :20], axis=1, dtype=np.uint8)   # smooth half
    for mode, arr in (("RGB", img), ("RGBA", np.dstack([img, img[..., :1]])),
                      ("L", img[..., 0])):
        path = tmp_path / f"x_{mode}.png"
        PIL.fromarray(arr, mode).save(path, optimize=True)
        ref = np.asarray(PIL.open(path).convert("RGB"))
        np.testing.assert_array_equal(tvideo.decode_png(str(path)), ref)


def test_inference_cli_end_to_end(tmp_path):
    """`python -m dynamicrafter_tpu_torch.inference` on the CPU at tiny size,
    through main(argv): random init, npy output."""
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(yaml.safe_dump(TINY_MODEL_CONFIG))
    prompts = tmp_path / "prompts"
    prompts.mkdir()
    shutil.copy(EXAMPLE_PNG, prompts / "example.png")
    (prompts / "prompts.txt").write_text("a fox in the snow\n")
    out_dir = tmp_path / "out"
    result = inference.main([
        "--config", str(cfg), "--prompt_dir", str(prompts), "--savedir", str(out_dir),
        "--random_init", "--height", str(HW), "--width", str(HW), "--frame_stride", "24",
        "--timestep_spacing", "uniform_trailing", "--guidance_rescale", "0.7",
        "--perframe_ae", "--unconditional_guidance_scale", "7.5", "--text_input",
        "--video_length", str(T), "--ddim_steps", "2", "--ddim_eta", "1.0",
        "--device", "cpu"])
    frames = np.load(out_dir / "example.npy")
    assert result["paths"] == [str(out_dir / "example.npy")]
    assert frames.shape == (T, HW, HW, 3) and frames.dtype == np.uint8
    assert set(result["timings"][0]) == {"conditioning", "ddim", "decode"}


def test_cuda_device_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DynamiCrafterPipeline(ModelConfig(TINY_MODEL_CONFIG), "cuda")
