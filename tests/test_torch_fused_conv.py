"""K7 and K8 of the port (`experiments/fused_conv/`) against the JAX
repository's Pallas kernels, on the CPU.

The Pallas kernels run in interpret mode, loaded from
`experiments/fused_conv/` by path, as that directory's own tests run them;
the port runs its plain versions (CPU tensors), which the CUDA kernels are
held against on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`). The
same numpy draw feeds both. Tolerances: fp32 atol 2e-4, rtol 1e-4 (the JAX
tests' own: another order of the sums). bf16: every output is rounded once
and an activation that lands on a rounding boundary may flip, so two
matching implementations differ by at most 2 output ulps (2^-7 relative to
the largest output) at a few elements, and by less than 1e-3 of the output
scale on average.
"""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dynamicrafter_tpu_torch.experiments.fused_conv import fused_conv as tconv  # noqa: E402
from dynamicrafter_tpu_torch.experiments.fused_conv import (  # noqa: E402
    fused_conv_tiled as ttiled,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    path = os.path.join(REPO, "experiments", "fused_conv", name + ".py")
    spec = importlib.util.spec_from_file_location("jax_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jconv, jtiled = _load("fused_conv"), _load("fused_conv_tiled")


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def draw(n, h, w, c, co, emb, seed=0, emb_scale=1.0, gn_bias_shift=0.0):
    """The JAX tests' draw: x, kernel, bias, gn scale, gn bias, emb."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: a.astype(np.float32)
    ops = [f32(rng.standard_normal((n, h, w, c))),
           f32(rng.standard_normal((3, 3, c, co)) * 0.1),
           f32(rng.standard_normal((co,)) * 0.1),
           f32(rng.standard_normal((c,)) * 0.2 + 1),
           f32(rng.standard_normal((c,)) * 0.2 + gn_bias_shift)]
    ops.append(f32(rng.standard_normal((n, c)) * emb_scale) if emb else None)
    return ops


def to_jax(ops, dtype=jnp.float32):
    x, k, b, gs, gb, e = ops
    cast = lambda a: None if a is None else jnp.asarray(a).astype(dtype)
    return cast(x), cast(k), cast(b), jnp.asarray(gs), jnp.asarray(gb), cast(e)


def to_torch(ops, dtype=torch.float32):
    x, k, b, gs, gb, e = ops
    cast = lambda a: None if a is None else torch.from_numpy(a).to(dtype)
    return cast(x), cast(k), cast(b), torch.from_numpy(gs), torch.from_numpy(gb), cast(e)


@pytest.mark.parametrize("emb", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 12, 64, 64), (1, 5, 7, 32, 32), (2, 8, 12, 64, 96)])
def test_k7_matches_pallas_fp32(shape, emb):
    ops = draw(*shape, emb)
    ref = np.asarray(jconv.fused_gn_silu_conv(*to_jax(ops), interpret=True))
    out = tconv.fused_gn_silu_conv(*to_torch(ops)).numpy()
    assert out.shape == ref.shape == (*shape[:3], shape[4])
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("emb", [False, True])
@pytest.mark.parametrize("shape,tile_h", [((2, 8, 14, 64, 64), 4), ((2, 8, 14, 64, 32), 4),
                                          ((1, 8, 6, 32, 32), 8)])
def test_k8_matches_pallas_fp32(shape, tile_h, emb):
    ops = draw(*shape, emb)
    ref = np.asarray(jtiled.fused_gn_silu_conv_tiled(*to_jax(ops), tile_h=tile_h,
                                                     interpret=True))
    out = ttiled.fused_gn_silu_conv_tiled(*to_torch(ops), tile_h=tile_h).numpy()
    assert out.shape == ref.shape == (*shape[:3], shape[4])
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=1e-4)


def _bf16_close(out, ref):
    out, ref = out.astype(np.float32), ref.astype(np.float32)
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 2 ** -7 * scale
    assert np.abs(out - ref).mean() <= 1e-3 * scale


def _bf16_case():
    # emb of size ~4 beside x of size ~1: x + emb is rarely a bf16 number
    ops = draw(2, 8, 14, 64, 64, True, seed=3, emb_scale=4.0)
    j, t = to_jax(ops, jnp.bfloat16), to_torch(ops, torch.bfloat16)
    np32 = lambda a: np.asarray(a.astype(jnp.float32))
    return (np32(jconv.fused_gn_silu_conv(*j, interpret=True)),
            np32(jtiled.fused_gn_silu_conv_tiled(*j, tile_h=4, interpret=True)),
            tconv.fused_gn_silu_conv(*t).float().numpy(),
            ttiled.fused_gn_silu_conv_tiled(*t, tile_h=4).float().numpy())


@pytest.fixture(scope="module")
def bf16_outputs():
    return _bf16_case()


def test_k7_matches_pallas_bf16(bf16_outputs):
    j7, _, t7, _ = bf16_outputs
    _bf16_close(t7, j7)


def test_k8_matches_pallas_bf16(bf16_outputs):
    _, j8, _, t8 = bf16_outputs
    _bf16_close(t8, j8)


def test_emb_rounding_separates_k7_from_k8(bf16_outputs):
    """K7 adds emb in fp32 and never rounds the sum; K8 is fed x + emb
    rounded to bf16. Each port follows its own kernel: the matched pairs are
    several times closer than the crossed ones."""
    j7, j8, t7, t8 = bf16_outputs
    d = lambda a, b: float(np.abs(a - b).mean())
    assert d(j7, j8) > 0 and d(t7, t8) > 0
    assert d(t7, j7) < 0.25 * d(t7, j8)
    assert d(t8, j8) < 0.25 * d(t8, j7)


@pytest.mark.parametrize("which", ["K7", "K8"])
def test_ring_is_zeroed_after_silu(which):
    """A large GroupNorm bias makes silu(0 * scale + bias) far from 0: a
    version that pads x with zeros and normalises the ring too is wrong at
    every border pixel, and only there."""
    ops = draw(1, 8, 6, 32, 32, False, seed=4, gn_bias_shift=2.0)
    if which == "K7":
        ref = np.asarray(jconv.fused_gn_silu_conv(*to_jax(ops), interpret=True))
        out = tconv.fused_gn_silu_conv(*to_torch(ops)).numpy()
    else:
        ref = np.asarray(jtiled.fused_gn_silu_conv_tiled(*to_jax(ops), tile_h=4,
                                                         interpret=True))
        out = ttiled.fused_gn_silu_conv_tiled(*to_torch(ops), tile_h=4).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=1e-4)
    # the wrong order: the same normalisation applied to a zero-padded x
    x, k, b, gs, gb, _ = to_torch(ops)
    _, scale, shift = ttiled.gn_prepass(x, gs, gb, None, 32, 1e-5)
    padded = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    act = padded * scale[:, None, None] + shift[:, None, None]
    act = act * torch.sigmoid(act)
    wrong = torch.zeros_like(x)
    for di in range(3):
        for dj in range(3):
            wrong += act[:, di:di + 8, dj:dj + 6] @ k[di, dj]
    wrong = (wrong + b).numpy()
    border = np.ones((8, 6), bool)
    border[1:-1, 1:-1] = False
    np.testing.assert_allclose(wrong[:, ~border], ref[:, ~border], atol=2e-4, rtol=1e-4)
    assert np.abs(wrong[:, border] - ref[:, border]).min(axis=-1).max() > 1e-2
    assert np.abs(out[:, border] - ref[:, border]).max() <= 2e-4 + 1e-4 * np.abs(ref).max()


def test_k7_and_k8_agree_in_fp32():
    ops = to_torch(draw(2, 8, 14, 64, 96, True, seed=5))
    a, b = tconv.fused_gn_silu_conv(*ops), ttiled.fused_gn_silu_conv_tiled(*ops, tile_h=2)
    torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-5)


def test_plain_versions_match_the_library_route():
    """groupnorm -> silu -> conv2d through PyTorch's own operators."""
    x, k, b, gs, gb, e = to_torch(draw(2, 5, 7, 32, 64, True, seed=6))
    F = torch.nn.functional
    ref = F.conv2d(F.silu(F.group_norm((x + e[:, None, None]).permute(0, 3, 1, 2), 32, gs, gb,
                                       1e-5)), k.permute(3, 2, 0, 1), b, padding=1)
    ref = ref.permute(0, 2, 3, 1)
    for out in (tconv.fused_gn_silu_conv(x, k, b, gs, gb, e),
                ttiled.fused_gn_silu_conv_tiled(x, k, b, gs, gb, e, tile_h=5)):
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=1e-5)


def test_tile_h_must_divide_h():
    ops = to_torch(draw(1, 8, 6, 32, 32, False))
    with pytest.raises(ValueError, match="tile_h"):
        ttiled.fused_gn_silu_conv_tiled(*ops, tile_h=3)
    with pytest.raises(AssertionError, match="tile_h"):
        jtiled.fused_gn_silu_conv_tiled(*to_jax(draw(1, 8, 6, 32, 32, False)), tile_h=3,
                                        interpret=True)


def test_supported():
    # the JAX tests' shapes: the CUDA kernels tile, so the large image fits too
    assert tconv.supported((32, 40, 64, 320), 320) and jconv.supported((32, 40, 64, 320), 320)
    assert tconv.supported((32, 72, 128, 320), 320)
    assert tconv.supported((16, 576, 1024, 128), 128)
    assert not jconv.supported((16, 576, 1024, 128), 128)
    assert tconv.supported((32, 20, 32, 1920), 1280) and tconv.supported((1, 5, 7, 32), 32)
    assert not tconv.supported((1, 8, 8, 48), 64)        # 32 groups do not divide C
    assert not tconv.supported((1, 8, 8, 64), 3)         # rows of Co are not 16 bytes
    assert not tconv.supported((70000, 8, 8, 64), 64)    # N beyond the launch grid


@pytest.mark.parametrize("h,w,tile_h", [(40, 64, None), (20, 32, None), (10, 16, None),
                                        (72, 128, None), (5, 7, None), (8, 14, 4),
                                        (40, 64, 8), (20, 32, 10), (1, 1, None),
                                        (33, 200, None), (128, 3, 128)])
def test_pick_tile(h, w, tile_h):
    th, tw = tconv.pick_tile(h, w, tile_h)
    assert 1 <= th and 1 <= tw <= w and th * tw <= tconv.MAX_TILE_PIXELS
    if tile_h is not None:
        assert th == tile_h
    # no other tile covers the image in fewer thread-steps
    steps = lambda a, b: -(-h // a) * -(-w // b) * -(-a * b // tconv.PIXEL_GROUPS)
    best = min(steps(a, b) for a in ([tile_h] if tile_h else range(1, min(h, 32) + 1))
               for b in range(1, min(w, tconv.MAX_TILE_PIXELS // a) + 1))
    assert steps(th, tw) == best
    if (h, w, tile_h) == (40, 64, None):
        assert (th, tw) == (8, 16)


def test_wrappers_count_no_launch_on_the_cpu():
    ops = to_torch(draw(1, 5, 7, 32, 32, False))
    before = (tconv.fused_gn_silu_conv.launches, ttiled.fused_gn_silu_conv_tiled.launches)
    tconv.fused_gn_silu_conv(*ops)
    ttiled.fused_gn_silu_conv_tiled(*ops, tile_h=5)
    assert (tconv.fused_gn_silu_conv.launches,
            ttiled.fused_gn_silu_conv_tiled.launches) == before


# -- the bf16 route's pieces that the CPU reaches: statistics, tiles, route ----

def _moments_reference(x, gs, gb, emb, groups=32, eps=1e-5):
    """K7's statistics written out as the Pallas kernel states them."""
    n, h, w, c = x.shape
    v = x.float() + (0 if emb is None else emb.float()[:, None, None, :])
    grp = v.reshape(n, h * w, groups, c // groups)
    n_el = float(h * w * (c // groups))
    g1 = grp.sum(dim=(1, 3)) / n_el
    g2 = (grp * grp).sum(dim=(1, 3)) / n_el
    inv = torch.rsqrt(g2 - g1 * g1 + eps)
    scale = gs.float()[None] * inv.repeat_interleave(c // groups, dim=1)
    return scale, gb.float()[None] - g1.repeat_interleave(c // groups, dim=1) * scale


def _two_pass_reference(x, gs, gb, emb, groups=32, eps=1e-5):
    """K8's pre-pass written out as the JAX entry states it."""
    n, h, w, c = x.shape
    v = x.float() + (0 if emb is None else emb.float()[:, None, None, :])
    grp = v.reshape(n, h * w, groups, c // groups)
    mean = grp.mean(dim=(1, 3))
    var = (grp - mean[:, None, :, None]).square().mean(dim=(1, 3))
    scale = gs.float()[None] * torch.rsqrt(var + eps).repeat_interleave(c // groups, dim=1)
    return scale, gb.float()[None] - mean.repeat_interleave(c // groups, dim=1) * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("emb", [False, True])
@pytest.mark.parametrize("two_pass", [False, True])
def test_gn_stats_plain_is_each_kernels_statistics_bit_for_bit(two_pass, emb, dtype):
    x, _, _, gs, gb, e = to_torch(draw(2, 8, 12, 64, 64, emb, seed=7), dtype)
    scale, shift = tconv.gn_stats_plain(x, gs, gb, e, two_pass=two_pass)
    ref = (_two_pass_reference if two_pass else _moments_reference)(x, gs, gb, e)
    assert scale.dtype == shift.dtype == torch.float32 and scale.shape == (2, 64)
    assert torch.equal(scale, ref[0]) and torch.equal(shift, ref[1])
    if two_pass:
        _, s8, b8 = ttiled.gn_prepass(x, gs, gb, e, 32, 1e-5)
        assert torch.equal(scale, s8) and torch.equal(shift, b8)
    # the CPU entry is the plain version and counts no launch
    before = tconv.gn_stats.launches
    s2, b2 = tconv.gn_stats(x, gs, gb, e, two_pass=two_pass)
    assert torch.equal(s2, scale) and torch.equal(b2, shift)
    assert tconv.gn_stats.launches == before


def _conv_from_stats(x, k, b, emb, scale, shift, round_emb):
    v = x.float() + (0 if emb is None else emb.float()[:, None, None, :])
    if round_emb:
        v = v.to(x.dtype).float()
    act = v * scale[:, None, None] + shift[:, None, None]
    return tconv.conv3x3_plain((act * torch.sigmoid(act)).to(x.dtype), k, b)


@pytest.mark.parametrize("emb", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 12, 64, 64), (1, 8, 6, 32, 32)])
def test_gn_stats_plain_matches_the_pallas_statistics(shape, emb):
    """The statistics of either mode, fed to the rest of the arithmetic,
    give the Pallas kernels' outputs (interpret mode, fp32)."""
    ops = draw(*shape, emb, seed=8)
    x, k, b, gs, gb, e = to_torch(ops)
    j7 = np.asarray(jconv.fused_gn_silu_conv(*to_jax(ops), interpret=True))
    j8 = np.asarray(jtiled.fused_gn_silu_conv_tiled(*to_jax(ops), tile_h=shape[1],
                                                    interpret=True))
    for two_pass, ref in ((False, j7), (True, j8)):
        scale, shift = tconv.gn_stats_plain(x, gs, gb, e, two_pass=two_pass)
        out = _conv_from_stats(x, k, b, e, scale, shift, two_pass).numpy()
        np.testing.assert_allclose(out, ref, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("n,h,w,tile_h", [
    (32, 40, 64, None), (32, 20, 32, None), (32, 10, 16, None), (16, 72, 128, None),
    (32, 40, 64, 8), (32, 20, 32, 10), (32, 10, 16, 10), (16, 72, 128, 8),
    (1, 5, 7, None), (3, 5, 7, 5), (2, 8, 14, 4), (2, 8, 14, 2), (1, 1, 1, None),
    (2, 33, 200, None), (1, 128, 3, 128), (16, 576, 1024, None)])
def test_pick_tile_tc(n, h, w, tile_h):
    """At most 128 pixels (two warpgroups of 64 rows), a halo that fits the
    shared memory, and no other tile covers the N*H x W image in fewer
    blocks; with tile_h, rows dividing tile_h unless such tiles need more
    blocks than the free choice."""
    th, tw = tconv.pick_tile_tc(n, h, w, tile_h)
    assert 1 <= th and 1 <= tw <= w and th * tw <= tconv.MAX_TILE_PIXELS
    assert (th + 2) * (tw + 2) <= tconv.MAX_HALO_PIXELS
    rows = n * h
    blocks = lambda a, b: -(-rows // a) * -(-w // b)
    least = lambda ths: min(blocks(a, b) for a in ths for b in range(1, min(w, 128 // a) + 1)
                            if (a + 2) * (b + 2) <= tconv.MAX_HALO_PIXELS)
    free = least(range(1, min(rows, tconv.MAX_TILE_PIXELS) + 1))
    assert blocks(th, tw) == free
    if tile_h is not None:
        banded = least([d for d in range(1, tile_h + 1) if tile_h % d == 0])
        if banded == free:
            assert tile_h % th == 0 and h % th == 0
    if (n, h, w) in ((32, 40, 64), (32, 20, 32), (32, 10, 16), (16, 72, 128)):
        # every 320x512 / 576x1024 ResBlock shape takes 8 x 16, in K7 and
        # (tile_h 8 or 10) in K8; at 10 x 16 (ds4, 160 pixels a sample) the
        # 32 samples stacked are 40 whole tiles, nothing of M wasted
        assert (th, tw) == (8, 16)
        assert rows * w == blocks(th, tw) * 128


def test_tensor_core_route_is_a_function_of_the_dtype():
    assert tconv.tensor_core_route(torch.bfloat16)
    assert not tconv.tensor_core_route(torch.float32)
    assert not tconv.tensor_core_route(torch.float16)


@pytest.mark.parametrize("n,hw,sms", [(32, 2560, 132), (32, 160, 132), (16, 9216, 132),
                                      (1, 35, 132), (2, 1, 132), (1, 100000, 132),
                                      (65535, 4, 132)])
def test_stats_splits_cover_the_pixels_with_no_empty_run(n, hw, sms):
    splits = tconv.stats_splits(n, hw, sms)
    run = -(-hw // splits)
    assert splits >= 1 and (splits - 1) * run < hw <= splits * run
    assert splits == 1 or run >= 32 or splits * n <= 4 * sms + n
