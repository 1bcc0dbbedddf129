"""The norm layers of the PyTorch port: the fp32 island and the norm kernels.

On the CPU: the plain functions equal the island's compositions (the
parent formulas: `F.group_norm(x.float(), ...).to(x.dtype)`, then SiLU;
the emb add in x's dtype before it) to the bit, in fp32 and bf16; every
norm module and every caller that now passes `silu=` or `add=` equals the
composition of its Sequential's modules to the bit; the routing rule (a
CPU tensor, a call recording a graph and `ClipGroupNorm(frames=...)` never
reach a kernel wrapper; a CUDA call that takes the island is counted);
the (N, C, R, HW) view of strided inputs.

On the card (marker `cuda`, skipped without one; no JAX, so
`python -m pytest --noconftest tests/test_torch_norms.py -q` runs there):
the kernels against their plain versions at the main path's shapes, in
bf16 (relative L2 <= 1e-2: the kernel rounds once where the island rounds
the norm before SiLU, 2^-9 relative an element) and fp32 (<= 1e-5: fp32
statistics summed in another order); every GroupNorm plan; two launches bit
for bit; a sample's bits alone as in its batch; a tiny UNet through the
kernels against the island within 2e-2; no launch while a graph records.
"""
import dataclasses
import re
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from dynamicrafter_tpu_torch.models.blocks import (  # noqa: E402
    ResBlock, TemporalConvBlock, _from_clip, _to_clip,
)
from dynamicrafter_tpu_torch.models.vae import ResnetBlock  # noqa: E402
from dynamicrafter_tpu_torch.ops import norms  # noqa: E402
from dynamicrafter_tpu_torch.parallel.sharding import FrameSplit, Mesh  # noqa: E402


@pytest.fixture
def few_torch_threads():
    """Tiny tensors: more intra-op threads only contend with the other test
    workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _affine(c, seed, device="cpu"):
    g = _gen(seed)
    w = 1.0 + 0.3 * torch.randn(c, generator=g)
    b = 0.3 * torch.randn(c, generator=g)
    return w.to(device), b.to(device)


def _island_gn(x, w, b, groups, eps, add=None, silu=False):
    """The parent's composition, written out."""
    if add is not None:
        x = x + add
    y = F.group_norm(x.float(), groups, w.float(), b.float(), eps).to(x.dtype)
    return torch.nn.SiLU()(y) if silu else y


def _island_ln(x, w, b, eps, keep_fp32=False):
    y = F.layer_norm(x.float(), x.shape[-1:], w.float(), b.float(), eps)
    return y if keep_fp32 else y.to(x.dtype)


def _gn_input(case, dtype, seed=0):
    """(x, add) of a GroupNorm case: per-frame (N, C, H, W), the temporal
    conv's `_to_clip` view, the temporal transformer's transposed view."""
    g = _gen(seed)
    if case == "per_frame":
        x = torch.randn(6, 64, 5, 8, generator=g)
    elif case == "to_clip":
        x = _to_clip(torch.randn(2 * 4, 64, 5, 8, generator=g), 4)
    else:   # transpose: (B, T, C, HW) -> (B, C, T, HW)
        x = torch.randn(2, 4, 64, 40, generator=g).transpose(1, 2)
    add = 0.5 * torch.randn(x.shape[0], 64, *([1] * (x.dim() - 2)), generator=g)
    return 2.0 * x.to(dtype) + 0.7, add.to(dtype)


GN_CASES = [(case, add, silu) for case in ("per_frame", "to_clip", "transpose")
            for add, silu in ((False, False), (False, True), (True, False), (True, True))
            if case == "per_frame" or not add]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case,add,silu", GN_CASES)
def test_group_norm_plain_is_the_island(few_torch_threads, case, add, silu, dtype):
    x, a = _gn_input(case, dtype)
    w, b = _affine(64, 1)
    a = a if add else None
    out = norms.group_norm_act_plain(x, w, b, 32, 1e-6, a, silu)
    assert out.dtype == dtype and out.is_contiguous()
    assert torch.equal(out, _island_gn(x, w, b, 32, 1e-6, a, silu))
    # the CPU entry of the kernel wrapper is the plain function, no launch
    before = norms.group_norm_act.launches
    assert torch.equal(norms.group_norm_act(x, w, b, 32, 1e-6, a, silu), out)
    assert norms.group_norm_act.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("keep_fp32", [False, True], ids=["cast", "keep_fp32"])
def test_layer_norm_plain_is_the_island(few_torch_threads, keep_fp32, dtype):
    x = (3.0 * torch.randn(2, 7, 96, generator=_gen(2)) + 1.0).to(dtype)
    w, b = _affine(96, 3)
    out = norms.layer_norm_plain(x, w, b, 1e-5, keep_fp32)
    assert out.dtype == (torch.float32 if keep_fp32 else dtype)
    assert torch.equal(out, _island_ln(x, w, b, 1e-5, keep_fp32))
    before = norms.layer_norm.launches
    assert torch.equal(norms.layer_norm(x, w, b, 1e-5, keep_fp32), out)
    assert norms.layer_norm.launches == before


def _with_affine(m, seed):
    with torch.no_grad():
        for i, mod in enumerate(m.modules()):
            if isinstance(mod, (norms.GroupNorm, norms.LayerNorm)):
                w, b = _affine(mod.weight.shape[0], seed + i)
                mod.weight.copy_(w)
                mod.bias.copy_(b)
    return m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["group_norm", "clip_group_norm", "layer_norm",
                                  "layer_norm_keep_fp32"])
def test_norm_modules_are_the_parent_formula(few_torch_threads, kind, dtype):
    if kind.startswith("layer_norm"):
        keep = kind.endswith("fp32")
        m = _with_affine(norms.LayerNorm(96, keep_fp32=keep), 4)
        x = (torch.randn(3, 5, 96, generator=_gen(5)) * 2).to(dtype)
        assert torch.equal(m(x), _island_ln(x, m.weight, m.bias, m.eps, keep))
        return
    cls = norms.GroupNorm if kind == "group_norm" else norms.ClipGroupNorm
    m = _with_affine(cls(32, 64, eps=1e-6), 6)
    x, a = _gn_input("per_frame" if kind == "group_norm" else "to_clip", dtype)
    assert torch.equal(m(x), _island_gn(x, m.weight, m.bias, 32, 1e-6))
    assert torch.equal(m(x, silu=True), _island_gn(x, m.weight, m.bias, 32, 1e-6, silu=True))
    if kind == "group_norm":
        assert torch.equal(m(x, add=a, silu=True),
                           _island_gn(x, m.weight, m.bias, 32, 1e-6, a, True))


def _resblock_parent(m, x, emb, t):
    """ResBlock.forward as it was before the norms took SiLU and the emb add:
    the Sequentials run module by module."""
    if m.resample is not None:
        h = m.resample(m.in_layers[:2](x))
        x = m.resample(x)
        h = m.in_layers[2](h)
    else:
        h = m.in_layers(x)
    emb_out = m.emb_layers(emb).to(h.dtype)[:, None].expand(-1, t, -1)
    emb_out = emb_out.reshape(h.shape[0], -1, 1, 1)
    if m.use_scale_shift_norm:
        scale, shift = emb_out.chunk(2, dim=1)
        h = m.out_layers[1:](m.out_layers[0](h) * (1 + scale) + shift)
    else:
        h = m.out_layers(h + emb_out)
    h = m.skip_connection(x) + h
    if m.temopral_conv is not None:
        clip, c = _to_clip(h, t), m.temopral_conv
        h = _from_clip(clip + c.conv4(c.conv3(c.conv2(c.conv1(clip)))))
    return h


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("variant", ["plain", "scale_shift", "down", "up_out_ch",
                                     "temporal_conv"])
def test_resblock_is_its_sequentials(few_torch_threads, variant, dtype):
    torch.manual_seed(11)
    kw = dict(use_scale_shift_norm=variant == "scale_shift", down=variant == "down",
              up=variant == "up_out_ch", use_temporal_conv=variant == "temporal_conv")
    m = _with_affine(ResBlock(64, 48, out_channels=96 if variant == "up_out_ch" else None,
                              **kw), 12).to(dtype)
    norms.keep_norms_fp32(m)
    t = 4
    x = torch.randn(2 * t, 64, 4, 6, generator=_gen(13)).to(dtype)
    emb = torch.randn(2, 48, generator=_gen(14)).to(dtype)
    with torch.no_grad():
        assert torch.equal(m(x, emb, t), _resblock_parent(m, x, emb, t))


@pytest.mark.parametrize("aware", [False, True], ids=["plain", "spatial_aware"])
def test_temporal_conv_block_is_its_sequentials(few_torch_threads, aware):
    torch.manual_seed(15)
    m = _with_affine(TemporalConvBlock(64, spatial_aware=aware), 16).to(torch.bfloat16)
    norms.keep_norms_fp32(m)
    t = 4
    x = torch.randn(2 * t, 64, 3, 5, generator=_gen(17)).to(torch.bfloat16)
    clip = _to_clip(x, t)
    want = _from_clip(clip + m.conv4(m.conv3(m.conv2(m.conv1(clip)))))
    with torch.no_grad():
        assert torch.equal(m(x, t), want)


def test_vae_resnet_block_is_the_parent_formula(few_torch_threads):
    torch.manual_seed(18)
    m = _with_affine(ResnetBlock(64, 96), 19).to(torch.bfloat16)
    norms.keep_norms_fp32(m)
    x = torch.randn(2, 64, 6, 8, generator=_gen(20)).to(torch.bfloat16)
    h = m.conv1(F.silu(m.norm1(x)))
    h = m.conv2(m.dropout(F.silu(m.norm2(h))))
    with torch.no_grad():
        assert torch.equal(m(x), m.nin_shortcut(x) + h)


GROUP_NORM_ACT = norms.group_norm_act   # the wrapper itself, before any test stands in for it
CSRC_NORMS = Path(norms.__file__).resolve().parents[1] / "csrc" / "norms.cu"


@pytest.fixture
def counting_kernels(monkeypatch):
    """The kernel wrappers replaced by counters that run the plain versions."""
    calls = {"group_norm": 0, "layer_norm": 0}

    def gn(*args, **kw):
        calls["group_norm"] += 1
        return norms.group_norm_act_plain(*args, **kw)

    def ln(*args, **kw):
        calls["layer_norm"] += 1
        return norms.layer_norm_plain(*args, **kw)

    monkeypatch.setattr(norms, "group_norm_act", gn)
    monkeypatch.setattr(norms, "layer_norm", ln)
    return calls


@pytest.mark.parametrize("grad", ["no_grad", "records"])
def test_cpu_tensors_never_reach_a_kernel(few_torch_threads, counting_kernels, grad):
    gn, cgn, ln = norms.GroupNorm(32, 64), norms.ClipGroupNorm(32, 64), norms.LayerNorm(96)
    x, a = _gn_input("per_frame", torch.float32)
    clip, _ = _gn_input("to_clip", torch.float32)
    before = norms.island_calls
    with torch.set_grad_enabled(grad == "records"):
        gn(x, add=a, silu=True)
        cgn(clip, silu=True)
        ln(torch.randn(2, 96))
    assert counting_kernels == {"group_norm": 0, "layer_norm": 0}
    assert norms.island_calls == before          # the count is of CUDA calls


def _fake_cuda(dtype=torch.bfloat16, requires_grad=False):
    return types.SimpleNamespace(is_cuda=True, dtype=dtype, requires_grad=requires_grad)


@pytest.mark.parametrize("case,grad_on,x_grad,w_grad,kernel", [
    ("inference", False, False, True, True),
    ("grad_on_nothing_requires", True, False, False, True),
    ("input_records", True, True, False, False),
    ("weight_records", True, False, True, False),
    ("no_grad_with_requires", False, True, True, True),
])
def test_kernel_route_rule(case, grad_on, x_grad, w_grad, kernel):
    w = torch.ones(4, requires_grad=w_grad)
    before = norms.island_calls
    with torch.set_grad_enabled(grad_on):
        assert norms._kernel_route(_fake_cuda(requires_grad=x_grad), w) is kernel
    assert norms.island_calls == before + (0 if kernel else 1)


def test_kernel_route_dtypes():
    w = torch.ones(4)
    before = norms.island_calls
    assert norms._kernel_route(_fake_cuda(torch.float32), w)
    assert not norms._kernel_route(_fake_cuda(torch.float16), w)
    assert not norms._kernel_route(torch.ones(2), w)          # CPU: not counted
    assert norms.island_calls == before + 1


def test_routed_modules_pass_their_parts(few_torch_threads, counting_kernels, monkeypatch):
    """With the route forced open, each module hands x, add and silu to its
    wrapper, and `ClipGroupNorm(frames=...)` still takes the island."""
    monkeypatch.setattr(norms, "_kernel_route", lambda x, w: True)
    monkeypatch.setattr(norms, "sp_all_reduce", lambda t, frames: t.clone())
    gn = _with_affine(norms.GroupNorm(32, 64, eps=1e-6), 21)
    x, a = _gn_input("per_frame", torch.float32)
    assert torch.equal(gn(x, add=a, silu=True),
                       _island_gn(x, gn.weight, gn.bias, 32, 1e-6, a, True))
    ln = norms.LayerNorm(96, keep_fp32=True)
    ln(torch.randn(2, 96).to(torch.bfloat16))
    assert counting_kernels == {"group_norm": 1, "layer_norm": 1}
    cgn = _with_affine(norms.ClipGroupNorm(32, 64, eps=1e-6), 22)
    clip, _ = _gn_input("to_clip", torch.float32)
    frames = FrameSplit(Mesh({"dp": 1, "sp": 1}), clip.shape[2])
    y = cgn(clip, frames, silu=True)
    assert counting_kernels == {"group_norm": 1, "layer_norm": 1}
    torch.testing.assert_close(y, _island_gn(clip, cgn.weight, cgn.bias, 32, 1e-6, silu=True),
                               atol=1e-5, rtol=1e-5)


def test_launches_by_plan_names_the_kernels_plans(few_torch_threads, counting_kernels,
                                                  monkeypatch):
    """`group_norm_act.launches_by_plan` is keyed by `GN_PLANS`, the names of
    `csrc/norms.cu`'s PlanKind in its order (the C side returns the number);
    a call that launches nothing (the CPU, the wrapper stood in for by a
    counter) counts under no plan."""
    kinds = re.search(r"enum PlanKind \{([^}]*)\}", CSRC_NORMS.read_text()).group(1)
    names = tuple(re.sub(r"(?<!^)([A-Z])", r"_\1", k.split("=")[0].strip()[1:]).lower()
                  for k in kinds.split(","))
    assert names == norms.GN_PLANS
    before = dict(GROUP_NORM_ACT.launches_by_plan)
    x, a = _gn_input("per_frame", torch.float32)
    GROUP_NORM_ACT(x, torch.ones(64), torch.zeros(64), 32, 1e-6, a, True)
    monkeypatch.setattr(norms, "_kernel_route", lambda x, w: True)
    norms.GroupNorm(32, 64)(x, add=a, silu=True)
    assert counting_kernels["group_norm"] == 1
    assert GROUP_NORM_ACT.launches_by_plan == before


@pytest.mark.parametrize("view,want", [
    ("contiguous", (4, 64, 1, 48, 3072, 48, 48)),
    ("to_clip", (2, 64, 3, 20, 3840, 20, 1280)),
    ("transpose", (2, 64, 16, 20, 20480, 20, 1280)),
    ("folded_r", (2, 64, 15, 20, 19200, 20, 1280)),
    ("rank3", (4, 64, 1, 10, 640, 10, 10)),
    ("w_not_last", None),
])
def test_rows_view(view, want):
    x = {"contiguous": lambda: torch.empty(4, 64, 6, 8),
         "to_clip": lambda: torch.empty(2, 3, 64, 4, 5).transpose(1, 2),
         "transpose": lambda: torch.empty(2, 16, 64, 20).transpose(1, 2),
         "folded_r": lambda: torch.empty(2, 3, 5, 64, 4, 5).permute(0, 3, 1, 2, 4, 5),
         "rank3": lambda: torch.empty(4, 64, 10),
         "w_not_last": lambda: torch.empty(2, 64, 4, 5).transpose(2, 3)}[view]()
    assert norms._rows(x) == want


@pytest.mark.parametrize("layout,want", [
    ("contiguous", torch.contiguous_format), ("channels_last", torch.channels_last),
    ("clip_of_channels_last", torch.channels_last), ("channels_last_3d", torch.channels_last_3d),
    ("transposed_clip", torch.contiguous_format),
])
def test_layout_is_atens_suggestion(layout, want):
    """`_layout` names x's channels-last layout, as ATen suggests it: the
    layout of the island's result on the CPU."""
    base = torch.randn(4, 64, 6, 8)
    x = {"contiguous": lambda: base,
         "channels_last": lambda: base.contiguous(memory_format=torch.channels_last),
         "clip_of_channels_last": lambda: base.contiguous(memory_format=torch.channels_last)
         .permute(0, 2, 3, 1).view(2, 2, 48, 64).permute(0, 3, 1, 2),
         "channels_last_3d": lambda: base.view(2, 2, 64, 6, 8).transpose(1, 2)
         .contiguous(memory_format=torch.channels_last_3d),
         "transposed_clip": lambda: base.view(2, 2, 64, 48).transpose(1, 2)}[layout]()
    assert norms._layout(x) == want
    out = F.group_norm(x.float(), 32)
    assert out.is_contiguous(memory_format=want)


def test_layer_norm_widths():
    fits = lambda c, dt: norms.layer_norm_fits(torch.empty(1, c, dtype=dt))
    assert all(fits(c, torch.bfloat16) for c in (320, 640, 1024, 1280, 2560))
    assert fits(1280, torch.float32) and not fits(1284, torch.float32)
    assert not fits(100, torch.bfloat16) and not fits(2568, torch.bfloat16)


# ---- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _cl(x):
    return x.contiguous(memory_format=torch.channels_last)

# (name, x maker (device, dtype, generator) -> x): the main path's shapes
GN_SHAPES = {
    "frame_320_40x64": lambda d, t, g: torch.randn(32, 320, 40, 64, generator=g, device=d),
    "frame_320_72x128": lambda d, t, g: torch.randn(16, 320, 72, 128, generator=g, device=d),
    "frame_1280_5x8": lambda d, t, g: torch.randn(32, 1280, 5, 8, generator=g, device=d),
    "frame_640_72x128": lambda d, t, g: torch.randn(16, 640, 72, 128, generator=g, device=d),
    "vae_tile_128_512x512": lambda d, t, g: torch.randn(2, 128, 512, 512, generator=g, device=d),
    "clip_b1_320_72x128": lambda d, t, g: _to_clip(
        torch.randn(16, 320, 72, 128, generator=g, device=d), 16),
    "clip_b2_320_72x128": lambda d, t, g: torch.randn(
        2, 16, 320, 72 * 128, generator=g, device=d).transpose(1, 2),
    "clip_b2_320_40x64": lambda d, t, g: _to_clip(
        torch.randn(32, 320, 40, 64, generator=g, device=d), 16),
    "clip_b1_1280_5x8": lambda d, t, g: _to_clip(
        torch.randn(16, 1280, 5, 8, generator=g, device=d), 16),
    # channels-last, as the UNet's and the VAE's convs leave their activations
    "cl_frame_320_4x8": lambda d, t, g: _cl(torch.randn(6, 320, 4, 8, generator=g, device=d)),
    "cl_frame_320_72x128": lambda d, t, g: _cl(
        torch.randn(16, 320, 72, 128, generator=g, device=d)),
    "cl_frame_640_72x128": lambda d, t, g: _cl(
        torch.randn(16, 640, 72, 128, generator=g, device=d)),
    "cl_frame_960_72x128": lambda d, t, g: _cl(
        torch.randn(16, 960, 72, 128, generator=g, device=d)),
    "cl_frame_1280_72x128": lambda d, t, g: _cl(
        torch.randn(16, 1280, 72, 128, generator=g, device=d)),
    "cl_frame_320_40x64": lambda d, t, g: _cl(torch.randn(32, 320, 40, 64, generator=g, device=d)),
    "cl_frame_640_36x64": lambda d, t, g: _cl(torch.randn(16, 640, 36, 64, generator=g, device=d)),
    "cl_frame_1280_5x8": lambda d, t, g: _cl(torch.randn(32, 1280, 5, 8, generator=g, device=d)),
    "cl_vae_tile_128_512x512": lambda d, t, g: _cl(
        torch.randn(2, 128, 512, 512, generator=g, device=d)),
    "cl_vae_tile_4x128_512x512": lambda d, t, g: _cl(
        torch.randn(4, 128, 512, 512, generator=g, device=d)),
    "cl_clip_b1_320_72x128": lambda d, t, g: _to_clip(
        _cl(torch.randn(16, 320, 72, 128, generator=g, device=d)), 16),
    "cl_clip_b2_320_40x64": lambda d, t, g: _cl(
        torch.randn(32, 320, 40, 64, generator=g, device=d)).view(2, 16, 320, 40 * 64)
    .transpose(1, 2),
    "cl_clip_b2_320_T25_72x128": lambda d, t, g: _to_clip(
        _cl(torch.randn(50, 320, 72, 128, generator=g, device=d)), 25),
}
# the plan each channels-last shape takes: a block a sample; a sample held
# in several blocks' rings; a sample over what the rings hold, streamed
GN_PLAN = {"cl_frame_320_4x8": "rows_block", "cl_frame_320_72x128": "rows_held",
           "cl_frame_1280_72x128": "rows_held", "cl_frame_1280_5x8": "rows_block",
           "cl_vae_tile_128_512x512": "rows_streamed", "cl_vae_tile_4x128_512x512": "rows_streamed",
           "cl_clip_b1_320_72x128": "rows_streamed", "cl_clip_b2_320_T25_72x128": "rows_streamed",
           "frame_1280_5x8": "channel", "frame_640_72x128": "channel_rounds",
           "clip_b1_320_72x128": "channel_rounds", "vae_tile_128_512x512": "channel_rounds"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", list(GN_SHAPES))
def test_cuda_group_norm_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(30)
    x = (1.5 * GN_SHAPES[shape](cuda, dtype, g) + 0.4).to(dtype)
    c = x.shape[1]
    w, b = _affine(c, 31, cuda)
    per_frame = "frame" in shape or "vae" in shape
    add = (0.5 * torch.randn(x.shape[0], c, 1, 1, generator=g, device=cuda)).to(dtype) \
        if per_frame else None
    before = norms.group_norm_act.launches
    for a, silu in ((None, False), (add, True)):
        out = norms.group_norm_act(x, w, b, 32, 1e-6, a, silu)
        ref = norms.group_norm_act_plain(x, w, b, 32, 1e-6, a, silu)
        assert out.dtype == dtype and out.shape == x.shape
        assert out.is_contiguous(memory_format=norms._layout(x))
        assert _rel(out, ref) <= TOL[dtype], (shape, a is not None, silu)
    assert norms.group_norm_act.launches > before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["frame_1280_5x8", "frame_640_72x128", "clip_b1_320_72x128",
                                   "vae_tile_128_512x512", "cl_frame_320_4x8",
                                   "cl_frame_320_72x128", "cl_vae_tile_128_512x512",
                                   "cl_clip_b1_320_72x128", "cl_frame_1280_72x128",
                                   "cl_frame_1280_5x8", "cl_vae_tile_4x128_512x512",
                                   "cl_clip_b2_320_T25_72x128"])
def test_cuda_group_norm_plans_repeat_bit_for_bit(cuda, shape):
    """Each plan within bf16's tolerance of plain, and two launches equal: a
    block a group (per channel) or a sample (channels-last), rounds of
    resident blocks, a channels-last sample held in several blocks' rings,
    and one streamed past what the rings hold (the VAE tile, the clips);
    the launch counted under its plan."""
    g = torch.Generator(device=cuda).manual_seed(32)
    x = (2.0 * GN_SHAPES[shape](cuda, torch.bfloat16, g) - 0.3).to(torch.bfloat16)
    w, b = _affine(x.shape[1], 33, cuda)
    before = dict(norms.group_norm_act.launches_by_plan)
    one = norms.group_norm_act(x, w, b, 32, 1e-6, silu=True)
    after = norms.group_norm_act.launches_by_plan
    assert {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)} == \
        {GN_PLAN[shape]: 1}
    assert torch.equal(one, norms.group_norm_act(x, w, b, 32, 1e-6, silu=True))
    assert _rel(one, norms.group_norm_act_plain(x, w, b, 32, 1e-6, silu=True)) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["frame_320_40x64", "frame_1280_5x8", "clip_b2_320_40x64",
                                   "cl_frame_320_72x128", "cl_frame_1280_5x8",
                                   "cl_clip_b2_320_40x64", "cl_frame_960_72x128",
                                   "cl_frame_320_40x64", "cl_vae_tile_4x128_512x512",
                                   "cl_clip_b2_320_T25_72x128"])
def test_cuda_group_norm_is_batch_invariant(cuda, shape):
    """A sample normalises to the same bits alone as in its batch (CFG's two
    passes batched or apart, a dp rank's share of the rows): the plan's
    chunks follow from a unit's shape, not from how many units there are."""
    g = torch.Generator(device=cuda).manual_seed(38)
    x = (1.5 * GN_SHAPES[shape](cuda, torch.bfloat16, g) + 0.2).to(torch.bfloat16)
    w, b = _affine(x.shape[1], 39, cuda)
    add = (0.5 * torch.randn(x.shape[0], x.shape[1], 1, 1, generator=g, device=cuda)
           ).to(torch.bfloat16) if "frame" in shape else None
    whole = norms.group_norm_act(x, w, b, 32, 1e-6, add, True)
    half = x.shape[0] // 2
    part = norms.group_norm_act(x[:half], w, b, 32, 1e-6, None if add is None else add[:half],
                                True)
    assert torch.equal(part, whole[:half])


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 320, 128, 1280],
                         ids=["copied", "in_place", "in_place_128", "in_place_1280"])
@pytest.mark.parametrize("layout", ["channels_last", "clip_of_channels_last", "channels_last_3d"])
def test_cuda_group_norm_keeps_a_channels_last_layout(cuda, layout, c):
    """A channels-last input (the UNet's convs keep the layout of its
    permuted input) comes back in its own layout, as the island returns it,
    so the ops after the norm keep theirs; the values within bf16's
    tolerance of the island. 320 channels are read in place (no copy kernel
    runs); at 64 a bf16 vector spans four groups, and x is copied."""
    g = torch.Generator(device=cuda).manual_seed(40)
    base = torch.randn(4, c, 6, 8, generator=g, device=cuda).to(torch.bfloat16)
    if layout == "channels_last":
        x = base.contiguous(memory_format=torch.channels_last)
    elif layout == "clip_of_channels_last":   # (B, C, T, HW) over (B*T, HW, C) memory
        x = base.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1).view(
            2, 2, 48, c).permute(0, 3, 1, 2)
    else:
        x = base.view(2, 2, c, 6, 8).transpose(1, 2).contiguous(
            memory_format=torch.channels_last_3d)
    w, b = _affine(c, 41, cuda)
    add = (0.5 * torch.randn(x.shape[0], c, *([1] * (x.dim() - 2)), generator=g, device=cuda)
           ).to(torch.bfloat16)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = norms.group_norm_act(x, w, b, 32, 1e-6, add, silu=True)
        torch.cuda.synchronize()
    ref = norms.group_norm_act_plain(x, w, b, 32, 1e-6, add, silu=True)
    assert out.shape == ref.shape and out.stride() == x.stride()
    assert _rel(out, ref) <= 1e-2
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [n for n in names if "copy" in n.lower() or "elementwise" in n.lower()]
    assert any("group_norm" in n for n in names), names
    assert bool(copies) == (c == 64), names


@pytest.mark.cuda
def test_cuda_group_norm_unaligned_and_ragged(cuda):
    """HW not a multiple of a vector, and a storage offset off 16 bytes: the
    element-wise route."""
    g = torch.Generator(device=cuda).manual_seed(34)
    w, b = _affine(64, 35, cuda)
    for x in (torch.randn(3, 64, 5, 7, generator=g, device=cuda).to(torch.bfloat16),
              torch.randn(3 * 64 * 40 + 1, generator=g, device=cuda).to(torch.bfloat16)[1:]
              .view(3, 64, 5, 8)):
        out = norms.group_norm_act(x, w, b, 32, 1e-6, silu=True)
        assert _rel(out, norms.group_norm_act_plain(x, w, b, 32, 1e-6, silu=True)) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c", [320, 640, 1024, 1280])
def test_cuda_layer_norm_matches_plain(cuda, c, dtype):
    g = torch.Generator(device=cuda).manual_seed(36)
    x = (2.0 * torch.randn(4, 2560, c, generator=g, device=cuda) + 0.5).to(dtype)
    w, b = _affine(c, 37, cuda)
    before = norms.layer_norm.launches
    for keep in (False, True):
        out = norms.layer_norm(x, w, b, 1e-5, keep)
        assert out.dtype == (torch.float32 if keep else dtype)
        assert _rel(out, norms.layer_norm_plain(x, w, b, 1e-5, keep)) <= TOL[dtype]
    assert norms.layer_norm.launches == before + 2
    out = norms.layer_norm(x, w, b, 1e-5)
    assert torch.equal(out, norms.layer_norm(x, w, b, 1e-5))
    assert torch.equal(norms.layer_norm(x[:1], w, b, 1e-5), out[:1])   # rows alone as in a batch


TINY_UNET = dict(in_channels=8, out_channels=4, model_channels=64, attention_resolutions=[2, 1],
                 num_res_blocks=1, channel_mult=[1, 2], num_head_channels=32,
                 transformer_depth=1, context_dim=64, temporal_conv=True,
                 temporal_attention=True, temporal_length=4, addition_attention=True,
                 image_cross_attention=True, image_cross_attention_scale_learnable=True,
                 default_fs=3, fs_condition=True, dropout=0.0)


def _tiny_unet(cuda):
    from dynamicrafter_tpu_torch.models.unet3d import UNetConfig, UNetModel
    from dynamicrafter_tpu_torch.utils.weights import init_normal_

    cfg = dataclasses.replace(UNetConfig.from_dict(TINY_UNET), use_checkpoint=False)
    torch.manual_seed(40)
    unet = norms.keep_norms_fp32(UNetModel(cfg).to(cuda).to(torch.bfloat16)).eval()
    init_normal_(unet, torch.Generator(device=cuda).manual_seed(41), 0.05)
    g = torch.Generator(device=cuda).manual_seed(42)
    rand = lambda *s: torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
    args = (rand(1, 4, 16, 16, 8), torch.full((1,), 500, dtype=torch.long, device=cuda))
    kw = dict(context_text=rand(1, 7, 64), context_img=rand(1, 4, 16, 64),
              fs=torch.full((1,), 3, dtype=torch.long, device=cuda))
    return unet, args, kw


@pytest.mark.cuda
def test_cuda_tiny_unet_through_the_kernels(cuda, monkeypatch):
    unet, args, kw = _tiny_unet(cuda)
    gn0, ln0, island0 = norms.group_norm_act.launches, norms.layer_norm.launches, \
        norms.island_calls
    with torch.no_grad():
        fast = unet(*args, **kw)
    assert norms.island_calls == island0
    assert norms.group_norm_act.launches > gn0 and norms.layer_norm.launches > ln0
    monkeypatch.setattr(norms, "_kernel_route", lambda x, w: False)
    with torch.no_grad():
        island = unet(*args, **kw)
    assert _rel(fast, island) <= 2e-2


@pytest.mark.cuda
def test_cuda_recording_a_graph_takes_the_island(cuda):
    unet, args, kw = _tiny_unet(cuda)
    gn0, ln0, island0 = norms.group_norm_act.launches, norms.layer_norm.launches, \
        norms.island_calls
    out = unet(*args, **kw)
    out.float().square().mean().backward()
    assert norms.group_norm_act.launches == gn0 and norms.layer_norm.launches == ln0
    assert norms.island_calls > island0
