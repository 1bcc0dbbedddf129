"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
The file imports no JAX, so it runs on the GPU machine as it is:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: forward outputs relative L2 <= 1e-5 in fp32 (the kernels
accumulate in fp32, in another order than cuBLAS) and <= 1e-2 in bf16 (the
inputs' own rounding, the output's, and that of p before the PV product in
the tensor-core K1/K3, K2, K5, K6, K9 and K10, which read about 2.3e-3; <= 5e-3
for K6, K9 and K10, at scales 0.125, 0.3 and -0.125 for K6, K9 and K10, and
K10's mode exp2 equal to K1 bit for bit); lse max abs <= 1e-3; the backward's dq, dk, dv
<= 1e-4 in fp32 and <= 2e-2 in bf16 (ds is rounded to bf16 before its
products, as in the Pallas kernels, and in the tensor-core K4b p before the
dV product; they read about 2.4e-3); its di pre-pass <= 1e-6 (fp32 sums in
another order); weight gradients through a whole
transformer in bf16 <= 2e-2. TF32 is off for the plain versions' fp32
matmuls. K7 and K8 (fused GroupNorm -> SiLU -> 3x3 conv): <= 1e-5 in fp32
and <= 1e-2 in bf16 (each output is rounded once, 2^-9 relative, and bf16
products accumulate on the tensor cores, wgmma, in another order; read 1e-4
to 3e-4), and K7 against K8 on one fp32 input <= 1e-5; the bf16 route's
GroupNorm statistics (`gn_stats`) <= 1e-5 on scale and bias (fp32 sums in
another order).
"""
import os

import pytest

torch = pytest.importorskip("torch")

from dynamicrafter_tpu_torch.experiments.flash_pairs import (  # noqa: E402
    bench_flash_variants as tvariants,
)
from dynamicrafter_tpu_torch.experiments.flash_pairs.flash_pairs import (  # noqa: E402
    flash_attention_pairs,
)
from dynamicrafter_tpu_torch.experiments.fused_conv import fused_conv as tconv  # noqa: E402
from dynamicrafter_tpu_torch.experiments.fused_conv import (  # noqa: E402
    fused_conv_tiled as tconv_tiled,
)
from dynamicrafter_tpu_torch.models.blocks import (  # noqa: E402
    SpatialTransformer, TemporalTransformer,
)
from dynamicrafter_tpu_torch.ops import attention as tattn  # noqa: E402
from dynamicrafter_tpu_torch.ops import flash_attention as tflash  # noqa: E402
from dynamicrafter_tpu_torch.ops import kernels as tkernels  # noqa: E402
from dynamicrafter_tpu_torch.ops import small_attention as tsmall  # noqa: E402
from dynamicrafter_tpu_torch.ops.norms import keep_norms_fp32  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def _qkv(shape, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, device=device, generator=g).to(dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("n,lq,lk,h", [(2, 300, 300, 2), (4, 2560, 2560, 5), (2, 130, 77, 1)])
def test_k1_kernel_matches_plain(cuda, dtype, tol, n, lq, lk, h):
    q = _qkv((n, lq, h * 64), dtype, cuda)[0]
    _, k, v = _qkv((n, lk, h * 64), dtype, cuda, seed=1)
    before = tflash.flash_fwd.launches
    out = tflash.flash_fwd(q, k, v, h, 0.125)
    ref = tflash.flash_fwd_plain(q.float(), k.float(), v.float(), h, 0.125)
    torch.cuda.synchronize()
    assert tflash.flash_fwd.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert _rel(out, ref) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,t,g,h", [(2, 16, 2560, 5), (2, 16, 40, 20), (1, 5, 37, 2),
                                     (1, 16, 9216, 5), (16, 16, 1024, 5),
                                     (2, 25, 9216, 5), (2, 25, 2304, 10), (2, 25, 576, 20)])
def test_k2_kernel_matches_plain(cuda, dtype, tol, b, t, g, h):
    """The 320 x 512 shapes, a ragged one, the largest of the 576 x 1024
    (G = 9216) and 256 x 256 --bs 8 (B = 16) paths, and Stable Video
    Diffusion XT's three levels at T = 25 (the two-tile kernel)."""
    q, k, v = _qkv((b, t, g, h * 64), dtype, cuda)
    before = tsmall.small_t_fwd_tmajor.launches
    out = tsmall.small_t_fwd_tmajor(q, k, v, h, 0.125)
    ref = tsmall.small_t_fwd_tmajor_plain(q.float(), k.float(), v.float(), h, 0.125)
    torch.cuda.synchronize()
    assert tsmall.small_t_fwd_tmajor.launches == before + 1
    assert _rel(out, ref) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("g,t,h,d", [(256, 16, 20, 64), (37, 8, 3, 64), (5, 32, 2, 32),
                                     (130, 1, 1, 8), (19, 5, 2, 64)])
def test_k5_kernel_matches_plain(cuda, dtype, tol, g, t, h, d):
    """The 256 x 256 middle-block shape, and ragged cases: G not a multiple of
    the row tile, T = 1, 5, 8 and 32, other head counts and widths."""
    q, k, v = _qkv((g, t, h * d), dtype, cuda)
    before = tsmall.small_t_fwd.launches
    out = tsmall.small_t_fwd(q, k, v, h, d ** -0.5)
    ref = tsmall.small_t_fwd_plain(q.float(), k.float(), v.float(), h, d ** -0.5)
    torch.cuda.synchronize()
    assert tsmall.small_t_fwd.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert _rel(out, ref) <= tol


def test_k5_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(4, 33, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="T=33"):
        tsmall.small_t_fwd(q, q, q, 1, 0.125)
    q = torch.zeros(4, 16, 2 * 12, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        tsmall.small_t_fwd(q, q, q, 2, 0.125)
    q = torch.zeros(4, 16, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        tsmall.small_t_fwd(q.transpose(0, 1), q.transpose(0, 1), q.transpose(0, 1), 1, 0.125)
    with pytest.raises(TypeError, match="dtype"):
        tsmall.small_t_fwd(q.half(), q.half(), q.half(), 1, 0.125)


# K5's bf16 route with head dim 64: the tensor-core kernel (K2's warp loop on
# the position-major layout). T = 1, 5 and 16 take one m16 tile of rows, 17
# and 32 two; G = 1, 3 (fewer groups than a block's warps), 257 (ragged) and
# 4096 (more groups than the persistent grid's warps)
K5_TC_SHAPES = [(g, t, h) for t in (1, 5, 16, 17, 32) for g, h in ((3, 3), (257, 2))] + [
    (1, 16, 1), (1, 32, 20), (4096, 16, 2), (4096, 17, 1)]


def _k5_entry(q, k, v, out, h, scale, device):
    g, t, hd = q.shape
    tkernels.check(tkernels.library().dct_small_t_fwd_posmajor(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), tkernels.DTYPE_CODES[q.dtype],
        g, t, h, hd // h, scale, tkernels.stream_handle(device)), "dct_small_t_fwd_posmajor")


@pytest.mark.parametrize("g,t,h", K5_TC_SHAPES)
def test_k5_tensor_core_kernel_matches_plain(cuda, g, t, h):
    """bf16 K5 on the tensor cores (p rounded to bf16 as in Pallas) against
    the fp32 plain version at 1e-2."""
    q, k, v = _qkv((g, t, h * 64), torch.bfloat16, cuda)
    before = tsmall.small_t_fwd.launches
    out = tsmall.small_t_fwd(q, k, v, h, 0.125)
    ref = tsmall.small_t_fwd_plain(q.float(), k.float(), v.float(), h, 0.125)
    torch.cuda.synchronize()
    assert tsmall.small_t_fwd.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert _rel(out, ref) <= 1e-2


@pytest.mark.parametrize("t", [5, 16, 32])
@pytest.mark.parametrize("scale", [0.3, -0.125, 0.0])
def test_k5_tensor_core_kernel_takes_any_scale(cuda, scale, t):
    """Any scale, negative and zero (uniform attention) included."""
    q, k, v = _qkv((37, t, 3 * 64), torch.bfloat16, cuda)
    out = tsmall.small_t_fwd(q, k, v, 3, scale)
    ref = tsmall.small_t_fwd_plain(q.float(), k.float(), v.float(), 3, scale)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= 1e-2, _rel(out, ref)


@pytest.mark.parametrize("g,t,h", [(3, 5, 3), (257, 17, 2), (256, 16, 20), (1, 1, 1)])
def test_k5_tensor_core_kernel_writes_nothing_past_the_output(cuda, g, t, h):
    """The library entry writes o into the head of a larger buffer whose NaN
    tail stays NaN; the head is the wrapper's output bit for bit."""
    q, k, v = _qkv((g, t, h * 64), torch.bfloat16, cuda)
    buf = torch.full((q.numel() + 4096,), float("nan"), device=cuda, dtype=torch.bfloat16)
    _k5_entry(q, k, v, buf, h, 0.125, cuda)
    torch.cuda.synchronize()
    assert bool(buf[q.numel():].isnan().all())
    assert torch.equal(buf[:q.numel()].view_as(q), tsmall.small_t_fwd(q, k, v, h, 0.125))


@pytest.mark.parametrize("g,t,h", [(256, 16, 20), (4096, 17, 2)])
def test_k5_tensor_core_kernel_is_deterministic(cuda, g, t, h):
    """Each warp owns its groups and sums in a fixed order: three runs agree
    bit for bit."""
    q, k, v = _qkv((g, t, h * 64), torch.bfloat16, cuda)
    first = tsmall.small_t_fwd(q, k, v, h, 0.125)
    for _ in range(2):
        assert torch.equal(first, tsmall.small_t_fwd(q, k, v, h, 0.125))


@pytest.mark.parametrize("g,t,h", [(256, 16, 20), (257, 32, 3), (3, 1, 2)])
def test_k5_tensor_core_kernel_is_k2s_loop_on_the_same_memory(cuda, g, t, h):
    """(G, T, H*64) is K2's (B, T, G, H*64) layout with B = G and G = 1, and
    K5's kernel runs K2's warp loop: the same output bit for bit."""
    q, k, v = _qkv((g, t, h * 64), torch.bfloat16, cuda)
    out = tsmall.small_t_fwd(q, k, v, h, -0.3)
    as_k2 = tsmall.small_t_fwd_tmajor(*(x.view(g, t, 1, h * 64) for x in (q, k, v)), h, -0.3)
    assert torch.equal(out, as_k2.view_as(out))


@pytest.mark.parametrize("dtype,d,t,kernel", [
    (torch.bfloat16, 64, 16, "small_t_posmajor_tc_kernel<1>"),
    (torch.bfloat16, 64, 17, "small_t_posmajor_tc_kernel<2>"),
    (torch.float32, 64, 16, "small_t_posmajor_kernel<float>"),
    (torch.bfloat16, 32, 16, "small_t_posmajor_kernel<__nv_bfloat16>")])
def test_k5_routes_by_dtype_and_head_dim(cuda, dtype, d, t, kernel):
    """bf16 with head dim 64 runs the tensor-core kernel; fp32, and bf16 with
    another head dim, the SIMT kernel: the one kernel symbol the profiler
    records for one call."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v = _qkv((37, t, 2 * d), dtype, cuda)
    tsmall.small_t_fwd(q, k, v, 2, d ** -0.5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = tsmall.small_t_fwd(q, k, v, 2, d ** -0.5)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "small_t" in e.name]
    assert len(names) == 1 and kernel in names[0], names
    ref = tsmall.small_t_fwd_plain(q.float(), k.float(), v.float(), 2, d ** -0.5)
    assert _rel(out, ref) <= (1e-5 if dtype == torch.float32 else 1e-2)


def test_k5_head_count_limit_is_the_simt_kernels(cuda):
    """The tensor-core route's persistent grid counts G*heads groups and takes
    65536 heads; the SIMT kernel's grid has the head as its y and refuses
    them."""
    h = 65536
    q, k, v = _qkv((1, 2, h * 64), torch.bfloat16, cuda)
    out = tsmall.small_t_fwd(q, k, v, h, 0.125)
    ref = tsmall.small_t_fwd_plain(q.float(), k.float(), v.float(), h, 0.125)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= 1e-2
    with pytest.raises(ValueError, match="outside the launch grid"):
        tsmall.small_t_fwd(q.float(), k.float(), v.float(), h, 0.125)
    q = torch.zeros(1, 2, h * 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="outside the launch grid"):
        tsmall.small_t_fwd(q, q, q, h, 0.125)


@pytest.mark.parametrize("n,l,h", [(2, 9216, 5), (2, 2304, 10)])
def test_k1_at_the_1024_shapes(cuda, n, l, h):
    """The 576 x 1024 model's spatial self-attention lengths, at a small N
    (the plain version materialises N*H*L^2 logits)."""
    q, k, v = _qkv((n, l, h * 64), torch.bfloat16, cuda)
    out = tflash.flash_fwd(q, k, v, h, 0.125)
    ref = tflash.flash_fwd_plain(q.float(), k.float(), v.float(), h, 0.125)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= 1e-2


def test_k1_refuses_other_head_dims(cuda):
    q = torch.zeros(1, 64, 2 * 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_fwd(q, q, q, 2, 0.125)


def test_k2_refuses_long_t(cuda):
    q = torch.zeros(1, 33, 4, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="T=33"):
        tsmall.small_t_fwd_tmajor(q, q, q, 1, 0.125)


# K2's bf16 route with head dim 64: the tensor-core kernel. T = 1, 5 and 16
# take one m16 tile of rows, 17 and 32 two; G ragged against the 4-warp
# blocks (37) and B, H other than 1
K2_TC_SHAPES = [(b, t, g, h) for t in (1, 5, 16, 17, 32) for b, g, h in ((2, 37, 3), (1, 160, 5))]


def _k2_entry(q, k, v, out, h, scale, device):
    b, t, g, hd = q.shape
    tkernels.check(tkernels.library().dct_small_t_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), tkernels.DTYPE_CODES[q.dtype],
        b, t, g, h, hd // h, scale, tkernels.stream_handle(device)), "dct_small_t_fwd")


@pytest.mark.parametrize("b,t,g,h", K2_TC_SHAPES)
def test_k2_tensor_core_kernel_matches_plain(cuda, b, t, g, h):
    """bf16 K2 on the tensor cores (p rounded to bf16 as in Pallas) against
    the fp32 plain version at the existing 1e-2."""
    q, k, v = _qkv((b, t, g, h * 64), torch.bfloat16, cuda)
    before = tsmall.small_t_fwd_tmajor.launches
    out = tsmall.small_t_fwd_tmajor(q, k, v, h, 0.125)
    ref = tsmall.small_t_fwd_tmajor_plain(q.float(), k.float(), v.float(), h, 0.125)
    torch.cuda.synchronize()
    assert tsmall.small_t_fwd_tmajor.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert _rel(out, ref) <= 1e-2


@pytest.mark.parametrize("t", [5, 16, 32])
@pytest.mark.parametrize("scale", [0.3, -0.125, 0.0])
def test_k2_tensor_core_kernel_takes_any_scale(cuda, scale, t):
    """The logits are scaled before their max: any scale, negative and zero
    (uniform attention) included."""
    q, k, v = _qkv((2, t, 37, 3 * 64), torch.bfloat16, cuda)
    out = tsmall.small_t_fwd_tmajor(q, k, v, 3, scale)
    ref = tsmall.small_t_fwd_tmajor_plain(q.float(), k.float(), v.float(), 3, scale)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= 1e-2, _rel(out, ref)


@pytest.mark.parametrize("b,t,g,h", [(2, 5, 37, 3), (1, 17, 160, 5), (2, 16, 40, 20)])
def test_k2_tensor_core_kernel_writes_nothing_past_the_output(cuda, b, t, g, h):
    """The library entry writes o into the head of a larger buffer whose NaN
    tail stays NaN; the head is the wrapper's output bit for bit."""
    q, k, v = _qkv((b, t, g, h * 64), torch.bfloat16, cuda)
    buf = torch.full((q.numel() + 4096,), float("nan"), device=cuda, dtype=torch.bfloat16)
    _k2_entry(q, k, v, buf, h, 0.125, cuda)
    torch.cuda.synchronize()
    assert bool(buf[q.numel():].isnan().all())
    assert torch.equal(buf[:q.numel()].view_as(q), tsmall.small_t_fwd_tmajor(q, k, v, h, 0.125))


@pytest.mark.parametrize("b,t,g,h", [(2, 16, 2560, 5), (1, 17, 160, 5)])
def test_k2_tensor_core_kernel_is_deterministic(cuda, b, t, g, h):
    """Each warp owns its groups and sums in a fixed order: three runs agree
    bit for bit."""
    q, k, v = _qkv((b, t, g, h * 64), torch.bfloat16, cuda)
    first = tsmall.small_t_fwd_tmajor(q, k, v, h, 0.125)
    for _ in range(2):
        assert torch.equal(first, tsmall.small_t_fwd_tmajor(q, k, v, h, 0.125))


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 64, "small_t_tc_kernel<1>"),
    (torch.float32, 64, "small_t_kernel<float>"),
    (torch.bfloat16, 32, "small_t_kernel<__nv_bfloat16>")])
def test_k2_routes_by_dtype_and_head_dim(cuda, dtype, d, kernel):
    """bf16 with head dim 64 runs the tensor-core kernel; fp32, and bf16 with
    another head dim, the first version: the one kernel symbol the profiler
    records for one call."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v = _qkv((2, 16, 37, 2 * d), dtype, cuda)
    tsmall.small_t_fwd_tmajor(q, k, v, 2, d ** -0.5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = tsmall.small_t_fwd_tmajor(q, k, v, 2, d ** -0.5)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "small_t" in e.name]
    assert len(names) == 1 and kernel in names[0], names
    ref = tsmall.small_t_fwd_tmajor_plain(q.float(), k.float(), v.float(), 2, d ** -0.5)
    assert _rel(out, ref) <= (1e-5 if dtype == torch.float32 else 1e-2)


SHAPES = [(2, 300, 300, 2), (4, 2560, 2560, 5), (2, 130, 77, 1)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("n,lq,lk,h", SHAPES)
def test_k3_kernel_matches_plain(cuda, dtype, tol, n, lq, lk, h):
    q = _qkv((n, lq, h * 64), dtype, cuda)[0]
    _, k, v = _qkv((n, lk, h * 64), dtype, cuda, seed=1)
    before = tflash.flash_fwd_lse.launches
    out, lse = tflash.flash_fwd_lse(q, k, v, h, 0.125)
    ref, ref_lse = tflash.flash_fwd_lse_plain(q.float(), k.float(), v.float(), h, 0.125)
    torch.cuda.synchronize()
    assert tflash.flash_fwd_lse.launches == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert lse.shape == (n, h, lq)
    assert _rel(out, ref) <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-3


# ragged for the bf16 kernel's 128-row query and 64-row key tiles: one row,
# Lq < Lk and Lq > Lk, Lk exactly one key tile, and a 576x1024 level-1 shape
TC_SHAPES = [(1, 1, 1, 1), (2, 17, 77, 2), (2, 130, 300, 5), (3, 65, 64, 5), (2, 2304, 2304, 10)]


@pytest.mark.parametrize("n,lq,lk,h", TC_SHAPES)
@pytest.mark.parametrize("which", ["K1", "K3"])
def test_k1_k3_tensor_core_kernel_matches_plain(cuda, which, n, lq, lk, h):
    """bf16 K1 and K3 (both products on the tensor cores, p rounded to bf16)
    against the fp32 plain version: o rel L2 <= 1e-2, lse max abs <= 1e-3."""
    q = _qkv((n, lq, h * 64), torch.bfloat16, cuda)[0]
    _, k, v = _qkv((n, lk, h * 64), torch.bfloat16, cuda, seed=1)
    ref, ref_lse = tflash.flash_fwd_lse_plain(q.float(), k.float(), v.float(), h, 0.125)
    wrapper = tflash.flash_fwd if which == "K1" else tflash.flash_fwd_lse
    before = wrapper.launches
    out = wrapper(q, k, v, h, 0.125)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    if which == "K3":
        out, lse = out
        assert lse.dtype == torch.float32 and lse.shape == (n, h, lq)
        assert (lse - ref_lse).abs().max().item() <= 1e-3
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert _rel(out, ref) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,lq,lk,h", TC_SHAPES)
def test_k1_and_k3_outputs_are_identical(cuda, dtype, n, lq, lk, h):
    """K3 is K1's template with the lse store compiled in: o agrees bit for bit."""
    q = _qkv((n, lq, h * 64), dtype, cuda)[0]
    _, k, v = _qkv((n, lk, h * 64), dtype, cuda, seed=1)
    assert torch.equal(tflash.flash_fwd(q, k, v, h, 0.125),
                       tflash.flash_fwd_lse(q, k, v, h, 0.125)[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,lq,lk,h", [(2, 130, 77, 1), (3, 65, 64, 5)])
def test_k1_k3_write_nothing_past_the_output_or_lse(cuda, dtype, n, lq, lk, h):
    """Ragged query tiles: the library entries write o and lse into the head
    of larger buffers whose tails keep their fill."""
    q = _qkv((n, lq, h * 64), dtype, cuda)[0]
    _, k, v = _qkv((n, lk, h * 64), dtype, cuda, seed=1)
    ref, ref_lse = tflash.flash_fwd_lse_plain(q.float(), k.float(), v.float(), h, 0.125)
    lib, code = tkernels.library(), tkernels.DTYPE_CODES[dtype]
    stream = tkernels.stream_handle(cuda)
    numel, rows = q.numel(), n * h * lq
    o1, o3 = (torch.full((numel + 4096,), 7.0, device=cuda, dtype=dtype) for _ in range(2))
    lse = torch.full((rows + 4096,), 7.0, device=cuda)
    tkernels.check(lib.dct_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o1.data_ptr(),
                                     code, n, lq, lk, h, 0.125, stream), "K1")
    tkernels.check(lib.dct_flash_fwd_lse(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         o3.data_ptr(), lse.data_ptr(), code, n, lq, lk, h,
                                         0.125, stream), "K3")
    torch.cuda.synchronize()
    for buf in (o1, o3, lse):
        assert bool((buf[-4096:] == 7.0).all())
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert _rel(o1[:numel].view_as(q), ref) <= tol and _rel(o3[:numel].view_as(q), ref) <= tol
    assert (lse[:rows].view(n, h, lq) - ref_lse).abs().max().item() <= 1e-3


def test_k1_k3_tensor_core_kernel_refuses_a_scale_that_is_not_positive(cuda):
    """The bf16 kernel takes the running max on raw logits: only scale > 0
    is exact, and any other scale raises rather than taking another route."""
    q = torch.zeros(1, 64, 64, device=cuda, dtype=torch.bfloat16)
    for fn in (tflash.flash_fwd, tflash.flash_fwd_lse):
        for scale in (0.0, -0.125):
            with pytest.raises(RuntimeError, match="invalid argument"):
                fn(q, q, q, 1, scale)


# K4's shapes: K3's, and Lq != Lk with neither a multiple of any tile (the
# bf16 kernels' 64-row blocks and 64-row streamed tiles, the FMA kernels' 64)
K4_SHAPES = SHAPES + [(3, 77, 130, 5), (2, 2301, 2560, 5)]


def _k4_inputs(n, lq, lk, h, dtype, device, scale=0.125):
    """q, k, v, dO in `dtype`, and o, lse of the plain forward in fp32."""
    q, do = _qkv((n, lq, h * 64), dtype, device)[:2]
    _, k, v = _qkv((n, lk, h * 64), dtype, device, seed=1)
    o, lse = tflash.flash_fwd_lse_plain(q.float(), k.float(), v.float(), h, scale)
    return q, k, v, do, o, lse


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,lq,lk,h", K4_SHAPES)
def test_k4_kernels_match_plain(cuda, dtype, tol, n, lq, lk, h):
    """K4a and K4b from the plain forward's o and lse, against
    `flash_bwd_plain` on the same (fp32) inputs."""
    q, k, v, do, o, lse = _k4_inputs(n, lq, lk, h, dtype, cuda)
    refs = tflash.flash_bwd_plain(q.float(), k.float(), v.float(), o, lse, do.float(),
                                  h, 0.125)
    before = (tflash.flash_bwd_dq.launches, tflash.flash_bwd_dkv.launches)
    grads = tflash.flash_bwd(q, k, v, o.to(dtype), lse, do, h, 0.125)
    torch.cuda.synchronize()
    assert (tflash.flash_bwd_dq.launches, tflash.flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    for name, g, ref, x in zip(("dq", "dk", "dv"), grads, refs, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape, name
        assert _rel(g, ref) <= tol, (name, _rel(g, ref))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,lq,h", [(2, 300, 5), (3, 77, 1)])
def test_k4_di_prepass_matches_plain(cuda, dtype, n, lq, h):
    """The pre-pass's rowsum(dO * o) against the plain version's, fp32 sums
    in another order."""
    o, do = _qkv((n, lq, h * 64), dtype, cuda)[:2]
    before = tflash.flash_bwd_di.launches
    di = tflash.flash_bwd_di(o, do, h)
    torch.cuda.synchronize()
    assert tflash.flash_bwd_di.launches == before + 1
    assert di.dtype == torch.float32 and di.shape == (n, h, lq)
    assert _rel(di, tflash.flash_bwd_di_plain(o, do, h)) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,lq,lk,h", [(3, 77, 130, 5), (2, 130, 77, 1)])
def test_k4_write_nothing_past_dq_dk_dv(cuda, dtype, n, lq, lk, h):
    """Ragged tiles: the library entries write dq, dk and dv into the head of
    larger buffers whose NaN tails stay NaN (rows past Lq for dq, past Lk for
    dk and dv)."""
    q, k, v, do, o, lse = _k4_inputs(n, lq, lk, h, dtype, cuda)
    o = o.to(dtype)
    refs = tflash.flash_bwd_plain(q.float(), k.float(), v.float(), o.float(), lse,
                                  do.float(), h, 0.125)
    di = tflash.flash_bwd_di(o, do, h) if dtype == torch.bfloat16 else None
    lib, code = tkernels.library(), tkernels.DTYPE_CODES[dtype]
    stream = tkernels.stream_handle(cuda)
    bufs = [torch.full((x.numel() + 4096,), float("nan"), device=cuda, dtype=dtype)
            for x in (q, k, v)]
    ptrs = [b.data_ptr() for b in bufs]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            None if di is None else di.data_ptr(), do.data_ptr())
    tkernels.check(lib.dct_flash_bwd_dq(*args, ptrs[0], code, n, lq, lk, h, 0.125, stream),
                   "K4a")
    tkernels.check(lib.dct_flash_bwd_dkv(*args, *ptrs[1:], code, n, lq, lk, h, 0.125, stream),
                   "K4b")
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for buf, x, ref in zip(bufs, (q, k, v), refs):
        assert bool(buf[x.numel():].isnan().all())
        assert _rel(buf[:x.numel()].view_as(x), ref) <= tol


@pytest.mark.parametrize("n,lq,lk,h", [(3, 77, 130, 5), (2, 2560, 2560, 5)])
def test_k4_bf16_is_deterministic(cuda, n, lq, lk, h):
    """Each block owns its output tile and sums in a fixed order (no
    atomics): two runs agree bit for bit."""
    q, k, v, do, o, lse = _k4_inputs(n, lq, lk, h, torch.bfloat16, cuda)
    o = o.to(torch.bfloat16)
    first = tflash.flash_bwd(q, k, v, o, lse, do, h, 0.125)
    second = tflash.flash_bwd(q, k, v, o, lse, do, h, 0.125)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("scale", [0.3, -0.125])
def test_k4_takes_any_scale(cuda, dtype, tol, scale):
    """The backward takes lse as given (no running max), so any scale is
    exact: K4 at 0.3 and -0.125 against `flash_bwd_plain` with its lse."""
    n, lq, lk, h = 2, 200, 333, 5
    q, k, v, do, o, lse = _k4_inputs(n, lq, lk, h, dtype, cuda, scale=scale)
    refs = tflash.flash_bwd_plain(q.float(), k.float(), v.float(), o, lse, do.float(), h, scale)
    grads = tflash.flash_bwd(q, k, v, o.to(dtype), lse, do, h, scale)
    torch.cuda.synchronize()
    for name, g, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert _rel(g, ref) <= tol, (name, _rel(g, ref))


@pytest.mark.parametrize("dtype,kernels", [
    (torch.bfloat16, ("flash_bwd_di_kernel<__nv_bfloat16>", "flash_bwd_dq_tc_kernel",
                      "flash_bwd_dkv_tc_kernel")),
    (torch.float32, ("flash_bwd_dq_kernel<float>", "flash_bwd_dkv_kernel<float>"))])
def test_k4_routes_by_dtype(cuda, dtype, kernels):
    """bf16 runs the di pre-pass and the tensor-core kernels, fp32 the FMA
    kernels and no pre-pass: the kernel symbols the profiler records."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v, do, o, lse = _k4_inputs(2, 130, 77, 1, dtype, cuda)
    o = o.to(dtype)
    tflash.flash_bwd(q, k, v, o, lse, do, 1, 0.125)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tflash.flash_bwd(q, k, v, o, lse, do, 1, 0.125)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "flash_bwd" in e.name]
    assert len(names) == len(kernels), names
    for want in kernels:
        assert sum(want in name for name in names) == 1, (want, names)


def _weight_grads(module, run, backend):
    module.zero_grad(set_to_none=True)
    with tattn.use_backend(backend):
        run().float().square().mean().backward()
    return {name: p.grad.clone() if p.grad is not None else None
            for name, p in module.named_parameters()}


@pytest.mark.parametrize("kind", ["spatial", "temporal", "middle256"])
def test_attention_weights_receive_kernel_gradients(cuda, kind):
    """A backward pass through K3/K4 (spatial, L = 2560), K2 (temporal,
    T = 16) and K5 (the 256 x 256 middle block at 16 clips: 256 frames of
    4 x 4 tokens) reaches to_q, to_k and to_v of every self-attention, with
    the plain backend's gradients. Before K1 and K2 were differentiable, the
    kernel outputs had no grad_fn and these gradients were None."""
    torch.manual_seed(0)
    if kind == "middle256":
        mod = SpatialTransformer(1280, 20, 64, context_dim=1024, image_cross_attention=True)
        x = torch.randn(256, 1280, 4, 4, device=cuda)
        ctx = (torch.randn(16, 77, 1024, device=cuda),
               torch.randn(16, 16, 16, 1024, device=cuda))
        # the image cross-attention has 16 context tokens per frame, the
        # shape of q, and takes K5 as well
        attns = ["transformer_blocks.0.attn1"]
        counter = tsmall.small_t_fwd
    elif kind == "spatial":
        mod = SpatialTransformer(320, 5, 64, context_dim=1024, image_cross_attention=True)
        x = torch.randn(2, 320, 40, 64, device=cuda)
        ctx = (torch.randn(1, 77, 1024, device=cuda), torch.randn(1, 2, 16, 1024, device=cuda))
        attns = ["transformer_blocks.0.attn1"]
        counter = tflash.flash_fwd_lse
    else:
        mod = TemporalTransformer(320, 5, 64)
        x = torch.randn(16, 320, 8, 8, device=cuda)
        attns = ["transformer_blocks.0.attn1", "transformer_blocks.0.attn2"]
        counter = tsmall.small_t_fwd_tmajor
    mod = keep_norms_fp32(mod.to(cuda, torch.bfloat16))
    xb = x.to(torch.bfloat16)
    if kind == "temporal":
        run = lambda: mod(xb, 16)
    else:
        frames = 2 if kind == "spatial" else 16
        run = lambda: mod(xb, (ctx[0].bfloat16(), ctx[1].bfloat16()), frames)
    before = counter.launches
    got = _weight_grads(mod, run, "auto")
    assert counter.launches > before
    ref = _weight_grads(mod, run, "plain")
    names = [f"{a}.{proj}.weight" for a in attns for proj in ("to_q", "to_k", "to_v")]
    if kind == "middle256":
        names += [f"transformer_blocks.0.attn2.{p}.weight" for p in ("to_k_ip", "to_v_ip")]
    for name in names:
        assert got[name] is not None, name
        assert _rel(got[name], ref[name]) <= 2e-2, (name, _rel(got[name], ref[name]))


def test_k3_k4_refuse_other_head_dims(cuda):
    q = torch.zeros(1, 64, 2 * 32, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_fwd_lse(q, q, q, 2, 0.125)
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_bwd_dq(q, q, q, q, lse, q, 2, 0.125)
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_bwd_dkv(q, q, q, q, lse, q, 2, 0.125)


# K6, K9 and K10 compute K1's function: one set of shapes. Lq != Lk, ragged
# L, one head, odd and even head counts, several head groups (H = 7, 20).
VARIANT_SHAPES = [(2, 300, 300, 5), (2, 2560, 2560, 5), (2, 130, 77, 1), (1, 200, 333, 20),
                  (2, 64, 32, 2), (1, 97, 150, 7), (1, 2304, 2304, 10)]


def _variant_kernels():
    return {
        "packed": (tflash.flash_fwd_packed, tflash.flash_fwd_packed),
        "pairs": (flash_attention_pairs, flash_attention_pairs),
        "exp": (lambda *a: tvariants.run_variant(*a, "exp"), tvariants.run_variant),
        "exp2": (lambda *a: tvariants.run_variant(*a, "exp2"), tvariants.run_variant),
    }


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("n,lq,lk,h", VARIANT_SHAPES)
@pytest.mark.parametrize("which", ["packed", "pairs", "exp", "exp2"])
def test_flash_variant_kernels_match_plain(cuda, which, dtype, tol, n, lq, lk, h):
    """K6 (`flash_fwd_packed`), K9 (`flash_attention_pairs`) and K10
    (`run_variant` exp / exp2) against `flash_fwd_plain`."""
    fn, counter = _variant_kernels()[which]
    q = _qkv((n, lq, h * 64), dtype, cuda)[0]
    _, k, v = _qkv((n, lk, h * 64), dtype, cuda, seed=1)
    before = counter.launches
    out = fn(q, k, v, h, 0.125)
    ref = tflash.flash_fwd_plain(q.float(), k.float(), v.float(), h, 0.125)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    assert _rel(out, ref) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("n,lq,lk,h", VARIANT_SHAPES)
def test_k10_nosoftmax_matches_plain(cuda, dtype, tol, n, lq, lk, h):
    """The products-only mode against `run_variant_plain`; q and k scaled so
    that the clip at +-1 cuts some logits and leaves others."""
    q = _qkv((n, lq, h * 64), dtype, cuda)[0]
    _, k, v = _qkv((n, lk, h * 64), dtype, cuda, seed=1)
    out = tvariants.run_variant(q, k, v, h, 0.125, "nosoftmax")
    ref = tvariants.run_variant_plain(q.float(), k.float(), v.float(), h, 0.125, "nosoftmax")
    torch.cuda.synchronize()
    assert _rel(out, ref) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [1, 5])
def test_k9_odd_heads_touch_nothing_past_the_last_head(cuda, dtype, h):
    """The last pair of an odd H has one head: the kernel writes no column
    at or beyond H*64. The output is the head of a larger buffer whose tail
    (a guard region right behind the last row) must keep its fill; q, k and
    v end exactly at the end of their allocations."""
    n, lq, lk = 2, 100, 77
    q = _qkv((n, lq, h * 64), dtype, cuda)[0]
    _, k, v = _qkv((n, lk, h * 64), dtype, cuda, seed=1)
    numel, guard = q.numel(), 4096
    buf = torch.full((numel + guard,), 7.0, device=cuda, dtype=dtype)
    out = buf[:numel].view(n, lq, h * 64)
    code = tkernels.library().dct_flash_fwd_pairs(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), tkernels.DTYPE_CODES[dtype],
        n, lq, lk, h, 0.125, tkernels.stream_handle(cuda))
    tkernels.check(code, "dct_flash_fwd_pairs")
    torch.cuda.synchronize()
    assert bool((buf[numel:] == 7.0).all())
    ref = tflash.flash_fwd_plain(q.float(), k.float(), v.float(), h, 0.125)
    assert _rel(out, ref) <= (1e-5 if dtype == torch.float32 else 5e-3)


# K6 and K9: bf16 on the tensor cores (csrc/flash_tc.cuh), fp32 on FMAs
K6_K9 = {"K6": (tflash.flash_fwd_packed, "dct_flash_fwd_packed"),
         "K9": (flash_attention_pairs, "dct_flash_fwd_pairs")}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 5e-3)])
@pytest.mark.parametrize("n,lq,lk,h", VARIANT_SHAPES)
@pytest.mark.parametrize("scale", [0.3, -0.125])
@pytest.mark.parametrize("which", ["K6", "K9"])
def test_k6_k9_take_any_scale(cuda, which, scale, n, lq, lk, h, dtype, tol):
    """The Pallas K6 and K9 scale the logits before their max, so any finite
    scale is theirs: the kernels against `flash_fwd_plain` at 0.3 and
    -0.125 (the tensor-core kernels move the scale's sign into Q)."""
    fn = K6_K9[which][0]
    q = _qkv((n, lq, h * 64), dtype, cuda)[0]
    _, k, v = _qkv((n, lk, h * 64), dtype, cuda, seed=1)
    out = fn(q, k, v, h, scale)
    ref = tflash.flash_fwd_plain(q.float(), k.float(), v.float(), h, scale)
    torch.cuda.synchronize()
    assert _rel(out, ref) <= tol, _rel(out, ref)


@pytest.mark.parametrize("n,lq,lk,h", VARIANT_SHAPES)
@pytest.mark.parametrize("which", ["K6", "K9"])
def test_k6_k9_write_nothing_past_the_output(cuda, which, n, lq, lk, h):
    """bf16: the library entry writes o into the head of a larger buffer
    whose NaN tail (right behind the last row) stays NaN, and the head is
    the wrapper's output bit for bit."""
    fn, entry = K6_K9[which]
    q = _qkv((n, lq, h * 64), torch.bfloat16, cuda)[0]
    _, k, v = _qkv((n, lk, h * 64), torch.bfloat16, cuda, seed=1)
    buf = torch.full((q.numel() + 4096,), float("nan"), device=cuda, dtype=torch.bfloat16)
    tkernels.check(getattr(tkernels.library(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), buf.data_ptr(),
        tkernels.DTYPE_CODES[torch.bfloat16], n, lq, lk, h, 0.125,
        tkernels.stream_handle(cuda)), entry)
    torch.cuda.synchronize()
    assert bool(buf[q.numel():].isnan().all())
    assert torch.equal(buf[:q.numel()].view_as(q), fn(q, k, v, h, 0.125))


@pytest.mark.parametrize("n,lq,lk,h", [(2, 2560, 2560, 5), (1, 97, 150, 7)])
@pytest.mark.parametrize("which", ["K6", "K9"])
def test_k6_k9_bf16_is_deterministic(cuda, which, n, lq, lk, h):
    """Each block owns its output tile and sums in a fixed order (no
    atomics): two runs agree bit for bit."""
    fn = K6_K9[which][0]
    q = _qkv((n, lq, h * 64), torch.bfloat16, cuda)[0]
    _, k, v = _qkv((n, lk, h * 64), torch.bfloat16, cuda, seed=1)
    assert torch.equal(fn(q, k, v, h, 0.125), fn(q, k, v, h, 0.125))


K10_MODES = ("exp", "exp2", "nosoftmax")


def _k10_plain(q, k, v, h, scale, mode):
    return tvariants.run_variant_plain(q.float(), k.float(), v.float(), h, scale, mode)


@pytest.mark.parametrize("n,lq,lk,h", VARIANT_SHAPES)
@pytest.mark.parametrize("scale", [0.3, -0.125])
@pytest.mark.parametrize("mode", K10_MODES)
def test_k10_tensor_core_modes_take_any_scale(cuda, mode, scale, n, lq, lk, h):
    """bf16 K10 on the tensor cores in each mode against its plain version
    at 0.3 and -0.125 (the scale's sign moves into Q), at 5e-3."""
    q = _qkv((n, lq, h * 64), torch.bfloat16, cuda)[0]
    _, k, v = _qkv((n, lk, h * 64), torch.bfloat16, cuda, seed=1)
    before = tvariants.run_variant.launches
    out = tvariants.run_variant(q, k, v, h, scale, mode)
    ref = _k10_plain(q, k, v, h, scale, mode)
    torch.cuda.synchronize()
    assert tvariants.run_variant.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert _rel(out, ref) <= 5e-3, _rel(out, ref)


@pytest.mark.parametrize("n,lq,lk,h", VARIANT_SHAPES)
@pytest.mark.parametrize("scale", [0.125, 0.3, -0.125])
def test_k10_exp2_is_k1_bit_for_bit(cuda, scale, n, lq, lk, h):
    """Mode exp2 runs K1's arithmetic on K1's tile: its output equals K1's
    bit for bit. K1 takes only a positive scale; at a negative one K10 moves
    the sign into Q, which is K1 on -q (negating bf16 is exact)."""
    q = _qkv((n, lq, h * 64), torch.bfloat16, cuda)[0]
    _, k, v = _qkv((n, lk, h * 64), torch.bfloat16, cuda, seed=1)
    out = tvariants.run_variant(q, k, v, h, scale, "exp2")
    ref = tflash.flash_fwd(q if scale > 0 else -q, k, v, h, abs(scale))
    assert torch.equal(out, ref)


@pytest.mark.parametrize("n,lq,lk,h", [(2, 300, 300, 5), (2, 130, 77, 1), (1, 97, 150, 7)])
@pytest.mark.parametrize("mode", K10_MODES)
def test_k10_tensor_core_modes_write_nothing_past_the_output(cuda, mode, n, lq, lk, h):
    """The library entry writes o into the head of a larger buffer whose NaN
    tail stays NaN; the head is the wrapper's output bit for bit, and three
    runs agree bit for bit."""
    q = _qkv((n, lq, h * 64), torch.bfloat16, cuda)[0]
    _, k, v = _qkv((n, lk, h * 64), torch.bfloat16, cuda, seed=1)
    buf = torch.full((q.numel() + 4096,), float("nan"), device=cuda, dtype=torch.bfloat16)
    tkernels.check(tkernels.library().dct_flash_variant(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), buf.data_ptr(),
        tkernels.DTYPE_CODES[torch.bfloat16], tvariants.MODES[mode], n, lq, lk, h, 0.125,
        tkernels.stream_handle(cuda)), "dct_flash_variant")
    first, second = (tvariants.run_variant(q, k, v, h, 0.125, mode) for _ in range(2))
    torch.cuda.synchronize()
    assert bool(buf[q.numel():].isnan().all())
    assert torch.equal(buf[:q.numel()].view_as(q), first) and torch.equal(first, second)


@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "flash_variants_tc_kernel"),
                                          (torch.float32, "flash_variants_kernel<float")])
@pytest.mark.parametrize("mode", K10_MODES)
def test_k10_routes_by_dtype(cuda, mode, dtype, kernel):
    """bf16 runs the tensor-core kernel, fp32 the FMA kernel: the one kernel
    symbol the profiler records for one call."""
    from torch.profiler import ProfilerActivity, profile

    q = _qkv((1, 130, 5 * 64), dtype, cuda)[0]
    _, k, v = _qkv((1, 77, 5 * 64), dtype, cuda, seed=1)
    tvariants.run_variant(q, k, v, 5, 0.125, mode)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tvariants.run_variant(q, k, v, 5, 0.125, mode)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "flash_variants" in e.name]
    assert len(names) == 1 and kernel in names[0], names


@pytest.mark.parametrize("dtype,kernel", [
    (torch.bfloat16, {"K6": "flash_fwd_packed_tc_kernel", "K9": "flash_fwd_pairs_tc_kernel"}),
    (torch.float32, {"K6": "flash_fwd_packed_kernel<float>",
                     "K9": "flash_fwd_pairs_kernel<float>"})])
@pytest.mark.parametrize("which", ["K6", "K9"])
def test_k6_k9_route_by_dtype(cuda, which, dtype, kernel):
    """bf16 runs the tensor-core kernel, fp32 the FMA kernel: the one
    kernel symbol the profiler records for one call."""
    from torch.profiler import ProfilerActivity, profile

    fn = K6_K9[which][0]
    q = _qkv((1, 130, 5 * 64), dtype, cuda)[0]
    _, k, v = _qkv((1, 77, 5 * 64), dtype, cuda, seed=1)
    fn(q, k, v, 5, 0.125)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(q, k, v, 5, 0.125)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "flash_fwd" in e.name]
    assert len(names) == 1 and kernel[which] in names[0], names


def test_flash_attention_packed_routes(cuda):
    """`flash_attention(packed=True)`: K6 without a gradient, the shared op
    (K3, then K4a/K4b) under one, equal to the default path either way."""
    q, k, v = (x.view(2, 300, 5, 64) for x in _qkv((2, 300, 5 * 64), torch.bfloat16, cuda))
    n6, n1 = tflash.flash_fwd_packed.launches, tflash.flash_fwd.launches
    out = tflash.flash_attention(q, k, v, packed=True)
    assert (tflash.flash_fwd_packed.launches, tflash.flash_fwd.launches) == (n6 + 1, n1)
    assert _rel(out, tflash.flash_attention(q, k, v)) <= 5e-3
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    n3 = tflash.flash_fwd_lse.launches
    tflash.flash_attention(*leaves, packed=True).float().sum().backward()
    assert tflash.flash_fwd_lse.launches == n3 + 1
    assert tflash.flash_fwd_packed.launches == n6 + 1
    assert all(x.grad is not None for x in leaves)


def test_flash_variants_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 64, 2 * 32, device=cuda, dtype=torch.bfloat16)
    for fn in (tflash.flash_fwd_packed, flash_attention_pairs,
               lambda *a: tvariants.run_variant(*a, "exp")):
        with pytest.raises(ValueError, match="head dim"):
            fn(q, q, q, 2, 0.125)
    q = torch.zeros(1, 64, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unknown mode"):
        tvariants.run_variant(q, q, q, 1, 0.125, "tanh")


# -- K7 and K8: fused GroupNorm -> SiLU -> 3x3 conv ---------------------------

# (N, H, W, C, Co, tile_h): the JAX tests' shapes and one with Co != C
CONV_SHAPES = [(2, 8, 12, 64, 64, 8), (1, 5, 7, 32, 32, 5), (2, 8, 14, 64, 64, 4),
               (2, 20, 32, 320, 640, 4)]


def _conv_operands(n, h, w, c, co, dtype, device, emb, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    draw = lambda *shape: torch.randn(shape, device=device, generator=g)
    x = draw(n, h, w, c).to(dtype)
    kernel = (draw(3, 3, c, co) * 0.1).to(dtype)
    bias = (draw(co) * 0.1).to(dtype)
    gs, gb = draw(c) * 0.2 + 1, draw(c) * 0.2
    e = draw(n, c).to(dtype) if emb else None
    return x, kernel, bias, gs, gb, e


def _conv_entries(tile_h):
    return {"K7": (tconv.fused_gn_silu_conv, tconv.fused_gn_silu_conv_plain, {}),
            "K8": (tconv_tiled.fused_gn_silu_conv_tiled,
                   tconv_tiled.fused_gn_silu_conv_tiled_plain, {"tile_h": tile_h})}


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("emb", [False, True])
@pytest.mark.parametrize("n,h,w,c,co,tile_h", CONV_SHAPES)
@pytest.mark.parametrize("which", ["K7", "K8"])
def test_fused_conv_kernels_match_plain(cuda, which, n, h, w, c, co, tile_h, emb, dtype, tol):
    fn, plain, kw = _conv_entries(tile_h)[which]
    ops = _conv_operands(n, h, w, c, co, dtype, cuda, emb)
    before = fn.launches
    out = fn(*ops, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert out.dtype == dtype and out.shape == (n, h, w, co)
    assert _rel(out, plain(*ops, **kw)) <= tol


@pytest.mark.parametrize("n,h,w,c,co,tile_h", CONV_SHAPES)
def test_k7_and_k8_agree_in_fp32(cuda, n, h, w, c, co, tile_h):
    ops = _conv_operands(n, h, w, c, co, torch.float32, cuda, True)
    a = tconv.fused_gn_silu_conv(*ops)
    b = tconv_tiled.fused_gn_silu_conv_tiled(*ops, tile_h=tile_h)
    assert _rel(a, b) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c,co,tile_h", CONV_SHAPES[1:3])
def test_fused_conv_kernels_write_nothing_past_the_output(cuda, dtype, n, h, w, c, co, tile_h):
    """Ragged tiles (H, W no multiple of the block's tile): the library
    entries write into the head of a larger buffer whose tail keeps its
    fill."""
    x, kernel, bias, gs, gb, e = _conv_operands(n, h, w, c, co, dtype, cuda, True)
    lib, code = tkernels.library(), tkernels.DTYPE_CODES[dtype]
    numel = n * h * w * co
    ref = tconv.fused_gn_silu_conv_plain(x, kernel, bias, gs, gb, e)
    for which in ("K7", "K8"):
        buf = torch.full((numel + 4096,), 7.0, device=cuda, dtype=dtype)
        e_ptr = e.data_ptr()
        if dtype == torch.bfloat16:   # the wrappers' route: gn_stats, then the wgmma conv
            scale, shift = tconv.gn_stats(x, gs, gb, e, two_pass=which == "K8")
            xin = x
            th, tw = tconv.pick_tile_tc(n, h, w, None if which == "K7" else tile_h)
        elif which == "K8":
            xin, scale, shift = tconv_tiled.gn_prepass(x, gs, gb, e, 32, 1e-5)
            (th, tw), e_ptr = tconv.pick_tile(h, w, tile_h), None
        else:
            scale = shift = None
            th, tw = tconv.pick_tile(h, w)
        sp, bp = (None, None) if scale is None else (scale.data_ptr(), shift.data_ptr())
        if which == "K7":
            rc = lib.dct_fused_gn_silu_conv(
                x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), gs.data_ptr(), gb.data_ptr(),
                e.data_ptr(), buf.data_ptr(), code, n, h, w, c, co, 32, 1e-5, th, tw, sp, bp,
                tkernels.stream_handle(cuda))
        else:
            rc = lib.dct_fused_gn_silu_conv_tiled(
                xin.data_ptr(), sp, bp, kernel.data_ptr(), bias.data_ptr(), buf.data_ptr(), code,
                n, h, w, c, co, th, tw, e_ptr, tkernels.stream_handle(cuda))
        tkernels.check(rc, which)
        torch.cuda.synchronize()
        assert bool((buf[numel:] == 7.0).all()), which
        assert _rel(buf[:numel].view(n, h, w, co), ref) <= 1e-2, which


def test_fused_conv_refuses_what_the_kernels_do_not_take(cuda):
    x, kernel, bias, gs, gb, e = _conv_operands(1, 8, 8, 64, 64, torch.bfloat16, cuda, True)
    with pytest.raises(ValueError, match="tile_h"):
        tconv_tiled.fused_gn_silu_conv_tiled(x, kernel, bias, gs, gb, e, tile_h=3)
    with pytest.raises(ValueError, match="16-byte"):
        tconv.fused_gn_silu_conv(x, kernel[..., :60].contiguous(), bias[:60].contiguous(),
                                 gs, gb, e)
    with pytest.raises(ValueError, match="emb"):
        tconv.fused_gn_silu_conv(x, kernel, bias, gs, gb, e[:, :32].contiguous())
    with pytest.raises(TypeError):
        tconv.fused_gn_silu_conv(x.half(), kernel.half(), bias.half(), gs, gb, None)
    with pytest.raises(ValueError, match="contiguous"):
        tconv.fused_gn_silu_conv(x.transpose(1, 2), kernel, bias, gs, gb, e)
    assert tconv.supported((32, 40, 64, 320), 320) and tconv.supported((16, 576, 1024, 128), 128)
    assert not tconv.supported((1, 8, 8, 48), 64) and not tconv.supported((1, 8, 8, 64), 3)


# -- K7 and K8 in bf16: gn_stats, then the wgmma + TMA conv ---------------------

# (N, H, W, C, Co, tile_h): a 64-channel chunk past C (32, 96), ragged output
# tiles (Co 96, 8), images of 5 x 7, 8 x 14, 10 x 16 (K7's tiles straddle
# samples) and 72 x 128
TC_CONV_SHAPES = [(2, 8, 14, 32, 64, 4), (2, 8, 14, 96, 96, 2), (2, 8, 12, 64, 96, 4),
                  (3, 5, 7, 32, 8, 5), (4, 10, 16, 64, 64, 5), (2, 72, 128, 64, 64, 8)]


@pytest.mark.parametrize("emb", [False, True])
@pytest.mark.parametrize("n,h,w,c,co,tile_h", TC_CONV_SHAPES)
@pytest.mark.parametrize("which", ["K7", "K8"])
def test_fused_conv_tensor_core_route_matches_plain(cuda, which, n, h, w, c, co, tile_h, emb):
    fn, plain, kw = _conv_entries(tile_h)[which]
    ops = _conv_operands(n, h, w, c, co, torch.bfloat16, cuda, emb)
    before = (fn.launches, tconv.gn_stats.launches)
    out = fn(*ops, **kw)
    torch.cuda.synchronize()
    assert (fn.launches, tconv.gn_stats.launches) == (before[0] + 1, before[1] + 1)
    assert out.dtype == torch.bfloat16 and out.shape == (n, h, w, co)
    assert _rel(out, plain(*ops, **kw)) <= 1e-2


@pytest.mark.parametrize("n,h,w,c,co,tile_h", TC_CONV_SHAPES)
@pytest.mark.parametrize("which", ["K7", "K8"])
def test_fused_conv_tensor_core_route_is_deterministic(cuda, which, n, h, w, c, co, tile_h):
    """Statistics in a fixed order of sums and each block owning its output
    tile: three runs agree bit for bit."""
    fn, _, kw = _conv_entries(tile_h)[which]
    ops = _conv_operands(n, h, w, c, co, torch.bfloat16, cuda, True)
    first = fn(*ops, **kw)
    for _ in range(2):
        assert torch.equal(first, fn(*ops, **kw))


@pytest.mark.parametrize("emb", [False, True])
@pytest.mark.parametrize("two_pass", [False, True])
@pytest.mark.parametrize("n,h,w,c", [(32, 40, 64, 320), (3, 5, 7, 32), (2, 10, 16, 1280),
                                     (1, 1, 3, 64)])
def test_gn_stats_kernel_matches_plain(cuda, n, h, w, c, two_pass, emb):
    """Relative L2 <= 1e-5 on scale and bias (fp32 sums in another order)."""
    x, _, _, gs, gb, e = _conv_operands(n, h, w, c, 8, torch.bfloat16, cuda, emb)
    before = tconv.gn_stats.launches
    scale, shift = tconv.gn_stats(x, gs, gb, e, two_pass=two_pass)
    ref = tconv.gn_stats_plain(x, gs, gb, e, two_pass=two_pass)
    torch.cuda.synchronize()
    assert tconv.gn_stats.launches == before + 1
    assert scale.shape == shift.shape == (n, c) and scale.dtype == torch.float32
    assert _rel(scale, ref[0]) <= 1e-5 and _rel(shift, ref[1]) <= 1e-5


@pytest.mark.parametrize("dtype,kernels", [
    (torch.bfloat16, ("gn_stats_kernel", "gn_stats_finish_kernel", "fused_conv_tc_kernel")),
    (torch.float32, ("fused_gn_silu_conv_kernel<float>",))])
def test_k7_routes_by_dtype(cuda, dtype, kernels):
    """bf16 K7 runs the statistics kernels and the wgmma conv, fp32 the first
    kernel: the kernel symbols the profiler records for one call."""
    from torch.profiler import ProfilerActivity, profile

    ops = _conv_operands(2, 8, 12, 64, 64, dtype, cuda, True)
    tconv.fused_gn_silu_conv(*ops)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tconv.fused_gn_silu_conv(*ops)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.name.startswith("void (anonymous namespace)::")]
    assert len(names) == len(kernels), names
    for name, kernel in zip(names, kernels):
        assert kernel in name, names


@pytest.mark.parametrize("dtype,kernels", [
    (torch.bfloat16, ("gn_stats_kernel<__nv_bfloat16, true>", "gn_stats_finish_kernel<true>",
                      "fused_conv_tc_kernel<true>")),
    (torch.float32, ("fused_conv_tiled_kernel<float>",))])
def test_k8_routes_by_dtype(cuda, dtype, kernels):
    from torch.profiler import ProfilerActivity, profile

    ops = _conv_operands(2, 8, 12, 64, 64, dtype, cuda, dtype == torch.bfloat16)
    tconv_tiled.fused_gn_silu_conv_tiled(*ops, tile_h=4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tconv_tiled.fused_gn_silu_conv_tiled(*ops, tile_h=4)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.name.startswith("void (anonymous namespace)::")]
    assert len(names) == len(kernels), names
    for name, kernel in zip(names, kernels):
        assert kernel in name, names


def test_fused_conv_tensor_core_route_refuses_what_it_does_not_take(cuda):
    x, kernel, bias, gs, gb, e = _conv_operands(2, 8, 8, 64, 64, torch.bfloat16, cuda, True)
    # a contiguous view 2 bytes off the 16-byte alignment
    shifted = torch.empty(x.numel() + 8, device=cuda, dtype=x.dtype)[1:1 + x.numel()].view_as(x)
    shifted.copy_(x)
    with pytest.raises(ValueError, match="16-byte"):
        tconv.fused_gn_silu_conv(shifted, kernel, bias, gs, gb, e)
    with pytest.raises(ValueError, match="16-byte"):
        tconv.gn_stats(shifted, gs, gb, e)
    with pytest.raises(TypeError, match="bfloat16"):
        tconv.gn_stats(x.float(), gs, gb, e.float())
    with pytest.raises(ValueError, match="16-byte"):   # Co not a multiple of 8
        tconv_tiled.fused_gn_silu_conv_tiled(x, kernel[..., :60].contiguous(),
                                             bias[:60].contiguous(), gs, gb, e, tile_h=4)
    lib, code = tkernels.library(), tkernels.DTYPE_CODES[torch.bfloat16]
    out = torch.empty(2, 8, 8, 64, device=cuda, dtype=torch.bfloat16)
    scale, shift = tconv.gn_stats(x, gs, gb, e)
    for th, tw, stats in ((16, 16, True), (0, 16, True), (8, 8, False)):   # > 128, empty, none
        rc = lib.dct_fused_gn_silu_conv(
            x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), gs.data_ptr(), gb.data_ptr(),
            e.data_ptr(), out.data_ptr(), code, 2, 8, 8, 64, 64, 32, 1e-5, th, tw,
            scale.data_ptr() if stats else None, shift.data_ptr() if stats else None,
            tkernels.stream_handle(cuda))
        assert rc != 0, (th, tw, stats)
        with pytest.raises(RuntimeError, match="CUDA error"):
            tkernels.check(rc, "refused")


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_checkpoint_none_matches_config_on_the_bf16_unet(cuda):
    """`--checkpoint none` against `config` on the full-width 320x512 UNet,
    bf16 N(0, 0.02) weights, cut to 2 frames, dropout off: the loss is equal
    and the gradients agree within 5e-2 (the recompute runs the same kernels;
    the backward's sums may land in another order)."""
    import dataclasses

    from dynamicrafter_tpu_torch.config import ModelConfig
    from dynamicrafter_tpu_torch.models.unet3d import UNetConfig, UNetModel
    from dynamicrafter_tpu_torch.utils.weights import init_normal_

    cfg = UNetConfig.from_dict(ModelConfig.from_yaml(
        os.path.join(REPO, "configs", "inference_512_v1.0.yaml")).unet)
    assert cfg.use_checkpoint
    with torch.device("meta"):
        unet = UNetModel(cfg)
    unet = keep_norms_fp32(unet.to_empty(device=cuda).to(torch.bfloat16)).eval()
    init_normal_(unet, torch.Generator(device=cuda).manual_seed(0), 0.02)
    params = [p for p in unet.parameters() if p.requires_grad]
    g = torch.Generator(device=cuda).manual_seed(1)
    rand = lambda *s: torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)
    x, target = rand(1, 2, 40, 64, 8), rand(1, 2, 40, 64, 4)
    ctx_t, ctx_i = rand(1, 77, 1024) * 0.1, rand(1, 2, 16, 1024) * 0.1
    ts = torch.full((1,), 500, dtype=torch.long, device=cuda)
    fs = torch.full((1,), 24, dtype=torch.long, device=cuda)

    def loss_and_grad(use_checkpoint):
        unet.config = dataclasses.replace(cfg, use_checkpoint=use_checkpoint)
        before = tflash.flash_fwd_lse.launches
        pred = unet(x, ts, context_text=ctx_t, context_img=ctx_i, fs=fs)
        loss = (pred.float() - target.float()).square().mean()
        grads = torch.autograd.grad(loss, params)
        assert tflash.flash_fwd_lse.launches - before == 5   # (o, lse) kept, no recompute
        return loss.detach(), torch.cat([gr.float().flatten() for gr in grads])

    loss_c, g_c = loss_and_grad(True)
    loss_n, g_n = loss_and_grad(False)
    assert torch.isfinite(loss_c) and torch.equal(loss_c, loss_n)
    assert _rel(g_n, g_c) <= 5e-2 and g_c.norm() > 0


_SMALL_UNET = """\
model:
  params:
    unet_config:
      params:
        model_channels: 64
        channel_mult: [1, 2]
        num_res_blocks: 1
        attention_resolutions: [1]
data:
  params:
    batch_size: 1
    num_workers: 2
lightning:
  trainer:
    accumulate_grad_batches: 1
"""


def test_train_profile_steps_trace_names_the_flash_kernels(cuda, tmp_path):
    """`train --profile_steps 1` on the 320x512 recipe with a small UNet
    (level 0: L = 2560, one head of 64, bf16 autocast) and the process
    loader: the trace of micro-step 10 names K3, K4a, K4b and K2's
    tensor-core kernels."""
    from dynamicrafter_tpu_torch import train

    (tmp_path / "small.yaml").write_text(_SMALL_UNET)
    res = train.main(["--config", os.path.join(REPO, "configs", "training_512_v1.0.yaml"),
                      str(tmp_path / "small.yaml"), "--synthetic_data", "--bf16",
                      "--max_steps", "11", "--profile_steps", "1", "--loader", "processes",
                      "--logdir", str(tmp_path), "--name", "p", "--device", "cuda"])
    with open(res["trace"]) as f:
        trace = f.read()
    for kernel in ("flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel",
                   "small_t_tc_kernel"):
        assert kernel in trace, kernel
    assert len(res["worker_pids"]) == 2 and os.getpid() not in res["worker_pids"]
