"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
The file imports no JAX, so it runs on the GPU machine as it is:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: forward outputs relative L2 <= 1e-5 in fp32 (the kernels
accumulate in fp32, in another order than cuBLAS) and <= 1e-2 in bf16 (the
inputs' own rounding; <= 5e-3 for K6, K9 and K10, which read 2.3e-3: the
output's rounding and that of p before the PV product); lse max abs <= 1e-3; the backward's dq, dk, dv
<= 1e-4 in fp32 and <= 2e-2 in bf16 (ds is rounded to bf16 before its
products, as in the Pallas kernels); weight gradients through a whole
transformer in bf16 <= 2e-2. TF32 is off for the plain versions' fp32
matmuls. K7 and K8 (fused GroupNorm -> SiLU -> 3x3 conv): <= 1e-5 in fp32
and <= 1e-2 in bf16 (each output is rounded once, 2^-9 relative, and bf16
products accumulate on the tensor cores in another order; read 1e-4 to 3e-4),
and K7 against K8 on one fp32 input <= 1e-5.
"""
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
                                     (1, 16, 9216, 5), (16, 16, 1024, 5)])
def test_k2_kernel_matches_plain(cuda, dtype, tol, b, t, g, h):
    """The 320 x 512 shapes, a ragged one, and the largest of the 576 x 1024
    (G = 9216) and 256 x 256 --bs 8 (B = 16) paths."""
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,lq,lk,h", SHAPES)
def test_k4_kernels_match_plain(cuda, dtype, tol, n, lq, lk, h):
    """K4a and K4b from the plain forward's o and lse, against
    `flash_bwd_plain` on the same (fp32) inputs."""
    q, do = _qkv((n, lq, h * 64), dtype, cuda)[:2]
    _, k, v = _qkv((n, lk, h * 64), dtype, cuda, seed=1)
    o, lse = tflash.flash_fwd_lse_plain(q.float(), k.float(), v.float(), h, 0.125)
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
        if which == "K7":
            th, tw = tconv.pick_tile(h, w)
            rc = lib.dct_fused_gn_silu_conv(
                x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), gs.data_ptr(), gb.data_ptr(),
                e.data_ptr(), buf.data_ptr(), code, n, h, w, c, co, 32, 1e-5, th, tw,
                tkernels.stream_handle(cuda))
        else:
            xe, scale, shift = tconv_tiled.gn_prepass(x, gs, gb, e, 32, 1e-5)
            th, tw = tconv.pick_tile(h, w, tile_h)
            rc = lib.dct_fused_gn_silu_conv_tiled(
                xe.data_ptr(), scale.data_ptr(), shift.data_ptr(), kernel.data_ptr(),
                bias.data_ptr(), buf.data_ptr(), code, n, h, w, c, co, th, tw,
                tkernels.stream_handle(cuda))
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
