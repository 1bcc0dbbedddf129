"""The attention kernels of the PyTorch package.

On the CPU: each kernel's plain PyTorch version against the JAX package's
Pallas kernel in interpret mode (and its XLA reference), fp32, at the
tolerance of the JAX package's own kernel tests (atol 2e-5, rtol 1e-4):
K1 and K2, K3 (`_flash_fwd(save_lse=True)`), K4a/K4b (`_flash_bwd`), and
the gradients of the differentiable entries against `jax.grad`; K6
(`flash_attention(packed=True)`) and K9 (`flash_attention_pairs`) against
their Pallas kernels in interpret mode in fp32 and bf16 (bf16 at atol =
rtol = 2e-2, the inputs' rounding) and in fp32 at scales 0.3 and -0.125,
K10's plain version against
`xla_attention` and, for `nosoftmax`, its formula in numpy, and all three
modes at a negative scale against their formula; K2's plain version
against the Pallas kernel in bf16 (p rounded on both sides); the wrappers take the plain path for CPU tensors without building or
launching anything; the routing rule; a missing nvcc is a clear error;
the registers and spill bytes read from a `ptxas -v` report.

The CUDA kernels themselves are tested on the card in test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dynamicrafter_tpu.ops.attention import dot_product_attention, xla_attention  # noqa: E402
from dynamicrafter_tpu.ops.flash_attention import _flash_bwd, _flash_fwd  # noqa: E402
from dynamicrafter_tpu.ops.flash_attention import flash_attention as j_flash  # noqa: E402
from dynamicrafter_tpu.ops.small_attention import (  # noqa: E402
    _small_t_fwd_tmajor as j_small_t_fwd,
)
from dynamicrafter_tpu.ops.small_attention import (  # noqa: E402
    small_t_attention_tmajor as j_small_t,
)
from dynamicrafter_tpu_torch.ops import attention as tattn  # noqa: E402
from dynamicrafter_tpu_torch.ops import flash_attention as tflash  # noqa: E402
from dynamicrafter_tpu_torch.ops import kernels  # noqa: E402
from dynamicrafter_tpu_torch.ops import small_attention as tsmall  # noqa: E402

ATOL, RTOL = 2e-5, 1e-4


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def test_k1_plain_matches_jax_flash_kernel():
    """Ragged L = 200 (not a multiple of any tile)."""
    q, k, v = _qkv((2, 200, 2, 64), 0)
    ref_kernel = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    interpret=True))
    ref_xla = np.asarray(xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    before = tflash.flash_fwd.launches
    out = tflash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    assert tflash.flash_fwd.launches == before    # CPU: plain path, no launch
    np.testing.assert_allclose(out, ref_kernel, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out, ref_xla, atol=ATOL, rtol=RTOL)


def test_k1_plain_cross_lengths():
    """Lq != Lk through the (N, L, H*D) wrapper itself."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, 130, 128)).astype(np.float32)
    k, v = (rng.standard_normal((3, 77, 128)).astype(np.float32) for _ in range(2))
    split = lambda a: jnp.asarray(a.reshape(*a.shape[:2], 2, 64))
    ref = np.asarray(xla_attention(split(q), split(k), split(v))).reshape(3, 130, 128)
    out = tflash.flash_fwd(*(torch.from_numpy(a) for a in (q, k, v)), 2, 0.125).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_k2_plain_matches_jax_small_t_kernel():
    q, k, v = _qkv((2, 16, 40, 2, 32), 2)
    ref = np.asarray(j_small_t(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               interpret=True))
    before = tsmall.small_t_fwd_tmajor.launches
    out = tsmall.small_t_attention_tmajor(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    assert tsmall.small_t_fwd_tmajor.launches == before
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("t", [8, 16, 32])
def test_k2_plain_matches_jax_small_t_kernel_in_bf16(t):
    """bf16: the Pallas `_small_t_fwd_tmajor` in interpret mode and the
    port's plain version both round the normalised p to bf16 before the
    product with v and accumulate it in fp32, the function K2's tensor-core
    kernel computes. G = 7 (padded to the Pallas block inside the JAX
    wrapper), two heads of 64. Tolerance atol = rtol = 2e-2: both outputs
    are rounded to bf16 (2^-8 relative), and the fp32 logits, summed in
    another order, can move a p across a bf16 rounding boundary."""
    rng = np.random.default_rng(30 + t)
    q, k, v = (np.array(jnp.asarray(rng.standard_normal((2, t, 7, 2, 64)).astype(np.float32),
                                    jnp.bfloat16).astype(jnp.float32)) for _ in range(3))
    ref = np.asarray(j_small_t_fwd(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), 0.125,
                                   True).astype(jnp.float32)).reshape(2, t, 7, 128)
    args = [torch.from_numpy(a).to(torch.bfloat16).reshape(2, t, 7, 128) for a in (q, k, v)]
    out = tsmall.small_t_fwd_tmajor(*args, 2, 0.125)
    assert out.dtype == torch.bfloat16 and out.shape == (2, t, 7, 128)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=2e-2, rtol=2e-2)


def test_plain_attention_matches_xla_with_mask_and_broadcast():
    """Causal mask (CLIP text tower) and K/V shared across a leading axis
    (text context over frames)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 3, 9, 2, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 9, 2, 16)).astype(np.float32) for _ in range(2))
    mask = np.tril(np.ones((9, 9), bool))
    ref = np.asarray(dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           mask=jnp.asarray(mask), backend="xla"))
    out = tattn.plain_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_routing_rule(monkeypatch):
    calls = []
    monkeypatch.setattr(tattn, "flash_attention", lambda q, k, v, scale=None:
                        calls.append(("k1", q.shape[-3])) or q)
    monkeypatch.setattr(tattn, "small_t_attention_tmajor", lambda q, k, v, scale=None:
                        calls.append(("k2", q.shape[1])) or q)
    monkeypatch.setattr(tattn, "small_t_attention", lambda q, k, v, scale=None:
                        calls.append(("k5", tuple(q.shape[:-2]))) or q)
    z = lambda *s: torch.zeros(*s)
    tattn.dot_product_attention(z(1, 2048, 1, 64), z(1, 2048, 1, 64), z(1, 2048, 1, 64))
    tattn.dot_product_attention(z(1, 640, 1, 64), z(1, 640, 1, 64), z(1, 640, 1, 64))
    tattn.dot_product_attention(z(1, 2048, 1, 64), z(1, 77, 1, 64), z(1, 77, 1, 64))
    tattn.attention_axis1(z(1, 16, 4, 1, 64), z(1, 16, 4, 1, 64), z(1, 16, 4, 1, 64))
    tattn.attention_axis1(z(1, 40, 4, 1, 64), z(1, 40, 4, 1, 64), z(1, 40, 4, 1, 64))
    with tattn.use_backend("plain"):
        tattn.dot_product_attention(z(1, 2048, 1, 64), z(1, 2048, 1, 64), z(1, 2048, 1, 64))
        tattn.attention_axis1(z(1, 16, 4, 1, 64), z(1, 16, 4, 1, 64), z(1, 16, 4, 1, 64))
    assert calls == [("k1", 2048), ("k2", 16)]
    # K5: unmasked q, k, v of one shape, at most 32 tokens, any number of
    # rows of leading batch (the 256 x 256 middle block at 16 clips of 16
    # frames, and at one clip: one shape takes one path at every batch size)
    del calls[:]
    x = z(16, 16, 16, 2, 8)
    tattn.dot_product_attention(x, x, x)
    tattn.dot_product_attention(z(256, 5, 2, 8), z(256, 5, 2, 8), z(256, 5, 2, 8))
    y = z(255, 16, 2, 8)
    tattn.dot_product_attention(y, y, y)                                     # 255 rows
    y = z(2, 16, 16, 2, 8)
    tattn.dot_product_attention(y, y, y)                                     # --bs 1
    assert calls == [("k5", (16, 16, 16)), ("k5", (256, 5)), ("k5", (255, 16)),
                     ("k5", (2, 16, 16))]
    del calls[:]
    tattn.dot_product_attention(x, x, x, mask=torch.ones(16, 16, dtype=torch.bool))
    tattn.dot_product_attention(x, z(16, 16, 4, 2, 8), z(16, 16, 4, 2, 8))   # cross lengths
    tattn.dot_product_attention(x, z(16, 16, 2, 8), z(16, 16, 2, 8))         # shared K/V
    y = z(16, 16, 16, 2, 6)
    tattn.dot_product_attention(y, y, y)                     # 24-byte head rows
    y = z(16, 16, 33, 2, 8)
    tattn.dot_product_attention(y, y, y)                                     # 33 tokens
    y = z(256, 2, 8)
    tattn.dot_product_attention(y, y, y)                                     # 3 dims
    with tattn.use_backend("plain"):
        tattn.dot_product_attention(x, x, x)
    tattn.dot_product_attention(x, x, x, backend="plain")
    assert calls == []


def test_missing_nvcc_is_a_clear_error(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernels.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels._nvcc()


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor neither on the CPU nor on CUDA raises."""
    m = torch.empty(1, 64, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tflash.flash_fwd(m, m, m, 1, 0.125)
    with pytest.raises(ValueError, match="unsupported device"):
        tflash.flash_fwd_lse(m, m, m, 1, 0.125)
    lse = torch.empty(1, 1, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tflash.flash_bwd_dq(m, m, m, m, lse, m, 1, 0.125)
    with pytest.raises(ValueError, match="unsupported device"):
        tflash.flash_bwd_dkv(m, m, m, m, lse, m, 1, 0.125)
    with pytest.raises(ValueError, match="unsupported device"):
        tflash.flash_bwd_di(m, m, 1)
    m5 = torch.empty(1, 16, 4, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsmall.small_t_fwd_tmajor(m5, m5, m5, 1, 0.125)
    with pytest.raises(ValueError, match="unsupported device"):
        tsmall.small_t_fwd(m, m, m, 1, 0.125)


def _head_major(x, heads):
    """(N, L, H*D) numpy -> (N, H, L, D) jnp."""
    n, l, hd = x.shape
    return jnp.asarray(x.reshape(n, l, heads, hd // heads).transpose(0, 2, 1, 3))


def _nlhd(x):
    """(N, H, L, D) -> (N, L, H*D) numpy."""
    n, h, l, d = x.shape
    return np.asarray(x).transpose(0, 2, 1, 3).reshape(n, l, h * d)


LENGTHS = [(200, 200), (300, 300), (130, 77)]


def _k34_inputs(lq, lk, heads=2, n=2, seed=4):
    rng = np.random.default_rng(seed + lq + lk)
    q, do = (rng.standard_normal((n, lq, heads * 64)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((n, lk, heads * 64)).astype(np.float32) for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("lq,lk", LENGTHS)
def test_k3_plain_matches_jax_fwd_with_lse(lq, lk):
    """Ragged L = 200 and 300 (not a multiple of the 128 blocks) and Lq != Lk."""
    q, k, v, _ = _k34_inputs(lq, lk)
    o_ref, lse_ref = _flash_fwd(*(_head_major(x, 2) for x in (q, k, v)), 0.125, 128, 128,
                                True, save_lse=True)
    before = tflash.flash_fwd_lse.launches
    o, lse = tflash.flash_fwd_lse(*(torch.from_numpy(x) for x in (q, k, v)), 2, 0.125)
    assert tflash.flash_fwd_lse.launches == before
    np.testing.assert_allclose(o.numpy(), _nlhd(o_ref), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[:, :, :lq, 0],
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n,lq,lk,h", [(1, 1, 1, 1), (2, 17, 77, 2), (2, 65, 64, 1)])
@pytest.mark.parametrize("which", ["K1", "K3"])
def test_k1_k3_plain_match_jax_kernels_in_bf16(which, n, lq, lk, h):
    """bf16, where the card runs K1/K3 on the tensor cores with p rounded to
    bf16 before the PV product: the plain versions that kernel is held
    against round p as the Pallas kernels do (`p.astype(v.dtype)`). Ragged
    for the card kernel's 128-row query and 64-row key tiles. Tolerance: the
    inputs' rounding (atol = rtol = 2e-2, as for K6 and K9); the plain
    version rounds the logits to bf16 (`xla_attention`'s math), the Pallas
    kernel keeps them in fp32, which lse shows at up to ~1e-2."""
    q, k, v = _variant_inputs(n, lq, lk, h, "bfloat16", 30 + lq)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (_head_major(a, h).astype(jnp.bfloat16) for a in (q, k, v))
    if which == "K1":
        out = tflash.flash_fwd(tq, tk, tv, h, 0.125)
        ref = j_flash(*(_heads_split(a, h, "bfloat16") for a in (q, k, v)), interpret=True)
        ref = np.asarray(ref.astype(jnp.float32)).reshape(n, lq, h * 64)
    else:
        out, lse = tflash.flash_fwd_lse(tq, tk, tv, h, 0.125)
        o_ref, lse_ref = _flash_fwd(jq, jk, jv, 0.125, 128, 128, True, save_lse=True)
        ref = _nlhd(o_ref.astype(jnp.float32))
        np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[:, :, :lq, 0],
                                   **VARIANT_TOL["bfloat16"])
    assert out.dtype == torch.bfloat16 and out.shape == (n, lq, h * 64)
    np.testing.assert_allclose(out.float().numpy(), ref, **VARIANT_TOL["bfloat16"])


def test_profile_families_name_the_flash_forward_kernels():
    from dynamicrafter_tpu_torch.profile_unet import family

    for name in ("void (anonymous namespace)::flash_fwd_tc_kernel<false>(__nv_bfloat16 const*)",
                 "void (anonymous namespace)::flash_fwd_tc_kernel<true>(__nv_bfloat16 const*)",
                 "void (anonymous namespace)::flash_fwd_fma_kernel<false>(float const*)"):
        assert family(name) == "K1 flash_fwd"
    assert family("void (anonymous namespace)::small_t_kernel<__nv_bfloat16>()") == \
        "K2 small_t_kernel"
    # K2's tensor-core route: its key `small_t_kernel` does not match it
    assert family("void (anonymous namespace)::small_t_tc_kernel<1>(__nv_bfloat16 const*)") == \
        "K2 small_t_kernel"
    # K10 computes K1's function through K1's loop: its own family, not K1's
    for name in ("flash_variants_tc_kernel<0>(__nv_bfloat16 const*)",
                 "flash_variants_tc_kernel<2>(__nv_bfloat16 const*)",
                 "flash_variants_kernel<float, 1>(float const*)"):
        assert family("void (anonymous namespace)::" + name) == "K10 run_variant"
    # the backward's kernels, both routes, and the bf16 route's pre-pass
    # K6 and K9 compute K1's function: their own families, not K1's
    for name, fam in (("flash_fwd_packed_tc_kernel(__nv_bfloat16 const*)",
                       "K6 flash_fwd_packed"),
                      ("flash_fwd_packed_kernel<float>(float const*)", "K6 flash_fwd_packed"),
                      ("flash_fwd_pairs_tc_kernel(__nv_bfloat16 const*)",
                       "K9 flash_attention_pairs"),
                      ("flash_fwd_pairs_kernel<float>(float const*)",
                       "K9 flash_attention_pairs")):
        assert family("void (anonymous namespace)::" + name) == fam
    for name, fam in (("flash_bwd_dq_tc_kernel(__nv_bfloat16 const*)", "K4a flash_bwd_dq"),
                      ("flash_bwd_dq_kernel<float>(float const*)", "K4a flash_bwd_dq"),
                      ("flash_bwd_dkv_tc_kernel(__nv_bfloat16 const*)", "K4b flash_bwd_dkv"),
                      ("flash_bwd_dkv_kernel<float>(float const*)", "K4b flash_bwd_dkv"),
                      ("flash_bwd_di_kernel<__nv_bfloat16>(__nv_bfloat16 const*)",
                       "K4 di pre-pass")):
        assert family("void (anonymous namespace)::" + name) == fam


def test_profile_families_tell_k5_from_k2():
    """K5's tensor-core kernel runs K2's warp loop under a name of its own, so
    that a profile counts it as K5 and not as K2."""
    from dynamicrafter_tpu_torch.profile_unet import family

    for name in ("small_t_posmajor_tc_kernel<1>(__nv_bfloat16 const*)",
                 "small_t_posmajor_tc_kernel<2>(__nv_bfloat16 const*)",
                 "small_t_posmajor_kernel<float>(float const*)",
                 "small_t_posmajor_kernel<__nv_bfloat16>(__nv_bfloat16 const*)"):
        assert family("void (anonymous namespace)::" + name) == "K5 small_t_fwd"
    for name in ("small_t_tc_kernel<1>(__nv_bfloat16 const*)",
                 "small_t_tc_kernel<2>(__nv_bfloat16 const*)",
                 "small_t_kernel<float>(float const*)"):
        assert family("void (anonymous namespace)::" + name) == "K2 small_t_kernel"


@pytest.mark.parametrize("lq,lk", LENGTHS)
def test_k4_plain_matches_jax_bwd(lq, lk):
    """dq, dk, dv from the same o and lse (JAX's), ragged and Lq != Lk."""
    q, k, v, do = _k34_inputs(lq, lk)
    jq, jk, jv, jdo = (_head_major(x, 2) for x in (q, k, v, do))
    o, lse = _flash_fwd(jq, jk, jv, 0.125, 128, 128, True, save_lse=True)
    refs = _flash_bwd(jq, jk, jv, o, lse, jdo, 0.125, 128, 128, True)
    before = (tflash.flash_bwd_dq.launches, tflash.flash_bwd_dkv.launches)
    got = tflash.flash_bwd(*(torch.from_numpy(x) for x in (q, k, v)),
                           torch.from_numpy(_nlhd(o)),
                           torch.from_numpy(np.ascontiguousarray(np.asarray(lse)[:, :, :lq, 0])),
                           torch.from_numpy(do), 2, 0.125)
    assert (tflash.flash_bwd_dq.launches, tflash.flash_bwd_dkv.launches) == before
    for g, ref in zip(got, refs):
        np.testing.assert_allclose(g.numpy(), _nlhd(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_wrappers_split_the_plain_backward_on_the_cpu(dtype):
    """On CPU tensors K4a's and K4b's wrappers return exactly
    `flash_bwd_plain`'s dq and (dk, dv), the pre-pass's wrapper its di
    (rowsum(dO * o) per head, (N, H, Lq) fp32), and nothing is launched."""
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in _k34_inputs(130, 77))
    o, lse = tflash.flash_fwd_lse(q, k, v, 2, 0.125)
    args = (q, k, v, o, lse, do, 2, 0.125)
    before = (tflash.flash_bwd_dq.launches, tflash.flash_bwd_dkv.launches,
              tflash.flash_bwd_di.launches)
    dq, dk, dv = tflash.flash_bwd_plain(*args)
    assert torch.equal(tflash.flash_bwd_dq(*args), dq)
    got_dk, got_dv = tflash.flash_bwd_dkv(*args)
    assert torch.equal(got_dk, dk) and torch.equal(got_dv, dv)
    assert all(torch.equal(a, b) for a, b in zip(tflash.flash_bwd(*args), (dq, dk, dv)))
    di = tflash.flash_bwd_di(o, do, 2)
    assert di.dtype == torch.float32 and di.shape == lse.shape
    ref = (do.float().view(2, 130, 2, 64) * o.float().view(2, 130, 2, 64)).sum(-1)
    torch.testing.assert_close(di, ref.transpose(1, 2), rtol=1e-6, atol=1e-6)
    assert (tflash.flash_bwd_dq.launches, tflash.flash_bwd_dkv.launches,
            tflash.flash_bwd_di.launches) == before


def _grads_match(t_fn, j_fn, shape, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    _, vjp = jax.vjp(j_fn, *(jnp.asarray(x) for x in (q, k, v)))
    refs = vjp(jnp.asarray(g))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(t_fn(*xs), xs, torch.from_numpy(g))
    for a, ref in zip(got, refs):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def test_flash_attention_grads_match_jax():
    """The differentiable entry (K3 forward, K4a/K4b backward; their plain
    versions on the CPU) against jax.vjp of the JAX entry, ragged L = 200."""
    _grads_match(tflash.flash_attention, lambda q, k, v: j_flash(q, k, v, interpret=True),
                 (2, 200, 2, 64), 5)


def test_small_t_attention_grads_match_jax():
    """K2's autograd Function: backward through the plain version, as the
    JAX package's `_vjp_bwd_tmajor`."""
    _grads_match(tsmall.small_t_attention_tmajor,
                 lambda q, k, v: j_small_t(q, k, v, interpret=True), (2, 16, 12, 2, 32), 6)


def test_wrappers_without_grad_take_the_inference_path(monkeypatch):
    """No input needs a gradient: K1, K2 and K5 as before, not the autograd
    entries (so the sampler's launch counts stay 5 and 34 per UNet call)."""
    calls = []
    monkeypatch.setattr(tflash, "flash_fwd", lambda *a: calls.append("k1") or a[0])
    monkeypatch.setattr(tflash, "flash_fwd_lse", lambda *a: calls.append("k3"))
    monkeypatch.setattr(tsmall, "small_t_fwd_tmajor", lambda *a: calls.append("k2") or a[0])
    x = torch.zeros(1, 64, 1, 64)
    tflash.flash_attention(x, x, x)
    monkeypatch.setattr(tsmall, "small_t_fwd", lambda *a: calls.append("k5") or a[0])
    monkeypatch.setattr(tsmall.SmallTAttention, "apply",
                        lambda *a: calls.append("autograd") or a[0])
    x5 = torch.zeros(1, 4, 3, 1, 64)
    tsmall.small_t_attention_tmajor(x5, x5, x5)
    tsmall.small_t_attention(x5, x5, x5)
    with torch.no_grad():
        tflash.flash_attention(x.requires_grad_(), x, x)
        tsmall.small_t_attention(x5.requires_grad_(), x5, x5)
    assert calls == ["k1", "k2", "k5", "k1", "k5"]
    tsmall.small_t_attention(x5, x5, x5)
    assert calls[-1] == "autograd"


# ---------------------------------------------------------------------------
# K6 (packed rows), K9 (head pairs), K10 (all heads in a block, three modes)
# ---------------------------------------------------------------------------

# (N, Lq, Lk, H): H = 5 and H = 1 (odd: the last pair has one head), ragged L,
# Lq != Lk, an even H
VARIANT_CASES = [(2, 200, 200, 5), (1, 130, 77, 1), (2, 96, 160, 2), (1, 300, 300, 5)]
# fp32: the JAX kernel tests' tolerance; bf16: the inputs' own rounding
VARIANT_TOL = {"float32": dict(atol=2e-5, rtol=1e-4), "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _variant_inputs(n, lq, lk, h, dtype, seed):
    """q (N, Lq, H*64) and k, v (N, Lk, H*64) in `dtype`, as numpy float32
    arrays holding values `dtype` represents exactly."""
    rng = np.random.default_rng(seed)
    draw = lambda l: np.array(jnp.asarray(
        rng.standard_normal((n, l, h * 64)).astype(np.float32), dtype).astype(jnp.float32))
    return draw(lq), draw(lk), draw(lk)


def _heads_split(a, h, dtype):
    return jnp.asarray(a.reshape(*a.shape[:2], h, 64), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,lq,lk,h", VARIANT_CASES)
def test_k6_plain_matches_jax_packed_kernel(n, lq, lk, h, dtype):
    """`flash_attention(packed=True)` on the CPU (the plain version) against
    the JAX package's packed Pallas kernel in interpret mode."""
    q, k, v = _variant_inputs(n, lq, lk, h, dtype, 20)
    ref = np.asarray(j_flash(*(_heads_split(a, h, dtype) for a in (q, k, v)),
                             interpret=True, packed=True).astype(jnp.float32))
    tdtype = getattr(torch, dtype)
    before = tflash.flash_fwd_packed.launches
    out = tflash.flash_attention(
        *(torch.from_numpy(a).to(tdtype).unflatten(-1, (h, 64)) for a in (q, k, v)),
        packed=True)
    assert tflash.flash_fwd_packed.launches == before   # CPU: plain path, no launch
    assert out.dtype == tdtype and out.shape == (n, lq, h, 64)
    np.testing.assert_allclose(out.float().numpy(), ref, **VARIANT_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,lq,lk,h", VARIANT_CASES)
def test_k9_plain_matches_jax_pairs_kernel(n, lq, lk, h, dtype):
    """`flash_attention_pairs` on the CPU against the JAX repository's
    pair-packed Pallas kernel in interpret mode (tiles of 128)."""
    from experiments.flash_pairs.flash_pairs import flash_attention_pairs as j_pairs

    from dynamicrafter_tpu_torch.experiments.flash_pairs.flash_pairs import (
        flash_attention_pairs)

    q, k, v = _variant_inputs(n, lq, lk, h, dtype, 21)
    ref = np.asarray(j_pairs(*(jnp.asarray(a, dtype) for a in (q, k, v)), h, 0.125, 128, 128,
                             interpret=True).astype(jnp.float32))
    tdtype = getattr(torch, dtype)
    before = flash_attention_pairs.launches
    out = flash_attention_pairs(*(torch.from_numpy(a).to(tdtype) for a in (q, k, v)), h, 0.125)
    assert flash_attention_pairs.launches == before
    assert out.dtype == tdtype and out.shape == q.shape
    np.testing.assert_allclose(out.float().numpy(), ref, **VARIANT_TOL[dtype])


@pytest.mark.parametrize("n,lq,lk,h", [(1, 130, 77, 3), (2, 96, 160, 2)])
@pytest.mark.parametrize("scale", [0.3, -0.125])
@pytest.mark.parametrize("which", ["K6", "K9"])
def test_k6_k9_plain_match_jax_at_any_scale(which, scale, n, lq, lk, h):
    """The Pallas K6 and K9 scale the logits before their running max, so
    any finite scale is theirs to take, a negative one included: the plain
    versions behind `flash_attention(packed=True)` and
    `flash_attention_pairs` agree with them in fp32 at 0.3 and -0.125 (odd
    and even H, ragged Lq != Lk), the contract the CUDA kernels keep."""
    from experiments.flash_pairs.flash_pairs import flash_attention_pairs as j_pairs

    from dynamicrafter_tpu_torch.experiments.flash_pairs.flash_pairs import (
        flash_attention_pairs)

    dtype = "float32"
    q, k, v = _variant_inputs(n, lq, lk, h, dtype, 23)
    tdtype = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(tdtype) for a in (q, k, v)]
    if which == "K6":
        ref = j_flash(*(_heads_split(a, h, dtype) for a in (q, k, v)), scale=scale,
                      interpret=True, packed=True).reshape(q.shape)
        out = tflash.flash_attention(*(a.unflatten(-1, (h, 64)) for a in args), scale=scale,
                                     packed=True).flatten(-2)
    else:
        ref = j_pairs(*(jnp.asarray(a, dtype) for a in (q, k, v)), h, scale, 128, 128,
                      interpret=True)
        out = flash_attention_pairs(*args, h, scale)
    assert out.dtype == tdtype and out.shape == q.shape
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               **VARIANT_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["exp", "exp2", "nosoftmax"])
@pytest.mark.parametrize("n,lq,lk,h", [(2, 128, 128, 5), (1, 128, 256, 2)])
def test_k10_plain_matches_reference(n, lq, lk, h, mode, dtype):
    """`run_variant` on the CPU (`run_variant_plain`). The JAX bench script
    that holds the Pallas kernel runs its benchmark when imported and its
    `pallas_call` has no interpret switch, so the kernel itself cannot run
    here: `exp` and `exp2` are held against `xla_attention` (they are
    attention), and `nosoftmax` against its formula, o = clip(q k^T * scale,
    -1, 1) v per head with p rounded to the input dtype and fp32 sums,
    written in numpy, at lengths that the kernel's tiles divide (where the
    JAX body's padding mask plays no part)."""
    from dynamicrafter_tpu_torch.experiments.flash_pairs.bench_flash_variants import (
        run_variant, run_variant_plain)

    q, k, v = _variant_inputs(n, lq, lk, h, dtype, 22)
    q, k = q * 0.5, k * 0.5      # exact in bf16; logits on both sides of the clip
    if mode == "nosoftmax":
        split = lambda a: a.reshape(*a.shape[:2], h, 64).transpose(0, 2, 1, 3)
        s = np.einsum("nhqd,nhkd->nhqk", split(q), split(k)) * np.float32(0.125)
        p = np.asarray(jnp.asarray(np.clip(s, -1.0, 1.0), dtype).astype(jnp.float32))
        assert (np.abs(s) > 1).any() and (np.abs(s) < 1).any()
        ref = np.einsum("nhqk,nhkd->nhqd", p, split(v)).transpose(0, 2, 1, 3).reshape(q.shape)
        ref = np.asarray(jnp.asarray(ref, dtype).astype(jnp.float32))
    else:
        ref = np.asarray(xla_attention(*(_heads_split(a, h, dtype) for a in (q, k, v)))
                         .astype(jnp.float32)).reshape(q.shape)
    tdtype = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(tdtype) for a in (q, k, v)]
    before = run_variant.launches
    out = run_variant(*args, h, 0.125, mode)
    assert run_variant.launches == before
    assert out.dtype == tdtype
    assert torch.equal(out, run_variant_plain(*args, h, 0.125, mode))
    np.testing.assert_allclose(out.float().numpy(), ref, **VARIANT_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["exp", "exp2", "nosoftmax"])
def test_k10_plain_modes_at_a_negative_scale(mode, dtype):
    """`run_variant_plain` at scale -0.125 against its formula in numpy:
    softmax(q k^T * scale) v per head for `exp` and `exp2` (the scale's sign
    enters before the max, as the Pallas body scales before its max), and
    clip(q k^T * scale, -1, 1) v for `nosoftmax`; p rounded to the input
    dtype, fp32 sums. Ragged Lq != Lk, odd H. The tensor-core kernels move
    a negative scale's sign into Q: this is the function they keep."""
    from dynamicrafter_tpu_torch.experiments.flash_pairs.bench_flash_variants import (
        run_variant_plain)

    n, lq, lk, h, scale = 1, 130, 77, 3, -0.125
    q, k, v = _variant_inputs(n, lq, lk, h, dtype, 24)
    q, k = q * 0.5, k * 0.5      # exact in bf16; logits on both sides of the clip
    split = lambda a: a.reshape(*a.shape[:2], h, 64).transpose(0, 2, 1, 3)
    s = np.einsum("nhqd,nhkd->nhqk", split(q), split(k)) * np.float32(scale)
    if mode == "nosoftmax":
        assert (np.abs(s) > 1).any() and (np.abs(s) < 1).any()
        p = np.clip(s, -1.0, 1.0)
    else:
        e = np.exp(s - s.max(-1, keepdims=True))
        p = e / e.sum(-1, keepdims=True)
    p = np.asarray(jnp.asarray(p, dtype).astype(jnp.float32))
    ref = np.einsum("nhqk,nhkd->nhqd", p, split(v)).transpose(0, 2, 1, 3).reshape(q.shape)
    ref = np.asarray(jnp.asarray(ref, dtype).astype(jnp.float32))
    tdtype = getattr(torch, dtype)
    out = run_variant_plain(*(torch.from_numpy(a).to(tdtype) for a in (q, k, v)), h, scale,
                            mode)
    assert out.dtype == tdtype and out.shape == q.shape
    np.testing.assert_allclose(out.float().numpy(), ref, **VARIANT_TOL[dtype])


def test_variant_wrappers_refuse_other_devices_and_modes():
    from dynamicrafter_tpu_torch.experiments.flash_pairs import bench_flash_pairs
    from dynamicrafter_tpu_torch.experiments.flash_pairs import bench_flash_variants as bv
    from dynamicrafter_tpu_torch.experiments.flash_pairs.flash_pairs import (
        flash_attention_pairs)

    q = torch.zeros(1, 8, 64, device="meta")
    for fn in (tflash.flash_fwd_packed, flash_attention_pairs,
               lambda *a: bv.run_variant(*a, "exp")):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(q, q, q, 1, 0.125)
    q = torch.zeros(1, 8, 64)
    with pytest.raises(ValueError, match="unknown mode"):
        bv.run_variant(q, q, q, 1, 0.125, "tanh")
    with pytest.raises(ValueError, match="unknown mode"):
        bv.run_variant_plain(q, q, q, 1, 0.125, "tanh")
    # the benches time CUDA kernels: no CPU run, and no silent one without a card
    for main in (bv.main, bench_flash_pairs.main):
        with pytest.raises(ValueError, match="times CUDA kernels"):
            main(["--device", "cpu"])
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                main([])


PTXAS_ENTRY = """ptxas info    : Compiling entry function '{name}' for 'sm_90a'
ptxas info    : Function properties for {name}
    {spill} bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads
ptxas info    : Used {regs} registers, used 1 barriers, 384 bytes cmem[0]
"""


@pytest.mark.parametrize("regs,spill", [(255, 0), (168, 48)])
def test_ptxas_report_reads_registers_and_spills(regs, spill):
    """`kernels.ptxas_report`, which holds the tensor-core kernels to 0
    spill on the card, reads each entry function's registers and spill-store
    bytes from nvcc's `-Xptxas -v` output."""
    log = (PTXAS_ENTRY.format(name="flash_fwd_pairs_tc_kernel", regs=regs, spill=spill)
           + PTXAS_ENTRY.format(name="small_t_kernel", regs=40, spill=0))
    assert kernels.ptxas_report(log) == {
        "flash_fwd_pairs_tc_kernel": {"regs": regs, "spill": spill},
        "small_t_kernel": {"regs": 40, "spill": 0}}
