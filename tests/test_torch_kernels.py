"""The two attention kernels of the PyTorch package.

On the CPU: each kernel's plain PyTorch version against the JAX package's
Pallas kernel in interpret mode (and its XLA reference), fp32, at the
tolerance of the JAX package's own kernel tests (atol 2e-5, rtol 1e-4);
the wrappers take the plain path for CPU tensors without building or
launching anything; the routing rule; a missing nvcc is a clear error.

The CUDA kernels themselves are tested on the card in test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dynamicrafter_tpu.ops.attention import dot_product_attention, xla_attention  # noqa: E402
from dynamicrafter_tpu.ops.flash_attention import flash_attention as j_flash  # noqa: E402
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
    m5 = torch.empty(1, 16, 4, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsmall.small_t_fwd_tmajor(m5, m5, m5, 1, 0.125)
