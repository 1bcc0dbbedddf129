"""The PyTorch port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
The file imports no JAX, so it runs on the GPU machine as it is:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: relative L2 <= 1e-5 in fp32 (the kernels accumulate in fp32,
in another order than cuBLAS) and <= 1e-2 in bf16 (the inputs' own
rounding). TF32 is off for the plain versions' fp32 matmuls.
"""
import pytest

torch = pytest.importorskip("torch")

from dynamicrafter_tpu_torch.ops import flash_attention as tflash  # noqa: E402
from dynamicrafter_tpu_torch.ops import small_attention as tsmall  # noqa: E402

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
@pytest.mark.parametrize("b,t,g,h", [(2, 16, 2560, 5), (2, 16, 40, 20), (1, 5, 37, 2)])
def test_k2_kernel_matches_plain(cuda, dtype, tol, b, t, g, h):
    q, k, v = _qkv((b, t, g, h * 64), dtype, cuda)
    before = tsmall.small_t_fwd_tmajor.launches
    out = tsmall.small_t_fwd_tmajor(q, k, v, h, 0.125)
    ref = tsmall.small_t_fwd_tmajor_plain(q.float(), k.float(), v.float(), h, 0.125)
    torch.cuda.synchronize()
    assert tsmall.small_t_fwd_tmajor.launches == before + 1
    assert _rel(out, ref) <= tol


def test_k1_refuses_other_head_dims(cuda):
    q = torch.zeros(1, 64, 2 * 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_fwd(q, q, q, 2, 0.125)


def test_k2_refuses_long_t(cuda):
    q = torch.zeros(1, 33, 4, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="T=33"):
        tsmall.small_t_fwd_tmajor(q, q, q, 1, 0.125)
