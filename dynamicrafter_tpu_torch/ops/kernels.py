"""Build and bind the hand-written CUDA kernels in `csrc/`.

The sources are compiled at first use with nvcc, one nvcc process per
source, all started together, and linked into one shared library with a
plain C interface, loaded with ctypes. The library lands in
`build/kernels/` at the repository root, named by a hash of the sources
and flags, so an edited source is rebuilt and an unchanged one reused.
Nothing here runs at import time: the CPU tests import every module on a
machine without nvcc.

Each C entry point launches on the stream it is given and returns
cudaGetLastError(); `check` turns a nonzero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build
build_log: str = ""                     # nvcc/ptxas output (registers, spills)


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def build() -> Path:
    """Compile csrc/*.cu into one shared library (cached by content)."""
    global build_seconds, build_log
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    tag = digest.hexdigest()[:16]
    out = BUILD_DIR / f"libdct_kernels_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{src.stem}_{tag}.{os.getpid()}.o" for src in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources, objs)]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    run = lambda cmd: subprocess.run(cmd, capture_output=True, text=True)
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(len(cmds)) as pool:
            procs = list(pool.map(run, cmds))
        build_log = "".join(p.stdout + p.stderr for p in procs)
        for cmd, proc in zip(cmds, procs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        proc = run(link)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.dct_flash_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                      i32, f32, ptr]
        lib.dct_flash_fwd.restype = i32
        lib.dct_flash_fwd_lse.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                          i32, i32, f32, ptr]
        lib.dct_flash_fwd_lse.restype = i32
        lib.dct_flash_bwd_dq.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32,
                                         i32, i32, i32, i32, f32, ptr]
        lib.dct_flash_bwd_dq.restype = i32
        lib.dct_flash_bwd_dkv.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                          i32, i32, i32, i32, i32, f32, ptr]
        lib.dct_flash_bwd_dkv.restype = i32
        for name in ("dct_flash_fwd_packed", "dct_flash_fwd_pairs"):
            getattr(lib, name).argtypes = lib.dct_flash_fwd.argtypes
            getattr(lib, name).restype = i32
        lib.dct_flash_variant.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                                          i32, f32, ptr]
        lib.dct_flash_variant.restype = i32
        lib.dct_small_t_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                        i32, i32, f32, ptr]
        lib.dct_small_t_fwd.restype = i32
        lib.dct_small_t_fwd_posmajor.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                                 i32, i32, f32, ptr]
        lib.dct_small_t_fwd_posmajor.restype = i32
        lib.dct_fused_gn_silu_conv.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32,
                                               i32, i32, i32, i32, i32, i32, f32, i32,
                                               i32, ptr]
        lib.dct_fused_gn_silu_conv.restype = i32
        lib.dct_fused_gn_silu_conv_tiled.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32,
                                                     i32, i32, i32, i32, i32, i32, i32,
                                                     ptr]
        lib.dct_fused_gn_silu_conv_tiled.restype = i32
        lib.dct_error_string.argtypes = [i32]
        lib.dct_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    if code != 0:
        msg = library().dct_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def check_operands(name: str, *tensors: torch.Tensor) -> None:
    """What every kernel wrapper requires of its CUDA operands."""
    t0 = tensors[0]
    if t0.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t0.dtype} not supported "
                        "(bfloat16 or float32)")
    for t in tensors:
        if t.device != t0.device or t.dtype != t0.dtype:
            raise ValueError(f"{name}: operands differ in device or dtype")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
