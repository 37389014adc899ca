"""Build ``csrc/*.cu`` with nvcc into one shared library, load it with ctypes.

The library has a plain C interface (no PyTorch headers), so a build
takes seconds.  It is compiled for ``sm_90a`` at first use into
``build/kernels/`` beside the package, under a name keyed by a hash of
the sources and flags, and reused while neither changes.

Floating-point flags: no ``--use_fast_math`` (``atan2f``, ``sqrtf`` and
division stay IEEE) and ``-fmad=false``, so each kernel rounds op for op
like its plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
# what the last build printed (ptxas register / spill report)
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the port's CUDA kernels "
            "are built from csrc/ at first use")
    return str(path)


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libwam_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built already; return its path."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources()]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{build_log}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib


def check_cuda(device: torch.device) -> None:
    """Raise unless ``device`` is a CUDA device PyTorch can use."""
    if device.type != "cuda":
        raise ValueError(
            f"kernels take CPU tensors (plain version) or CUDA tensors, "
            f"got {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"tensor on {device} but torch.cuda.is_available() is False: "
            "the kernel cannot launch, and there is no fallback")


def use_kernel(*tensors: torch.Tensor) -> bool:
    """False when every tensor lies on the CPU (the caller runs its plain
    version); True when all lie on one usable CUDA device.  Raises on
    anything else — a CUDA tensor never falls back to the plain path."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")
    (device,) = devices
    if device.type == "cpu":
        return False
    check_cuda(device)
    return True


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    """Validate one kernel operand: dtype, shape (None = any), contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(shape) != t.dim() or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def raise_on_error(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error "
                           f"{err} (cudaGetLastError)")
