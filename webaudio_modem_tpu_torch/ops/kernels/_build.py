"""Build each ``csrc/*.cu`` with nvcc into its own shared library, load
it with ctypes.

The libraries have a plain C interface (no PyTorch headers), so a build
takes seconds.  Each source is compiled for ``sm_90a`` at first use into
``build/kernels/`` beside the package, under a name keyed by a hash of
that source, the ``csrc/`` headers it includes (``seq_front.cuh``, the
front end K1 and K6 share; ``framing_step.cuh``, the step K2 and K8
share) and the flags, and reused while none of them
changes.  ``build`` starts one nvcc per missing library, all at once, and
waits for them.

Floating-point flags: no ``--use_fast_math`` (``atan2f``, ``sqrtf`` and
division stay IEEE) and ``-fmad=false``, so each kernel rounds op for op
like its plain PyTorch version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

_libs: Dict[str, ctypes.CDLL] = {}
# what the last build of each source printed (ptxas register / spill
# report), by kernel name
build_log: Dict[str, str] = {}


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


def names() -> list:
    """The kernel sources, by name (``csrc/<name>.cu``)."""
    return sorted(src.stem for src in CSRC_DIR.glob("*.cu"))


def headers(name: str) -> list:
    """The ``csrc/`` headers that ``csrc/<name>.cu`` includes with
    ``#include "..."``, directly or through another header, sorted."""
    found, todo = set(), [CSRC_DIR / f"{name}.cu"]
    while todo:
        text = todo.pop().read_text()
        for inc in _INCLUDE.findall(text):
            path = CSRC_DIR / inc
            if path not in found and path.exists():
                found.add(path)
                todo.append(path)
    return sorted(found)


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` for the current source,
    the headers it includes and the flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC_DIR / f"{name}.cu", *headers(name)]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libwam_{name}_{h.hexdigest()[:16]}.so"


def build(which: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the libraries of ``which`` (default: every source) that
    are not built yet, one nvcc each, all started together; return
    their paths by name."""
    which = list(names() if which is None else which)
    paths = {name: library_path(name) for name in which}
    missing = [name for name, out in paths.items() if not out.exists()]
    if not missing:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in missing:
        out = paths[name]
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (cmd, tmp, proc) in procs.items():
        build_log[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{build_log[name]}")
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first call."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(str(build([name])[name]))
    return lib


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


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """The device address of ``t``; a null pointer for None (a stream
    the kernel does not store)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def raise_on_error(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error "
                           f"{err} (cudaGetLastError)")
