"""The port's native (C++) host runtime: CRC-16 and the per-channel XModem
deframer of ``modem_native.cpp``, loaded with ctypes.

``get_lib()`` builds the library with g++ at its first call (about a
second) into ``build/native/`` beside the package, under a name keyed by
a hash of the source and the flags, and reuses it while neither changes.
The build goes to a temporary name and is moved into place, so processes
that build at once (test workers) never load a half-written file.  A
failed build or load raises with g++'s output: there is no quiet
fallback; the pure-Python deframer runs only when asked for
(``Deframer(force_python=True)``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "modem_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmodem_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``modem_native.cpp`` unless its library exists; return
    the library's path.  Raises ``RuntimeError`` with the compiler's
    output when g++ is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the port's native runtime is "
                           f"built from {SOURCE} at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.wam_crc16.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.wam_crc16.restype = ctypes.c_uint16
    lib.wam_crc16_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint16)]
    lib.wam_crc16_batch.restype = None
    lib.wam_deframer_new.argtypes = [ctypes.c_int]
    lib.wam_deframer_new.restype = ctypes.c_void_p
    lib.wam_deframer_free.argtypes = [ctypes.c_void_p]
    lib.wam_deframer_push.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t]
    lib.wam_deframer_pending.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.wam_deframer_pending.restype = ctypes.c_size_t
    lib.wam_deframer_reset.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.wam_deframer_poll.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.wam_deframer_poll.restype = ctypes.c_int
    lib.wam_deframer_total_pending.argtypes = [ctypes.c_void_p]
    lib.wam_deframer_total_pending.restype = ctypes.c_size_t
    lib.wam_deframer_drain.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_size_t]
    lib.wam_deframer_drain.restype = ctypes.c_int
    _lib = lib
    return _lib
