"""CRC-16-CCITT-FALSE over rows of decoded bits (``csrc/crc16.cu``).

Replaces no TPU kernel: the JAX package runs this CRC as a ``lax.scan``
over bytes (``webaudio_modem_tpu/ops/soft_fsk.py``
``_crc16_bits_device``), compiled into its program; run eagerly, the
same recurrence cost seven launches a byte.  Two entry points, one
launch each on the card:

  ``crc_rows(bits)``: bits [..., n] (0 / 1, MSB first) -> crc i32 [...]
      (poly 0x1021, init 0xFFFF), any n;
  ``pack_bodies(bodies, found, payload_len)``: the soft decode's body
      gate and packing, decoded bits u8 [B, 8 (payload_len + 2)] ->
      u8 [B, payload_len + 1]: the payload bytes, then ``found`` AND the
      payload's CRC equals the trailing two bytes.

The kernel uses the CRC's linearity over GF(2) (the source's note): each
1 bit adds a constant of its position, so a row splits into segments
that combine by XOR.  The host gives each segment's first constant and
the init's term (``_plan``).  On CPU tensors both entries run their plain
versions (``crc_rows_plain``, ``pack_bodies_plain``: the table recurrence
over whole bytes, then the bit-serial form over a tail), which the
kernel equals bit for bit on bits that are 0 or 1.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from webaudio_modem_tpu_torch.ops.kernels import _build
from webaudio_modem_tpu_torch.utils.crc16 import INITIAL_VALUE, TABLE

# kernel launches through ``crc_rows`` and ``pack_bodies`` (CPU calls run
# the plain versions and are not counted)
launches = 0

ROWS = 32                     # rows a block (csrc/crc16.cu kRows)
MAX_SEGMENTS = 32             # warps a block, one segment each
MIN_SEGMENT_BYTES = 4         # bytes a segment, at the least
SMEM_LIMIT = 232448           # shared bytes a block can use on an H100
_POLY = 0x11021               # x^16 + x^12 + x^5 + 1


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _crc_table(device: torch.device) -> torch.Tensor:
    """The CRC16 table on ``device``, copied there once (a copy from host
    memory waits for the stream)."""
    return torch.tensor(TABLE, dtype=torch.int32, device=device)


def crc_rows_plain(bits: torch.Tensor) -> torch.Tensor:
    """CRC-16-CCITT-FALSE over an MSB-first bit stream: bits [..., n] 0/1
    -> crc [...] int32.  Whole bytes go through the 256-entry table
    recurrence, a tail of fewer than 8 bits through the bit-serial
    shift/XOR form (poly 0x1021, init 0xFFFF)."""
    b = bits.to(torch.int32)
    n = b.shape[-1]
    crc = torch.full(b.shape[:-1], INITIAL_VALUE, dtype=torch.int32,
                     device=b.device)
    n_bytes = n // 8
    if n_bytes:
        table = _crc_table(b.device)
        w8 = 1 << torch.arange(7, -1, -1, dtype=torch.int32,
                               device=b.device)
        byts = (b[..., :8 * n_bytes].reshape(b.shape[:-1] + (n_bytes, 8))
                * w8).sum(-1)
        for j in range(n_bytes):
            idx = ((crc >> 8) ^ byts[..., j]) & 0xFF
            crc = ((crc << 8) & 0xFFFF) ^ table[idx.to(torch.int64)]
    for j in range(8 * n_bytes, n):
        msb = (crc >> 15) & 1
        crc = ((crc << 1) & 0xFFFF) ^ ((msb ^ b[..., j]) * 0x1021)
    return crc


def pack_bodies_plain(bodies: torch.Tensor, found: torch.Tensor,
                      payload_len: int) -> torch.Tensor:
    """Plain PyTorch version of ``pack_bodies``: the bytes, the CRC over
    the payload's bits, the compare with the trailing two bytes."""
    B = bodies.shape[0]
    bi = bodies.to(torch.int32)
    w8 = 1 << torch.arange(7, -1, -1, dtype=torch.int32, device=bi.device)
    body_bytes = (bi.reshape(B, payload_len + 2, 8) * w8).sum(-1)
    bcrc = (body_bytes[:, payload_len] << 8) | body_bytes[:, payload_len + 1]
    body_ok = found & (crc_rows_plain(bi[:, :8 * payload_len]) == bcrc)
    packed = torch.cat([body_bytes[:, :payload_len],
                        body_ok[:, None].to(torch.int32)], dim=1)
    return packed.to(torch.uint8)


# ---------------------------------------------------------------------------
# The kernel's plan: polynomial arithmetic mod P on the host
# ---------------------------------------------------------------------------

def _mulmod(a: int, b: int) -> int:
    r = 0
    for i in range(15, -1, -1):
        r <<= 1
        if r & 0x10000:
            r ^= _POLY
        if (a >> i) & 1:
            r ^= b
    return r


def _xpow(m: int) -> int:
    """x^m mod P."""
    r, base = 1, 2
    while m:
        if m & 1:
            r = _mulmod(r, base)
        base = _mulmod(base, base)
        m >>= 1
    return r


class _Plan(ctypes.Structure):
    _fields_ = [("n_bits", ctypes.c_int32), ("seg_bits", ctypes.c_int32),
                ("n_seg", ctypes.c_int32), ("init", ctypes.c_uint32),
                ("g0", ctypes.c_uint32 * MAX_SEGMENTS)]


@functools.lru_cache(maxsize=64)
def _plan(n_bits: int) -> _Plan:
    """Segments of whole bytes (at least MIN_SEGMENT_BYTES, at most
    MAX_SEGMENTS of them), each segment's first constant
    x^(16 + n - 1 - i0) and the init's term 0xFFFF x^n, mod P."""
    n_bytes = -(-n_bits // 8)
    n_seg = min(MAX_SEGMENTS, max(1, -(-n_bytes // MIN_SEGMENT_BYTES)))
    seg_bytes = max(1, -(-n_bytes // n_seg))
    n_seg = max(1, -(-n_bytes // seg_bytes))
    plan = _Plan(n_bits, 8 * seg_bytes, n_seg,
                 _mulmod(INITIAL_VALUE, _xpow(n_bits)))
    for s in range(n_seg):
        i0 = 8 * seg_bytes * s
        if i0 < n_bits:
            plan.g0[s] = _xpow(16 + n_bits - 1 - i0)
    return plan


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _entry(name: str):
    fn = getattr(_build.library("crc16"), name)
    if fn.argtypes is None:
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([vp, ci, ll, ll, vp, vp, vp] if name == "wam_crc_rows"
                       else [vp, ci, ll, ll, vp, vp, ci, vp, vp])
        fn.restype = ci
    return fn


def crc_rows(bits: torch.Tensor) -> torch.Tensor:
    """bits [..., n] (uint8, or any integer type holding 0 / 1: cast to
    uint8, one more launch), any strides -> crc int32 [...]."""
    global launches
    if not _build.use_kernel(bits):
        return crc_rows_plain(bits)
    n = bits.shape[-1]
    lead = bits.shape[:-1]
    if bits.dtype != torch.uint8:
        bits = bits.to(torch.uint8)
    R = math.prod(lead)
    rows = bits.reshape(R, n)           # a view where the strides allow
    crc = torch.empty(R, dtype=torch.int32, device=bits.device)
    if R:
        p = _build.ptr
        with torch.cuda.device(bits.device):
            err = _entry("wam_crc_rows")(
                p(rows), R, rows.stride(0), rows.stride(1),
                ctypes.byref(_plan(n)), p(crc), _build.stream())
        _build.raise_on_error(err, "crc16")
        launches += 1
    return crc.reshape(lead)


def pack_bodies(bodies: torch.Tensor, found: torch.Tensor,
                payload_len: int) -> torch.Tensor:
    """bodies u8 [B, 8 (payload_len + 2)] (K3's bits, any strides), found
    bool [B] -> packed u8 [B, payload_len + 1]."""
    global launches
    if not _build.use_kernel(bodies, found):
        return pack_bodies_plain(bodies, found, payload_len)
    B = bodies.shape[0]
    n = 8 * (payload_len + 2)
    if bodies.dtype != torch.uint8:
        raise TypeError(f"bodies: expected torch.uint8, got {bodies.dtype}")
    if tuple(bodies.shape) != (B, n):
        raise ValueError(f"bodies: expected shape ({B}, {n}), got "
                         f"{tuple(bodies.shape)}")
    _build.check(found, "found", torch.bool, (B,))
    plan = _plan(n)
    if 4 * ROWS * plan.n_seg + ROWS * (payload_len + 1) > SMEM_LIMIT:
        raise ValueError(f"payload_len {payload_len}: the block's tile of "
                         f"{ROWS} rows exceeds the card's shared memory")
    packed = torch.empty((B, payload_len + 1), dtype=torch.uint8,
                         device=bodies.device)
    if B:
        p = _build.ptr
        with torch.cuda.device(bodies.device):
            err = _entry("wam_crc_pack")(
                p(bodies), B, bodies.stride(0), bodies.stride(1),
                ctypes.byref(plan), p(found), payload_len, p(packed),
                _build.stream())
        _build.raise_on_error(err, "crc16")
        launches += 1
    return packed
