"""Per-channel incremental XModem deframer: the port's copy of
``webaudio_modem_tpu/native/deframer.py``.

Parses the farm's decoded byte streams into wire events — data packets
(SOH|SEQ|~SEQ|LEN|PAYLOAD|CRC16), bare control bytes (ACK/NAK/EOT) and
junk — without per-byte Python, in the native library
(``native/modem_native.cpp``), which the constructor builds or raises.
The pure-Python parser with the same semantics (its CRC the Python one
too) runs only when asked for, ``Deframer(force_python=True)``: it is
the plain version the native one is held against.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional

import numpy as np

from webaudio_modem_tpu_torch.native import get_lib
from webaudio_modem_tpu_torch.utils.crc16 import CRC16

PACKET = "packet"
CONTROL = "control"
JUNK = "junk"
BAD_SEQ = "bad_seq"
BAD_CRC = "bad_crc"

_CODE_MAP = {1: PACKET, 2: CONTROL, -1: BAD_SEQ, -2: BAD_CRC, -3: JUNK}


@dataclasses.dataclass(frozen=True)
class Frame:
    kind: str                      # PACKET / CONTROL / JUNK / BAD_*
    seq: Optional[int] = None      # PACKET only
    payload: Optional[bytes] = None  # PACKET only
    byte: Optional[int] = None     # CONTROL / JUNK only


class Deframer:
    """Streaming deframer over ``n_channels`` independent byte streams:
    native, or pure Python with ``force_python``."""

    def __init__(self, n_channels: int = 1, force_python: bool = False):
        self.n_channels = n_channels
        self._lib = None if force_python else get_lib()
        if self._lib is not None:
            self._handle = self._lib.wam_deframer_new(n_channels)
            self._out = (ctypes.c_uint8 * 260)()
        else:
            self._buffers: List[bytearray] = [bytearray()
                                              for _ in range(n_channels)]

    def __del__(self):
        if getattr(self, "_lib", None) is not None and \
                getattr(self, "_handle", None):
            self._lib.wam_deframer_free(self._handle)
            self._handle = None

    @property
    def is_native(self) -> bool:
        return self._lib is not None

    def push(self, channel: int, data: bytes) -> None:
        if self._lib is not None:
            self._lib.wam_deframer_push(self._handle, channel,
                                        bytes(data), len(data))
        else:
            self._buffers[channel] += data

    def pending(self, channel: int) -> int:
        if self._lib is not None:
            return int(self._lib.wam_deframer_pending(self._handle, channel))
        return len(self._buffers[channel])

    def reset(self, channel: int) -> None:
        if self._lib is not None:
            self._lib.wam_deframer_reset(self._handle, channel)
        else:
            self._buffers[channel] = bytearray()

    def poll(self, channel: int) -> Optional[Frame]:
        """Next event, or None if more bytes are needed."""
        if self._lib is not None:
            code = int(self._lib.wam_deframer_poll(self._handle, channel,
                                                   self._out))
            if code == 0:
                return None
            kind = _CODE_MAP[code]
            if kind == PACKET:
                length = self._out[1]
                return Frame(kind=PACKET, seq=self._out[0],
                             payload=bytes(self._out[2:2 + length]))
            if kind in (CONTROL, JUNK):
                return Frame(kind=kind, byte=self._out[0])
            return Frame(kind=kind)
        return self._poll_python(channel)

    def poll_all(self, channel: int) -> List[Frame]:
        frames = []
        while True:
            f = self.poll(channel)
            if f is None:
                return frames
            frames.append(f)

    def total_pending(self) -> int:
        if self._lib is not None:
            return int(self._lib.wam_deframer_total_pending(self._handle))
        return sum(len(b) for b in self._buffers)

    def drain(self, vals, counts) -> List[tuple]:
        """Batched farm-quantum drain: push every channel's decoded
        bytes AND poll every wire event in ONE native call.

        ``vals``: [n_channels, stride] uint8, ``counts``: [n_channels]
        — the farm's DemodOut (bytes_out, byte_count) host arrays.
        Returns [(channel, Frame), ...] in channel order: one ctypes
        crossing a quantum instead of three per active channel.
        """
        vals = np.ascontiguousarray(vals, dtype=np.uint8)
        counts = np.ascontiguousarray(counts, dtype=np.int32)
        if vals.ndim != 2 or counts.shape != (vals.shape[0],):
            raise ValueError("drain expects vals [C, stride], counts [C]")
        if vals.shape[0] != self.n_channels:
            raise ValueError(
                f"drain expects {self.n_channels} channels, got "
                f"{vals.shape[0]}")
        if self._lib is None:
            return self._drain_python(vals, counts)
        # one event per byte is the worst case (all junk)
        cap = int(counts.sum()) + self.total_pending()
        if cap == 0:
            return []
        ev = np.empty((cap, 4), np.int32)
        payloads = np.empty(cap, np.uint8)
        n = int(self._lib.wam_deframer_drain(
            self._handle,
            vals.ctypes.data_as(ctypes.c_void_p), vals.shape[1],
            counts.ctypes.data_as(ctypes.c_void_p), vals.shape[0],
            ev.ctypes.data_as(ctypes.c_void_p), cap,
            payloads.ctypes.data_as(ctypes.c_void_p), cap))
        if n < 0:  # cannot happen with the cap above; guard anyway
            raise RuntimeError("wam_deframer_drain buffer overflow")
        out = []
        pay_off = 0
        pay_bytes = payloads.tobytes()
        for i in range(n):
            ch, code, a, length = (int(ev[i, 0]), int(ev[i, 1]),
                                   int(ev[i, 2]), int(ev[i, 3]))
            kind = _CODE_MAP[code]
            if kind == PACKET:
                frame = Frame(kind=PACKET, seq=a,
                              payload=pay_bytes[pay_off:pay_off + length])
                pay_off += length
            elif kind in (CONTROL, JUNK):
                frame = Frame(kind=kind, byte=a)
            else:
                frame = Frame(kind=kind)
            out.append((ch, frame))
        return out

    def _drain_python(self, vals, counts) -> List[tuple]:
        """The pure-Python drain, same semantics (any channel with new or
        leftover bytes is polled)."""
        out = []
        for ch in range(self.n_channels):
            c = int(counts[ch])
            if c > 0:
                self.push(ch, bytes(vals[ch, :c]))
            if not self._buffers[ch]:
                continue
            for f in self.poll_all(ch):
                out.append((ch, f))
        return out

    # -- the pure-Python parser (force_python; identical semantics) --------

    def _poll_python(self, channel: int) -> Optional[Frame]:
        buf = self._buffers[channel]
        while buf:
            first = buf[0]
            if first in (0x04, 0x06, 0x15):       # EOT/ACK/NAK
                del buf[0]
                return Frame(kind=CONTROL, byte=first)
            if first != 0x01:                     # not SOH
                del buf[0]
                return Frame(kind=JUNK, byte=first)
            if len(buf) < 4:
                return None
            seq, nseq, length = buf[1], buf[2], buf[3]
            if ((seq + nseq) & 0xFF) != 0xFF:
                del buf[:4]
                return Frame(kind=BAD_SEQ)
            total = 4 + length + 2
            if len(buf) < total:
                return None
            payload = bytes(buf[4:4 + length])
            wire_crc = (buf[4 + length] << 8) | buf[4 + length + 1]
            del buf[:total]
            if CRC16.calculate_python(payload) != wire_crc:
                return Frame(kind=BAD_CRC)
            return Frame(kind=PACKET, seq=seq, payload=payload)
        return None
