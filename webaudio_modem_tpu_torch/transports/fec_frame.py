"""FEC frame layer: the error-correction framing of the FEC design memo.

The port's copy of ``webaudio_modem_tpu/transports/fec_frame.py``.  A
``FrameEncoder`` frames and FEC-encodes a payload in one step; a
stream-oriented ``FrameDecoder`` buffers partial input, detects frame
boundaries, FEC-decodes and extracts complete frames, over the rate-1/2
K=7 convolutional code of ``ops/fec.py``:

    frame := coded(header) || coded(body)
      header = LEN(2, big-endian) + CRC16(LEN)            (4 bytes)
      body   = payload + CRC16(payload)                   (len+2 bytes)

Each part is separately convolutionally encoded with trellis flush, so
the decoder can recover LEN first (validated by its own CRC: the
boundary detection), then decode exactly the right number of coded body
bytes.  A header whose CRC fails causes a one-byte slide and resync
(junk tolerance); a body whose CRC fails is reported through the
``on_error`` hook and skipped.  Every decode is one hard-decision
Viterbi, kernel K3 on the card (``fec.decode_bytes``).

The layer is byte-oriented and sits on top of any byte stream: it
protects against bit corruption inside delivered bytes; erasures are
left to the ARQ layer above.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from webaudio_modem_tpu_torch.ops import fec
from webaudio_modem_tpu_torch.utils.crc16 import CRC16
from webaudio_modem_tpu_torch.utils.device import resolve_device

HEADER_PLAIN = fec.FRAME_HEADER_PLAIN  # LEN(2) + CRC16(LEN)
HEADER_CODED = fec.coded_length(HEADER_PLAIN)
MAX_PAYLOAD = 65535


class FrameEncoder:
    """Payload -> framed + FEC-coded bytes (memo: FrameEncoder)."""

    @staticmethod
    def encode_frame(payload: bytes) -> bytes:
        payload = bytes(payload)
        if len(payload) > MAX_PAYLOAD:
            raise ValueError("payload too large for a single frame")
        return (fec.encode_bytes(fec.build_frame_header(len(payload)))
                + fec.encode_bytes(fec.build_frame_body(payload)))

    @staticmethod
    def coded_frame_length(payload_len: int) -> int:
        return HEADER_CODED + fec.coded_length(payload_len + 2)


class FrameDecoder:
    """Streaming coded bytes -> decoded frames (memo: FrameDecoder).

    ``process(data)`` ingests any number of bytes and returns the list
    of completed, CRC-valid payloads (empty if more input is needed).
    Partial frames are buffered internally; invalid headers slide one
    byte for resync; corrupt bodies are skipped and reported through
    ``on_error``.  The Viterbi decodes run on ``device`` (the card
    unless the caller asks for the CPU).
    """

    def __init__(self, on_error: Optional[Callable[[str], None]] = None,
                 max_payload: int = MAX_PAYLOAD,
                 max_slides_per_call: int = 1024, device="cuda"):
        self._device = resolve_device(device)
        self._buf = bytearray()
        self._on_error = on_error
        # Every one-byte resync slide re-runs the header Viterbi (one K3
        # launch and one copy back to the host on the card), so a
        # junk-heavy stream costs one 64-state decode per byte: bound the
        # work a single process() call may do.  When the bound is hit the
        # call returns with the buffer retained; scanning resumes on the
        # next process() call (process(b"") continues immediately).
        # Nothing is dropped, only deferred.
        self._max_slides_per_call = max_slides_per_call
        self._scan_pending = False
        # Upper bound on a believable header LEN: a junk byte window has
        # ~2^-16 odds of passing the header CRC by chance, and a large
        # phantom LEN stalls decoding until its coded-body span arrives
        # (the resync below is lossless, so nothing is dropped, but on a
        # stream that ends early the tail stays undecoded).  Deployments
        # with small frames should pass their real bound; the default
        # accepts anything the encoder can produce.
        self._max_payload = max_payload
        # decoded-but-unvalidated header state
        self._body_coded_len: Optional[int] = None
        self._payload_len = 0
        self.frames_decoded = 0
        self.headers_resynced = 0
        self.bodies_dropped = 0

    def reset(self) -> None:
        self._buf.clear()
        self._body_coded_len = None
        self._payload_len = 0
        self._scan_pending = False

    def pending(self) -> int:
        return len(self._buf)

    @property
    def scan_pending(self) -> bool:
        """True when a resync scan was deferred by the per-call slide
        bound: call ``process(b"")`` to continue it."""
        return self._scan_pending

    def _decode(self, coded: bytes, n_bytes: int) -> bytes:
        return fec.decode_bytes(coded, n_bytes, device=self._device)

    def process(self, data: bytes) -> List[bytes]:
        self._buf += bytes(data)
        out: List[bytes] = []
        slides = 0
        self._scan_pending = False
        while True:
            if slides >= self._max_slides_per_call:
                self._scan_pending = True
                return out
            if self._body_coded_len is None:
                if len(self._buf) < HEADER_CODED:
                    return out
                header = self._decode(bytes(self._buf[:HEADER_CODED]),
                                      HEADER_PLAIN)
                ln = (header[0] << 8) | header[1]
                crc = (header[2] << 8) | header[3]
                if CRC16.calculate(header[:2]) != crc or \
                        ln > self._max_payload:
                    # not a believable frame start: slide one byte and
                    # resync (the memo's boundary detection under junk)
                    del self._buf[0]
                    self.headers_resynced += 1
                    slides += 1
                    continue
                # header bytes stay in the buffer until the body
                # validates: if this "header" was junk that passed the
                # 16-bit CRC by chance, a genuine frame may start INSIDE
                # the phantom body window, and consuming it here would
                # lose that frame
                self._payload_len = ln
                self._body_coded_len = fec.coded_length(ln + 2)
            total = HEADER_CODED + self._body_coded_len
            if len(self._buf) < total:
                return out
            body = self._decode(bytes(self._buf[HEADER_CODED:total]),
                                self._payload_len + 2)
            self._body_coded_len = None
            payload = body[:self._payload_len]
            crc = (body[self._payload_len] << 8) | body[self._payload_len + 1]
            if CRC16.calculate(payload) != crc:
                self.bodies_dropped += 1
                if self._on_error is not None:
                    self._on_error("frame body CRC failed after FEC")
                # lossless resync: slide one byte past the header START
                # and re-scan; nothing beyond the slide is discarded
                del self._buf[0]
                self.headers_resynced += 1
                slides += 1
                continue
            del self._buf[:total]
            self.frames_decoded += 1
            out.append(payload)
