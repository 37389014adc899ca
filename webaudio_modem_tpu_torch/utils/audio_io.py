"""WAV file I/O for modem signals: the port's copy of
``webaudio_modem_tpu/utils/audio_io.py``, writing the same bytes.

Modulate to a .wav anyone can play into a sound card, and demodulate a
.wav captured from one.  Self-contained RIFF reader/writer (numpy only):
mono or multi-channel, 8/16/32-bit PCM and IEEE float32; the stdlib
``wave`` module cannot read float WAVs, and lossless float round-trips
matter for differential tests.
"""

from __future__ import annotations

import struct

import numpy as np

_PCM = 1
_IEEE_FLOAT = 3


def write_wav(path, samples, sample_rate: int = 48000,
              fmt: str = "pcm16") -> None:
    """Write a mono WAV.  ``fmt``: "pcm16" (playable anywhere, 16-bit)
    or "float32" (lossless for modem signals)."""
    x = np.asarray(samples, dtype=np.float64).reshape(-1)
    if fmt == "pcm16":
        payload = np.clip(np.round(x * 32767.0), -32768,
                          32767).astype("<i2").tobytes()
        tag, width = _PCM, 2
    elif fmt == "float32":
        payload = x.astype("<f4").tobytes()
        tag, width = _IEEE_FLOAT, 4
    else:
        raise ValueError(f"unsupported fmt: {fmt!r}")
    rate = int(sample_rate)
    hdr = b"".join([
        b"RIFF", struct.pack("<I", 36 + len(payload)), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, tag, 1, rate,
                             rate * width, width, width * 8),
        b"data", struct.pack("<I", len(payload)),
    ])
    with open(path, "wb") as f:
        f.write(hdr + payload)


def read_wav(path):
    """Read a WAV file -> (float32 mono samples in [-1, 1], rate).

    Handles PCM 8/16/32-bit and IEEE float32, any channel count
    (averaged to mono), and skips non-data chunks (LIST, fact, ...).
    """
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        tag = n_ch = width = rate = None
        data = None
        while True:
            chunk_hdr = f.read(8)
            if len(chunk_hdr) < 8:
                break
            cid, size = chunk_hdr[:4], struct.unpack(
                "<I", chunk_hdr[4:8])[0]
            if cid == b"fmt ":
                body = f.read(size)
                tag, n_ch, rate, _, _, bits = struct.unpack(
                    "<HHIIHH", body[:16])
                if tag == 0xFFFE and size >= 40:  # WAVE_FORMAT_EXTENSIBLE
                    tag = struct.unpack("<H", body[24:26])[0]
                width = bits // 8
            elif cid == b"data":
                data = f.read(size)
                if size & 1:          # chunks are word-aligned
                    f.seek(1, 1)
            else:
                f.seek(size + (size & 1), 1)  # chunks are word-aligned
            if data is not None and tag is not None:
                break
    if tag is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    if tag == _IEEE_FLOAT and width == 4:
        x = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif tag == _PCM and width == 2:
        x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    elif tag == _PCM and width == 4:
        x = np.frombuffer(data, dtype="<i4").astype(np.float32) \
            / 2147483648.0
    elif tag == _PCM and width == 1:
        x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32)
             - 128.0) / 128.0
    else:
        raise ValueError(f"{path}: unsupported format tag={tag} "
                         f"width={width}")
    if n_ch and n_ch > 1:
        x = x[:len(x) - len(x) % n_ch].reshape(-1, n_ch).mean(axis=1)
    return np.ascontiguousarray(x, dtype=np.float32), int(rate)
