"""Plain reference of the soft-FEC frame transmitter.

Follows ``webaudio_modem_tpu_torch/ops/soft_fsk.py``
(``encode_frames_batch``, ``frames_synth_device_fn``) and
``webaudio_modem_tpu_torch/ops/fec.py``: a frame is the UART-framed
preamble + SFD pattern, then the convolutionally coded header (LEN, 2
bytes big-endian, and its CRC-16) and the coded body (payload and its
CRC-16), each coded on its own with the rate-1/2 K=7 code (generators
0o171 / 0o133, the NASA / CCSDS code) and K-1 zero flush bits; coded
bits are sent raw (no UART framing), phase-continuous over the whole
frame, with two bit-times of silence before and one byte-time after.
CRC-16 is CCITT-FALSE (polynomial 0x1021, initial value 0xFFFF, MSB
first).
"""

from __future__ import annotations

import torch

from wam_bench.reference import uart_fsk

K = 7
G0, G1 = 0o171, 0o133
POLY = 0x1021


def crc16_table(device) -> torch.Tensor:
    """The 256-entry CRC-16-CCITT table, int64."""
    crc = torch.arange(256, dtype=torch.int64, device=device) << 8
    for _ in range(8):
        crc = torch.where((crc & 0x8000) != 0, ((crc << 1) ^ POLY) & 0xFFFF,
                          (crc << 1) & 0xFFFF)
    return crc


def crc16_rows(data: torch.Tensor) -> torch.Tensor:
    """CRC-16-CCITT-FALSE of each row of ``data`` [B, n] uint8 -> [B]."""
    table = crc16_table(data.device)
    d = data.to(torch.int64)
    crc = torch.full((d.shape[0],), 0xFFFF, dtype=torch.int64,
                     device=d.device)
    for j in range(d.shape[1]):
        crc = ((crc << 8) & 0xFFFF) ^ table[((crc >> 8) ^ d[:, j]) & 0xFF]
    return crc


def bytes_to_bits(data: torch.Tensor) -> torch.Tensor:
    """[B, n] uint8 -> [B, 8n] int64 bits, MSB first."""
    shifts = torch.arange(7, -1, -1, device=data.device)
    return ((data.to(torch.int64)[..., None] >> shifts) & 1).reshape(
        data.shape[0], -1)


def conv_encode(bits: torch.Tensor) -> torch.Tensor:
    """[B, n] bits -> [B, 2 (n + K - 1)] coded bits: the two generators'
    outputs interleaved, K-1 zero flush bits appended."""
    B, n = bits.shape
    padded = torch.nn.functional.pad(bits, (K - 1, K - 1))
    streams = []
    for g in (G0, G1):
        acc = torch.zeros((B, n + K - 1), dtype=torch.int64,
                          device=bits.device)
        # generator bit K-1-j taps window column j (oldest bit first)
        for j in range(K):
            if (g >> (K - 1 - j)) & 1:
                acc = acc ^ padded[:, j:j + n + K - 1]
        streams.append(acc)
    return torch.stack(streams, 2).reshape(B, -1)


def frame_bits(fsk: uart_fsk.Fsk, payloads: torch.Tensor) -> torch.Tensor:
    """[B, n] uint8 payloads -> the frame's bits [B, P + H + body]."""
    B, n = payloads.shape
    dev = payloads.device
    pat = torch.tensor(fsk.pattern, dtype=torch.int64, device=dev)
    pattern = uart_fsk.byte_bits_table(fsk, dev)[pat].reshape(-1)
    header = torch.tensor([[n >> 8, n & 0xFF]], dtype=torch.uint8,
                          device=dev)
    hcrc = crc16_rows(header)
    header = torch.cat([header, torch.stack([hcrc >> 8, hcrc & 0xFF],
                                            1).to(torch.uint8)], 1)
    bcrc = crc16_rows(payloads)
    body = torch.cat([payloads, torch.stack([bcrc >> 8, bcrc & 0xFF],
                                            1).to(torch.uint8)], 1)
    return torch.cat([pattern.expand(B, -1),
                      conv_encode(bytes_to_bits(header)).expand(B, -1),
                      conv_encode(bytes_to_bits(body))], 1)


def frame_slots(fsk: uart_fsk.Fsk, payloads: torch.Tensor) -> torch.Tensor:
    """Slot rows of the frames: 2 silent slots, the bits, one byte-time
    of silent slots."""
    bits = frame_bits(fsk, payloads)
    sil = lambda n: torch.full((bits.shape[0], n), -1,  # noqa: E731
                               dtype=torch.int64, device=bits.device)
    return torch.cat([sil(2), bits, sil(fsk.bits_per_byte)], 1)


def frame_samples(fsk: uart_fsk.Fsk, payload_len: int) -> int:
    """Samples of one frame of ``payload_len`` bytes."""
    n_bits = (len(fsk.pattern) * fsk.bits_per_byte + 2 * (8 * 4 + K - 1)
              + 2 * (8 * (payload_len + 2) + K - 1))
    return (n_bits + 2 + fsk.bits_per_byte) * fsk.spb


def synth_frames(fsk: uart_fsk.Fsk, payloads: torch.Tensor,
                 out: torch.Tensor = None) -> torch.Tensor:
    """[B, n] uint8 payloads -> f32 frame audio [B, frame_samples(n)]."""
    slots = frame_slots(fsk, payloads)
    first = torch.full_like(slots, 2)
    return uart_fsk.synth_slots(fsk, slots,
                                uart_fsk.phase_acc(fsk, slots, first), out)
