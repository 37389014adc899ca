"""Forward error correction: convolutional code + batched Viterbi.

Counterpart of ``webaudio_modem_tpu/ops/fec.py``:

  * rate-1/2, K=7 convolutional encoder with the generators G0=0o171,
    G1=0o133 (free distance 10), trellis-terminated with K-1 zero flush
    bits — numpy, copied from the reference;
  * the batched soft-decision Viterbi decoder ``_viterbi_core``: kernel
    K3 (``ops/kernels/viterbi.py``, ``csrc/viterbi.cu``) on CUDA
    tensors, its plain PyTorch version on CPU tensors, both with the
    grouped (every 16 steps) normalization; ``per_step_norm=True`` is
    the reference's normalize-every-step schedule, plain PyTorch on any
    device (no TPU kernel backs it);
  * the byte helpers and the shared frame header/body builders.

Decoded bits equal the reference's for the same correlations: the same
single-add branch terms, the same strict ``>`` tie-break, the same
normalization schedule.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from webaudio_modem_tpu_torch.ops.kernels import viterbi as kviterbi
from webaudio_modem_tpu_torch.utils.crc16 import CRC16
from webaudio_modem_tpu_torch.utils.device import resolve_device

K = 7                   # constraint length
N_STATES = 1 << (K - 1)  # 64
G0 = 0o171
G1 = 0o133
RATE_INV = 2            # rate 1/2: two coded bits per input bit


def _parity(x: int) -> int:
    return bin(x).count("1") & 1


@functools.lru_cache(maxsize=1)
def _tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static trellis tables.

    Returns (out [64, 2, 2], pred [64, 2], pred_out [64, 2, 2]):
      out[s, b]      = the two coded bits emitted from state s on
                       input bit b (state = last K-1 input bits, newest
                       in the LSB).
      pred[s2, h]    = the two predecessor states of s2 (h = the bit
                       shifted out, i.e. the predecessor's MSB).
      pred_out[s2,h] = the coded bits emitted on pred[s2, h] -> s2.
    """
    out = np.zeros((N_STATES, 2, 2), np.int8)
    nxt = np.zeros((N_STATES, 2), np.int32)
    for s in range(N_STATES):
        for b in (0, 1):
            reg = (s << 1) | b          # K bits: state + new input
            out[s, b, 0] = _parity(reg & G0)
            out[s, b, 1] = _parity(reg & G1)
            nxt[s, b] = reg & (N_STATES - 1)
    pred = np.zeros((N_STATES, 2), np.int32)
    pred_out = np.zeros((N_STATES, 2, 2), np.int8)
    for s2 in range(N_STATES):
        b = s2 & 1                      # input bit is the new LSB
        for h in (0, 1):
            s = (s2 >> 1) | (h << (K - 2))
            if nxt[s, b] != s2:
                raise AssertionError("trellis tables are inconsistent")
            pred[s2, h] = s
            pred_out[s2, h] = out[s, b]
    return out, pred, pred_out


def conv_encode_bits(bits: np.ndarray) -> np.ndarray:
    """Encode a 1-D bit array (0/1) -> coded bits [2 * (n + K - 1)],
    with K-1 zero flush bits so the trellis terminates in state 0."""
    out_tab, _, _ = _tables()
    bits = np.asarray(bits, np.int64).ravel()
    padded = np.concatenate([bits, np.zeros(K - 1, np.int64)])
    coded = np.empty(2 * len(padded), np.uint8)
    s = 0
    for i, b in enumerate(padded):
        coded[2 * i] = out_tab[s, b, 0]
        coded[2 * i + 1] = out_tab[s, b, 1]
        s = ((s << 1) | int(b)) & (N_STATES - 1)
    return coded


def conv_encode_bits_batch(bits: np.ndarray) -> np.ndarray:
    """Encode a batch of equal-length bit rows [B, n] -> coded bits
    [B, 2 * (n + K - 1)], identical per row to ``conv_encode_bits``:
    each coded bit is the XOR of the generator-tapped columns of a
    K-wide sliding window over the zero-padded rows."""
    bits = np.asarray(bits, np.uint8)
    if bits.ndim != 2:
        raise ValueError("conv_encode_bits_batch expects [B, n] bits")
    B, n = bits.shape
    padded = np.concatenate(
        [np.zeros((B, K - 1), np.uint8), bits,
         np.zeros((B, K - 1), np.uint8)], axis=1)
    coded = np.empty((B, 2 * (n + K - 1)), np.uint8)
    for out, g in ((coded[:, 0::2], G0), (coded[:, 1::2], G1)):
        acc = np.zeros((B, n + K - 1), np.uint8)
        # G bit (K-1-j) taps window column j (oldest bit at the MSB)
        for j in range(K):
            if (g >> (K - 1 - j)) & 1:
                acc ^= padded[:, j:j + n + K - 1]
        out[:] = acc
    return coded


def branch_sums(soft: torch.Tensor):
    """The trellis inputs of correlations soft [..., T, 2]: a = x0 + x1
    and d = x0 - x1, one add each as the reference, time-major [T, L]
    with L the flattened batch."""
    flat = soft.reshape(-1, soft.shape[-2], 2)
    a = (flat[..., 0] + flat[..., 1]).t().contiguous()
    d = (flat[..., 0] - flat[..., 1]).t().contiguous()
    return a, d


def _viterbi_core(soft: torch.Tensor, n_bits: int,
                  per_step_norm: bool = False) -> torch.Tensor:
    """soft: f32 [..., n_bits + K - 1, 2] correlations (+1 ~ coded bit
    1, -1 ~ coded bit 0; magnitude = confidence), on any device.
    Returns the decoded bits u8 [..., n_bits] on the same device (the
    flush bits are consumed, not returned).

    The default groups 16 steps per normalization (kernel K3 on the
    card); ``per_step_norm=True`` normalizes after every step, the
    reference's original schedule."""
    batch_shape = soft.shape[:-2]
    a, d = branch_sums(soft)
    if per_step_norm:
        bits = kviterbi.decode_plain(a, d, n_bits, group=1)
    else:
        bits = kviterbi.decode(a, d, n_bits)
    return bits.reshape(batch_shape + (n_bits,))


def viterbi_decode_soft(soft, n_bits: int, per_step_norm: bool = False,
                        device="cuda") -> np.ndarray:
    """Soft-decision Viterbi decode on ``device``.

    soft: [..., 2*(n_bits+K-1)] interleaved coded-bit correlations
    (positive ~ 1, negative ~ 0) or already-paired [..., n+K-1, 2].
    Returns hard decoded bits [..., n_bits] (uint8, numpy)."""
    soft = torch.as_tensor(np.asarray(soft, np.float32),
                           device=resolve_device(device))
    if soft.shape[-1] != 2:
        soft = soft.reshape(soft.shape[:-1] + (-1, 2))
    expect = n_bits + K - 1
    if soft.shape[-2] != expect:
        raise ValueError(
            f"need {expect} coded pairs for {n_bits} bits, got "
            f"{soft.shape[-2]}")
    return _viterbi_core(soft, n_bits, per_step_norm).cpu().numpy()


def viterbi_decode_bits(coded_bits, n_bits: int,
                        device="cuda") -> np.ndarray:
    """Hard-decision decode: coded bits (0/1) -> decoded bits."""
    hard = np.asarray(coded_bits, np.float32) * 2.0 - 1.0
    return viterbi_decode_soft(hard, n_bits, device=device)


# -- shared frame format ------------------------------------------------------

FRAME_HEADER_PLAIN = 4                 # LEN(2, big-endian) + CRC16(LEN)


def build_frame_header(payload_len: int) -> bytes:
    header = bytes([payload_len >> 8, payload_len & 0xFF])
    return header + CRC16.calculate(header).to_bytes(2, "big")


def build_frame_body(payload: bytes) -> bytes:
    payload = bytes(payload)
    return payload + CRC16.calculate(payload).to_bytes(2, "big")


# -- byte-level helpers -------------------------------------------------------

def bits_to_bytes(bits: np.ndarray) -> bytes:
    bits = np.asarray(bits, np.uint8).ravel()
    pad = (-len(bits)) % 8
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
    return np.packbits(bits).tobytes()


def bytes_to_bits(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(bytes(data), np.uint8))


def encode_bytes(data: bytes) -> bytes:
    """Convolutionally encode a byte string (MSB-first bit order)."""
    return bits_to_bytes(conv_encode_bits(bytes_to_bits(data)))


def coded_length(n_data_bytes: int) -> int:
    """Coded byte length for ``n_data_bytes`` input bytes."""
    coded_bits = 2 * (8 * n_data_bytes + K - 1)
    return (coded_bits + 7) // 8


def decode_bytes(coded: bytes, n_data_bytes: int, device="cuda") -> bytes:
    """Hard-decision decode ``coded`` back to ``n_data_bytes`` bytes."""
    n_bits = 8 * n_data_bytes
    need = 2 * (n_bits + K - 1)
    bits = bytes_to_bits(coded)[:need]
    return bits_to_bytes(viterbi_decode_bits(bits, n_bits, device))[
        :n_data_bytes]
