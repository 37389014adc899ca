"""Batched FSK modulator — phase-continuous DDS, array-first.

Counterpart of ``webaudio_modem_tpu/ops/fsk_mod.py``.  The numpy
framing helpers are written again here because the JAX module imports
JAX at the top.  The host computes the per-bit phase prefix (exact
integer arithmetic mod fs for integer frequencies); the device expands
it to ``sin(offset[bit] + k * omega[bit])`` for every sample of every
channel in one pass.

Signal layout: 2 bit-times of leading zeros, preamble + SFD + data bytes
UART-framed (start bits, 8 data bits MSB-first, optional parity, stop
bits), one byte-time of trailing silence.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from webaudio_modem_tpu_torch.models.config import FSKParams, _framed_bits
from webaudio_modem_tpu_torch.utils.device import resolve_device

_TWO_PI = 2.0 * np.pi


@functools.lru_cache(maxsize=32)
def _framed_table(config) -> np.ndarray:
    """[256, bits_per_byte] int8 lookup of UART-framed bytes (read-only)."""
    table = np.asarray([_framed_bits(v, config) for v in range(256)],
                       dtype=np.int8)
    table.setflags(write=False)
    return table


def frame_bits_batch(params: FSKParams,
                     messages: Sequence[bytes]) -> np.ndarray:
    """UART-frame a batch of equal-length messages -> [B, n_bits] int8."""
    if not messages:
        raise ValueError("frame_bits_batch requires at least one message")
    if len({len(m) for m in messages}) != 1:
        raise ValueError(
            "frame_bits_batch requires equal-length messages; group by "
            "length (or pad at the transport layer) first")
    cfg = params.config
    table = _framed_table(cfg)
    pre = np.asarray([*cfg.preamble_pattern, *cfg.sfd_pattern], np.uint8)
    B = len(messages)
    data = np.frombuffer(b"".join(messages), np.uint8).reshape(B, -1) \
        if messages[0] else np.zeros((B, 0), np.uint8)
    all_bytes = np.concatenate(
        [np.tile(pre[None, :], (B, 1)), data], axis=1)
    return table[all_bytes].reshape(B, -1)


def signal_length(params: FSKParams, n_data_bytes: int) -> int:
    """Total sample count of one modulated message."""
    cfg = params.config
    total_bytes = (len(cfg.preamble_pattern) + len(cfg.sfd_pattern)
                   + n_data_bytes)
    padding = params.samples_per_bit * 2 if total_bytes > 0 else 0
    silence = params.bits_per_byte * params.samples_per_bit
    return (total_bytes * params.bits_per_byte * params.samples_per_bit
            + padding + silence)


def _phase_tables(params: FSKParams,
                  bits: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-bit (phase offset mod 2pi, per-sample increment), float64
    on the host — the path for non-integer frequencies."""
    freq = np.where(bits == 1, params.mark_freq, params.space_freq)
    omega = _TWO_PI * freq / params.sample_rate          # [..., n_bits]
    advance = omega * params.samples_per_bit
    offsets = np.cumsum(advance, axis=-1) - advance      # exclusive
    return np.mod(offsets, _TWO_PI), omega


def _expand(offsets: torch.Tensor, omega: torch.Tensor,
            samples_per_bit: int, pad: Tuple[int, int]) -> torch.Tensor:
    """[..., n_bits] f32 phase tables -> [..., T] f32 signal."""
    k = torch.arange(samples_per_bit, dtype=torch.float32,
                     device=offsets.device)
    sig = torch.sin(offsets[..., None] + omega[..., None] * k)
    sig = sig.reshape(*sig.shape[:-2], -1)
    return torch.nn.functional.pad(sig, pad)


def _synth(offsets: np.ndarray, omega: np.ndarray, samples_per_bit: int,
           pad: Tuple[int, int], device) -> torch.Tensor:
    """Synthesis from float64 host phase tables (rounded to f32)."""
    off = torch.from_numpy(offsets.astype(np.float32)).to(device)
    om = torch.from_numpy(omega.astype(np.float32)).to(device)
    return _expand(off, om, samples_per_bit, pad)


def _phase_acc_int(params: FSKParams, bits: np.ndarray) -> np.ndarray:
    """Exact integer exclusive phase prefix (mod fs) for integer
    mark/space/sample-rate configurations: the per-bit advance is
    2*pi*(f*spb mod fs)/fs, so the prefix is integer arithmetic mod fs.
    int32 while the un-reduced prefix fits, int64 beyond."""
    spb = params.samples_per_bit
    fs = int(params.sample_rate)
    mark_step = int(params.mark_freq) * spb % fs
    space_step = int(params.space_freq) * spb % fs
    b = np.asarray(bits)
    n_bits = b.shape[-1]
    dt = (np.int32 if n_bits * max(mark_step, space_step, 1)
          < 2 ** 31 else np.int64)
    steps = space_step + b.astype(dt) * dt(mark_step - space_step)
    acc = np.cumsum(steps, axis=-1, dtype=dt) - steps
    return (acc % fs).astype(np.int32)


def _synth_int(acc: torch.Tensor, bits: torch.Tensor, fs: int,
               mark_freq: float, space_freq: float, samples_per_bit: int,
               pad: Tuple[int, int]) -> torch.Tensor:
    """Device synthesis from the exact integer phase prefix: the radian
    offsets (acc < fs is exact in f32) and per-bit omega are derived on
    the device of ``acc``."""
    offsets = acc.to(torch.float32) * float(np.float32(_TWO_PI / fs))
    omega = torch.where(
        bits == 1,
        torch.tensor(np.float32(_TWO_PI * mark_freq / fs),
                     device=acc.device),
        torch.tensor(np.float32(_TWO_PI * space_freq / fs),
                     device=acc.device))
    return _expand(offsets, omega, samples_per_bit, pad)


def _int_config(params: FSKParams) -> bool:
    return (float(params.mark_freq).is_integer()
            and float(params.space_freq).is_integer()
            and float(params.sample_rate).is_integer())


def synth_bits_batch(params: FSKParams, bits: np.ndarray, lead: int,
                     device) -> torch.Tensor:
    """Bit rows [B, n] -> f32 [B, T] on ``device``, with ``lead`` samples
    of silence before and one byte's worth after: the exact integer
    phase prefix for integer frequencies, float64 host tables otherwise;
    the sine expansion runs on the device."""
    trail = params.bits_per_byte * params.samples_per_bit
    if _int_config(params):
        acc = torch.from_numpy(_phase_acc_int(params, bits)).to(device)
        bits_t = torch.from_numpy(bits).to(device)
        return _synth_int(acc, bits_t, int(params.sample_rate),
                          float(params.mark_freq), float(params.space_freq),
                          params.samples_per_bit, (lead, trail))
    offsets, omega = _phase_tables(params, bits)
    return _synth(offsets, omega, params.samples_per_bit, (lead, trail),
                  device)


def modulate_batch(params: FSKParams, messages: Sequence[bytes],
                   device="cuda") -> torch.Tensor:
    """Modulate a batch of equal-length messages -> f32 [B, T] on
    ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    lengths = {len(m) for m in messages}
    if len(lengths) != 1:
        raise ValueError(
            "modulate_batch requires equal-length messages; pad at the "
            "transport layer or call per-message")
    bits = frame_bits_batch(params, [bytes(m) for m in messages])
    total_bytes = bits.shape[-1] // params.bits_per_byte
    lead = params.samples_per_bit * 2 if total_bytes > 0 else 0
    return synth_bits_batch(params, bits, lead, device)


def modulate(params: FSKParams, data: bytes, device="cuda") -> np.ndarray:
    """Modulate one message on ``device`` -> float32 numpy [T]."""
    return modulate_batch(params, [data], device)[0].cpu().numpy()


def modulate_bits(params: FSKParams, bits, device="cuda") -> np.ndarray:
    """Modulate a raw bit sequence (no UART framing) -> float32 numpy [T].

    Same phase-continuous synthesis and lead/trail layout as
    ``modulate`` (float64 host phase tables, as the reference's
    ``modulate_bits``); used by the soft-decision FEC path
    (``ops/soft_fsk.py``), whose bits are convolutionally coded instead
    of UART-framed."""
    bits = np.asarray(bits, dtype=np.int8)[None]
    offsets, omega = _phase_tables(params, bits)
    lead = params.samples_per_bit * 2
    trail = params.bits_per_byte * params.samples_per_bit
    return _synth(offsets, omega, params.samples_per_bit, (lead, trail),
                  device)[0].cpu().numpy()
