"""Plain reference of a UART-framed, phase-continuous FSK transmitter.

Follows ``webaudio_modem_tpu_torch/ops/fsk_mod.py`` (``frame_bits_batch``,
``_phase_acc_int``, ``_synth_int``): a byte is a start bit, 8 data bits
MSB first, optional parity and stop bits; a 1 bit is sent at the mark
frequency, a 0 bit at the space frequency; a message is two bit-times
of silence, the preamble and SFD bytes and the payload, then one
byte-time of silence.  The phase runs on from bit to bit within a
message and starts at 0 at its first bit.

Audio is laid out in *slots* of one bit-time each: a slot is silence
(-1) or a bit (0 / 1) with its phase offset, an integer below the
sample rate (the exclusive sum of the per-bit advances f * spb mod fs).
``synth_slots`` expands slots to samples with the same float32
expression as ``fsk_mod._synth_int``, so a slot row of one message
gives the program's modulator's samples exactly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

TWO_PI = 2.0 * math.pi


@dataclass(frozen=True)
class Fsk:
    """The transmitter's numbers, from a configuration's ``fsk`` group."""

    sample_rate: int
    baud_rate: int
    mark: int
    space: int
    pattern: tuple          # preamble + SFD bytes
    start_bits: int
    stop_bits: int
    parity: str

    @staticmethod
    def from_config(fsk: dict) -> "Fsk":
        for key in ("sample_rate", "mark_frequency", "space_frequency"):
            if float(fsk[key]) != int(fsk[key]):
                raise ValueError(f"{key} must be a whole number of Hz")
        return Fsk(int(fsk["sample_rate"]), int(fsk["baud_rate"]),
                   int(fsk["mark_frequency"]), int(fsk["space_frequency"]),
                   tuple(fsk["preamble_pattern"]) + tuple(fsk["sfd_pattern"]),
                   int(fsk["start_bits"]), int(fsk["stop_bits"]),
                   fsk["parity"])

    @property
    def spb(self) -> int:
        """Samples per bit."""
        return self.sample_rate // self.baud_rate

    @property
    def bits_per_byte(self) -> int:
        return (8 + self.start_bits + self.stop_bits
                + (0 if self.parity == "none" else 1))

    def steps(self):
        """(mark, space) phase advance of one bit, integers mod fs."""
        fs = self.sample_rate
        return self.mark * self.spb % fs, self.space * self.spb % fs


def byte_bits_table(fsk: Fsk, device) -> torch.Tensor:
    """[256, bits_per_byte] int64: the UART-framed bits of each byte."""
    v = torch.arange(256, device=device)[:, None]
    data = (v >> torch.arange(7, -1, -1, device=device)) & 1
    cols = [torch.zeros((256, fsk.start_bits), dtype=torch.int64,
                        device=device), data]
    if fsk.parity != "none":
        par = data.sum(1, keepdim=True) & 1
        cols.append(par if fsk.parity == "even" else 1 - par)
    cols.append(torch.ones((256, fsk.stop_bits), dtype=torch.int64,
                           device=device))
    return torch.cat(cols, 1)


def phase_acc(fsk: Fsk, slots: torch.Tensor,
              first_bit: torch.Tensor) -> torch.Tensor:
    """Integer phase offsets [B, S] of slot rows ``slots`` (-1 silence):
    the exclusive sum of the advances since the slot ``first_bit`` [B, S]
    (index of the first bit of the message each slot belongs to), mod
    fs."""
    mark, space = fsk.steps()
    step = torch.where(slots == 1, mark, torch.where(slots == 0, space, 0))
    cs = torch.cumsum(step.to(torch.int64), dim=1) - step
    base = torch.take_along_dim(cs, first_bit.clamp_min(0), dim=1)
    return torch.remainder(cs - base, fsk.sample_rate)


def synth_slots(fsk: Fsk, slots: torch.Tensor, acc: torch.Tensor,
                out: torch.Tensor = None) -> torch.Tensor:
    """Slots [B, S] (-1 silence, 0 space, 1 mark) and their phase
    offsets [B, S] -> f32 audio [B, S * spb] (into ``out`` if given)."""
    fs = fsk.sample_rate
    dev = slots.device
    offsets = acc.to(torch.float32) * float(torch.tensor(
        TWO_PI / fs, dtype=torch.float32))
    w_mark = torch.tensor(TWO_PI * fsk.mark / fs, dtype=torch.float32,
                          device=dev)
    w_space = torch.tensor(TWO_PI * fsk.space / fs, dtype=torch.float32,
                           device=dev)
    omega = torch.where(slots == 1, w_mark, w_space)
    k = torch.arange(fsk.spb, dtype=torch.float32, device=dev)
    sig = torch.sin(offsets[..., None] + omega[..., None] * k)
    sig = torch.where((slots >= 0)[..., None], sig, 0.0)
    sig = sig.reshape(slots.shape[0], -1)
    if out is None:
        return sig
    out.copy_(sig)
    return out


def message_slots(fsk: Fsk, payloads: torch.Tensor) -> torch.Tensor:
    """One message per row: [B, n] uint8 payloads -> its slot row
    [B, 2 + (len(pattern) + n + 1) * bits_per_byte] (lead silence,
    framed bits, one byte-time of silence)."""
    B = payloads.shape[0]
    dev = payloads.device
    pat = torch.tensor(fsk.pattern, dtype=torch.int64, device=dev)
    data = torch.cat([pat.expand(B, -1), payloads.to(torch.int64)], 1)
    bits = byte_bits_table(fsk, dev)[data].reshape(B, -1)
    sil = lambda n: torch.full((B, n), -1, dtype=torch.int64,  # noqa: E731
                               device=dev)
    return torch.cat([sil(2), bits, sil(fsk.bits_per_byte)], 1)
