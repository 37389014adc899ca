"""Generator of the ``stream`` mixes: every channel carries its own
seeded stream of framed messages, played as a cycle of audio.

Follows the message layout of ``webaudio_modem_tpu_torch/ops/fsk_mod.py``
(through ``wam_bench.reference.uart_fsk``) and the load of
``bench.py`` / ``examples/farm_endurance.py``'s hard wire: each message is
two bit-times of silence, preamble + SFD + payload UART-framed, one
byte-time of silence, then an idle gap.  Everything is drawn on the
device from one ``torch.Generator`` seeded with the run's seed:

* payload lengths: a rounded log-normal of median ``payload_median``
  and log-sigma ``payload_sigma``, clipped to [payload_min,
  payload_max] (a heavy tail);
* idle gaps: whole bit-times, uniform in [0, gap_max_seconds];
* payload bytes: uniform.

Messages are placed back to back from the cycle's start; the last one
ends ``tail_silence_seconds`` or more before the cycle ends, so the
cycle ends in silence and replaying it leaves the carried state sound.
Frozen AWGN at ``snr_db`` covers the whole cycle, silence included;
``snr_db`` null is a clean line.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import torch

from wam_bench.reference import channel, uart_fsk


@dataclass
class StreamTraffic:
    audio: torch.Tensor          # f32 [B, cycle samples] on the device
    messages: List[List[bytes]]  # per channel, the payloads of one cycle
    chunk: int
    n_chunks: int                # chunks in a cycle

    def chunk_view(self, k: int) -> torch.Tensor:
        """Chunk ``k`` of the endless replay, a [B, chunk] view."""
        j = k % self.n_chunks
        return self.audio[:, j * self.chunk:(j + 1) * self.chunk]


def layout(fsk: uart_fsk.Fsk, batch: int, mix: dict, gen: torch.Generator,
           device):
    """Slot rows of one cycle and the messages they carry: (slots [B, S],
    first_bit [B, S], lengths [B, M], valid [B, M], payloads [B, M,
    payload_max])."""
    S = round(mix["cycle_seconds"] * fsk.baud_rate)
    nb = fsk.bits_per_byte
    n_pat = len(fsk.pattern)
    lead, trail = 2, nb
    tail = math.ceil(mix["tail_silence_seconds"] * fsk.baud_rate)
    lo, hi = int(mix["payload_min"]), int(mix["payload_max"])
    M = S // (lead + (n_pat + lo) * nb + trail) + 1
    B = batch

    z = torch.randn((B, M), generator=gen, device=device)
    lengths = torch.exp(math.log(mix["payload_median"])
                        + mix["payload_sigma"] * z).round()
    lengths = lengths.clamp(lo, hi).to(torch.int64)
    gap_max = round(mix["gap_max_seconds"] * fsk.baud_rate)
    gaps = torch.randint(0, gap_max + 1, (B, M), generator=gen,
                         device=device)
    payloads = torch.randint(0, 256, (B, M, hi), generator=gen,
                             device=device, dtype=torch.int64)

    span = lead + (n_pat + lengths) * nb + trail       # slots per message
    starts = torch.cumsum(gaps + span, 1) - span
    valid = starts + span <= S - tail

    s = torch.arange(S, device=device).expand(B, S).contiguous()
    m = torch.searchsorted(starts, s, right=True) - 1
    mc = m.clamp_min(0)
    st = torch.take_along_dim(starts, mc, 1)
    ln = torch.take_along_dim(lengths, mc, 1)
    ok = (m >= 0) & torch.take_along_dim(valid, mc, 1)
    local = s - st - lead
    is_bit = ok & (local >= 0) & (local < (n_pat + ln) * nb)
    local = local.clamp_min(0)
    byte_i, bit_i = local // nb, local % nb
    pat = torch.tensor(fsk.pattern, dtype=torch.int64, device=device)
    pay_i = (mc * hi + (byte_i - n_pat).clamp(0, hi - 1))
    pay = torch.take_along_dim(payloads.reshape(B, M * hi), pay_i, 1)
    byte = torch.where(byte_i < n_pat, pat[byte_i.clamp_max(n_pat - 1)],
                       pay)
    table = uart_fsk.byte_bits_table(fsk, device)
    bits = table.reshape(-1)[byte * nb + bit_i]
    slots = torch.where(is_bit, bits, -1)
    return slots, st + lead, lengths, valid, payloads


def make(fsk: uart_fsk.Fsk, batch: int, chunk: int, mix: dict, seed: int,
         device, rows: int = 256) -> StreamTraffic:
    """The cycle of audio on ``device`` and its messages, from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    slots, first, lengths, valid, payloads = layout(fsk, batch, mix, gen,
                                                    device)
    acc = uart_fsk.phase_acc(fsk, slots, first)
    S = slots.shape[1]
    T = S * fsk.spb
    if T % chunk:
        raise ValueError(f"cycle of {T} samples is not whole chunks of "
                         f"{chunk}")
    audio = torch.empty((batch, T), dtype=torch.float32, device=device)
    for r in range(0, batch, rows):
        uart_fsk.synth_slots(fsk, slots[r:r + rows], acc[r:r + rows],
                             out=audio[r:r + rows])
    del slots, first, acc
    if mix["snr_db"] is not None:
        channel.awgn_(audio, mix["snr_db"], gen, rows)
    lengths, valid = lengths.cpu().tolist(), valid.cpu().tolist()
    pay = payloads.to(torch.uint8).cpu().numpy()
    messages = [[pay[b, m, :lengths[b][m]].tobytes()
                 for m in range(len(valid[b])) if valid[b][m]]
                for b in range(batch)]
    return StreamTraffic(audio, messages, chunk, T // chunk)
