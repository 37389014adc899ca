"""Generator of the ``frames`` mixes: batches of soft-FEC frames, one
payload length a batch.

Follows ``webaudio_modem_tpu_torch/ops/soft_fsk.py``'s frame synthesis
(through ``wam_bench.reference.fec_fsk``) and ``chip_smoke.py`` phase 8's
load (a batch of B frames at 8 dB).  For each payload length of the
mix's ``block``, ``copies`` noisy batches are made on the device from
the seed and kept there; the order of batches is the block, shuffled by
the seed once per block, so every seed decodes the same mix of lengths,
in another order.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple

import torch

from wam_bench.reference import channel, fec_fsk, uart_fsk


@dataclass
class FramesTraffic:
    audio: Dict[Tuple[int, int], torch.Tensor]   # (length, copy) -> [B, T]
    payloads: Dict[Tuple[int, int], List[bytes]]
    block: List[int]
    copies: int
    seed: int

    def order(self) -> Iterator[Tuple[int, int]]:
        """The endless sequence of (length, copy) keys."""
        rng = random.Random(self.seed)
        n = 0
        while True:
            block = list(self.block)
            rng.shuffle(block)
            for length in block:
                yield length, n % self.copies
                n += 1


def make(fsk: uart_fsk.Fsk, batch: int, mix: dict, seed: int,
         device) -> FramesTraffic:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    audio, payloads = {}, {}
    for length in sorted(set(mix["block"])):
        for c in range(mix["copies"]):
            pay = torch.randint(0, 256, (batch, length), generator=gen,
                                device=device, dtype=torch.int64
                                ).to(torch.uint8)
            sig = fec_fsk.synth_frames(fsk, pay)
            audio[(length, c)] = channel.awgn_(sig, mix["snr_db"], gen)
            host = pay.cpu().numpy()
            payloads[(length, c)] = [host[b].tobytes() for b in range(batch)]
    return FramesTraffic(audio, payloads, list(mix["block"]),
                         int(mix["copies"]), seed)
