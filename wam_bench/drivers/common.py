"""What the drivers share: the configuration's FSK numbers for the
program and the reference, waiting out the program's background
warm-ups, and CUDA-event spans."""

from __future__ import annotations

from typing import List, Optional

import torch

from wam_bench.reference import uart_fsk

# answers still due when the window closes are waited for this long
DUE_WAIT_S = 60.0


def program_config(config: dict):
    """The program's ``FSKConfig`` of a configuration file."""
    from webaudio_modem_tpu_torch.models.config import FSKConfig

    return FSKConfig.from_dict(config["fsk"])


def reference_fsk(config: dict) -> uart_fsk.Fsk:
    return uart_fsk.Fsk.from_config(config["fsk"])


def join_background_warmups() -> None:
    """Wait for the program's quality-calibration builds that its facades
    start on host threads, so none runs inside the window."""
    from webaudio_modem_tpu_torch.ops import fsk_demod

    for t in list(getattr(fsk_demod, "_warm_threads", ())):
        t.join()


def check_choice(kind: str, value: Optional[str], allowed) -> None:
    if value is not None and value not in allowed:
        raise ValueError(f"{kind} {value!r}: one of {sorted(allowed)}")


class EventSpans:
    """Pairs of CUDA events around calls, read after the window (device
    time between the two points of the stream)."""

    def __init__(self, on: bool):
        self.on = on
        self.pairs: List[tuple] = []

    def begin(self):
        if not self.on:
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def end(self, start) -> None:
        if start is None:
            return
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.pairs.append((start, e))

    def ms(self) -> List[float]:
        if not self.pairs:
            return []
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.pairs]
