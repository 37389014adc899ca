"""Pure host cost of a farm-hub ARQ round at scale, device stubbed.

The endurance harness (``farm_endurance.py --soft``) measures wall clock
WITH the device work; this one isolates the HOST topology cost: ring-write
bookkeeping, cohort launch, window scheduling, finalize / drain /
delivery, the protocol coroutines and the event-loop pumping, for a full
B-session XModem round over the scheduled soft hub (``SoftFarmHub``) with
every device program replaced by a host stub: ``_write_group`` keeps the
hub's bookkeeping line for line but synthesizes nothing and writes no
ring, and a window decode returns the exact payload bytes recorded at
write time (as a CPU tensor, so the finalize path reads it as it reads
a decode's pinned copy).

If THIS number exceeds the 100 ms audio quantum, no kernel can make the
topology realtime; if it is far under, the gap is device cost.  Runs on
the CPU, no card needed:

    python -m webaudio_modem_tpu_torch.examples.farm_host_cost --batch 256
"""

from __future__ import annotations

import argparse
import asyncio
import sys
import time

import numpy as np
import torch


def make_stub_hub(batch: int, quantum: int):
    """SoftFarmHub (on the CPU) with every device program stubbed on the
    host."""
    from webaudio_modem_tpu_torch.models.config import (DEFAULT_FSK_CONFIG,
                                                        FSKParams)
    from webaudio_modem_tpu_torch.ops import soft_fsk
    from webaudio_modem_tpu_torch.runtime.soft_hub import SoftFarmHub

    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)

    class StubSoftHub(SoftFarmHub):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            # (side, w, Lpad) -> {row: payload bytes} recorded at write
            self._written = {}

        def _write_group(self, side, w, t_read, rows, datas, entries,
                         length):
            # RingHubBase._write_group minus the device work (synthesis,
            # padding, the mask upload, the ring writes); every line of
            # its Python bookkeeping is kept (defer, busy_until,
            # resolve_at, _on_group_written)
            T = soft_fsk.frame_signal_length(params, length)
            Lpad = self._quanta(T)
            if w + Lpad - t_read > self.ring_len:
                self._defer(side, rows, entries)
                return
            mask = np.zeros((self.batch,), bool)
            mask[rows] = True
            s_end = (w + T - 1) // self.quantum
            for i, e in zip(rows, entries):
                self._busy_until[side][i] = w + T
                e.cohort = (w, Lpad)
                self._resolve_at[side][s_end].append((i, e))
            self._on_group_written(side, w, Lpad, T, rows, entries, length)

        def _on_group_written(self, side, w, Lpad, T, rows, entries,
                              length):
            self._written[(side, w, Lpad)] = {
                i: e.data for i, e in zip(rows, entries)}
            super()._on_group_written(side, w, Lpad, T, rows, entries,
                                      length)

        def _dispatch_group(self, tx_side, rx_side, group):
            for i in group.rows:
                hit = self._sched.get((tx_side, i))
                if hit is not None and hit[0] is group:
                    del self._sched[(tx_side, i)]
            if not group.active.any():
                return
            datas = self._written.pop((tx_side, group.w, group.Lpad))
            pl = group.payload_len
            packed = np.zeros((self.batch, pl + 1), np.uint8)
            for i, d in datas.items():
                packed[i, :len(d)] = np.frombuffer(d, np.uint8)
                packed[i, pl] = 1
            self._pending_dec[rx_side].append(
                (group, torch.from_numpy(packed), None, self.steps))

    return StubSoftHub(DEFAULT_FSK_CONFIG, batch, quantum=quantum,
                       ring_quanta=24, device="cpu")


async def run(batch: int, rounds: int, payload_size: int,
              quantum: int) -> dict:
    from webaudio_modem_tpu_torch.examples.farm_endurance import \
        round_payloads
    from webaudio_modem_tpu_torch.transports.xmodem import XModemTransport
    from webaudio_modem_tpu_torch.utils.trace import metrics

    hub = make_stub_hub(batch, quantum)
    senders = [XModemTransport(hub.channel("a", i)) for i in range(batch)]
    receivers = [XModemTransport(hub.channel("b", i))
                 for i in range(batch)]
    for t in senders + receivers:
        t.configure({"timeout_ms": 600000})
    pump = asyncio.ensure_future(hub.run())
    ok = True
    before = metrics.snapshot()["timings"]
    t0 = time.perf_counter()
    steps0 = hub.steps
    try:
        for rnd in range(rounds):
            payloads = round_payloads(rnd, batch, payload_size)
            rxs = [asyncio.ensure_future(r.receive_data())
                   for r in receivers]
            await asyncio.sleep(0)
            await asyncio.gather(*(s.send_data(p)
                                   for s, p in zip(senders, payloads)))
            got = await asyncio.gather(*rxs)
            bad = sum(1 for g, p in zip(got, payloads) if g != p)
            if bad:
                ok = False
                print(f"  round {rnd + 1}: {bad} MISMATCHES")
    finally:
        hub.stop()
        await pump
    wall = time.perf_counter() - t0
    steps = hub.steps - steps0
    audio = steps * quantum / 48000
    print(f"B={batch} x {rounds} rounds ({payload_size} B payloads), "
          f"device stubbed: {'ALL OK' if ok else 'MISMATCH'}")
    print(f"  host wall {wall:.2f} s for {audio:.2f} s of audio "
          f"({steps} quanta) -> {wall / steps * 1e3:.1f} ms/quantum "
          f"host cost vs the {quantum / 48:.0f} ms budget "
          f"({'REALTIME' if wall < audio else 'OVER'}, "
          f"{audio / wall:.2f}x); {wall / rounds:.3f} s per round")
    snap = metrics.snapshot()["timings"]
    timers = {}
    for name in ("farm_hub.host_tx", "farm_hub.host_drain",
                 "farm_hub.soft_finalize", "farm_hub.chunk",
                 "farm_hub.yield_pump", "farm_hub.fetch_wait"):
        agg, old = snap.get(name), before.get(name)
        if agg:
            n = agg["count"] - (old["count"] if old else 0)
            total = agg["total_s"] - (old["total_s"] if old else 0.0)
            timers[name] = (n, total)
            print(f"  {name.split('.')[1]:12s} "
                  f"{total * 1e3 / max(n, 1):7.2f} ms mean x {n:5d} "
                  f"= {total:6.2f} s total")
    return {"ok": ok, "wall_s": wall, "steps": steps,
            "round_s": wall / rounds, "timers": timers}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--payload", type=int, default=40)
    p.add_argument("--quantum", type=int, default=4800)
    args = p.parse_args(argv)
    out = asyncio.run(run(args.batch, args.rounds, args.payload,
                          args.quantum))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
