"""Farm-transport endurance on the card: N concurrent XModem ARQ sessions
over ONE device-resident hub.

Every session runs the complete stop-and-wait protocol (initial NAK,
data packets, ACKs, EOT) over the batched farm wire, a tensor ring on
the card: per audio quantum the host launches one pump per direction
(K1 + K2, ``DeviceFarmHub``) and receives ONLY the decoded byte
aggregates, drained through the batched C++ deframer.

    python -m webaudio_modem_tpu_torch.examples.farm_endurance \\
        --batch 4096 --rounds 3

``--soft`` runs the same topology over the soft-decision FEC wire
(``runtime/soft_hub.SoftFarmHub``: coded frames synthesized on the card,
one fused window decode per transmission):

    python -m webaudio_modem_tpu_torch.examples.farm_endurance --soft \\
        --batch 4096 --rounds 3

``--blind`` (implies the soft wire) swaps in the fully blind receive
path (``runtime/soft_hub.BlindSoftFarmHub``): frames are acquired by the
streaming sync scan and lengths read from decoded headers.
``--rs-parity`` / ``--body`` (the RS outer code, LDPC / turbo bodies)
are slice E of the port (ROADMAP queue 1, item 14) and raise.

Prints per-round results, per-quantum host time (from the metrics
timers), and a final ALL OK / MISMATCH verdict with RSS.  Exits non-zero
on any payload mismatch.
"""

from __future__ import annotations

import argparse
import asyncio
import resource
import sys
import time

BODY_NOT_PORTED = ("--rs-parity / --body: the RS outer code and the LDPC / "
                   "turbo body codes are ported in slice E (ROADMAP queue "
                   "1, item 14)")


def _rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def soft_ring_quanta(config, quantum: int, rs_parity: int = 0,
                     body_code=None) -> int:
    """Quanta a soft wire's ring needs: the longest frame (a 133-byte
    XModem packet) plus slack, as the reference sizes it."""
    from webaudio_modem_tpu_torch.models.config import FSKParams
    from webaudio_modem_tpu_torch.ops import soft_fsk

    params = FSKParams.from_config(config)
    return -(-soft_fsk.frame_signal_length(params, 133, rs_parity,
                                           body_code) // quantum) + 2


def make_soft_hub(config, batch: int, quantum: int, ring_quanta: int,
                  chan, blind: bool, device, rs_parity: int = 0,
                  body_code=None):
    """The soft-FEC hub of ``--soft`` (``SoftFarmHub``) or ``--blind``
    (``BlindSoftFarmHub``, payloads up to 160 bytes), its ring at least
    ``soft_ring_quanta`` quanta.  ``rs_parity`` / ``body_code`` are slice
    E of the port and raise (ROADMAP queue 1, item 14)."""
    from webaudio_modem_tpu_torch.runtime.soft_hub import (BlindSoftFarmHub,
                                                           SoftFarmHub)

    cls = BlindSoftFarmHub if blind else SoftFarmHub
    kw = {"max_payload": 160} if blind else {}
    ring = max(ring_quanta, soft_ring_quanta(config, quantum, rs_parity,
                                             body_code))
    return cls(config, batch, quantum=quantum, ring_quanta=ring,
               device_channel_fn=chan, rs_parity=rs_parity,
               body_code=body_code, device=device, **kw)


def round_payloads(rnd: int, batch: int, payload_size: int):
    """Round ``rnd``'s payloads: distinct per session and per round."""
    return [bytes([rnd & 0xFF, i & 0xFF, (i >> 8) & 0xFF])
            + bytes((rnd * 131 + i * 7 + k) & 0xFF
                    for k in range(payload_size - 3))
            for i in range(batch)]


async def run(batch: int, rounds: int, payload_size: int,
              noise_power: float, quantum: int, ring_quanta: int,
              timeout_ms: float, soft: bool = False, blind: bool = False,
              stages: bool = False, device: str = "cuda",
              rs_parity: int = 0, body: str = "") -> int:
    if rs_parity or body:
        raise NotImplementedError(BODY_NOT_PORTED)
    from webaudio_modem_tpu_torch.models.config import DEFAULT_FSK_CONFIG
    from webaudio_modem_tpu_torch.sim import make_device_awgn
    from webaudio_modem_tpu_torch.transports.xmodem import XModemTransport
    from webaudio_modem_tpu_torch.utils.trace import metrics

    chan = make_device_awgn(noise_power) if noise_power else None
    soft = soft or blind
    if soft:
        hub = make_soft_hub(DEFAULT_FSK_CONFIG, batch, quantum, ring_quanta,
                            chan, blind, device)
        kind = f"{'BLIND ' if blind else ''}soft-FEC (conv)"
    else:
        from webaudio_modem_tpu_torch.runtime.device_hub import \
            DeviceFarmHub

        hub = DeviceFarmHub(DEFAULT_FSK_CONFIG, batch, quantum=quantum,
                            ring_quanta=ring_quanta, device_channel_fn=chan,
                            device=device)
        kind = "hard-UART"
    print(f"{batch} concurrent XModem sessions over the {kind} wire "
          f"on {hub.device}, {payload_size} B payload, "
          f"{DEFAULT_FSK_CONFIG.baud_rate} baud, noise={noise_power} "
          f"(native deframer: {hub._deframers['a'].is_native}, "
          f"ring {hub.ring_len} samples/side)")

    senders = [XModemTransport(hub.channel("a", i)) for i in range(batch)]
    receivers = [XModemTransport(hub.channel("b", i))
                 for i in range(batch)]
    # a generous timeout for the warm-up (the first launches build the
    # kernels); the configured timeout applies from round 1
    for t in (senders[0], receivers[0]):
        t.configure({"timeout_ms": 600000})

    pump = asyncio.ensure_future(hub.run())
    ok = True
    total_bytes = 0
    # warm-up: one single-session transfer builds every kernel and runs
    # every path (pump, control + packet synthesis, ring writes) BEFORE
    # the fleet starts, so no first-use stall eats the ARQ wall-clock
    # timeouts
    warm_rx = asyncio.ensure_future(receivers[0].receive_data())
    await asyncio.sleep(0)
    await senders[0].send_data(bytes(payload_size))
    assert await warm_rx == bytes(payload_size)
    print(f"  warmup transfer OK ({hub.steps} quanta)", flush=True)
    for t in senders + receivers:
        t.configure({"timeout_ms": timeout_ms})

    t0 = time.perf_counter()
    try:
        for rnd in range(rounds):
            payloads = round_payloads(rnd, batch, payload_size)
            t_rnd = time.perf_counter()
            steps0 = hub.steps
            snap_r0 = metrics.snapshot()["timings"] if stages else None
            recv_tasks = [asyncio.ensure_future(r.receive_data())
                          for r in receivers]
            await asyncio.sleep(0)
            send_tasks = [asyncio.ensure_future(s.send_data(p))
                          for s, p in zip(senders, payloads)]
            await asyncio.gather(*send_tasks)
            results = await asyncio.gather(*recv_tasks)
            bad = sum(1 for r, p in zip(results, payloads) if r != p)
            total_bytes += sum(len(p) for p in payloads)
            dt = time.perf_counter() - t_rnd
            print(f"  round {rnd + 1}/{rounds}: "
                  f"{'OK' if bad == 0 else f'{bad} MISMATCHES'} — "
                  f"{batch} transfers in {dt:.1f}s / "
                  f"{hub.steps - steps0} quanta "
                  f"({dt / max(hub.steps - steps0, 1) * 1000:.0f} ms/"
                  f"quantum, RSS {_rss_mb():.0f} MB)", flush=True)
            if stages:
                # per-round stage deltas per quantum
                snap_r1 = metrics.snapshot()["timings"]
                q = max(hub.steps - steps0, 1)
                deltas = sorted(
                    ((k, v["total_s"]
                      - snap_r0.get(k, {"total_s": 0.0})["total_s"])
                     for k, v in snap_r1.items()),
                    key=lambda kv: -kv[1])
                print("    stages ms/q: " + "  ".join(
                    f"{k.split('.', 1)[-1]}={v / q * 1e3:.1f}"
                    for k, v in deltas[:9] if v > 0.0005), flush=True)
            if bad:
                ok = False
                break
    finally:
        hub.stop()
        await pump

    wall = time.perf_counter() - t0
    retx = sum(s.get_statistics().packets_retransmitted for s in senders)
    snap = metrics.snapshot()["timings"]

    def t_ms(name):
        agg = snap.get(name)
        return (f"{agg['mean_ms']:.2f} ms mean / {agg['max_ms']:.1f} ms "
                f"max over {agg['count']}") if agg else "n/a"

    audio_s = hub.steps * quantum / DEFAULT_FSK_CONFIG.sample_rate
    print(f"result: {'ALL OK' if ok else 'MISMATCH'} — "
          f"{total_bytes} bytes across {batch} sessions x {rounds} "
          f"rounds in {wall:.1f}s wall ({audio_s:.1f}s simulated audio, "
          f"{retx} retransmits, RSS {_rss_mb():.0f} MB)")
    print(f"host tx/launch per direction-quantum: "
          f"{t_ms('farm_hub.host_tx')}")
    print(f"host drain per direction-quantum:    "
          f"{t_ms('farm_hub.host_drain')}")
    print(f"device fetch wait per drain:         "
          f"{t_ms('farm_hub.fetch_wait')}")
    if snap.get("farm_hub.soft_finalize"):
        print(f"soft window finalize per decode:     "
              f"{t_ms('farm_hub.soft_finalize')}")
    print(f"launch+drain (chunk) per direction-quantum: "
          f"{t_ms('farm_hub.chunk')}")
    print(f"event-loop yield pump per quantum:   "
          f"{t_ms('farm_hub.yield_pump')}")

    def total_s(name):
        agg = snap.get(name)
        return agg["mean_ms"] * agg["count"] / 1e3 if agg else 0.0

    budget = {n: total_s(f"farm_hub.{n}") for n in
              ("host_tx", "host_drain", "soft_finalize", "fetch_wait",
               "chunk", "yield_pump")}
    print("host budget totals (s): " + ", ".join(
        f"{k}={v:.2f}" for k, v in budget.items())
        + f" | wall {wall:.2f}")
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--payload", type=int, default=40,
                   help="payload bytes per session per round")
    p.add_argument("--noise", type=float, default=1e-4)
    p.add_argument("--quantum", type=int, default=4800)
    p.add_argument("--ring-quanta", type=int, default=16)
    p.add_argument("--timeout-ms", type=float, default=30000)
    p.add_argument("--soft", action="store_true",
                   help="run over the soft-FEC wire "
                        "(runtime/soft_hub.SoftFarmHub)")
    p.add_argument("--blind", action="store_true",
                   help="soft wire with the fully blind receive path "
                        "(runtime/soft_hub.BlindSoftFarmHub)")
    p.add_argument("--rs-parity", type=int, default=0,
                   help="soft wire: RS parity symbols (slice E: raises)")
    p.add_argument("--body", default="",
                   help="soft wire body code: ldpc | turbo (slice E: "
                        "raises)")
    p.add_argument("--stages", action="store_true",
                   help="print per-round stage deltas (ms/quantum)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return asyncio.run(run(args.batch, args.rounds, args.payload,
                           args.noise, args.quantum, args.ring_quanta,
                           args.timeout_ms, soft=args.soft,
                           blind=args.blind, stages=args.stages,
                           device=args.device, rs_parity=args.rs_parity,
                           body=args.body))


if __name__ == "__main__":
    sys.exit(main())
