"""Farm-scale transport demo: N concurrent XModem sessions over ONE
batched modem farm per direction (the port's ``FarmLoopbackHub``).

Each of N independent "wires" carries a full ARQ session — sender and
receiver transports, FSK audio both ways, AWGN — while the DSP for all
wires runs as single [N, T] batched kernel launches and the decoded byte
streams are parsed by the native C++ deframer.

    python -m webaudio_modem_tpu_torch.examples.farm_transport_demo -n 64
    python -m webaudio_modem_tpu_torch.examples.farm_transport_demo \\
        -n 8 --device cpu
"""

from __future__ import annotations

import argparse
import asyncio
import time

from webaudio_modem_tpu_torch.models.config import FSKConfig
from webaudio_modem_tpu_torch.runtime.farm_channel import FarmLoopbackHub
from webaudio_modem_tpu_torch.sim import make_awgn_channel
from webaudio_modem_tpu_torch.transports.xmodem import XModemTransport
from webaudio_modem_tpu_torch.utils.trace import metrics


async def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--sessions", type=int, default=64)
    ap.add_argument("--noise", type=float, default=1e-4)
    ap.add_argument("--payload", type=int, default=96,
                    help="bytes per session")
    ap.add_argument("--baud", type=int, default=1200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    config = FSKConfig(baud_rate=args.baud)
    hub = FarmLoopbackHub(config, args.sessions, quantum=4800,
                          channel_fn=make_awgn_channel(args.noise, seed=0),
                          device=args.device)
    payloads = [bytes([i & 0xFF]) + f"session {i:04d} ".encode()
                + bytes((i + j) & 0xFF for j in range(args.payload))
                for i in range(args.sessions)]

    senders = [XModemTransport(hub.channel("a", i))
               for i in range(args.sessions)]
    receivers = [XModemTransport(hub.channel("b", i))
                 for i in range(args.sessions)]
    for t in senders + receivers:
        t.configure({"timeout_ms": 120000})

    print(f"{args.sessions} concurrent XModem sessions, "
          f"{args.payload + 14} B payload each, {args.baud} baud, "
          f"noise={args.noise} on {hub.device} "
          f"(native deframer: {hub.get_status()['native_deframer']})")
    t0 = time.time()
    pump = asyncio.ensure_future(hub.run())
    try:
        recv_tasks = [asyncio.ensure_future(r.receive_data())
                      for r in receivers]
        await asyncio.sleep(0)
        await asyncio.gather(*(s.send_data(p)
                               for s, p in zip(senders, payloads)))
        results = await asyncio.gather(*recv_tasks)
    finally:
        hub.stop()
        await pump
    wall = time.time() - t0

    ok = results == payloads
    total = sum(len(p) for p in payloads)
    audio = hub.steps * hub.quantum / config.sample_rate
    retrans = sum(s.get_statistics().packets_retransmitted
                  for s in senders)
    print(f"result: {'ALL OK' if ok else 'MISMATCH'} — {total} bytes "
          f"across {args.sessions} sessions in {wall:.1f}s wall "
          f"({audio:.1f}s simulated audio, {hub.steps} quanta, "
          f"{retrans} retransmits)")
    snap = metrics.snapshot()
    if "farm_hub.chunk" in snap["timings"]:
        t = snap["timings"]["farm_hub.chunk"]
        print(f"farm chunk: {t['count']} launches, "
              f"mean {t['mean_ms']:.1f} ms")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(asyncio.run(main()))
