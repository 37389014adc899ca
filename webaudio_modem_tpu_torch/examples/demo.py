"""CLI demo: bring up two modem stations on a simulated loopback audio
graph and transfer text (or any file) over the XModem transport, with
progress events and transport statistics.  The modems run on the card
unless ``--device cpu`` is given.

    python -m webaudio_modem_tpu_torch.examples.demo
    python -m webaudio_modem_tpu_torch.examples.demo --message "hi there"
    python -m webaudio_modem_tpu_torch.examples.demo --file payload.bin
    python -m webaudio_modem_tpu_torch.examples.demo --noise 1e-4 --baud 300
    python -m webaudio_modem_tpu_torch.examples.demo --fec    # FEC framing
    python -m webaudio_modem_tpu_torch.examples.demo --soft   # soft-FEC PHY

``--fec`` wraps the payload in one convolutional FEC frame
(``transports/fec_frame.FrameEncoder``; the received bytes go through a
``FrameDecoder``, whose Viterbi runs on the device); ``--soft`` replaces
the hard UART modem with the soft-FEC physical layer (``SoftModemCore``:
coded frames, no start / stop bits).
"""

from __future__ import annotations

import argparse
import asyncio
import sys
import time


async def main(argv=None) -> int:
    from webaudio_modem_tpu_torch.models.config import FSKConfig
    from webaudio_modem_tpu_torch.runtime import AudioGraph, FSKProcessor
    from webaudio_modem_tpu_torch.sim import make_awgn_channel
    from webaudio_modem_tpu_torch.transports.xmodem import XModemTransport

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--message", default="Hello from the GPU modem!")
    ap.add_argument("--file", default=None)
    ap.add_argument("--baud", type=int, default=1200)
    ap.add_argument("--noise", type=float, default=0.0,
                    help="AWGN noise power on the graph")
    ap.add_argument("--quantum", type=int, default=512)
    ap.add_argument("--timeout-ms", type=float, default=30000)
    ap.add_argument("--fec", action="store_true",
                    help="wrap the payload in a convolutional FEC frame "
                         "(rate-1/2 K=7 + Viterbi)")
    ap.add_argument("--soft", action="store_true",
                    help="replace the hard UART modem with the soft FEC "
                         "physical layer (SoftModemCore)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.soft and args.fec:
        ap.error("--soft already codes every frame; drop --fec")

    if args.file:
        with open(args.file, "rb") as f:
            payload = f.read()
    else:
        payload = args.message.encode()
    if args.fec:
        from webaudio_modem_tpu_torch.transports.fec_frame import \
            FrameEncoder

        data = FrameEncoder.encode_frame(payload)
        print(f"FEC framing: {len(payload)} B payload -> {len(data)} B "
              f"coded frame")
    else:
        data = payload
    config = FSKConfig(baud_rate=args.baud)

    # system bring-up: two stations on one loopback graph
    def station(name):
        core = None
        if args.soft:
            from webaudio_modem_tpu_torch.models import SoftModemCore

            core = SoftModemCore(device=args.device)
        proc = FSKProcessor(name=name, core=core, device=args.device)
        proc.configure(config)
        return proc

    sender_proc, receiver_proc = station("sender"), station("receiver")
    channel_fn = make_awgn_channel(args.noise) if args.noise else None
    graph = AudioGraph(quantum=args.quantum, channel_fn=channel_fn)
    graph.connect(sender_proc)
    graph.connect(receiver_proc)

    sender = XModemTransport(sender_proc)
    receiver = XModemTransport(receiver_proc)
    for t in (sender, receiver):
        t.configure({"timeout_ms": args.timeout_ms, "max_retries": 5})

    receiver.on("fragmentReceived", lambda ev: print(
        f"  fragment {ev.data['seq_num']}: "
        f"{ev.data['total_bytes_received']} bytes received"))

    print(f"transferring {len(data)} bytes at {args.baud} baud "
          f"(noise power {args.noise}) on {args.device}...")
    t0 = time.time()
    drive = asyncio.ensure_future(graph.run())
    try:
        send_task = asyncio.ensure_future(sender.send_data(data))
        received = await receiver.receive_data()
        await send_task
    finally:
        graph.stop()
        await drive
    wall = time.time() - t0

    if args.fec:
        from webaudio_modem_tpu_torch.transports.fec_frame import \
            FrameDecoder

        frames = FrameDecoder(device=args.device).process(received)
        received = frames[0] if frames else b""
        ok = received == payload
    else:
        ok = received == data
    audio_seconds = graph.steps * args.quantum / config.sample_rate
    print(f"result: {'OK' if ok else 'MISMATCH'} — {len(received)} bytes "
          f"in {wall:.2f}s wall ({audio_seconds:.1f}s simulated audio)")
    stats = sender.get_statistics()
    print(f"sender stats: {stats.packets_sent} packets, "
          f"{stats.packets_retransmitted} retransmitted, "
          f"{stats.bytes_transferred} bytes")
    from webaudio_modem_tpu_torch.utils.trace import metrics

    snap = metrics.snapshot()
    print(f"metrics: {snap['counters']}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(asyncio.run(main()))
