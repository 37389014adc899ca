"""The port's ``BlindSoftFarmHub`` against the JAX package's.

The same scripted transmissions on a few wires of both hubs (XModem
packets of several lengths, two of one length in one cohort, control
bytes, two sends queued back to back on one wire, a junk byte run, an
empty packet, traffic both ways), no channel noise, the same number of
steps at the reference's 4800-sample quantum: the blind receivers drain
the same bytes step by step, the deframers emit the same wire events,
each channel queues the same frames, and both hubs' receivers count the
same events, decodes and erasures.  (With noise the two
packages draw different sequences, a torch.Generator against a JAX key,
so noisy runs compare by payloads only: test_torch_blind_hub.py.)"""

import asyncio

import numpy as np
import pytest

from tests.torch_port.torch_port_helpers import configs
from webaudio_modem_tpu.runtime.soft_hub import \
    BlindSoftFarmHub as JaxBlindSoftFarmHub
from webaudio_modem_tpu_torch.runtime.soft_hub import BlindSoftFarmHub
from webaudio_modem_tpu_torch.transports.xmodem import XModemPacket

STEPS = 14
MAX_PAYLOAD = 32
B = 5


def _packet(seq, payload):
    return XModemPacket.serialize(XModemPacket.create_data(seq, payload))


SENDS = {
    0: [("a", 0, _packet(1, bytes(range(10)))),
        ("a", 1, _packet(2, bytes(range(10, 20)))),   # one cohort with a0
        ("a", 2, b"\x06"), ("a", 2, b"\x04"),         # queued back to back
        ("b", 3, b"\x15")],
    3: [("b", 0, _packet(3, b"short")), ("a", 4, b"junk\x99"),
        ("a", 3, _packet(4, b""))],
}


def _frame(f):
    return (f.kind, f.seq, None if f.payload is None else bytes(f.payload),
            f.byte)


def _run(hub, drained_of):
    """Drive ``hub`` through SENDS for STEPS steps and a flush.  Returns
    the drains [(step, rx side, {wire: bytes})], the deframers' events
    per drain call, each channel's queued frames and the counters."""
    drains, events = [], []
    orig = hub._drain

    def spy(rx_side, out):
        counts, vals = drained_of(out)
        drains.append((hub.steps, rx_side,
                       {int(b): bytes(vals[b, :counts[b]])
                        for b in np.nonzero(counts)[0]}))
        orig(rx_side, out)

    hub._drain = spy
    for side in ("a", "b"):
        d = hub._deframers[side]
        d_drain = d.drain

        def record(vals, counts, side=side, d_drain=d_drain):
            ev = d_drain(vals, counts)
            events.append((side, [(ch, _frame(f)) for ch, f in ev]))
            return ev

        d.drain = record

    async def drive():
        tasks = []
        for t in range(STEPS):
            for side, wire, data in SENDS.get(t, ()):
                tasks.append(asyncio.ensure_future(
                    hub.channel(side, wire).modulate(data)))
            await asyncio.sleep(0)
            hub.step()
            await asyncio.sleep(0)
        hub.flush()
        await asyncio.gather(*tasks)

    asyncio.run(drive())
    frames = {}
    for side in ("a", "b"):
        for w in range(B):
            q = hub.channel(side, w)._frames_q
            frames[side, w] = []
            while not q.empty():
                frames[side, w].append(_frame(q.get_nowait()))
    status = hub.get_status()
    rx = {s: {k: status["rx"][s][k] for k in (
        "fed_quanta", "events_detected", "frames_decoded", "frames_erased",
        "headers_failed", "dropped_ring")} for s in ("a", "b")}
    return drains, events, frames, (rx, hub.steps)


@pytest.fixture(scope="module")
def runs():
    pc, jc, _, _ = configs()
    port = _run(BlindSoftFarmHub(pc, B, max_payload=MAX_PAYLOAD,
                                 device="cpu"), lambda out: out.ready())
    ref = _run(JaxBlindSoftFarmHub(jc, B, max_payload=MAX_PAYLOAD),
               lambda out: (np.asarray(out.byte_count),
                            np.asarray(out.bytes_out)))
    return port, ref


def test_drained_bytes_equal_step_by_step(runs):
    port, ref = runs
    assert port[0] == ref[0]
    # every scripted transmission decoded, each on its own wire and side
    got = {(side, w) for _, side, d in port[0] for w in d}
    assert got == {("b", 0), ("b", 1), ("b", 2), ("a", 3), ("a", 0),
                   ("b", 4), ("b", 3)}


def test_deframer_events_and_frames_equal(runs):
    port, ref = runs
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert ("packet", 1, bytes(range(10)), None) in port[2]["b", 0]
    assert ("packet", 2, bytes(range(10, 20)), None) in port[2]["b", 1]
    assert [f[3] for f in port[2]["b", 2]] == [0x06, 0x04]
    assert ("packet", 4, b"", None) in port[2]["b", 3]
    assert [f[3] for f in port[2]["a", 3]] == [0x15]


def test_receiver_counters_equal(runs):
    port, ref = runs
    assert port[3] == ref[3]
    rx, steps = port[3]
    assert steps == STEPS
    assert rx["b"]["frames_decoded"] == 6 and rx["a"]["frames_decoded"] == 2
    assert rx["a"]["frames_erased"] == rx["b"]["frames_erased"] == 0
