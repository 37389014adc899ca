"""The port's ``FarmLoopbackHub`` against the JAX package's.

The same scripted transmissions on a few wires of both hubs (XModem
packets of several lengths, control bytes, a junk byte run, two sends
queued back to back on one wire, traffic both ways), no channel noise,
the same number of steps at the reference's 4800-sample quantum: the
bytes each side drains are equal quantum by quantum, and so are the wire
events the deframers emit and each channel's queued frames."""

import asyncio

import numpy as np
import pytest

from tests.torch_port.torch_port_helpers import configs
from webaudio_modem_tpu.runtime.farm_channel import \
    FarmLoopbackHub as JaxFarmLoopbackHub
from webaudio_modem_tpu_torch.runtime.farm_channel import FarmLoopbackHub
from webaudio_modem_tpu_torch.transports.xmodem import XModemPacket

STEPS = 7
B = 5


def _packet(seq, payload):
    return XModemPacket.serialize(XModemPacket.create_data(seq, payload))


SENDS = {
    0: [("a", 0, _packet(1, bytes(range(30)))),
        ("a", 1, b"\x06"), ("a", 1, b"\x04"),        # queued back to back
        ("b", 2, b"\x15"),
        ("a", 3, _packet(2, b"short"))],
    1: [("b", 0, b"\x06"), ("a", 4, b"junk\x99")],
    2: [("b", 3, _packet(7, bytes([0xA5]) * 12)),
        ("a", 2, _packet(3, b""))],
}


def _frame(f):
    return (f.kind, f.seq, None if f.payload is None else bytes(f.payload),
            f.byte)


def _run(hub, drained_of):
    """Drive ``hub`` through SENDS for STEPS steps and a flush.  Returns
    the per-quantum drains [(rx side, {wire: bytes})], the deframers'
    events per drain call and each channel's queued frames."""
    drains, events = [], []
    orig = hub._drain

    def spy(rx_side, out):
        counts, vals = drained_of(out)
        drains.append((rx_side, {int(b): bytes(vals[b, :counts[b]])
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
    return drains, events, frames


@pytest.fixture(scope="module")
def runs():
    pc, jc, _, _ = configs()
    port = _run(FarmLoopbackHub(pc, B, device="cpu"),
                lambda pending: pending.ready())
    ref = _run(JaxFarmLoopbackHub(jc, B),
               lambda out: (np.asarray(out.byte_count),
                            np.asarray(out.bytes_out)))
    return port, ref


def test_drained_bytes_equal_quantum_by_quantum(runs):
    port, ref = runs
    assert len(port[0]) == len(ref[0]) == 2 * STEPS
    assert port[0] == ref[0]
    # the script decoded something on every wire it used
    got = {(side, w) for side, d in port[0] for w in d}
    assert got == {("b", 0), ("b", 1), ("a", 2), ("b", 3), ("b", 4),
                   ("a", 0), ("b", 2), ("a", 3)}


def test_deframer_events_and_frames_equal(runs):
    port, ref = runs
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert ("packet", 1, bytes(range(30)), None) in port[2]["b", 0]
    assert [f[3] for f in port[2]["b", 1]] == [0x06, 0x04]
    assert ("packet", 3, b"", None) in port[2]["b", 2]
