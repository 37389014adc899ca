"""The port's copy of tests/runtime/test_device_hub.py: ``DeviceFarmHub``,
the wire a tensor ring on the hub's device (the CPU here), host traffic
bytes-only.

As in test_torch_farm_transport.py, the reference's transfer cases run
as concurrent sessions on separate wires of ONE hub (``_shared_run``,
once per module; each step pays K1's plain version for every sample of
both directions): wires 0-127 carry the 128-session case, wires 128-135
the device-AWGN case, wires 136-139 the multi-fragment case (payloads of
40 + 7 i bytes at a 32-byte fragment size, two fragments; the reference
sends 200 + 7 i bytes at 128), all with on-device AWGN 1e-4 and a
13-quantum ring that the run wraps.  The transports wait
``ARQ_TIMEOUT_MS``; the sessions are held to zero retransmissions.
"""

import asyncio

import numpy as np
import pytest
import torch

from tests.torch_port.torch_port_helpers import ARQ_TIMEOUT_MS
from webaudio_modem_tpu_torch.models.config import (DEFAULT_FSK_CONFIG,
                                                    FSKConfig)
from webaudio_modem_tpu_torch.runtime.device_hub import DeviceFarmHub
from webaudio_modem_tpu_torch.runtime.farm_channel import FarmLoopbackHub
from webaudio_modem_tpu_torch.sim import make_device_awgn
from webaudio_modem_tpu_torch.transports.xmodem import (XModemPacket,
                                                        XModemTransport)
from webaudio_modem_tpu_torch.utils.abort import AbortController, AbortError

MANY = range(0, 128)
AWGN = range(128, 136)
MULTI = range(136, 140)
B = 140


def _many_payload(i):
    return bytes([i]) + b"ch" + bytes([i ^ 0x5A])


def _awgn_payload(i):
    k = i - AWGN[0]
    return bytes([k]) + f"devhub {k:02d}".encode() + bytes(range(k % 16))


def _multi_payload(i):
    k = i - MULTI[0]
    return bytes([0x60 + k]) * (40 + 7 * k)


def _transports(hub, wires, **config):
    pairs = []
    for i in wires:
        tx = XModemTransport(hub.channel("a", i))
        rx = XModemTransport(hub.channel("b", i))
        for t in (tx, rx):
            t.configure({"timeout_ms": ARQ_TIMEOUT_MS, **config})
        pairs.append((tx, rx))
    return pairs


async def _transfer(tx, rx, payload):
    recv = asyncio.ensure_future(rx.receive_data())
    await asyncio.sleep(0)
    await tx.send_data(payload)
    return await recv


async def _shared_run_async():
    hub = DeviceFarmHub(DEFAULT_FSK_CONFIG, B, ring_quanta=13,
                        device_channel_fn=make_device_awgn(1e-4),
                        device="cpu")
    pairs = {"many": _transports(hub, MANY), "awgn": _transports(hub, AWGN),
             "multi": _transports(hub, MULTI, max_payload_size=32)}
    payload = {"many": _many_payload, "awgn": _awgn_payload,
               "multi": _multi_payload}
    wires = {"many": MANY, "awgn": AWGN, "multi": MULTI}
    pump = asyncio.ensure_future(hub.run())
    try:
        groups = await asyncio.gather(*(
            asyncio.gather(*(_transfer(tx, rx, payload[k](i))
                             for (tx, rx), i in zip(pairs[k], wires[k])))
            for k in ("many", "awgn", "multi")))
    finally:
        hub.stop()
        await pump
    return {"hub": hub, "results": dict(zip(("many", "awgn", "multi"),
                                            groups)),
            "senders": {k: [tx for tx, _ in v] for k, v in pairs.items()}}


@pytest.fixture(scope="module")
def shared():
    return asyncio.run(_shared_run_async())


def _retransmitted(senders):
    return sum(s.get_statistics().packets_retransmitted for s in senders)


def test_concurrent_sessions_with_device_awgn(shared):
    """ARQ sessions over the device-resident wire with noise drawn on the
    device; every payload exact, C++ deframer on the drain path."""
    assert shared["results"]["awgn"] == [_awgn_payload(i) for i in AWGN]
    assert shared["hub"].get_status()["native_deframer"]
    for s in shared["senders"]["awgn"]:
        assert s.get_statistics().packets_sent >= 2
    assert _retransmitted(shared["senders"]["awgn"]) == 0


def test_multi_fragment_and_ring_wrap(shared):
    """Multi-fragment transfers long enough that the ring read/write
    pointers wrap."""
    hub = shared["hub"]
    assert shared["results"]["multi"] == [_multi_payload(i) for i in MULTI]
    # the transfer consumed more than one full ring revolution
    assert hub.steps * hub.quantum > hub.ring_len
    for s in shared["senders"]["multi"]:
        assert s.get_statistics().packets_sent >= 3  # 2 fragments + EOT


def test_128_concurrent_sessions_exact(shared):
    """128 concurrent ARQ sessions over the device-resident wire (the
    card's 4096 run is chip_smoke.py phase 19 and the port's
    examples/farm_endurance.py; this is the same topology)."""
    assert shared["results"]["many"] == [_many_payload(i) for i in MANY]
    assert shared["hub"].get_status()["native_deframer"]
    assert _retransmitted(shared["senders"]["many"]) == 0


def _scripted(hub, steps, sends):
    """Drive ``hub`` ``steps`` steps with ``sends`` (step -> [(side,
    wire, bytes)]) submitted before each step; returns the per-quantum
    drains [(rx side, {wire: bytes})] and each b-side wire's frames."""
    drains = []
    orig = hub._drain

    def spy(rx_side, pending):
        counts, vals = pending.ready()
        drains.append((rx_side, {int(b): bytes(vals[b, :counts[b]])
                                 for b in np.nonzero(counts)[0]}))
        orig(rx_side, pending)

    hub._drain = spy

    async def drive():
        tasks = []
        for t in range(steps):
            for side, wire, data in sends.get(t, ()):
                tasks.append(asyncio.ensure_future(
                    hub.channel(side, wire).modulate(data)))
            await asyncio.sleep(0)
            hub.step()
            await asyncio.sleep(0)
        hub.flush()
        await asyncio.gather(*tasks)

    asyncio.run(drive())
    frames = {w: [] for w in range(hub.batch)}
    for w in frames:
        q = hub.channel("b", w)._frames_q
        while not q.empty():
            frames[w].append(q.get_nowait())
    return drains, frames


def test_payloads_match_host_hub():
    """The same transmissions (no noise) through the host-playout hub and
    the device hub: the same bytes drained quantum by quantum, the same
    wire events, and every packet's payload exact."""
    n = 3
    payloads = [bytes([0x41 + i]) * 30 for i in range(n)]
    sends = {0: [("a", i, XModemPacket.serialize(
        XModemPacket.create_data(1 + i, p))) for i, p in enumerate(payloads)]}
    sends[1] = [("b", 1, bytes([0x06]))]
    dev = _scripted(DeviceFarmHub(DEFAULT_FSK_CONFIG, n, device="cpu"),
                    6, sends)
    host = _scripted(FarmLoopbackHub(DEFAULT_FSK_CONFIG, n, device="cpu"),
                     6, sends)
    assert dev[0] == host[0]
    assert dev[1] == host[1]
    for i, p in enumerate(payloads):
        packets = [f for f in dev[1][i] if f.kind == "packet"]
        assert [(f.seq, f.payload) for f in packets] == [(1 + i, p)]


async def test_modulate_resolves_on_playout():
    hub = DeviceFarmHub(DEFAULT_FSK_CONFIG, 2, device="cpu")
    ch = hub.channel("a", 0)
    done = []

    async def tx():
        await ch.modulate(b"\x06")
        done.append(True)

    task = asyncio.ensure_future(tx())
    await asyncio.sleep(0)
    assert not done  # nothing pumped yet
    for _ in range(10):
        hub.step()
        await asyncio.sleep(0)
        if done:
            break
    assert done
    await task
    hub.flush()
    frame = await asyncio.wait_for(hub.channel("b", 0).next_frame(), 1)
    assert frame.kind == "control" and frame.byte == 0x06


async def test_aborted_modulate_clears_ring():
    hub = DeviceFarmHub(FSKConfig(baud_rate=1200), 2, quantum=512,
                        ring_quanta=64, device="cpu")
    ch = hub.channel("a", 0)
    ctrl = AbortController()
    task = asyncio.ensure_future(ch.modulate(b"X" * 40,
                                             signal=ctrl.signal))
    await asyncio.sleep(0)
    hub.step()          # launches + starts playing
    ctrl.abort()
    with pytest.raises(AbortError):
        await task
    assert not hub.tx_pending("a", 0)
    # everything beyond the already-consumed quantum is silence now
    ring = hub._rings["a"].numpy()
    start = hub.steps * hub.quantum
    assert np.abs(ring[0, start:]).max() == 0.0
    # the peer decodes at most a junk fragment, never a full frame; 40
    # steps (the reference runs 80) outlast the 36 quanta the signal
    # would have taken
    for _ in range(40):
        hub.step()
    hub.flush()
    frames_q = hub.channel("b", 0)._frames_q
    while not frames_q.empty():
        assert frames_q.get_nowait().kind != "packet"


async def test_reset_rejects_pending_and_silences_channel():
    hub = DeviceFarmHub(DEFAULT_FSK_CONFIG, 2, device="cpu")
    ch = hub.channel("a", 1)
    waiter = asyncio.ensure_future(ch.modulate(b"xx"))
    await asyncio.sleep(0)
    await ch.reset()
    with pytest.raises(AbortError):
        await waiter


async def test_oversized_signal_raises():
    hub = DeviceFarmHub(DEFAULT_FSK_CONFIG, 2, ring_quanta=4, device="cpu")
    ch = hub.channel("a", 0)
    task = asyncio.ensure_future(ch.modulate(bytes(120)))
    await asyncio.sleep(0)
    with pytest.raises(ValueError, match="ring_quanta"):
        hub.step()
    task.cancel()


async def test_queued_signal_defers_until_ring_has_room():
    """Two back-to-back sends on one channel: the second waits for the
    first playout (per-channel busy) and both arrive in order."""
    hub = DeviceFarmHub(DEFAULT_FSK_CONFIG, 1, ring_quanta=16, device="cpu")
    pump = asyncio.ensure_future(hub.run())
    a = hub.channel("a", 0)
    b = hub.channel("b", 0)
    try:
        await a.modulate(b"\x15")   # NAK
        await a.modulate(b"\x06")   # ACK
        kinds = []
        for _ in range(2):
            f = await asyncio.wait_for(b.next_frame(), 120)
            kinds.append(f.byte)
        assert kinds == [0x15, 0x06]
    finally:
        hub.stop()
        await pump


async def test_bytes_only_host_traffic():
    """The per-quantum host<->device traffic is the decoded-byte
    aggregates only: the pump is handed the ring, a tensor on the hub's
    device, never a host-built numpy frame."""
    hub = DeviceFarmHub(DEFAULT_FSK_CONFIG, 4,
                        device_channel_fn=make_device_awgn(1e-4),
                        device="cpu")
    seen = []
    orig = hub._pump

    def spy(ring, state, roff, generator):
        seen.append((ring, type(roff), generator))
        return orig(ring, state, roff, generator)

    hub._pump = spy
    ch = hub.channel("a", 0)
    task = asyncio.ensure_future(ch.modulate(b"\x06"))
    await asyncio.sleep(0)
    for _ in range(3):
        hub.step()
        await asyncio.sleep(0)
    hub.flush()
    await task
    assert len(seen) == 6
    for ring, roff_t, gen in seen:
        # the wire argument is a tensor on the hub's device, not numpy
        assert isinstance(ring, torch.Tensor)
        assert ring.device == hub.device
        assert ring.shape == (4, hub.ring_len)
        assert roff_t is int
        assert isinstance(gen, torch.Generator)
        assert gen.device == hub.device


def test_device_hub_refuses_a_mesh():
    """The reference shards the ring wire over a device mesh; the port
    has no mesh (ROADMAP queue 1, item 18) and refuses one."""
    with pytest.raises(NotImplementedError, match="item 18"):
        DeviceFarmHub(DEFAULT_FSK_CONFIG, 8, mesh=object(), device="cpu")


def test_device_hub_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        DeviceFarmHub(DEFAULT_FSK_CONFIG, 2)


def test_ring_writes_wrap_and_keep_other_rows():
    """The masked write selects (does not add), keeps the rows outside
    the mask, and splits at the ring's end: a write that wraps, one
    beside another row's live signal, a uniform-row write and an abort
    clear, held against numpy."""
    hub = DeviceFarmHub(DEFAULT_FSK_CONFIG, 3, quantum=480, ring_quanta=4,
                        device="cpu")
    rng = np.random.default_rng(5)
    ring = hub._rings["a"]
    want = np.zeros((3, hub.ring_len), np.float32)
    live = rng.standard_normal(960).astype(np.float32)
    ring[2, 480:1440] = torch.from_numpy(live)      # row 2's live signal
    want[2, 480:1440] = live
    sig = rng.standard_normal((3, 960)).astype(np.float32)
    mask = torch.tensor([True, True, False])
    hub._ring_write(ring, torch.from_numpy(sig), mask, 480)
    want[:2, 480:1440] = sig[:2]
    np.testing.assert_array_equal(ring.numpy(), want)
    # a write of 960 samples at offset 1440 of a 1920-sample ring wraps
    sig2 = rng.standard_normal((3, 960)).astype(np.float32)
    mask2 = torch.tensor([False, True, True])
    hub._ring_write(ring, torch.from_numpy(sig2[:, :480]), mask2, 1440)
    hub._ring_write(ring, torch.from_numpy(sig2[:, 480:]), mask2, 0)
    want[1:, 1440:] = sig2[1:, :480]
    want[1:, :480] = sig2[1:, 480:]
    np.testing.assert_array_equal(ring.numpy(), want)
    row = rng.standard_normal(480).astype(np.float32)
    hub._ring_write_row(ring, torch.from_numpy(row),
                        torch.tensor([True, False, False]), 960)
    want[0, 960:1440] = row
    np.testing.assert_array_equal(ring.numpy(), want)
    hub._ring_clear(ring, torch.tensor([True, False, True]), 240, 960)
    want[1, 240:1200] = 0.0
    np.testing.assert_array_equal(ring.numpy(), want)


def test_pump_copies_the_frame_before_the_clear():
    """The pump reads its quantum before zeroing it: with no channel
    function the demodulator is handed a view of the ring, and its
    decode equals that of a copy taken first."""
    hub = DeviceFarmHub(DEFAULT_FSK_CONFIG, 2, quantum=480, ring_quanta=4,
                        device="cpu")
    from webaudio_modem_tpu_torch.ops import fsk_mod

    sig = fsk_mod.modulate_batch(hub._params, [b"\x55", b"\x0f"],
                                 device="cpu")[:, :480]
    ring = hub._rings["a"]
    ring[:, 480:960] = sig
    state = hub._states["b"]
    _, want_state, want, _ = hub._pump(ring.clone(), state, 480, None)
    ring, got_state, got, _ = hub._pump(ring, state, 480, None)
    assert float(ring.abs().max()) == 0.0
    for k in vars(want):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert torch.equal(got_state.front, want_state.front)
