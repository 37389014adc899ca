"""The port's copy of tests/runtime/test_farm_transport.py: concurrent
XModem sessions over ONE batched ``ModemFarm`` pair (the port's
``FarmLoopbackHub``, on the CPU), decoded bytes drained through the
native C++ deframer.

On the CPU each hub step pays K1's plain version for every sample of
both directions (~0.4-0.6 ms a sample, whatever B), so a one-fragment
transfer (~14 quanta of 4800 samples) costs about a minute.  The
reference's transfer cases therefore run as concurrent sessions on
separate wires of ONE hub (``_shared_run``, once per module), and each
reference test checks its own wires of that run:

  * wires 0-15: the 64-session case, cut to 16 sessions, AWGN 1e-4;
  * wires 16-17: the multi-fragment case, payloads of 40 + i bytes at a
    32-byte fragment size (two fragments; the reference sends 200 + i
    bytes at 128);
  * wire 18: the corrupted-frame case.  Its first data packet reaches
    the receiver with one payload byte changed (the same packet
    modulated with that byte flipped, sample for sample in its place),
    so the CRC fails, the receiver NAKs at once and the sender
    retransmits; the reference's zeroed quantum loses the packet and
    recovers at an 8 s wall-clock timeout, which the CPU's steps pass
    by themselves;
  * wire 19: sequential rounds, cut from three to two;
  * wires 20-23: idle (the independence case).

XModem's timeouts are wall-clock, so the transports wait
``ARQ_TIMEOUT_MS`` (120 s) and the sessions are held to zero
retransmissions, except wire 18's one.
"""

import asyncio

import numpy as np
import pytest

from tests.torch_port.torch_port_helpers import ARQ_TIMEOUT_MS
from webaudio_modem_tpu_torch.models.config import (DEFAULT_FSK_CONFIG,
                                                    FSKConfig, FSKParams)
from webaudio_modem_tpu_torch.ops import fsk_mod
from webaudio_modem_tpu_torch.runtime.farm_channel import (FarmDataChannel,
                                                           FarmLoopbackHub)
from webaudio_modem_tpu_torch.sim import awgn
from webaudio_modem_tpu_torch.transports.xmodem import (XModemPacket,
                                                        XModemTransport)
from webaudio_modem_tpu_torch.utils.abort import AbortController, AbortError

SESSIONS = range(0, 16)
MULTI = range(16, 18)
CORRUPT = 18
ROUNDS = 19
IDLE = range(20, 24)
B = 24
QUANTUM = 4800


def _session_payload(i):
    return bytes([i]) + f"session {i:03d} payload".encode() \
        + bytes(range(i % 32))


def _multi_payload(i):
    return bytes([0x40 + i]) * (40 + i)


CORRUPT_PAYLOAD = bytes([0x30]) * 24


class _Channel:
    """The shared run's channel: AWGN (1e-4, seeded) on the session
    wires; on wire ``CORRUPT``, the first data packet of side a replaced
    sample for sample by the same packet with one payload byte flipped.
    Called a->b, then b->a, each step."""

    def __init__(self):
        params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
        wire = bytearray(XModemPacket.serialize(
            XModemPacket.create_data(1, CORRUPT_PAYLOAD)))
        wire[4 + 5] ^= 0x5A
        self.altered = fsk_mod.modulate(params, bytes(wire), device="cpu")
        self.rng = np.random.RandomState(0)
        self.calls = 0
        self.start = None
        self.replaced = 0

    def __call__(self, frame):
        self.calls += 1
        frame = frame.copy()
        rows = list(SESSIONS)
        frame[rows] = awgn(frame[rows], 1e-4, self.rng)
        if self.calls % 2 == 0:
            return frame
        step = (self.calls - 1) // 2
        if self.start is None and np.abs(frame[CORRUPT]).max() > 0.1:
            self.start = step
        if self.start is not None:
            lo = (step - self.start) * QUANTUM
            if lo < len(self.altered):
                piece = self.altered[lo:lo + QUANTUM]
                frame[CORRUPT] = 0.0
                frame[CORRUPT, :len(piece)] = piece
                self.replaced += 1
        return frame


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
    chan = _Channel()
    hub = FarmLoopbackHub(DEFAULT_FSK_CONFIG, B, quantum=QUANTUM,
                          channel_fn=chan, device="cpu")
    out = {"hub": hub, "channel": chan, "rounds": [], "queues": []}
    sessions = _transports(hub, SESSIONS)
    multi = _transports(hub, MULTI, max_payload_size=32)
    (ctx, crx), = _transports(hub, [CORRUPT])
    (rtx, rrx), = _transports(hub, [ROUNDS])

    async def rounds():
        for rnd in range(2):
            out["rounds"].append(await _transfer(rtx, rrx,
                                                 bytes([rnd]) * 20))
            out["queues"].append((
                hub.channel("b", ROUNDS)._bytes_q.qsize(),
                hub.channel("b", ROUNDS)._frames_q.qsize(),
                hub.channel("a", ROUNDS)._bytes_q.qsize()))

    pump = asyncio.ensure_future(hub.run())
    try:
        results = await asyncio.gather(
            asyncio.gather(*(_transfer(tx, rx, _session_payload(i))
                             for (tx, rx), i in zip(sessions, SESSIONS))),
            asyncio.gather(*(_transfer(tx, rx, _multi_payload(i))
                             for (tx, rx), i in zip(multi, MULTI))),
            _transfer(ctx, crx, CORRUPT_PAYLOAD), rounds())
    finally:
        hub.stop()
        await pump
    out["sessions"], out["multi"], out["corrupt"], _ = results
    out["senders"] = {"sessions": [tx for tx, _ in sessions],
                      "multi": [tx for tx, _ in multi],
                      "corrupt": ctx, "rounds": rtx}
    out["corrupt_rx"] = crx
    return out


@pytest.fixture(scope="module")
def shared():
    return asyncio.run(_shared_run_async())


def _no_retransmissions(senders):
    return sum(s.get_statistics().packets_retransmitted for s in senders)


def test_64_concurrent_sessions_exact(shared):
    """Concurrent ARQ sessions over one batched audio stream with AWGN
    on (16 of the reference's 64); every payload arrives exactly."""
    assert shared["sessions"] == [_session_payload(i) for i in SESSIONS]
    status = shared["hub"].get_status()
    assert status["native_deframer"], \
        "C++ deframer must be on the farm drain path"
    for s in shared["senders"]["sessions"]:
        assert s.get_statistics().packets_sent >= 2  # data + EOT
    assert _no_retransmissions(shared["senders"]["sessions"]) == 0


def test_multi_fragment_farm_transfer(shared):
    """Payloads spanning several XModem fragments."""
    assert shared["multi"] == [_multi_payload(i) for i in MULTI]
    for s in shared["senders"]["multi"]:
        assert s.get_statistics().packets_sent >= 3  # 2 fragments + EOT
    assert _no_retransmissions(shared["senders"]["multi"]) == 0


def test_corrupted_frames_recovered_by_retry(shared):
    """A corrupted packet fails its CRC, the receiver NAKs, the sender
    retransmits, and the payload still arrives exactly."""
    assert shared["corrupt"] == CORRUPT_PAYLOAD
    assert shared["channel"].replaced > 0
    assert shared["senders"]["corrupt"].get_statistics() \
        .packets_retransmitted > 0
    assert shared["corrupt_rx"].get_statistics().packets_dropped > 0


def test_farm_sessions_are_independent(shared):
    """Channels with no traffic stay silent while others transfer."""
    hub = shared["hub"]
    for b in IDLE:
        assert hub.channel("b", b)._frames_q.empty()
        assert hub.channel("a", b)._frames_q.empty()
        assert hub.channel("b", b)._bytes_q.empty()


def test_sequential_rounds_queues_stay_bounded(shared):
    """Multi-round soak (two rounds): after each completed transfer
    round the per-channel queues are drained — the surface the consumer
    does not use stops filling."""
    assert shared["rounds"] == [bytes([rnd]) * 20 for rnd in range(2)]
    assert shared["queues"] == [(0, 0, 0)] * 2
    assert shared["senders"]["rounds"].get_statistics() \
        .packets_retransmitted == 0


async def test_farm_channel_frame_path_used():
    """The transport takes the framed (deframer) receive path over a
    FarmDataChannel."""
    hub = FarmLoopbackHub(DEFAULT_FSK_CONFIG, 2, device="cpu")
    ch = hub.channel("a", 0)
    t = XModemTransport(ch)
    assert ch.supports_frames
    assert t._frames_supported()


async def test_farm_channel_modulate_resolves_on_playout():
    hub = FarmLoopbackHub(DEFAULT_FSK_CONFIG, 2, quantum=4800, device="cpu")
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
    # drain the pipelined last quantum (step() overlaps device compute
    # with the previous quantum's host-side parsing)
    hub.flush()
    # and the peer side decoded the control byte through the deframer
    frame = await asyncio.wait_for(hub.channel("b", 0).next_frame(), 1)
    assert frame.kind == "control" and frame.byte == 0x06


async def test_aborted_modulate_stops_playout():
    # an aborted transmission must not keep feeding the wire
    hub = FarmLoopbackHub(DEFAULT_FSK_CONFIG, 2, quantum=512, device="cpu")
    ch = hub.channel("a", 0)
    ctrl = AbortController()
    task = asyncio.ensure_future(ch.modulate(b"X" * 40,
                                             signal=ctrl.signal))
    await asyncio.sleep(0)
    hub.step()          # starts playing
    ctrl.abort()
    with pytest.raises(AbortError):
        await task
    assert not hub.tx_pending("a", 0)  # remainder dropped
    # and the playing cohort row is deactivated — no further samples
    for c in hub._cohorts["a"]:
        assert not c.active.any()


async def test_farm_channel_reset_clears_pending():
    hub = FarmLoopbackHub(DEFAULT_FSK_CONFIG, 2, device="cpu")
    ch = hub.channel("a", 1)
    waiter = asyncio.ensure_future(ch.modulate(b"xx"))
    await asyncio.sleep(0)
    await ch.reset()
    with pytest.raises(AbortError):
        await waiter


async def test_psk_farm_transport_sessions():
    """The hub dispatches modulation through the model family: DBPSK
    configs carry ARQ sessions too."""
    from webaudio_modem_tpu_torch.models.psk import PSKConfig

    n = 4
    payloads = [bytes([0x50 + i]) * 24 for i in range(n)]
    hub = FarmLoopbackHub(PSKConfig(), n, device="cpu")
    pairs = _transports(hub, range(n))
    pump = asyncio.ensure_future(hub.run())
    try:
        results = await asyncio.gather(*(
            _transfer(tx, rx, p) for (tx, rx), p in zip(pairs, payloads)))
    finally:
        hub.stop()
        await pump
    assert results == payloads
    assert _no_retransmissions([tx for tx, _ in pairs]) == 0


def test_farm_hub_refuses_a_mesh():
    """The reference shards the hub's farms over a device mesh; the port
    has no mesh (ROADMAP queue 1, item 18) and refuses one instead of
    ignoring it."""
    with pytest.raises(NotImplementedError, match="item 18"):
        FarmLoopbackHub(DEFAULT_FSK_CONFIG, 8, mesh=object(), device="cpu")


def test_farm_hub_defaults_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        FarmLoopbackHub(DEFAULT_FSK_CONFIG, 2)


async def test_reset_wakes_blocked_waiters():
    # FarmDataChannel.reset drops coroutines blocked in
    # demodulate()/next_frame() with AbortError
    hub = FarmLoopbackHub(FSKConfig(baud_rate=1200), batch=2,
                          quantum=1024, device="cpu")
    ch = hub.channel("a", 0)
    waiter_b = asyncio.ensure_future(ch.demodulate())
    waiter_f = asyncio.ensure_future(ch.next_frame())
    await asyncio.sleep(0)          # let both block on their queues
    await ch.reset()
    for w in (waiter_b, waiter_f):
        with pytest.raises(AbortError):
            await w


def test_unconsumed_channel_backlog_bounded():
    # channels nobody consumes must not grow their queues forever
    hub = FarmLoopbackHub(FSKConfig(baud_rate=1200), batch=1,
                          quantum=1024, device="cpu")
    ch = hub.channel("a", 0)
    for _ in range(FarmDataChannel.UNCONSUMED_BACKLOG + 500):
        ch._deliver(b"x", [])
    assert ch._bytes_q.qsize() <= FarmDataChannel.UNCONSUMED_BACKLOG


async def test_pump_crash_fails_fast_not_deadlock():
    """An exception inside hub.step() poisons the hub: blocked
    modulate/demodulate waits raise immediately and later channel
    operations re-raise, instead of ARQ sessions hanging on queues only
    the dead pump can fill."""

    class Boom(RuntimeError):
        pass

    class CrashingHub(FarmLoopbackHub):
        def step(self):
            raise Boom("kernel launch failed")

    hub = CrashingHub(FSKConfig(baud_rate=1200), batch=2, quantum=1024,
                      device="cpu")
    ch_a, ch_b = hub.channel("a", 0), hub.channel("b", 0)
    # block BEFORE the crash: a demodulate wait and a queued modulate
    demod = asyncio.ensure_future(ch_b.demodulate())
    mod = asyncio.ensure_future(ch_a.modulate(b"hello"))
    await asyncio.sleep(0)
    pump = asyncio.ensure_future(hub.run())
    with pytest.raises(Boom):
        await pump
    with pytest.raises(Boom):
        await demod
    with pytest.raises(Boom):
        await mod
    # operations AFTER the crash re-raise instead of blocking
    with pytest.raises(Boom):
        await ch_a.modulate(b"more")
    with pytest.raises(Boom):
        await ch_b.demodulate()
