"""The port's copy of tests/runtime/test_blind_hub.py:
``BlindSoftFarmHub``, ARQ over the soft wire with a fully blind receive
path (``ops/soft_blind.BlindSoftBatchReceiver`` per direction: frames
discovered by the sync correlation, lengths read from decoded headers).

Every quantum costs the detector, K1's plain version over 4800 samples
in each direction whatever B, so the reference's transfer cases run as
concurrent sessions on the wires of ONE hub (``shared``) with on-device
AWGN 1e-4: wires 0-3 the device-AWGN sessions, wires 4-6 the staggered
sessions (started 0, 5 and 10 quanta apart), wire 7 the resend case,
wires 8-9 the back-to-back frames.  The reference suppresses wire 7's
first data frame and waits out XModem's timeout; here a payload byte of
that frame is corrupted as delivered (the packet CRC fails, the receiver
NAKs at once).  The transports wait ``ARQ_TIMEOUT_MS``.  The reference's
mesh case has no counterpart (``mesh=`` is refused, ROADMAP item 18)."""

import asyncio

import pytest
import torch

from tests.torch_port.torch_port_helpers import ARQ_TIMEOUT_MS
from webaudio_modem_tpu_torch.models.config import DEFAULT_FSK_CONFIG
from webaudio_modem_tpu_torch.ops import soft_fsk
from webaudio_modem_tpu_torch.runtime import BlindSoftFarmHub as Exported
from webaudio_modem_tpu_torch.runtime.soft_hub import BlindSoftFarmHub
from webaudio_modem_tpu_torch.sim import make_device_awgn
from webaudio_modem_tpu_torch.transports.xmodem import XModemTransport

AWGN = range(0, 4)
STAGGER = range(4, 7)
STAGGER_QUANTA = 5
RESEND = 7
ORDER = range(8, 10)
B = 10


def _awgn_payload(i):
    return bytes([i]) + f"blindhub {i:02d}".encode() \
        + bytes(range((i * 5) % 16))


def _stagger_payload(i):
    k = i - STAGGER[0]
    return f"staggered payload {k}".encode() * (k + 1)


RESEND_PAYLOAD = b"retransmit me blindly"


def _order_frames(i):
    k = i - ORDER[0]
    return [bytes([10 + k]), b"longer frame body %d" % k, bytes([20 + k]),
            bytes([30 + k])]


def _pair(hub, i):
    tx = XModemTransport(hub.channel("a", i))
    rx = XModemTransport(hub.channel("b", i))
    for t in (tx, rx):
        t.configure({"timeout_ms": ARQ_TIMEOUT_MS})
    return tx, rx


async def _transfer(hub, tx, rx, payload, start_step=0):
    recv = asyncio.ensure_future(rx.receive_data())
    # sessions start at DIFFERENT hub steps: TX cohorts no longer align,
    # so any schedule-shaped assumption in RX would decode wrong windows
    while hub.steps < start_step:
        await asyncio.sleep(0)
    await asyncio.sleep(0)
    await tx.send_data(payload)
    return await recv


async def _in_order(hub, i):
    """Several short frames on one wire in quick succession deliver in
    wire order (per-channel FIFO: bodies of different lengths resolve at
    different feeds)."""
    seq = _order_frames(i)
    want = b"".join(seq)
    a, b = hub.channel("a", i), hub.channel("b", i)

    async def collect():
        buf = b""
        while len(buf) < len(want):
            buf += await b.demodulate()
        return buf

    reader = asyncio.ensure_future(collect())
    for frame in seq:
        await a.modulate(frame)
    return await asyncio.wait_for(reader, ARQ_TIMEOUT_MS / 1e3)


async def _shared_run_async():
    hub = BlindSoftFarmHub(DEFAULT_FSK_CONFIG, B,
                           device_channel_fn=make_device_awgn(1e-4),
                           device="cpu")
    corrupted = []
    orig = hub._deliver

    def deliver(rx_side, events):
        # the resend wire's first data packet: flip its first payload
        # byte (SOH, seq, ~seq, LEN, payload, CRC) as delivered
        if rx_side == "b" and not corrupted:
            out = []
            for ch, pl in events:
                if ch == RESEND and len(pl) > 1:
                    pl = pl[:4] + bytes([pl[4] ^ 0x5A]) + pl[5:]
                    corrupted.append(len(pl))
                out.append((ch, pl))
            events = out
        orig(rx_side, events)

    hub._deliver = deliver
    pairs = {i: _pair(hub, i) for i in (*AWGN, *STAGGER, RESEND)}
    pump = asyncio.ensure_future(hub.run())
    try:
        got = await asyncio.gather(
            asyncio.gather(*(_transfer(hub, *pairs[i], _awgn_payload(i))
                             for i in AWGN)),
            asyncio.gather(*(_transfer(
                hub, *pairs[i], _stagger_payload(i),
                start_step=(i - STAGGER[0]) * STAGGER_QUANTA)
                for i in STAGGER)),
            _transfer(hub, *pairs[RESEND], RESEND_PAYLOAD),
            asyncio.gather(*(_in_order(hub, i) for i in ORDER)))
    finally:
        hub.stop()
        await pump
    return {"hub": hub, "awgn": got[0], "stagger": got[1],
            "resend": got[2], "order": got[3], "corrupted": corrupted,
            "pairs": pairs}


@pytest.fixture(scope="module")
def shared():
    return asyncio.run(_shared_run_async())


def test_blind_arq_sessions_with_device_awgn(shared):
    """Concurrent XModem sessions over the blind wire with on-device
    noise: every payload exact, no timing knowledge on the RX path."""
    assert shared["awgn"] == [_awgn_payload(i) for i in AWGN]
    st = shared["hub"].get_status()
    assert st["native_deframer"]
    rx = st["rx"]
    # each direction moved frames: data + EOT towards b, ACKs towards a
    assert rx["b"]["frames_decoded"] >= 2 * len(AWGN)
    assert rx["a"]["frames_decoded"] >= 2 * len(AWGN)
    assert rx["a"]["dropped_ring"] == rx["b"]["dropped_ring"] == 0
    for i in AWGN:
        assert shared["pairs"][i][0].get_statistics() \
            .packets_retransmitted == 0


def test_blind_staggered_sessions(shared):
    """Sessions launched at different hub steps (jittered TX): blind
    acquisition must not depend on cohort alignment."""
    assert shared["stagger"] == [_stagger_payload(i) for i in STAGGER]


def test_blind_corrupted_frame_retransmits(shared):
    """A data frame that arrives corrupted is refused by the packet CRC
    and resent over the blind wire; the transfer completes exactly."""
    assert shared["resend"] == RESEND_PAYLOAD
    assert shared["corrupted"], "the data frame never decoded"
    assert shared["pairs"][RESEND][0].get_statistics() \
        .packets_retransmitted >= 1


def test_blind_back_to_back_frames_in_order(shared):
    assert shared["order"] == [b"".join(_order_frames(i)) for i in ORDER]


async def test_blind_status_counts_events():
    hub = BlindSoftFarmHub(DEFAULT_FSK_CONFIG, 2, device="cpu")
    pump = asyncio.ensure_future(hub.run())
    try:
        await hub.channel("a", 0).modulate(b"hello")
        while hub._tx_active():
            await asyncio.sleep(0)
    finally:
        hub.stop()
        await pump
    rx = hub.get_status()["rx"]["b"]
    assert rx["events_detected"] == 1
    assert rx["frames_decoded"] == 1
    assert rx["headers_failed"] == 0
    assert hub.get_status()["rx"]["a"]["events_detected"] == 0


@pytest.mark.parametrize("batch", [1, 2])
def test_feeding_the_ring_view_equals_feeding_a_clone(batch):
    """The hub feeds its receiver a VIEW of the ring and clears the
    quantum after ``feed`` returns (the receiver uses a tensor on its
    device in place).  Safe only if nothing ``feed`` runs reads the
    samples after the detector's time-major copy: the same quanta fed as
    views (then cleared) and as clones give the same events, quantum by
    quantum, and the same receiver state.  B = 1 is the edge where the
    transposed view is already contiguous and K1 reads the ring itself."""
    hubs = [BlindSoftFarmHub(DEFAULT_FSK_CONFIG, batch, ring_quanta=8,
                             max_payload=8, device="cpu") for _ in range(2)]
    params = hubs[0]._params
    sig = soft_fsk.encode_frames_batch(
        params, [bytes([0x41 + k]) for k in range(batch)], device="cpu")
    for hub in hubs:
        hub._rings["a"][:, 2400:2400 + sig.shape[1]] = sig
    events = ([], [])
    for step in range(8):
        roff = step * hubs[0].quantum
        events[0].append(hubs[0]._consume(hubs[0]._rings["a"], roff, "b"))
        frame = hubs[1]._rings["a"].narrow(1, roff, hubs[1].quantum)
        events[1].append(hubs[1]._rx["b"].feed(frame.clone()))
        frame.zero_()
    events[0].append(hubs[0]._rx["b"].flush())
    events[1].append(hubs[1]._rx["b"].flush())
    assert events[0] == events[1]
    assert [p for ev in events[0] for p in ev] == \
        [(k, bytes([0x41 + k])) for k in range(batch)]
    assert float(hubs[0]._rings["a"].abs().max()) == 0.0
    rx0, rx1 = hubs[0]._rx["b"]._rx, hubs[1]._rx["b"]._rx
    assert torch.equal(rx0.ring, rx1.ring)
    assert torch.equal(rx0.demod.front, rx1.demod.front)


@pytest.mark.parametrize("kw", [{"rs_parity": 8}, {"body_code": object()}],
                         ids=["rs_parity", "body_code"])
def test_rs_and_block_body_modes_raise_naming_their_item(kw):
    with pytest.raises(NotImplementedError, match="item 14"):
        BlindSoftFarmHub(DEFAULT_FSK_CONFIG, 1, device="cpu", **kw)


def test_mesh_is_refused_naming_its_item():
    with pytest.raises(NotImplementedError, match="item 18"):
        BlindSoftFarmHub(DEFAULT_FSK_CONFIG, 8, mesh=object(), device="cpu")


def test_exported_and_defaults_to_the_card(monkeypatch):
    assert Exported is BlindSoftFarmHub
    hub = BlindSoftFarmHub(DEFAULT_FSK_CONFIG, 2, max_payload=40,
                           device="cpu")
    assert hub._rx["a"]._max_payload == 40
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        BlindSoftFarmHub(DEFAULT_FSK_CONFIG, 2)
