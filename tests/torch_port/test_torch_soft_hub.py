"""The port's copy of tests/runtime/test_soft_hub.py: ``SoftFarmHub``,
farm-scale ARQ over the soft-decision FEC wire, the wire a tensor ring
on the hub's device (the CPU here).

Each window decode runs K1's plain version over every sample of the
window, whatever B, so the reference's transfer cases run as concurrent
sessions on the wires of ONE hub (``shared``, once per module) with
on-device AWGN 1e-4: wires 0-3 the device-AWGN sessions, wire 4 the
resend case, wire 5 the back-to-back control frames.  The reference
erases wire 4's first data frame and waits out XModem's timeout; on the
CPU a window decode takes seconds of wall clock, so the port corrupts a
payload byte of that frame as decoded (the packet CRC fails, the
receiver NAKs at once) and the erasure bookkeeping is held apart
(``test_erased_frames_are_counted_and_not_delivered``).  The transports
wait ``ARQ_TIMEOUT_MS``.  The reference's mesh cases have no
counterpart (the hub refuses ``mesh=``, ROADMAP item 18); its RS / LDPC
body case becomes the check that those options raise (item 14)."""

import asyncio

import numpy as np
import pytest
import torch

from tests.torch_port.torch_port_helpers import ARQ_TIMEOUT_MS
from webaudio_modem_tpu_torch.models.config import DEFAULT_FSK_CONFIG
from webaudio_modem_tpu_torch.runtime import SoftFarmHub as Exported
from webaudio_modem_tpu_torch.runtime.soft_hub import (SoftFarmHub,
                                                       _DecodeGroup)
from webaudio_modem_tpu_torch.sim import make_device_awgn
from webaudio_modem_tpu_torch.transports.xmodem import XModemTransport
from webaudio_modem_tpu_torch.utils.abort import AbortController, AbortError

AWGN = range(0, 4)
RESEND = 4
CONTROLS = 5
B = 6


def _awgn_payload(i):
    return bytes([i]) + f"softhub {i:02d}".encode() \
        + bytes(range((i * 5) % 16))


RESEND_PAYLOAD = b"retransmit me"


def _pair(hub, i):
    tx = XModemTransport(hub.channel("a", i))
    rx = XModemTransport(hub.channel("b", i))
    for t in (tx, rx):
        t.configure({"timeout_ms": ARQ_TIMEOUT_MS})
    return tx, rx


async def _transfer(tx, rx, payload):
    recv = asyncio.ensure_future(rx.receive_data())
    await asyncio.sleep(0)
    await tx.send_data(payload)
    return await recv


async def _controls(hub):
    a = hub.channel("a", CONTROLS)
    b = hub.channel("b", CONTROLS)
    await a.modulate(b"\x15")   # NAK
    await a.modulate(b"\x06")   # ACK
    kinds = []
    for _ in range(2):
        f = await asyncio.wait_for(b.next_frame(), ARQ_TIMEOUT_MS / 1e3)
        kinds.append(f.byte)
    return kinds


async def _shared_run_async():
    hub = SoftFarmHub(DEFAULT_FSK_CONFIG, B,
                      device_channel_fn=make_device_awgn(1e-4), device="cpu")
    corrupted = []
    orig = hub._finalize

    def finalize(rx_side, group, packed):
        # the first data-packet window of the resend wire: flip the first
        # payload byte of the decoded packet (SOH, seq, ~seq, LEN,
        # payload, CRC)
        if (group.payload_len > 1 and not corrupted and RESEND in
                group.rows and group.active[group.slot_of[RESEND]]
                and packed[RESEND, group.payload_len]):
            packed = packed.copy()
            packed[RESEND, 4] ^= 0x5A
            corrupted.append(group.payload_len)
        orig(rx_side, group, packed)

    hub._finalize = finalize
    awgn = [_pair(hub, i) for i in AWGN]
    resend = _pair(hub, RESEND)
    pump = asyncio.ensure_future(hub.run())
    try:
        awgn_got, resend_got, kinds = await asyncio.gather(
            asyncio.gather(*(_transfer(tx, rx, _awgn_payload(i))
                             for (tx, rx), i in zip(awgn, AWGN))),
            _transfer(*resend, RESEND_PAYLOAD), _controls(hub))
    finally:
        hub.stop()
        await pump
    return {"hub": hub, "awgn": awgn_got, "resend": resend_got,
            "kinds": kinds, "corrupted": corrupted,
            "senders": [tx for tx, _ in awgn], "resend_sender": resend[0]}


@pytest.fixture(scope="module")
def shared():
    return asyncio.run(_shared_run_async())


def test_soft_arq_sessions_with_device_awgn(shared):
    """Concurrent XModem sessions over FEC-coded frames with on-device
    noise: every payload exact, deliveries through the C++ deframer."""
    assert shared["awgn"] == [_awgn_payload(i) for i in AWGN]
    st = shared["hub"].get_status()
    assert st["native_deframer"]
    # every session moved at least NAK + DATA + EOT worth of frames
    assert st["frames_decoded"] >= 3 * len(AWGN)
    assert st["frames_erased"] == 0
    assert st["pending_decodes"] == {"a": 0, "b": 0}
    for s in shared["senders"]:
        assert s.get_statistics().packets_sent >= 2
        assert s.get_statistics().packets_retransmitted == 0


def test_corrupted_frame_triggers_retransmit_and_recovers(shared):
    """A data frame that arrives corrupted is refused by the packet CRC
    and resent; the transfer completes exactly (failure-recovery parity:
    xmodem.ts NAK flow)."""
    assert shared["resend"] == RESEND_PAYLOAD
    assert shared["corrupted"], "the data window never decoded"
    stats = shared["resend_sender"].get_statistics()
    assert stats.packets_retransmitted >= 1


def test_back_to_back_controls_arrive_in_order(shared):
    assert shared["kinds"] == [0x15, 0x06]


def test_erased_frames_are_counted_and_not_delivered():
    """A window row whose CRC flag is 0 is an erasure: counted, nothing
    drained for it; rows that passed drain their payload bytes."""
    hub = SoftFarmHub(DEFAULT_FSK_CONFIG, 3, device="cpu")
    drained = []
    hub._drain = lambda side, out: drained.append(
        (side, *[a.copy() for a in out.ready()]))
    group = _DecodeGroup(0, 9600, 2, [0, 1, 2])
    group.active[2] = False                    # aborted before dispatch
    packed = np.array([[7, 8, 1], [9, 9, 0], [5, 5, 1]], np.uint8)
    hub._finalize("b", group, packed)
    assert (hub.frames_decoded, hub.frames_erased) == (1, 1)
    (side, counts, vals), = drained
    assert side == "b" and counts.tolist() == [2, 0, 0]
    assert vals[0].tolist() == [7, 8]
    packed[0, 2] = 0                           # every active row erased
    hub._finalize("b", group, packed)
    assert (hub.frames_decoded, hub.frames_erased) == (1, 3)
    assert len(drained) == 1


async def test_modulate_resolves_on_playout():
    hub = SoftFarmHub(DEFAULT_FSK_CONFIG, 2, device="cpu")
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
    # the scheduled window decode delivers the 1-byte control frame
    for _ in range(4):
        hub.step()
        await asyncio.sleep(0)
    hub.flush()
    frame = await asyncio.wait_for(hub.channel("b", 0).next_frame(), 1)
    assert frame.kind == "control" and frame.byte == 0x06


async def test_aborted_modulate_clears_ring_and_suppresses_decode():
    hub = SoftFarmHub(DEFAULT_FSK_CONFIG, 2, ring_quanta=32, device="cpu")
    decodes = []
    orig = hub._decode_window
    hub._decode_window = lambda w, pl: decodes.append(pl) or orig(w, pl)
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
    # the cancelled row is masked out of its scheduled window decode
    for _ in range(40):
        hub.step()
    hub.flush()
    assert decodes == []
    assert hub.get_status()["frames_decoded"] == 0
    assert hub.channel("b", 0)._frames_q.empty()


@pytest.mark.parametrize("kw", [{"rs_parity": 8}, {"body_code": object()}],
                         ids=["rs_parity", "body_code"])
def test_rs_and_block_body_modes_raise_naming_their_item(kw):
    """The reference's concatenated-RS and LDPC / turbo body modes are
    slice E of the port (ROADMAP queue 1, item 14)."""
    with pytest.raises(NotImplementedError, match="item 14"):
        SoftFarmHub(DEFAULT_FSK_CONFIG, 1, device="cpu", **kw)


def test_mesh_is_refused_naming_its_item():
    with pytest.raises(NotImplementedError, match="item 18"):
        SoftFarmHub(DEFAULT_FSK_CONFIG, 8, mesh=object(), device="cpu")


async def test_undersized_ring_raises():
    hub = SoftFarmHub(DEFAULT_FSK_CONFIG, 1, ring_quanta=4, device="cpu")
    ch = hub.channel("a", 0)
    task = asyncio.ensure_future(ch.modulate(bytes(120)))
    await asyncio.sleep(0)
    with pytest.raises(ValueError, match="ring_quanta"):
        hub.step()
    task.cancel()


def test_window_wraps_past_the_ring_end():
    """A decode window that runs past the ring's last column is the two
    pieces concatenated, in playout order; one that does not is a view."""
    hub = SoftFarmHub(DEFAULT_FSK_CONFIG, 2, quantum=480, ring_quanta=4,
                      device="cpu")
    ring = hub._rings["a"]
    ring.copy_(torch.arange(ring.numel(), dtype=torch.float32)
               .reshape(ring.shape))
    view = hub._window(ring, 480, 960)
    assert view.data_ptr() == ring[:, 480:].data_ptr()
    wrapped = hub._window(ring, 1440, 960)
    assert torch.equal(wrapped, torch.cat([ring[:, 1440:], ring[:, :480]],
                                          1))


def test_exported_and_defaults_to_the_card(monkeypatch):
    assert Exported is SoftFarmHub
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        SoftFarmHub(DEFAULT_FSK_CONFIG, 2)
