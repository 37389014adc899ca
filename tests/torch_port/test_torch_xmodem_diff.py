"""The port's XModem against the JAX package's, on the same seeded
inputs: packet serialisation, and whole transfers over in-memory
loopback channels (with and without the echoing hub, with a corrupted
packet) giving equal wire transcripts, statistics and event sequences.
Neither side touches audio, so the comparison is exact; only the
timestamps and the measured round-trip time differ."""

import asyncio
import dataclasses

import numpy as np
import pytest

from webaudio_modem_tpu.runtime import data_channel as jax_channel
from webaudio_modem_tpu.transports import xmodem as jax_xmodem
from webaudio_modem_tpu_torch.runtime import data_channel as port_channel
from webaudio_modem_tpu_torch.transports import xmodem as port_xmodem

PACKAGES = {"jax": (jax_xmodem, jax_channel),
            "port": (port_xmodem, port_channel)}


@pytest.mark.parametrize("seed", range(4))
def test_packets_serialise_alike(seed):
    rng = np.random.default_rng(seed)
    for _ in range(64):
        seq = int(rng.integers(1, 256))
        n = int(rng.choice([0, 1, int(rng.integers(2, 255)), 255]))
        payload = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        ref = jax_xmodem.XModemPacket.create_data(seq, payload)
        got = port_xmodem.XModemPacket.create_data(seq, payload)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        wire = port_xmodem.XModemPacket.serialize(got)
        assert wire == jax_xmodem.XModemPacket.serialize(ref)
        assert len(wire) == n + 6 and wire[3] == n
        assert port_xmodem.XModemPacket.verify(got)
        bad = dataclasses.replace(got, checksum=got.checksum ^ 1)
        assert not port_xmodem.XModemPacket.verify(bad)


def test_packet_errors_and_controls_alike():
    for seq, payload in ((0, b""), (256, b""), (1, bytes(256))):
        with pytest.raises(ValueError) as ref:
            jax_xmodem.XModemPacket.create_data(seq, payload)
        with pytest.raises(ValueError) as got:
            port_xmodem.XModemPacket.create_data(seq, payload)
        assert str(got.value) == str(ref.value)
    for name in ("SOH", "ACK", "NAK", "EOT"):
        ref, got = (getattr(m.ControlType, name) for m in (jax_xmodem,
                                                           port_xmodem))
        assert int(got) == int(ref)
        assert port_xmodem.XModemPacket.serialize_control(got) == \
            jax_xmodem.XModemPacket.serialize_control(ref)
    for name, value in vars(jax_xmodem.PacketConstants).items():
        if not name.startswith("_"):
            assert getattr(port_xmodem.PacketConstants, name) == value
    assert [s.value for s in port_xmodem.State] == \
        [s.value for s in jax_xmodem.State]
    assert dict(port_xmodem.XModemConfig()) == dict(jax_xmodem.XModemConfig())


def _corrupt_nth_packet(channel, n):
    """Flip one payload byte of the channel's n-th data packet on the
    wire (its sent copy stays intact), so the receiver NAKs it."""
    modulate = channel.modulate
    seen = [0]

    async def corrupting(data, signal=None):
        data = bytes(data)
        if len(data) > 6:
            seen[0] += 1
            if seen[0] == n:
                channel.sent_data.append(data)
                wire = bytearray(data)
                wire[4] ^= 0x40
                channel.peer.add_received_data(bytes(wire))
                if channel.echo:
                    channel.add_received_data(bytes(wire))
                return
        await modulate(data, signal)

    channel.modulate = corrupting


TRANSFERS = {
    "hello": dict(data=b"Hello, World!"),
    "fragments_echo": dict(data=bytes(range(256)) * 2, echo=True),
    "small_payload": dict(data=bytes(range(80)), payload=32),
    "empty": dict(data=b""),
    "crc_nak": dict(data=bytes(range(100)), payload=24, corrupt=2),
    "crc_nak_echo": dict(data=b"VECDRAIN-" * 40, echo=True, corrupt=1),
}


async def _transcript(package, data, payload=128, echo=False, corrupt=0):
    xmodem, channel = PACKAGES[package]
    a, b = channel.make_loopback_pair(echo=echo)
    if corrupt:
        _corrupt_nth_packet(a, corrupt)
    sender, receiver = xmodem.XModemTransport(a), xmodem.XModemTransport(b)
    sender.configure({"max_payload_size": payload, "timeout_ms": 5000})
    events = []
    for name, t in (("sender", sender), ("receiver", receiver)):
        t.on("statechange", lambda ev, name=name: events.append(
            (name, ev.data["old_state"], ev.data["new_state"],
             ev.data["context"])))
        t.on("error", lambda ev, name=name: events.append(
            (name, "error", ev.data["error"])))
    receiver.on("fragmentReceived", lambda ev: events.append(
        ("receiver", "fragment", ev.data["seq_num"], ev.data["fragment"],
         ev.data["total_fragments"], ev.data["total_bytes_received"])))
    send = asyncio.ensure_future(sender.send_data(data))
    received = await asyncio.wait_for(receiver.receive_data(), 30)
    await asyncio.wait_for(send, 30)
    stats = []
    for t in (sender, receiver):
        s = dataclasses.asdict(t.get_statistics())
        s.pop("average_round_trip_time")      # measured wall time
        stats.append(s)
    return dict(received=received, a=a.sent_data, b=b.sent_data,
                stats=stats, events=events,
                states=(sender.get_current_state(),
                        receiver.get_current_state()))


@pytest.mark.parametrize("case", sorted(TRANSFERS))
async def test_loopback_transcripts_alike(case):
    ref = await _transcript("jax", **TRANSFERS[case])
    got = await _transcript("port", **TRANSFERS[case])
    assert got["received"] == TRANSFERS[case]["data"]
    assert got == ref
    if "corrupt" in TRANSFERS[case]:
        # the NAK was heard and the fragment sent again
        assert got["stats"][0]["packets_retransmitted"] >= 1
        assert got["stats"][1]["packets_dropped"] >= 1
        assert ("receiver", "error", "Invalid CRC") in got["events"]
