"""The FEC frame layer (``transports/fec_frame.py``): the port's copies of
tests/transports/test_fec.py's ``TestFrameCodec``, ``TestFecOverModem``,
``TestDecoderResyncRobustness``, the decoder fuzz and
``TestResyncSlideBound``, then ``FrameEncoder`` / ``FrameDecoder`` against
the JAX package's on the same junk-laden byte streams.  The Viterbi
decodes run on the CPU (K3's plain version)."""

import numpy as np
import pytest

from webaudio_modem_tpu.transports import fec_frame as jax_fec_frame
from webaudio_modem_tpu_torch.ops import fec
from webaudio_modem_tpu_torch.transports import FrameDecoder as Exported
from webaudio_modem_tpu_torch.transports import fec_frame
from webaudio_modem_tpu_torch.transports.fec_frame import (HEADER_CODED,
                                                           MAX_PAYLOAD,
                                                           FrameEncoder)


def FrameDecoder(**kw):
    return fec_frame.FrameDecoder(device="cpu", **kw)


class TestFrameCodec:
    def test_roundtrip_single_frame(self):
        payload = b"framed payload 123"
        frame = FrameEncoder.encode_frame(payload)
        assert len(frame) == FrameEncoder.coded_frame_length(len(payload))
        assert FrameDecoder().process(frame) == [payload]

    def test_empty_payload_frame(self):
        frame = FrameEncoder.encode_frame(b"")
        assert FrameDecoder().process(frame) == [b""]

    def test_streaming_byte_by_byte(self):
        payload = bytes(range(64))
        frame = FrameEncoder.encode_frame(payload)
        dec = FrameDecoder()
        got = []
        for i in range(len(frame)):
            got += dec.process(frame[i:i + 1])
        assert got == [payload]

    def test_multiple_frames_back_to_back(self):
        payloads = [b"one", b"two two", b"", b"four" * 20]
        stream = b"".join(FrameEncoder.encode_frame(p) for p in payloads)
        assert FrameDecoder().process(stream) == payloads

    def test_junk_prefix_resyncs(self):
        payload = b"after junk"
        stream = b"\x00\xff\x37" + FrameEncoder.encode_frame(payload)
        dec = FrameDecoder()
        assert dec.process(stream) == [payload]
        assert dec.headers_resynced >= 1

    def test_bit_errors_inside_frame_corrected(self):
        rng = np.random.RandomState(5)
        payload = bytes(rng.randint(0, 256, 120, dtype=np.uint8))
        frame = bytearray(FrameEncoder.encode_frame(payload))
        # flip ~1.5% of the coded BITS, spread out
        for i in rng.choice(len(frame) * 8, size=len(frame) // 8,
                            replace=False):
            frame[i // 8] ^= 1 << (i % 8)
        assert FrameDecoder().process(bytes(frame)) == [payload]

    def test_uncorrectable_body_reported_and_stream_recovers(self):
        errors = []
        dec = FrameDecoder(on_error=errors.append)
        good = FrameEncoder.encode_frame(b"good")
        bad = bytearray(FrameEncoder.encode_frame(b"bad frame here"))
        # destroy a burst in the body (beyond correction), header intact
        for i in range(HEADER_CODED + 2, HEADER_CODED + 14):
            bad[i] ^= 0xFF
        got = dec.process(bytes(bad) + good)
        assert got == [b"good"]
        assert dec.bodies_dropped == 1
        assert errors and "CRC" in errors[0]

    def test_reset_clears_partial_state(self):
        dec = FrameDecoder()
        frame = FrameEncoder.encode_frame(b"partial")
        dec.process(frame[:10])
        dec.reset()
        assert dec.pending() == 0
        assert dec.process(frame) == [b"partial"]

    def test_oversized_payload_refused(self):
        with pytest.raises(ValueError, match="too large"):
            FrameEncoder.encode_frame(bytes(MAX_PAYLOAD + 1))


class TestFecOverModem:
    def test_fec_frames_over_fsk_audio(self):
        # end to end: FEC frame -> FSK audio -> demod -> FrameDecoder
        from webaudio_modem_tpu_torch.models.config import DEFAULT_FSK_CONFIG
        from webaudio_modem_tpu_torch.models.fsk import FSKCore

        core = FSKCore(DEFAULT_FSK_CONFIG, device="cpu")
        payload = b"FEC over FSK audio!"
        frame = FrameEncoder.encode_frame(payload)
        sig = core.modulate_data(frame)
        received = core.demodulate_data(sig)
        assert FrameDecoder().process(received) == [payload]

    def test_fec_recovers_byte_corruption_raw_does_not(self):
        # with the same corrupted byte stream, the raw payload is damaged
        # but the FEC frame decodes exactly
        rng = np.random.RandomState(9)
        payload = bytes(rng.randint(0, 256, 200, dtype=np.uint8))
        frame = bytearray(FrameEncoder.encode_frame(payload))
        raw = bytearray(payload)
        # corrupt ~1% of bits in both streams
        for buf in (frame, raw):
            n = max(1, len(buf) * 8 // 100)
            for i in rng.choice(len(buf) * 8, size=n, replace=False):
                buf[i // 8] ^= 1 << (i % 8)
        assert bytes(raw) != payload           # raw stream is damaged
        assert FrameDecoder().process(bytes(frame)) == [payload]


class TestDecoderResyncRobustness:
    def test_oversized_len_cap_resyncs(self):
        # a decoder configured with a small max_payload treats a header
        # advertising more as junk and keeps scanning
        big = FrameEncoder.encode_frame(b"x" * 64)
        good = FrameEncoder.encode_frame(b"ok")
        dec = FrameDecoder(max_payload=16)
        assert dec.process(big + good) == [b"ok"]
        assert dec.headers_resynced >= 1

    def test_lossless_resync_finds_frame_inside_phantom_body(self):
        # corrupt-body resync must not discard the body span: a genuine
        # frame that starts inside it is still decoded
        bad = bytearray(FrameEncoder.encode_frame(b"A" * 40))
        inner = FrameEncoder.encode_frame(b"inner")
        # splice the genuine frame INTO the bad frame's body region, then
        # pad so the phantom body window fills and its CRC fails
        splice_at = HEADER_CODED + 8
        stream = bytes(bad[:splice_at]) + inner + b"\x00" * len(bad)
        assert FrameDecoder().process(stream) == [b"inner"]


def _fuzz_stream(seed, n_frames=12):
    """[(junk, frame)] pairs and the payloads: arbitrary junk between
    genuine frames (the reference's fuzz)."""
    rng = np.random.RandomState(seed)
    pieces, expected = [], []
    for _ in range(n_frames):
        junk = bytes(rng.randint(0, 256, rng.randint(0, 40),
                                 dtype=np.uint8))
        payload = bytes(rng.randint(0, 256, rng.randint(1, 64),
                                    dtype=np.uint8))
        expected.append(payload)
        pieces.append((junk, FrameEncoder.encode_frame(payload)))
    return pieces, expected


def test_decoder_fuzz_never_crashes_and_recovers():
    # the decoder must never raise, never deadlock the scan, and still
    # decode every genuine frame followed by enough stream to flush the
    # phantom windows
    pieces, expected = _fuzz_stream(11)
    dec = FrameDecoder(max_payload=256)
    decoded = []
    for junk, frame in pieces:
        decoded += dec.process(junk)
        decoded += dec.process(frame)
    # flush: enough trailing zeros to drain any phantom body window
    decoded += dec.process(b"\x00" * FrameEncoder.coded_frame_length(258))
    assert decoded == expected


class TestResyncSlideBound:
    def test_junk_flood_is_bounded_per_call_and_lossless(self):
        """A junk-heavy stream may not cost unbounded Viterbi decodes in
        one process() call: the per-call slide bound defers the scan,
        and continuing with process(b'') still finds a genuine frame
        after the junk; nothing is lost."""
        frame = FrameEncoder.encode_frame(b"after the flood")
        junk = bytes((i * 37 + 11) & 0xFF for i in range(600))
        dec = FrameDecoder(max_slides_per_call=128)
        total = list(dec.process(junk + frame))
        calls = 1
        while dec.scan_pending and calls < 100:
            total += dec.process(b"")
            calls += 1
        assert total == [b"after the flood"]
        # the flood took multiple bounded calls, not one unbounded one
        assert calls > 1
        assert dec.headers_resynced >= len(junk) - 1

    def test_default_bound_transparent_for_clean_streams(self):
        dec = FrameDecoder()
        out = dec.process(FrameEncoder.encode_frame(b"x") * 3)
        assert out == [b"x"] * 3
        assert not dec.scan_pending


# -- against the JAX package -------------------------------------------------

@pytest.mark.parametrize("payload", [b"", b"x", bytes(range(200))])
def test_encoder_bytes_equal_the_reference(payload):
    assert FrameEncoder.encode_frame(payload) == \
        jax_fec_frame.FrameEncoder.encode_frame(payload)
    assert FrameEncoder.coded_frame_length(len(payload)) == \
        jax_fec_frame.FrameEncoder.coded_frame_length(len(payload))
    assert HEADER_CODED == jax_fec_frame.HEADER_CODED


def _drive(dec, calls):
    """Feed ``calls`` (byte strings) one process() each, then continue
    every deferred scan; returns (payloads per call, counters)."""
    out = []
    for data in calls:
        got = dec.process(data)
        while dec.scan_pending:
            got += dec.process(b"")
        out.append(got)
    return out, (dec.frames_decoded, dec.headers_resynced,
                 dec.bodies_dropped, dec.pending())


@pytest.mark.parametrize("case", ["fuzz", "corrupt_bodies", "bit_errors"])
def test_decoder_equals_the_reference_on_junk_laden_streams(case):
    """The same byte stream, in the same process() calls, through the
    port's decoder and the reference's: the same payloads after every
    call, the same counters and the same bytes left buffered."""
    rng = np.random.RandomState(17)
    if case == "fuzz":
        pieces, _ = _fuzz_stream(29, n_frames=8)
        calls = [p for pair in pieces for p in pair]
        kw = dict(max_payload=256, max_slides_per_call=64)
    elif case == "corrupt_bodies":
        calls = []
        for k in range(6):
            frame = bytearray(FrameEncoder.encode_frame(bytes([k]) * 20))
            if k % 2:
                for i in range(HEADER_CODED + 2, HEADER_CODED + 12):
                    frame[i] ^= 0xFF
            calls.append(bytes(frame))
        calls.append(b"\x00" * 80)
        kw = {}
    else:
        calls = []
        for k in range(5):
            frame = bytearray(FrameEncoder.encode_frame(
                bytes(rng.randint(0, 256, 30, dtype=np.uint8))))
            for i in rng.choice(len(frame) * 8, size=4 + 3 * k,
                                replace=False):
                frame[i // 8] ^= 1 << (i % 8)
            calls.append(bytes(frame[:25]))
            calls.append(bytes(frame[25:]))
        kw = dict(max_payload=64)
    errors_port, errors_ref = [], []
    port = _drive(FrameDecoder(on_error=errors_port.append, **kw), calls)
    ref = _drive(jax_fec_frame.FrameDecoder(on_error=errors_ref.append,
                                            **kw), calls)
    assert port == ref
    assert errors_port == errors_ref
    assert sum(len(p) for p in port[0]) > 0


def test_exported_and_decodes_on_the_asked_device():
    assert Exported is fec_frame.FrameDecoder
    assert fec.coded_length(fec_frame.HEADER_PLAIN) == HEADER_CODED
    assert FrameDecoder()._device.type == "cpu"
