"""The port's native runtime: the C++ CRC-16 and XModem deframer built
from ``webaudio_modem_tpu_torch/native/modem_native.cpp``.

The port's copy of tests/utils/test_native.py (the native library held
against the pure-Python parser, ``force_python=True``), a differential
test against the JAX package's deframer on fuzzed streams, and the
loader's refusals: a failed build raises with the compiler's output, and
the deframer never falls back to Python by itself."""

import numpy as np
import pytest

from webaudio_modem_tpu.native.deframer import Deframer as JaxDeframer
from webaudio_modem_tpu_torch import native
from webaudio_modem_tpu_torch.native import deframer as deframer_mod
from webaudio_modem_tpu_torch.native.deframer import (BAD_CRC, CONTROL, JUNK,
                                                      PACKET, Deframer, Frame)
from webaudio_modem_tpu_torch.transports.xmodem import (ControlType,
                                                        XModemPacket)
from webaudio_modem_tpu_torch.utils.crc16 import CRC16


def _wire(seq, payload):
    return XModemPacket.serialize(XModemPacket.create_data(seq, payload))


class TestNativeCRC:
    def test_matches_python_vectors(self):
        lib = native.get_lib()
        for data, expected in [(b"", 0xFFFF), (b"A", 0xB915),
                               (b"123456789", 0x29B1),
                               (bytes([0x00]), 0xE1F0),
                               (bytes([0xFF]), 0xFF00)]:
            assert lib.wam_crc16(data, len(data)) == expected

    def test_matches_python_random(self):
        lib = native.get_lib()
        rng = np.random.RandomState(0)
        for _ in range(20):
            data = bytes(rng.randint(0, 256, rng.randint(0, 300),
                                     dtype=np.uint8))
            assert lib.wam_crc16(data, len(data)) == \
                CRC16.calculate_python(data)


@pytest.mark.parametrize("force_python", [True, False])
class TestDeframer:
    def test_single_packet(self, force_python):
        d = Deframer(1, force_python=force_python)
        assert d.is_native is not force_python
        d.push(0, _wire(1, b"hello"))
        f = d.poll(0)
        assert f == Frame(kind=PACKET, seq=1, payload=b"hello")
        assert d.poll(0) is None

    def test_incremental_bytes(self, force_python):
        d = Deframer(1, force_python=force_python)
        wire = _wire(7, b"abc")
        for b in wire[:-1]:
            d.push(0, bytes([b]))
            assert d.poll(0) is None
        d.push(0, wire[-1:])
        f = d.poll(0)
        assert f.kind == PACKET and f.seq == 7 and f.payload == b"abc"

    def test_control_bytes(self, force_python):
        d = Deframer(1, force_python=force_python)
        d.push(0, bytes([ControlType.ACK, ControlType.NAK,
                         ControlType.EOT]))
        assert [d.poll(0).byte for _ in range(3)] == [0x06, 0x15, 0x04]

    def test_junk_skipped(self, force_python):
        d = Deframer(1, force_python=force_python)
        d.push(0, b"\x99" + _wire(1, b"x"))
        f1 = d.poll(0)
        assert f1.kind == JUNK and f1.byte == 0x99
        assert d.poll(0).kind == PACKET

    def test_bad_crc_reported(self, force_python):
        d = Deframer(1, force_python=force_python)
        wire = bytearray(_wire(1, b"abc"))
        wire[-1] ^= 0xFF
        d.push(0, bytes(wire))
        assert d.poll(0).kind == BAD_CRC

    def test_empty_payload_packet(self, force_python):
        d = Deframer(1, force_python=force_python)
        d.push(0, _wire(3, b""))
        f = d.poll(0)
        assert f.kind == PACKET and f.payload == b""

    def test_multichannel_independence(self, force_python):
        d = Deframer(3, force_python=force_python)
        d.push(0, _wire(1, b"zero"))
        d.push(2, _wire(9, b"two"))
        assert d.poll(1) is None
        assert d.poll(0).payload == b"zero"
        assert d.poll(2).seq == 9

    def test_poll_all_mixed_stream(self, force_python):
        d = Deframer(1, force_python=force_python)
        stream = (bytes([ControlType.NAK]) + _wire(1, b"a")
                  + bytes([ControlType.ACK]) + _wire(2, b"b")
                  + bytes([ControlType.EOT]))
        d.push(0, stream)
        kinds = [f.kind for f in d.poll_all(0)]
        assert kinds == [CONTROL, PACKET, CONTROL, PACKET, CONTROL]

    def test_reset(self, force_python):
        d = Deframer(1, force_python=force_python)
        d.push(0, b"\x01\x01")  # partial header
        assert d.pending(0) == 2
        d.reset(0)
        assert d.pending(0) == 0


def _fuzz_stream(rng, n_segments=30):
    """Valid packets interleaved with junk, control bytes and corruption."""
    stream = bytearray()
    for _ in range(n_segments):
        r = rng.randint(4)
        if r == 0:
            stream += _wire(rng.randint(1, 256),
                            bytes(rng.randint(0, 256, rng.randint(0, 40),
                                              dtype=np.uint8)))
        elif r == 1:
            stream += bytes([rng.choice([0x04, 0x06, 0x15])])
        elif r == 2:
            stream += bytes(rng.randint(0, 256, rng.randint(1, 10),
                                        dtype=np.uint8))
        else:
            w = bytearray(_wire(5, b"corrupt-me"))
            w[rng.randint(len(w))] ^= 0xFF
            stream += w
    return bytes(stream)


def test_native_matches_python_on_fuzzed_streams():
    rng = np.random.RandomState(42)
    dn = Deframer(1)
    dp = Deframer(1, force_python=True)
    assert dn.is_native
    stream = _fuzz_stream(rng)
    # feed in random-size pieces
    i = 0
    frames_n, frames_p = [], []
    while i < len(stream):
        n = rng.randint(1, 17)
        piece = stream[i:i + n]
        i += n
        dn.push(0, piece)
        dp.push(0, piece)
        frames_n += dn.poll_all(0)
        frames_p += dp.poll_all(0)
    assert frames_n == frames_p
    assert any(f.kind == PACKET for f in frames_n)


def _as_tuple(frame):
    return (frame.kind, frame.seq, frame.payload, frame.byte)


@pytest.mark.parametrize("seed", range(4))
def test_events_equal_the_jax_package_deframer(seed):
    """The same fuzzed byte streams, in the same random pieces on four
    channels, through the JAX package's deframer and the port's, native
    and ``force_python``: equal events, drained quantum by quantum and
    polled piece by piece."""
    rng = np.random.RandomState(1000 + seed)
    C = 4
    streams = [_fuzz_stream(rng, 20) for _ in range(C)]
    ref = JaxDeframer(C)
    ports = [Deframer(C), Deframer(C, force_python=True)]
    pos = [0] * C
    while any(p < len(s) for p, s in zip(pos, streams)):
        vals = np.zeros((C, 24), np.uint8)
        counts = np.zeros(C, np.int32)
        for c in range(C):
            n = min(int(rng.randint(0, 25)), len(streams[c]) - pos[c])
            vals[c, :n] = np.frombuffer(streams[c][pos[c]:pos[c] + n],
                                        np.uint8)
            counts[c] = n
            pos[c] += n
        want = [(ch, _as_tuple(f)) for ch, f in ref.drain(vals, counts)]
        for d in ports:
            got = [(ch, _as_tuple(f)) for ch, f in d.drain(vals, counts)]
            assert got == want
    for d in ports:
        assert d.total_pending() == ref.total_pending()
    piece_ref = JaxDeframer(1)
    piece_port = Deframer(1)
    for s in streams:
        for lo in range(0, len(s), 7):
            piece_ref.push(0, s[lo:lo + 7])
            piece_port.push(0, s[lo:lo + 7])
            assert ([_as_tuple(f) for f in piece_port.poll_all(0)]
                    == [_as_tuple(f) for f in piece_ref.poll_all(0)])


class TestBatchedDrain:
    """``wam_deframer_drain``: one native call per farm quantum."""

    def _mk_quantum(self, rng, C, maxb):
        """Random [C, maxb] vals + counts: fragments of wire streams."""
        vals = np.zeros((C, maxb), np.uint8)
        counts = np.zeros(C, np.int32)
        for c in range(C):
            if rng.rand() < 0.3:
                continue  # silent channel
            r = rng.randint(4)
            if r == 0:
                piece = _wire(rng.randint(1, 256),
                              bytes(rng.randint(0, 256, rng.randint(0, 20),
                                                dtype=np.uint8)))
            elif r == 1:
                piece = bytes([rng.choice([0x04, 0x06, 0x15])])
            elif r == 2:
                piece = bytes(rng.randint(0, 256, rng.randint(1, 8),
                                          dtype=np.uint8))
            else:
                w = bytearray(_wire(3, b"xx"))
                w[rng.randint(len(w))] ^= 0xFF
                piece = bytes(w)
            n = min(len(piece), maxb) if rng.rand() < 0.5 \
                else rng.randint(1, min(len(piece), maxb) + 1)
            vals[c, :n] = np.frombuffer(piece[:n], np.uint8)
            counts[c] = n
        return vals, counts

    def test_matches_per_channel_loop(self):
        """drain() is event-equivalent to the per-channel push + poll_all
        loop, including carry of partial frames across quanta."""
        rng = np.random.RandomState(7)
        C, maxb = 16, 24
        batched = Deframer(C)
        looped = Deframer(C)
        assert batched.is_native and looped.is_native
        for _ in range(40):
            vals, counts = self._mk_quantum(rng, C, maxb)
            got = batched.drain(vals, counts)
            want = []
            for c in range(C):
                if counts[c]:
                    looped.push(c, bytes(vals[c, :counts[c]]))
                for f in looped.poll_all(c):
                    want.append((c, f))
            assert got == want
        assert batched.total_pending() == looped.total_pending()

    def test_matches_python_path(self):
        rng = np.random.RandomState(11)
        C, maxb = 8, 24
        dn = Deframer(C)
        dp = Deframer(C, force_python=True)
        for _ in range(30):
            vals, counts = self._mk_quantum(rng, C, maxb)
            assert dn.drain(vals, counts) == dp.drain(vals, counts)
        assert dn.total_pending() == dp.total_pending()

    def test_empty_quantum_is_free(self):
        d = Deframer(4)
        assert d.drain(np.zeros((4, 8), np.uint8),
                       np.zeros(4, np.int32)) == []

    def test_total_pending_tracks_buffers(self):
        d = Deframer(2)
        d.push(0, b"\x01\x01")       # partial header, stays buffered
        d.push(1, b"\x06")           # control, consumed on poll
        assert d.total_pending() == 3
        assert d.poll(1).kind == CONTROL
        assert d.total_pending() == 2
        d.reset(0)
        assert d.total_pending() == 0


def test_library_is_built_under_build_native_keyed_by_source():
    path = native.build()
    assert path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "native")
    assert path == native.library_path() and path.exists()


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """No quiet fallback: a source that does not compile raises, and
    naming it in the error lets the caller see why; nothing is left
    behind under the library's name."""
    broken = tmp_path / "modem_native.cpp"
    broken.write_text("int wam_crc16( {\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g[+][+] failed") as err:
        native.get_lib()
    assert "error" in str(err.value)
    assert not native.library_path().exists()
    assert list((tmp_path / "build").iterdir()) == []
    # the deframer and the CRC raise too; only force_python runs Python
    with pytest.raises(RuntimeError, match="g[+][+] failed"):
        Deframer(2)
    with pytest.raises(RuntimeError, match="g[+][+] failed"):
        CRC16.calculate(b"x")
    assert not Deframer(2, force_python=True).is_native


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g[+][+] not found"):
        native.get_lib()


def test_deframer_module_has_no_fallback_switch():
    """The Python parser is reached only through ``force_python``."""
    import inspect

    src = inspect.getsource(deframer_mod.Deframer.__init__)
    assert "except" not in src and "force_python" in src
