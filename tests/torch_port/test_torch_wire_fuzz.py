"""The port's copy of tests/transports/test_wire_fuzz.py.

Two adversarial surfaces:

  1. The port's C++ deframer vs its pure-Python parser
     (``force_python=True``): random split / corrupt / interleaved byte
     streams must produce IDENTICAL event sequences through both
     (hypothesis-driven).
  2. Random FSKConfig golden differentials: randomized baud / frequency
     pairs (including mark > space) / parity configs must decode
     byte-identically through the port's ``FSKCore`` (on the CPU, the
     plain versions of K1 and K2) and the golden scalar comparator,
     clean and noisy.
"""

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from webaudio_modem_tpu_torch.native.deframer import Deframer
from webaudio_modem_tpu_torch.transports.xmodem.packet import XModemPacket


# ---------------------------------------------------------------------------
# Stream construction strategies
# ---------------------------------------------------------------------------

_control = st.sampled_from([b"\x04", b"\x06", b"\x15"])  # EOT/ACK/NAK
_junk = st.binary(min_size=1, max_size=12)


@st.composite
def _packet(draw):
    seq = draw(st.integers(1, 255))
    payload = draw(st.binary(min_size=0, max_size=40))
    return XModemPacket.serialize(XModemPacket.create_data(seq, payload))


@st.composite
def _corrupted_packet(draw):
    wire = bytearray(draw(_packet()))
    pos = draw(st.integers(0, len(wire) - 1))
    wire[pos] ^= draw(st.integers(1, 255))
    return bytes(wire)


@st.composite
def _truncated_packet(draw):
    wire = draw(_packet())
    cut = draw(st.integers(1, len(wire) - 1))
    return wire[:cut]


@st.composite
def wire_stream(draw):
    """A byte stream of interleaved valid/corrupt/control/junk segments
    (a truncated packet may only appear last — mid-stream truncation is
    equivalent to corruption and handled by that case)."""
    segs = draw(st.lists(
        st.one_of(_packet(), _corrupted_packet(), _control, _junk),
        min_size=1, max_size=8))
    if draw(st.booleans()):
        segs.append(draw(_truncated_packet()))
    return b"".join(segs)


def _split_points(stream: bytes, rnd: np.random.RandomState):
    if len(stream) < 2:
        return [stream]
    n = rnd.randint(1, min(8, len(stream)))
    cuts = np.sort(rnd.choice(np.arange(1, len(stream)),
                              size=n, replace=False))
    return [stream[lo:hi]
            for lo, hi in zip(np.r_[0, cuts], np.r_[cuts, len(stream)])]


# ---------------------------------------------------------------------------
# 1. native vs pure-Python event equivalence
# ---------------------------------------------------------------------------

class TestDeframerDifferentialFuzz:
    @settings(max_examples=150, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(stream=wire_stream(), seed=st.integers(0, 2**31 - 1))
    def test_random_streams_event_identical(self, stream, seed):
        """Same stream, same random chunking -> identical event lists,
        poll-after-every-push (the streaming usage pattern)."""
        rnd = np.random.RandomState(seed)
        native = Deframer(1)
        pure = Deframer(1, force_python=True)
        assert native.is_native and not pure.is_native
        ev_n, ev_p = [], []
        for piece in _split_points(stream, rnd):
            native.push(0, piece)
            pure.push(0, piece)
            ev_n += native.poll_all(0)
            ev_p += pure.poll_all(0)
        assert ev_n == ev_p
        assert native.pending(0) == pure.pending(0)

    @settings(max_examples=60, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(streams=st.lists(wire_stream(), min_size=2, max_size=5),
           seed=st.integers(0, 2**31 - 1))
    def test_batched_drain_matches_per_channel_polling(self, streams,
                                                       seed):
        """wam_deframer_drain (one native call per farm quantum) must
        produce exactly the per-channel push/poll_all events, channels
        interleaved quantum by quantum."""
        rnd = np.random.RandomState(seed)
        C = len(streams)
        native = Deframer(C)
        pure = Deframer(C, force_python=True)
        chunked = [_split_points(s, rnd) for s in streams]
        n_quanta = max(len(c) for c in chunked)
        stride = max(max((len(p) for p in c), default=1)
                     for c in chunked)
        for q in range(n_quanta):
            vals = np.zeros((C, stride), np.uint8)
            counts = np.zeros((C,), np.int32)
            for ch, pieces in enumerate(chunked):
                if q < len(pieces):
                    p = pieces[q]
                    vals[ch, :len(p)] = np.frombuffer(p, np.uint8)
                    counts[ch] = len(p)
            got = native.drain(vals, counts)
            want = pure._drain_python(vals, counts)
            assert got == want
        for ch in range(C):
            assert native.pending(ch) == pure.pending(ch)


# ---------------------------------------------------------------------------
# 2. random-config golden differentials
# ---------------------------------------------------------------------------

def _random_config(rnd: np.random.RandomState):
    from webaudio_modem_tpu_torch.models.config import FSKConfig

    baud = int(rnd.choice([300, 600, 1200]))
    # frequency pairs: random tone spacing >= max(2*baud, 160) Hz, both
    # tones in the audio band, randomly swapped so mark > space appears
    sep = float(rnd.choice([200, 330, 500])) + 2 * baud
    lo = float(rnd.randint(900, 2200))
    pair = (lo, lo + sep)
    if rnd.rand() < 0.5:
        pair = (pair[1], pair[0])  # mark > space (Bell-103 style)
    parity = str(rnd.choice(["none", "even", "odd"]))
    return FSKConfig(baud_rate=baud, mark_frequency=pair[0],
                     space_frequency=pair[1], parity=parity)


class TestRandomConfigGoldenDifferential:
    @pytest.mark.parametrize("seed", range(6))
    def test_random_config_decodes_identically(self, seed):
        from webaudio_modem_tpu_torch.golden import GoldenFSK
        from webaudio_modem_tpu_torch.models.fsk import FSKCore

        rnd = np.random.RandomState(100 + seed)
        config = _random_config(rnd)
        core = FSKCore(config, device="cpu")
        golden = GoldenFSK(config)
        data = bytes(rnd.randint(0, 256, size=rnd.randint(1, 12),
                                 dtype=np.uint8))
        sig = core.modulate_data(data)

        # clean: both decode the payload, byte-identically
        out_t = core.demodulate_data(sig)
        out_g = golden.demodulate(sig)
        assert out_t == out_g == data, config

        # noisy (25 dB): byte-identical WHATEVER each decodes
        power = float(np.mean(np.asarray(sig, np.float64) ** 2))
        amp = np.sqrt(3 * power / (10 ** 2.5))
        noisy = (np.asarray(sig)
                 + amp * (rnd.uniform(size=len(sig)) * 2 - 1)
                 ).astype(np.float32)
        core.reset()
        golden.reset()
        assert core.demodulate_data(noisy) == golden.demodulate(noisy), \
            config
