"""The streaming single-channel soft path of the port against the
reference's: ``fsk_demod.soft_stream``, ``soft_fsk.decode_frame_signal``,
``SoftFrameDecoder`` and ``decode_frame_chunks``, on the cases of
tests/transports/test_fec.py (TestSoftStreamSurface,
TestSoftPhysicalLayer, TestStreamingSoftDecode, and the soft decoder's
counterparts of the resync tests).

Tolerances: ``soft_stream``'s bits are exact and its softs and amps agree
within 1e-4 (two atan2 implementations, as test_torch_fsk_seq.py states);
chunked equals whole exactly in the port.  Payloads are compared at the
CRC gate: the port's equal the reference's (whole-signal and 128-sample
decodes, the resync cases) and the truth.  Payloads are
shorter than the reference suite's where the length does not matter to
the case (the CPU runs K1's plain version sample by sample).
"""

import numpy as np
import pytest

from torch_port_helpers import configs
from webaudio_modem_tpu.ops import fsk_demod as jax_demod
from webaudio_modem_tpu.ops import fsk_mod as jax_mod
from webaudio_modem_tpu.ops import soft_fsk as jax_soft
from webaudio_modem_tpu.sim import awgn as jax_awgn
from webaudio_modem_tpu_torch.ops import fsk_demod, soft_fsk
from webaudio_modem_tpu_torch.sim import awgn

ATOL = 1e-4


def _params(**kw):
    _, _, pp, jp = configs(**kw)
    return pp, jp


def _frame(jp, payload):
    return np.asarray(jax_soft.encode_frame_signal(jp, payload), np.float32)


def _chunks(sig, cuts):
    return [sig[lo:hi]
            for lo, hi in zip(np.r_[0, cuts], np.r_[cuts, len(sig)])]


# -- the soft-value surface ---------------------------------------------

@pytest.fixture(scope="module")
def hard_signal():
    pp, jp = _params()
    return pp, jp, np.asarray(jax_mod.modulate(jp, b"soft!"), np.float32)


def test_soft_stream_matches_hard_bits_and_reference(hard_signal):
    pp, jp, sig = hard_signal
    out = fsk_demod.soft_stream(pp, sig, device="cpu")
    ref = jax_demod.soft_stream(jp, sig)
    assert out.bits.shape == out.softs.shape == out.amps.shape == \
        ref.bits.shape
    derived = (pp.polarity * out.softs > 0).astype(np.float32)
    np.testing.assert_array_equal(derived, out.bits)
    assert out.amps.min() >= 0
    np.testing.assert_array_equal(out.bits, ref.bits)
    np.testing.assert_allclose(out.softs, ref.softs, rtol=0, atol=ATOL)
    np.testing.assert_allclose(out.amps, ref.amps, rtol=0, atol=ATOL)
    assert out.ds_phase == ref.ds_phase


def test_soft_stream_carry_is_exact(hard_signal):
    """Chunked with the carry equals one whole call, every plane exactly
    (the reference holds its analog planes to 1e-4 here; the port's
    plain version runs the same ops in the same order)."""
    pp, _, sig = hard_signal
    whole = fsk_demod.soft_stream(pp, sig, device="cpu")
    cuts = np.sort(np.random.RandomState(3).choice(
        np.arange(1, len(sig)), size=6, replace=False))
    state, phase, parts = None, 0, []
    for chunk in _chunks(sig, cuts):
        out = fsk_demod.soft_stream(pp, chunk, state, phase, device="cpu")
        state, phase = out.state, out.ds_phase
        parts.append(out)
    for name in ("bits", "amps", "softs"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(p, name) for p in parts]),
            getattr(whole, name), err_msg=name)


def test_soft_stream_batch_and_state_type(hard_signal):
    pp, _, sig = hard_signal
    two = fsk_demod.soft_stream(pp, np.stack([sig, sig[::-1]]), device="cpu")
    one = fsk_demod.soft_stream(pp, sig, device="cpu")
    np.testing.assert_array_equal(two.bits[:, 0], one.bits[:, 0])
    assert two.softs.shape[1] == 2
    assert isinstance(two.state, fsk_demod.DemodState)


# -- whole-signal decode ------------------------------------------------

@pytest.mark.parametrize("case", ["clean", "silence_prefix", "empty_payload",
                                  "bell103_300_baud"])
def test_decode_frame_signal_matches_reference(case):
    kw = (dict(baud_rate=300, mark_frequency=1270, space_frequency=1070)
          if case == "bell103_300_baud" else {})
    pp, jp = _params(**kw)
    payload = {"clean": b"soft!", "silence_prefix": b"offset",
               "empty_payload": b"", "bell103_300_baud": b"b"}[case]
    sig = _frame(jp, payload)
    if case == "clean":
        assert len(sig) == soft_fsk.frame_signal_length(pp, len(payload))
    if case == "silence_prefix":
        sig = np.concatenate([np.zeros(777, np.float32), sig])
    got = soft_fsk.decode_frame_signal(pp, sig, device="cpu")
    assert got == jax_soft.decode_frame_signal(jp, sig) == payload


def test_garbage_returns_none():
    pp, jp = _params()
    noise = np.random.RandomState(6).uniform(-0.5, 0.5, 8000) \
        .astype(np.float32)
    assert soft_fsk.decode_frame_signal(pp, noise, device="cpu") is None
    assert jax_soft.decode_frame_signal(jp, noise) is None


def test_decodes_at_6db_like_reference():
    """The headline of the soft path: at 6 dB (uniform noise, the
    reference's model) the frames decode, in the port as in the
    reference."""
    pp, jp = _params()
    payload = b"6 dB"
    sig = _frame(jp, payload)
    rng = np.random.RandomState(106)
    power = float(np.mean(sig.astype(np.float64) ** 2))
    amp = np.sqrt(3 * power / 10 ** 0.6)
    noisy = (sig + amp * (rng.uniform(size=len(sig)) * 2 - 1)) \
        .astype(np.float32)
    got = soft_fsk.decode_frame_signal(pp, noisy, device="cpu")
    assert got == jax_soft.decode_frame_signal(jp, noisy) == payload


# -- streaming decode ---------------------------------------------------

@pytest.fixture(scope="module")
def two_frames():
    pp, jp = _params()
    p1, p2 = b"1", b"2"
    return pp, jp, (p1, p2), (_frame(jp, p1), _frame(jp, p2))


def test_random_chunk_splits_equal_whole():
    """Any split decodes the payload the whole signal decodes (in the port
    and, on the whole signal, in the reference)."""
    pp, jp = _params()
    payload = b"sp"
    sig = _frame(jp, payload)
    assert soft_fsk.decode_frame_signal(pp, sig, device="cpu") == \
        jax_soft.decode_frame_signal(jp, sig) == payload
    rng = np.random.RandomState(17)
    for trial in range(2):
        cuts = np.sort(rng.choice(np.arange(1, len(sig)),
                                  size=rng.randint(1, 9), replace=False))
        got = soft_fsk.decode_frame_chunks(pp, _chunks(sig, cuts),
                                           device="cpu")
        assert got == [payload], f"trial {trial} cuts {cuts}"


def test_fixed_128_sample_quanta():
    pp, jp = _params()
    payload = bytes(range(6))
    sig = _frame(jp, payload)
    chunks = [sig[i:i + 128] for i in range(0, len(sig), 128)]
    assert soft_fsk.decode_frame_chunks(pp, chunks, device="cpu") == \
        jax_soft.decode_frame_chunks(jp, chunks) == [payload]


def test_two_frames_in_one_feed_decode_in_order(two_frames):
    """Both frames buffered in ONE feed decode in temporal order."""
    pp, _, (p1, p2), (s1, s2) = two_frames
    sig = np.concatenate([s1, np.zeros(500, np.float32), s2])
    assert soft_fsk.decode_frame_chunks(pp, [sig], device="cpu") == [p1, p2]


def test_back_to_back_frames_with_silence_gap(two_frames):
    pp, _, (p1, p2), (s1, s2) = two_frames
    sig = np.concatenate([s1, np.zeros(997, np.float32), s2])
    chunks = [sig[i:i + 777] for i in range(0, len(sig), 777)]
    assert soft_fsk.decode_frame_chunks(pp, chunks, device="cpu") == [p1, p2]


def test_incremental_decode_fires_as_frames_complete(two_frames):
    """The first frame decodes before the second's samples are fed."""
    pp, _, (p1, p2), (s1, s2) = two_frames
    dec = soft_fsk.SoftFrameDecoder(pp, device="cpu")
    assert dec.feed(s1) == [p1]
    assert dec.feed(s2) == [p2]
    assert dec.frames_decoded == 2
    dec.reset()
    assert dec.frames_decoded == 0 and dec.feed(np.zeros(0)) == []


def test_noise_and_junk_prefix_chunked():
    """After a noise-only lead-in, at ~14 dB, in 1024-sample chunks, with
    bounded memory; the port's ``sim.awgn`` draws the reference's noise."""
    pp, jp = _params()
    payload = b"noisy"
    rng = np.random.RandomState(5)
    lead = awgn(np.zeros(4000, np.float32), 0.01, rng)
    sig = awgn(np.concatenate([lead, _frame(jp, payload)]), 0.02, rng)
    rng = np.random.RandomState(5)
    ref_lead = jax_awgn(np.zeros(4000, np.float32), 0.01, rng)
    np.testing.assert_array_equal(
        sig, jax_awgn(np.concatenate([ref_lead, _frame(jp, payload)]),
                      0.02, rng))
    dec = soft_fsk.SoftFrameDecoder(pp, device="cpu")
    frames = []
    for i in range(0, len(sig), 1024):
        frames += dec.feed(sig[i:i + 1024])
    assert frames == [payload]
    assert len(dec._bits) < 4 * pp.sync_window + 10000


# -- resync robustness (the soft decoder's counterparts of the byte-level
#    FrameDecoder tests) -------------------------------------------------

def test_lossless_resync_finds_frame_inside_phantom_body():
    """A frame cut off after its header, with a genuine frame spliced into
    its body span: the cut frame's candidates fail once the phantom body
    has streamed in, and the genuine frame inside it still decodes."""
    pp, jp = _params()
    bad = _frame(jp, b"B" * 6)
    inner = _frame(jp, b"in")
    head = (len(pp.pattern_bits) + soft_fsk.HEADER_CODED_BITS + 8) \
        * pp.samples_per_bit + 2 * pp.samples_per_bit
    sig = np.concatenate([bad[:head], inner,
                          np.zeros(len(bad), np.float32)])
    chunks = [sig[i:i + 4800] for i in range(0, len(sig), 4800)]
    assert soft_fsk.decode_frame_chunks(pp, chunks, device="cpu") == \
        jax_soft.decode_frame_chunks(jp, chunks) == [b"in"]


def test_candidate_flood_is_bounded_per_feed_and_lossless():
    """Sync patterns with no frame behind them make many candidates; with
    ``max_candidates_per_scan`` small one feed tries only that many, and
    feeding nothing resumes the scan until the genuine frame after the
    flood decodes — feed for feed as the reference."""
    pp, jp = _params()
    pattern = np.asarray(pp.pattern_bits, np.int8)
    junk = np.asarray(jax_mod.modulate_bits(jp, np.tile(pattern, 4)),
                      np.float32)
    sig = np.concatenate([junk, _frame(jp, b"after")])
    port = soft_fsk.SoftFrameDecoder(pp, max_candidates_per_scan=4,
                                     device="cpu")
    ref = jax_soft.SoftFrameDecoder(jp, max_candidates_per_scan=4)
    outs = [(port.feed(sig), ref.feed(sig))]
    assert len(port._failed) >= 4          # the first feed's dead peaks
    while not outs[-1][0] and len(outs) < 100:
        outs.append((port.feed(np.zeros(0, np.float32)),
                     ref.feed(np.zeros(0, np.float32))))
    assert [o[0] for o in outs] == [o[1] for o in outs]
    assert outs[-1][0] == [b"after"]
    assert len(outs) > 1                 # the flood took several feeds


def test_default_bound_transparent_for_clean_streams():
    pp, jp = _params()
    frame = _frame(jp, b"x")
    sig = np.concatenate([frame] * 3)
    dec = soft_fsk.SoftFrameDecoder(pp, device="cpu")
    assert dec.feed(sig) == [b"x"] * 3


@pytest.mark.parametrize("kw", [dict(rs_parity=4), dict(body_code=object())],
                         ids=["rs_parity", "body_code"])
def test_slice_e_options_raise(kw):
    pp, _ = _params()
    with pytest.raises(NotImplementedError, match="slice E"):
        soft_fsk.SoftFrameDecoder(pp, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="slice E"):
        soft_fsk.decode_frame_signal(pp, np.zeros(64, np.float32),
                                     device="cpu", **kw)
