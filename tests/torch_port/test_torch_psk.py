"""The DBPSK slice as a whole, on the CPU: the port's ``ops/psk`` chunk
step, PSKCore and ModemFarm(PSKConfig) against the reference's.

Decoded bytes, byte / sync / EOD counts, the framing registers and the
quality window's anchor (its sample count and peak ratio, set by the
last sync fire) must be equal chunk for chunk; the float state within
K6's tolerances (rtol 1e-4, atol 5e-5); the SignalQuality estimates,
sums over up to W soft values each within 2e-3 of the reference's,
within ``QUALITY_ATOL``; the transmit signal within float32 rounding of
the sine (atol 1e-5).  PSKCore and the farm mirror the reference's own
DBPSK tests (``tests/modems/test_psk.py``).

The multi-channel streams run at 30-40 dB and at seeds where the
reference decodes every channel: its DBPSK decoder loses about one
random message in seven already at 30 dB (the channel syncs once, then
decodes no byte), and the port, equal to it chunk for chunk, loses the
same ones.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import add_noise, random_messages, reference_fields
from webaudio_modem_tpu.models import psk as jax_psk_model
from webaudio_modem_tpu.ops import fsk_demod as jax_demod
from webaudio_modem_tpu.ops import psk as jax_psk
from webaudio_modem_tpu_torch.models import psk as port_psk_model
from webaudio_modem_tpu_torch.models.farm import ModemFarm
from webaudio_modem_tpu_torch.ops import psk as port_psk

TOL = dict(rtol=1e-4, atol=5e-5)
# ber, frequency offset (Hz), phase jitter (rad), eye opening
QUALITY_ATOL = (1e-6, 0.5, 2e-3, 2e-3)


def _params():
    return port_psk.psk_params(), jax_psk.psk_params()


def _reference_stream(jp, x, chunk, state=None, ds_phase=0):
    state = jax_psk.init_state(jp, x.shape[0]) if state is None else state
    outs = []
    for s in range(0, x.shape[1], chunk):
        xc = x[:, s:s + chunk]
        step = jax_psk.make_demod_chunk(jp, ds_phase, donate=False)
        state, out = step(state, jnp.asarray(xc))
        ds_phase = (ds_phase + xc.shape[1]) % jp.downsample_ratio
        outs.append(out)
    return state, outs


def _port_stream(pp, x, chunk, state=None, ds_phase=0):
    state = port_psk.init_state(pp, x.shape[0], "cpu") \
        if state is None else state
    outs = []
    for s in range(0, x.shape[1], chunk):
        xc = torch.from_numpy(np.ascontiguousarray(x[:, s:s + chunk]))
        state, out = port_psk.make_demod_chunk(pp, ds_phase)(state, xc)
        ds_phase = (ds_phase + xc.shape[1]) % pp.downsample_ratio
        outs.append(out)
    return state, outs


def _collect(outs):
    got = [bytearray() for _ in range(int(outs[0].byte_count.shape[0]))]
    for o in outs:
        counts, vals = np.asarray(o.byte_count), np.asarray(o.bytes_out)
        for b in range(len(got)):
            got[b] += bytes(vals[b, :counts[b]])
    return [bytes(g) for g in got]


def _check_outs(p_outs, j_outs):
    assert len(p_outs) == len(j_outs)
    for po, jo in zip(p_outs, j_outs):
        np.testing.assert_array_equal(po.bytes_out.numpy(),
                                      np.asarray(jo.bytes_out))
        for name in ("byte_count", "sync_fired", "eod_fired"):
            np.testing.assert_array_equal(getattr(po, name).numpy(),
                                          np.asarray(getattr(jo, name)))
        np.testing.assert_allclose(po.mean_amplitude.numpy(),
                                   np.asarray(jo.mean_amplitude), **TOL)


def _check_states(pp, jp, pstate, jstate):
    ref = reference_fields(jstate)
    got = port_psk.state_to_reference(pstate)
    for name in ("started", "counter", "sil", "accum", "count", "bsc",
                 "next_idx", "byte_cur", "pos", "bit_fill", "amp_fill",
                 "sync_count", "eod_count", "r_tail", "bit_tail",
                 "q_win_cnt"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    # the sync peak is an integer match count over W; the two libraries'
    # divisions by W may differ in the last place
    W = pp.sync_window
    np.testing.assert_array_equal(np.rint(got["last_sync_ratio"] * W),
                                  np.rint(ref["last_sync_ratio"] * W))
    front = np.concatenate([np.reshape(got[n], (-1, len(got["agc_gain"])))
                            for n, _ in port_psk._FRONT_FIELDS])
    ref_front = np.concatenate([
        np.reshape(ref[n], (-1, len(ref["agc_gain"])))
        for n, _ in port_psk._FRONT_FIELDS])
    np.testing.assert_allclose(front, ref_front, **TOL)
    D = pp.ds_samples_per_bit
    order = (np.arange(D) + int(ref["zidx"])) % D
    np.testing.assert_allclose(
        np.concatenate([got["zbuf_i"], got["zbuf_q"]]),
        np.concatenate([ref["zbuf_i"][order], ref["zbuf_q"][order]]), **TOL)
    q_port = port_psk.quality_from_state(pp, pstate)
    q_ref = jax_demod.quality_from_state(jp, jstate, delay_ds=D,
                                         family="psk")
    for a, b, tol in zip(q_port, q_ref, QUALITY_ATOL):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


@pytest.mark.parametrize("chunk", [4800, 3001])
def test_stream_matches_reference(chunk):
    pp, jp = _params()
    rng = np.random.default_rng(45)
    msgs = random_messages(rng, 4, 3)
    sig = port_psk.modulate_batch(pp, msgs, "cpu").numpy()
    x = add_noise(np.pad(sig, ((0, 0), (1500, 1500))), 30, rng)
    jstate, j_outs = _reference_stream(jp, x, chunk)
    pstate, p_outs = _port_stream(pp, x, chunk)
    _check_outs(p_outs, j_outs)
    _check_states(pp, jp, pstate, jstate)
    assert _collect(p_outs) == msgs
    assert pstate.sync_count.tolist() == [1] * 4


def test_reference_stream_continued_by_port():
    """A reference stream handed over mid-message, with a sample pending
    in the downsample accumulator and the ring index away from 0, decodes
    the same bytes in the port; the state maps there and back exactly."""
    pp, jp = _params()
    rng = np.random.default_rng(42)
    msgs = random_messages(rng, 4, 6)
    x = add_noise(port_psk.modulate_batch(pp, msgs, "cpu").numpy(), 40, rng)
    cut = 2003          # odd: ds_phase 1, ring index 1 at the handover
    jstate, j_head = _reference_stream(jp, x[:, :cut], cut)
    fields = reference_fields(jstate)
    assert int(fields["zidx"]) != 0
    pstate = port_psk.state_from_reference(fields, "cpu")
    back = port_psk.state_from_reference(
        port_psk.state_to_reference(pstate), "cpu")
    for f in dataclasses.fields(pstate):
        assert torch.equal(getattr(back, f.name), getattr(pstate, f.name))

    jstate, j_tail = _reference_stream(jp, x[:, cut:], 1000, jstate, 1)
    pstate, p_tail = _port_stream(pp, x[:, cut:], 1000, pstate, 1)
    _check_outs(p_tail, j_tail)
    _check_states(pp, jp, pstate, jstate)
    head = _collect(j_head)
    assert [h + t for h, t in zip(head, _collect(p_tail))] == msgs
    assert all(0 < len(h) < 6 for h in head)


def test_modulate_batch_matches_reference():
    pp, jp = _params()
    msgs = [b"\x00\xff\x42", b"abc", b"\x7e\x55\xaa"]
    got = port_psk.modulate_batch(pp, msgs, "cpu").numpy()
    want = np.asarray(jax_psk.modulate_batch(jp, msgs))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_signal_quality_matches_reference():
    """One noisy transmission through PSKCore in both packages: the same
    bytes, and the five SignalQuality fields within QUALITY_ATOL (snr
    within 0.05 dB)."""
    config = dict(baud_rate=1200, carrier_frequency=1800.0)
    core = port_psk_model.PSKCore(port_psk_model.PSKConfig(**config),
                                  device="cpu")
    ref = jax_psk_model.PSKCore(jax_psk_model.PSKConfig(**config))
    rng = np.random.default_rng(43)
    sig = add_noise(core.modulate_data(b"QA"), 15, rng)
    assert core.demodulate_data(sig) == ref.demodulate_data(sig) == b"QA"
    q_c, q_r = core.get_signal_quality(), ref.get_signal_quality()
    fields = ("ber", "frequency_offset", "phase_jitter", "eye_opening")
    for field, tol in zip(fields, QUALITY_ATOL):
        assert getattr(q_c, field) == pytest.approx(getattr(q_r, field),
                                                    abs=tol), field
    assert q_c.snr == pytest.approx(q_r.snr, abs=0.05)
    assert q_c.phase_jitter > 0


@pytest.mark.parametrize("baud,carrier", [(300, 1200.0), (1200, 1800.0)])
def test_quality_calibration_matches_reference(baud, carrier):
    """The DBPSK tables SignalQuality measures against, built from K6's
    plain version here and the lax stage there over the same clean
    signal: the peak ratio equal, the mean and variance tables within
    1e-4 rad (rad^2) (measured: at most 8.3e-6)."""
    pp = port_psk.psk_params(carrier, baud)
    mean_p, var_p, ratio_p = port_psk._quality_calibration(pp)
    mean_r, var_r, ratio_r = jax_demod._quality_calibration(
        jax_psk.psk_params(carrier, baud), "psk")
    assert ratio_p == ratio_r
    np.testing.assert_allclose(mean_p, mean_r, rtol=0, atol=1e-4)
    np.testing.assert_allclose(var_p, var_r, rtol=0, atol=1e-4)


# -- PSKCore on the CPU: the reference's round-trip tests ---------------------

@pytest.fixture(scope="module")
def core():
    return port_psk_model.PSKCore(port_psk_model.DEFAULT_PSK_CONFIG,
                                  device="cpu")


@pytest.fixture(autouse=True)
def _reset(request):
    if "core" in request.fixturenames:
        request.getfixturevalue("core").configure(
            port_psk_model.DEFAULT_PSK_CONFIG)


def _uniform_noise(signal, snr_db, rng):
    power = float(np.mean(signal.astype(np.float64) ** 2))
    amp = np.sqrt(3 * power / (10 ** (snr_db / 10)))
    return (signal + amp * (rng.uniform(size=len(signal)) * 2 - 1)
            ).astype(np.float32)


def test_hello_world(core):
    data = b"Hello, World!"
    assert core.demodulate_data(core.modulate_data(data)) == data
    assert core.get_status()["sync_detections"] == 1


def test_all_byte_values(core):
    data = bytes([0x00, 0xFF, 0x55, 0xAA, 0x7E])
    assert core.demodulate_data(core.modulate_data(data)) == data


@pytest.mark.parametrize("baud,carrier", [(300, 1200.0), (1200, 1800.0)])
def test_rates_and_carriers(baud, carrier):
    c = port_psk_model.PSKCore(port_psk_model.PSKConfig(
        baud_rate=baud, carrier_frequency=carrier), device="cpu")
    assert c.demodulate_data(c.modulate_data(b"\x42")) == b"\x42"


def test_chunked_streaming(core):
    data = b"chunked"
    sig = core.modulate_data(data)
    out = b"".join(core.demodulate_data(sig[i:i + 128])
                   for i in range(0, len(sig), 128))
    assert out == data


def test_start_offset(core):
    sig = np.concatenate([np.zeros(777, np.float32),
                          core.modulate_data(b"\x42")])
    assert core.demodulate_data(sig) == b"\x42"


def test_noise_20db(core):
    noisy = _uniform_noise(core.modulate_data(b"\x12\x34"), 20,
                           np.random.RandomState(5))
    assert core.demodulate_data(noisy) == b"\x12\x34"


def test_low_amplitude_agc(core):
    sig = (core.modulate_data(b"\x42") * 0.1).astype(np.float32)
    assert core.demodulate_data(sig) == b"\x42"


def test_false_positive_silence(core):
    # 0.2 s, not the reference test's 1 s: the plain path runs ~0.5 ms per
    # sample on the CPU, and silence cannot sync however long it lasts
    assert core.demodulate_data(np.zeros(9600, np.float32)) == b""
    assert core.get_status()["sync_detections"] == 0


def test_multi_transmission_eod(core):
    gap = np.zeros(4800, np.float32)
    s1 = core.modulate_data(b"\x11")
    s2 = core.modulate_data(b"\x22")
    assert core.demodulate_data(np.concatenate([s1, gap, s2])) \
        == b"\x11\x22"
    assert core.get_status()["sync_detections"] == 2


def test_signal_is_constant_envelope(core):
    sig = core.modulate_data(b"\x42")
    pad = core.params.samples_per_bit * 2
    silence = core.params.bits_per_byte * core.params.samples_per_bit
    body = sig[pad:-silence]
    assert np.abs(body).max() <= 1.0 + 1e-5
    assert np.percentile(np.abs(body), 95) > 0.9


# -- ModemFarm(PSKConfig) on the CPU ------------------------------------------

def test_psk_farm_batch_decode():
    B = 8
    msgs = [bytes([i, 0x42]) for i in range(B)]
    farm = ModemFarm(port_psk_model.DEFAULT_PSK_CONFIG, B, device="cpu")
    sig = farm.modulate(msgs)
    assert farm.demodulate(sig, chunk_size=2048) == msgs
    assert farm.get_status()["sync_detections"].tolist() == [1] * B
    quality = farm.get_signal_quality()
    assert len(quality) == B and all(q.ber == 0.0 for q in quality)


def test_psk_demodulate_stream_equals_loop():
    B = 4
    msgs = [bytes([65 + b, 48 + b]) for b in range(B)]
    farm = ModemFarm(port_psk_model.PSKConfig(), B, device="cpu")
    sig = torch.nn.functional.pad(farm.modulate(msgs), (0, 555))
    loop = farm.demodulate(sig, chunk_size=512)
    farm.reset()
    assert farm.get_status()["sync_detections"].tolist() == [0] * B
    assert farm.demodulate_stream(sig, chunk_size=512) == loop == msgs
