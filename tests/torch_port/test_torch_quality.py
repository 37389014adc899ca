"""SignalQuality of the port against the JAX package on the CPU.

The quality-calibration warm-up mirrors the reference's
``tests/modems/test_signal_quality.py::TestCalibrationWarming`` and its
facades' calls; the calibration tables are held against the reference's
``_quality_calibration`` (its lax ``_stage_d`` there, ``stage_d_plain``
here, over the same clean signal); the reference's stage-D quality tests
(the FSK frequency-offset cases, ``TestFarmQuality`` and
``test_quality_unaffected_by_chunk_boundary_near_sync``) run in both
packages on the same seeded inputs, with their own assertions and the
port equal to the reference within ``QUALITY_ATOL``.

Each sample of audio costs ~0.3 ms on the CPU here (K1's plain version,
whatever B), so cases whose channels are independent share one batch:
the four carrier offsets and the farm cases are one farm call, the
chunk-boundary splits one batch whose channels are led by silence so
that each channel's split lands on the common chunk boundary.
"""

import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import add_noise, configs
from webaudio_modem_tpu.models import psk as jax_psk_model
from webaudio_modem_tpu.models.farm import ModemFarm as JaxFarm
from webaudio_modem_tpu.models.fsk import FSKCore as JaxCore
from webaudio_modem_tpu.ops import fsk_demod as jax_demod
from webaudio_modem_tpu.ops import fsk_mod as jax_mod
from webaudio_modem_tpu_torch.models import psk as port_psk_model
from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams
from webaudio_modem_tpu_torch.models.farm import ModemFarm
from webaudio_modem_tpu_torch.models.fsk import FSKCore
from webaudio_modem_tpu_torch.ops import fsk_demod, psk

MSG = b"Quality check 123"
# ber, frequency offset (Hz), phase jitter (rad), eye opening; snr (dB)
QUALITY_ATOL = (1e-6, 0.05, 2e-3, 2e-3)
SNR_ATOL = 0.05
FIELDS = ("ber", "frequency_offset", "phase_jitter", "eye_opening")
DELTAS = (0, 10, 30, -30)


def _same_quality(got, want):
    for field, tol in zip(FIELDS, QUALITY_ATOL):
        assert getattr(got, field) == pytest.approx(getattr(want, field),
                                                    abs=tol), field
    assert got.snr == pytest.approx(want.snr, abs=SNR_ATOL)


def _shifted(config, delta):
    """``config`` with both tones shifted by ``delta`` Hz (a pure carrier
    offset as seen by an unshifted receiver)."""
    return config.replace(mark_frequency=config.mark_frequency + delta,
                          space_frequency=config.space_frequency + delta)


# -- the warm-up -------------------------------------------------------------

@pytest.fixture
def fresh_warm(monkeypatch):
    """Empty warm bookkeeping; background builds joined afterwards."""
    monkeypatch.setattr(fsk_demod, "_warm_started", set())
    yield
    fsk_demod._join_warm_threads()


def test_warm_populates_cache_and_is_idempotent(fresh_warm):
    params = FSKParams.from_config(FSKConfig(
        baud_rate=1200, mark_frequency=2125, space_frequency=2295))
    cache = fsk_demod._quality_calibration
    cache.cache_clear()
    fsk_demod.warm_quality_calibration(params, background=False)
    assert cache.cache_info().currsize == 1
    assert (params, "fsk") in fsk_demod._warm_started
    # idempotent: the second warm neither spawns nor computes
    info = cache.cache_info()
    fsk_demod.warm_quality_calibration(params, background=False)
    fsk_demod.warm_quality_calibration(params)
    assert cache.cache_info() == info
    assert not fsk_demod._warm_threads


def test_configure_warms_in_background_when_enabled(fresh_warm,
                                                    monkeypatch):
    monkeypatch.setattr(fsk_demod, "AUTO_WARM_QUALITY", True)
    cache = fsk_demod._quality_calibration
    cache.cache_clear()
    t0 = time.perf_counter()
    core = FSKCore(FSKConfig(baud_rate=1200, mark_frequency=1500,
                             space_frequency=1700), device="cpu")
    # configure() does not block on the build ...
    assert time.perf_counter() - t0 < 2.0
    assert (core.params, "fsk") in fsk_demod._warm_started
    # ... which lands on its daemon thread
    fsk_demod._join_warm_threads()
    assert cache.cache_info().currsize == 1
    hits = cache.cache_info().hits
    core.get_signal_quality()           # no build left to pay
    assert cache.cache_info().hits == hits + 1


def test_family_psk_builds_the_dbpsk_calibration(fresh_warm):
    pp = psk.psk_params(1800.0, 1200)
    fsk_cache, psk_cache = fsk_demod._quality_calibration, \
        psk._quality_calibration
    fsk_cache.cache_clear()
    psk_cache.cache_clear()
    fsk_demod.warm_quality_calibration(pp, family="psk", background=False)
    assert psk_cache.cache_info().currsize == 1
    assert fsk_cache.cache_info().currsize == 0
    assert (pp, "psk") in fsk_demod._warm_started
    assert (pp, "fsk") not in fsk_demod._warm_started
    # in the background too, keyed apart from the FSK family's
    pp1500 = psk.psk_params(1500.0, 1200)
    fsk_demod.warm_quality_calibration(pp1500, family="psk")
    fsk_demod._join_warm_threads()
    assert psk_cache.cache_info().currsize == 2
    mean_t, var_t, ratio = psk._quality_calibration(pp1500)
    assert mean_t.shape == var_t.shape == (pp1500.sync_window + 1,)
    assert 0.0 < ratio <= 1.0


def test_unknown_family_is_refused(fresh_warm):
    params = FSKParams.from_config(FSKConfig())
    with pytest.raises(ValueError, match="family"):
        fsk_demod.warm_quality_calibration(params, family="qam")
    assert not fsk_demod._warm_started


def test_facades_warm_as_the_reference(monkeypatch):
    """FSKCore.configure and ModemFarm.__init__ warm their family's
    calibration under AUTO_WARM_QUALITY, with the reference's
    arguments (``family="psk"`` for a PSKConfig), and not without it."""
    calls = {"port": [], "jax": []}
    for key, module in (("port", fsk_demod), ("jax", jax_demod)):
        monkeypatch.setattr(module, "AUTO_WARM_QUALITY", True)
        monkeypatch.setattr(
            module, "warm_quality_calibration",
            lambda params, family="fsk", background=True, key=key:
            calls[key].append((params.config.baud_rate, family, background)))
    pc, jc, _, _ = configs()
    FSKCore(pc, device="cpu")
    ModemFarm(pc, 2, device="cpu")
    ModemFarm(port_psk_model.PSKConfig(), 2, device="cpu")
    JaxCore(jc)
    JaxFarm(jc, 2, donate=False)
    JaxFarm(jax_psk_model.PSKConfig(), 2, donate=False)
    assert calls["port"] == calls["jax"] == [
        (1200, "fsk", True), (1200, "fsk", True), (1200, "psk", True)]
    monkeypatch.setattr(fsk_demod, "AUTO_WARM_QUALITY", False)
    FSKCore(pc, device="cpu")
    ModemFarm(pc, 2, device="cpu")
    assert len(calls["port"]) == 3


# -- the calibration tables ---------------------------------------------------

@pytest.mark.parametrize("overrides", [
    {}, dict(baud_rate=300, mark_frequency=1270, space_frequency=1070)],
    ids=["default", "bench_300_mark_gt_space"])
def test_calibration_matches_reference(overrides):
    """The FSK tables SignalQuality measures against, from K1's and stage
    D's plain versions here and the reference's lax stages there over
    the same clean signal: the peak ratio equal, the mean and variance
    tables within 1e-4 rad (rad^2), as the DBPSK tables
    (test_torch_psk.py)."""
    _, _, pp, jp = configs(**overrides)
    mean_p, var_p, ratio_p = fsk_demod._quality_calibration(pp)
    mean_r, var_r, ratio_r = jax_demod._quality_calibration(jp, "fsk")
    assert ratio_p == ratio_r
    np.testing.assert_allclose(mean_p, mean_r, rtol=0, atol=1e-4)
    np.testing.assert_allclose(var_p, var_r, rtol=0, atol=1e-4)


# -- the reference's stage-D quality tests, both packages ---------------------

@pytest.fixture(scope="module")
def offset_farm():
    """One farm call in each package at the default configuration over
    MSG sent with each carrier offset of DELTAS (row 0 the clean signal),
    then the clean signal with uniform noise at 12 dB (RandomState(5), as
    the reference's TestFarmQuality): (port bytes, port quality, reference
    bytes, reference quality)."""
    pc, jc, _, _ = configs()
    rows = [np.asarray(FSKCore(_shifted(pc, d), device="cpu")
                       .modulate_data(MSG)) for d in DELTAS]
    T = len(rows[0])
    rows.append(add_noise(rows[0], 12, np.random.RandomState(5)))
    mat = np.stack([r[:T] for r in rows]).astype(np.float32)
    farm = ModemFarm(pc, len(mat), device="cpu")
    ref = JaxFarm(jc, len(mat), donate=False)
    return (farm.demodulate(mat), farm.get_signal_quality(),
            ref.demodulate(mat), ref.get_signal_quality())


@pytest.mark.parametrize("delta", DELTAS)
def test_tracks_injected_offset(offset_farm, delta):
    got, q, want, q_ref = offset_farm
    row = DELTAS.index(delta)
    assert got[row] == want[row] == MSG
    _same_quality(q[row], q_ref[row])
    assert q[row].frequency_offset == pytest.approx(delta, abs=2.0)


def test_per_channel_quality_is_independent(offset_farm):
    """Clean, +30 Hz and noisy channels of one batched call: each
    channel's estimates reflect its own impairment, as the reference's."""
    got, q, want, q_ref = offset_farm
    clean, offset, noisy = 0, DELTAS.index(30), len(DELTAS)
    assert got == want and got[clean] == MSG
    for a, b in zip(q, q_ref):
        _same_quality(a, b)
    assert q[clean].frequency_offset == pytest.approx(0, abs=2.0)
    assert q[offset].frequency_offset == pytest.approx(30, abs=3.0)
    assert q[clean].ber == 0.0
    assert q[offset].ber > 0.02
    assert q[noisy].ber > q[clean].ber


def test_tracks_offset_at_300_baud():
    overrides = dict(baud_rate=300, mark_frequency=1270,
                     space_frequency=1070)
    pc, jc, _, _ = configs(**overrides)
    sig = np.asarray(FSKCore(pc.replace(mark_frequency=1285,
                                        space_frequency=1085),
                             device="cpu").modulate_data(b"hi"))
    core, ref = FSKCore(pc, device="cpu"), JaxCore(jc)
    assert core.demodulate_data(sig) == ref.demodulate_data(sig) == b"hi"
    q = core.get_signal_quality()
    _same_quality(q, ref.get_signal_quality())
    assert q.frequency_offset == pytest.approx(15, abs=2.0)


def test_quality_survives_streaming_chunks():
    """The reference's 2048-sample pieces through FSKCore, the signal
    padded with silence to a whole number of pieces (so that the
    reference compiles one chunk shape)."""
    pc, jc, _, _ = configs()
    sig = np.asarray(FSKCore(_shifted(pc, 20), device="cpu")
                     .modulate_data(MSG))
    sig = np.pad(sig, (0, -len(sig) % 2048))
    core, ref = FSKCore(pc, device="cpu"), JaxCore(jc)
    out = ref_out = b""
    for i in range(0, len(sig), 2048):
        out += core.demodulate_data(sig[i:i + 2048])
        ref_out += ref.demodulate_data(sig[i:i + 2048])
    assert out == ref_out == MSG
    q = core.get_signal_quality()
    _same_quality(q, ref.get_signal_quality())
    assert q.frequency_offset == pytest.approx(20, abs=3.0)


def test_zero_before_any_sync():
    pc, jc, _, _ = configs()
    q = FSKCore(pc, device="cpu").get_signal_quality()
    q_ref = JaxCore(jc).get_signal_quality()
    _same_quality(q, q_ref)
    assert q.frequency_offset == q.ber == q.phase_jitter == 0.0


def test_quality_unaffected_by_chunk_boundary_near_sync():
    """A sync firing within a bit period of a chunk END must not anchor
    its quality window at the truncated chunk: on a clean signal the ber
    stays 0 for every split around the sync point (the reference's split
    positions).  The splits are channels of one batch: channel j is led
    by silence so that its split lands on the common chunk boundary
    (every lead a multiple of the downsample ratio), then both packages
    run the two chunks, of one length, through ``demod_chunk``."""
    _, _, pp, jp = configs()
    sig = np.asarray(jax_mod.modulate(jp, b"QB"), np.float32)
    spb, ratio = pp.samples_per_bit, pp.downsample_ratio
    approx = (2 + len(pp.pattern_bits)) * spb
    splits = [s for s in range(approx - spb, approx + spb // 2, ratio * 5)
              if 0 < s < len(sig)]
    assert len(splits) > 2
    cut = max(max(splits), len(sig) - min(splits))
    cut += -cut % ratio
    x = np.zeros((len(splits), 2 * cut), np.float32)
    for j, s in enumerate(splits):
        x[j, cut - s:cut - s + len(sig)] = sig

    port = fsk_demod.init_state(pp, len(splits), "cpu")
    ref = jax_demod.init_state(jp, len(splits))
    for piece in (x[:, :cut], x[:, cut:]):
        port, _ = fsk_demod.demod_chunk(pp, 0, port,
                                        torch.from_numpy(piece))
        ref, _ = jax_demod.demod_chunk(jp, 0, ref, jnp.asarray(piece))
    assert port.sync_count.tolist() == [1] * len(splits)
    assert np.asarray(ref.sync_count).tolist() == [1] * len(splits)
    q_port = fsk_demod.quality_from_state(pp, port)
    q_ref = jax_demod.quality_from_state(jp, ref)
    for a, b, tol in zip(q_port, q_ref, QUALITY_ATOL):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    bad = {s: float(b) for s, b in zip(splits, q_port[0]) if b > 1e-6}
    assert not bad, f"spurious BER at splits: {bad}"
