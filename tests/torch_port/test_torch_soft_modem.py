"""SoftModemCore of the port against the reference's
(tests/runtime/test_soft_integration.py's surface tests): the same
payloads through the FSKCore-shaped surface, chunked at random, and the
same SignalQuality within tolerance.

The sync ratio and so the BER estimate are exact; the other fields come
from the soft and amplitude sums over the sync window, whose samples
agree within 1e-4 rad (two atan2 implementations): the window's mean
then differs by at most 1e-4 rad, 0.38 Hz at the 24 kHz decision rate
(held to 0.5 Hz), the jitter by about as much (1e-4 rad), the eye
opening by that over a quarter of the tone separation (1e-3), the SNR
by well under 0.05 dB.  The XModem transfers of that file need
the runtimes (slice B) and are not mirrored here.
"""

import dataclasses

import numpy as np
import pytest

from webaudio_modem_tpu.models.config import DEFAULT_FSK_CONFIG
from webaudio_modem_tpu.models.soft_modem import SoftModemCore as JaxCore
from webaudio_modem_tpu_torch.models import SoftModemCore
from webaudio_modem_tpu_torch.models.config import FSKConfig
from webaudio_modem_tpu_torch.ops import fsk_demod

CONFIG = FSKConfig(**dataclasses.asdict(DEFAULT_FSK_CONFIG))


@pytest.fixture(autouse=True)
def _no_background_warm(monkeypatch):
    monkeypatch.setattr(fsk_demod, "AUTO_WARM_QUALITY", False)


def test_core_surface_parity():
    """Odd chunks through the stateful decoder, then reset."""
    core = SoftModemCore(CONFIG, device="cpu")
    ref = JaxCore(DEFAULT_FSK_CONFIG)
    assert core.is_ready() and core.params is not None
    sig = core.modulate_data(b"abc")
    assert isinstance(sig, np.ndarray) and sig.dtype == np.float32
    np.testing.assert_allclose(sig, ref.modulate_data(b"abc"), rtol=0,
                               atol=2e-6)
    got, got_ref = b"", b""
    rng = np.random.RandomState(0)
    i = 0
    while i < len(sig):
        n = int(rng.randint(64, 700))
        got += core.demodulate_data(sig[i:i + n])
        got_ref += ref.demodulate_data(sig[i:i + n])
        i += n
    assert got == got_ref == b"abc"
    status = core.get_status()
    ref_status = ref.get_status()
    assert status == ref_status
    assert status["frames_decoded"] == 1
    core.reset()
    assert core.get_status()["frames_decoded"] == 0
    assert core.get_status()["demodulation_calls"] == 0


@pytest.mark.parametrize("sigma", [0.0, 0.3])
def test_signal_quality_matches_reference(sigma):
    core = SoftModemCore(CONFIG, device="cpu")
    ref = JaxCore(DEFAULT_FSK_CONFIG)
    sig = np.asarray(ref.modulate_data(b"q"))
    noisy = (sig + sigma * np.random.RandomState(0).standard_normal(len(sig))
             ).astype(np.float32)
    assert core.demodulate_data(noisy) == ref.demodulate_data(noisy) == b"q"
    q, r = core.get_signal_quality(), ref.get_signal_quality()
    assert q.ber == r.ber
    assert q.eye_opening == pytest.approx(r.eye_opening, abs=1e-3)
    assert q.phase_jitter == pytest.approx(r.phase_jitter, abs=1e-4)
    assert q.frequency_offset == pytest.approx(r.frequency_offset, abs=0.5)
    assert q.snr == pytest.approx(r.snr, abs=0.05)
    assert q.snr > 0.0
    if sigma:
        assert q.ber > 0.01             # real re-sliced bit errors
    else:
        assert q.ber == 0.0             # peak-anchored: no bias


def test_quality_before_any_frame_is_neutral():
    q = SoftModemCore(CONFIG, device="cpu").get_signal_quality()
    assert q.ber == 0.0 and q.snr == 0.0


def test_unconfigured_raises():
    core = SoftModemCore(device="cpu")
    assert not core.is_ready()
    with pytest.raises(RuntimeError):
        core.modulate_data(b"x")
    with pytest.raises(RuntimeError):
        core.demodulate_data(np.zeros(8, np.float32))


def test_configure_from_dict_and_slice_e_options():
    core = SoftModemCore(device="cpu")
    core.configure(dataclasses.asdict(CONFIG))
    assert core.is_ready() and core.get_config() == CONFIG
    assert core.demodulate_data(np.zeros(0, np.float32)) == b""
    with pytest.raises(NotImplementedError, match="slice E"):
        SoftModemCore(CONFIG, rs_parity=4, device="cpu")


def test_configure_warms_the_calibration(monkeypatch):
    """With AUTO_WARM_QUALITY, configure() builds the quality calibration
    on a background thread; the build is the lru-cached one, keyed by
    (params, family) as the reference's."""
    monkeypatch.setattr(fsk_demod, "AUTO_WARM_QUALITY", True)
    monkeypatch.setattr(fsk_demod, "_warm_started", set())
    fsk_demod._quality_calibration.cache_clear()
    core = SoftModemCore(CONFIG, device="cpu")
    fsk_demod._join_warm_threads()
    assert fsk_demod._quality_calibration.cache_info().currsize == 1
    assert (core.params, "fsk") in fsk_demod._warm_started
