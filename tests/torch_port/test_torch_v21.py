"""BASELINE config 4 in the port: ITU-T V.21 full duplex (``models/v21.py``)
and the filters it runs on (``ops/filters.py``), mirroring
``tests/modems/test_v21_and_ber.py``'s ``TestV21`` on the CPU, and the
filters held against the JAX package's.

The FIR runs as a float32 convolution in both packages with their own
summation orders: outputs agree within 1e-5 (the separated line is of
order 1).  The windowed-sinc designs are the same float64 numpy code and
are equal.  An exchange costs ~9 s here (two stations' plain K1 over
14,720 samples each).
"""

import numpy as np
import pytest
import torch

from webaudio_modem_tpu.models import v21 as jax_v21
from webaudio_modem_tpu.ops import filters as jax_filters
from webaudio_modem_tpu_torch.models.v21 import (V21Duplex, V21Station,
                                                 v21_config)
from webaudio_modem_tpu_torch.ops import filters

FIR_ATOL = 1e-5


class TestV21:
    def test_config_channels(self):
        c1 = v21_config(1)
        c2 = v21_config(2)
        assert (c1.mark_frequency, c1.space_frequency) == (980, 1180)
        assert (c2.mark_frequency, c2.space_frequency) == (1650, 1850)
        assert c1.baud_rate == c2.baud_rate == 300

    def test_invalid_channel(self):
        with pytest.raises(ValueError):
            v21_config(3)

    def test_single_direction_through_separation_filter(self):
        station = V21Station(2, device="cpu")   # receives channel 1
        remote = V21Station(1, device="cpu")
        data = b"\x42"
        sig = remote.modulate(data)
        assert station.demodulate(sig) == data

    def test_full_duplex_exchange(self):
        # both directions simultaneously over one line (BASELINE cfg 4)
        link = V21Duplex(device="cpu")
        d1, d2 = b"ping!", b"pong."
        got1, got2 = link.exchange(d1, d2)
        assert got1 == d1
        assert got2 == d2

    def test_full_duplex_with_noise(self):
        link = V21Duplex(device="cpu")
        rng = np.random.RandomState(9)
        d1, d2 = b"\x11\x22", b"\x33\x44"
        sig_len = len(link.calling.modulate(b"\x11\x22"))
        link.calling.reset()
        noise = (rng.uniform(-1, 1, sig_len + 48000) * 0.02).astype(
            np.float32)
        got1, got2 = link.exchange(d1, d2, noise=noise)
        assert got1 == d1
        assert got2 == d2


def test_station_separation_taps_equal_the_reference():
    for channel in (1, 2):
        ours = V21Station(channel, device="cpu")
        ref = jax_v21.V21Station(channel)
        np.testing.assert_array_equal(ours._sep_taps, ref._sep_taps)
        assert ours._sep_taps.shape == (191,)


@pytest.mark.parametrize("args", [(1000.0, 48000.0, 51), (350.0, 8000.0, 30),
                                  (2000.0, 44100.0, 7)])
def test_sinc_designs_equal_the_reference(args):
    for name in ("sinc_lowpass", "sinc_highpass"):
        np.testing.assert_array_equal(getattr(filters, name)(*args),
                                      getattr(jax_filters, name)(*args))
    cutoff, fs, taps = args
    np.testing.assert_array_equal(
        filters.sinc_bandpass(cutoff, cutoff / 2, fs, taps),
        jax_filters.sinc_bandpass(cutoff, cutoff / 2, fs, taps))


@pytest.fixture(scope="module")
def fir_case():
    rng = np.random.default_rng(11)
    taps = filters.sinc_bandpass(1080.0, 800.0, 48000, 191)
    x = rng.uniform(-1, 1, (3, 5000)).astype(np.float32)
    _, want = jax_filters.fir_apply(taps, x)
    return taps, x, np.asarray(want)


def test_fir_apply_matches_the_reference(fir_case):
    taps, x, want = fir_case
    hist, got = filters.fir_apply(taps, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (3, 5000)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FIR_ATOL)
    np.testing.assert_array_equal(hist.numpy(), x[:, -190:])
    # one channel as a 1-D signal
    _, one = filters.fir_apply(taps, x[1])
    np.testing.assert_allclose(one.numpy(), want[1], rtol=0, atol=FIR_ATOL)


@pytest.mark.parametrize("cuts", [(1, 190, 2000), (777, 3001), (4999,)])
def test_fir_apply_streamed_in_pieces(fir_case, cuts):
    """The history carried across pieces of any size (shorter than the
    taps too) gives the whole-signal filter."""
    taps, x, want = fir_case
    hist, outs, start = None, [], 0
    for end in (*cuts, 5000):
        hist, y = filters.fir_apply(taps, torch.from_numpy(x[:, start:end]),
                                    hist)
        outs.append(y)
        start = end
    got = torch.cat(outs, dim=1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FIR_ATOL)
    whole = filters.fir_apply(taps, torch.from_numpy(x))[1].numpy()
    np.testing.assert_allclose(got, whole, rtol=0, atol=FIR_ATOL)


def test_biquad_scan_matches_the_reference():
    rng = np.random.default_rng(12)
    coeffs = filters.normalize_biquad(
        *filters.butterworth_bandpass(1750.0, 800.0, 48000.0))
    x = rng.uniform(-1, 1, (4, 600)).astype(np.float32)
    import jax.numpy as jnp

    ref_state, ref_y = jax_filters.biquad_scan(
        coeffs, jax_filters.biquad_init_state((4,)), jnp.asarray(x))
    state = filters.biquad_init_state((4,), device="cpu")
    outs = []
    for piece in np.split(x, [250], axis=1):    # streamed in two pieces
        state, y = filters.biquad_scan(coeffs, state, torch.from_numpy(piece))
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), np.asarray(ref_y),
                               rtol=0, atol=1e-5)
    for got, want in zip(state, ref_state):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
