"""The port's channel simulators against the reference's.

The numpy functions are copies: with the same ``RandomState`` they give
the same samples, exactly.  ``make_device_awgn`` draws from a
``torch.Generator`` (other numbers than JAX's PRNG), so it is held to its
model instead: reproducible from a seed, zero mean and variance
``noise_power`` within the bounds below, and bounded by sqrt(3 P).
"""

import numpy as np
import pytest
import torch

from webaudio_modem_tpu import sim as jax_sim
from webaudio_modem_tpu_torch import sim as port_sim

SIG = np.sin(np.arange(2000) * 0.37).astype(np.float32)


@pytest.mark.parametrize("name, args", [
    ("awgn", (0.05,)),
    ("awgn_snr", (6.0,)),
])
def test_noise_functions_match_reference(name, args):
    got = getattr(port_sim, name)(SIG, *args, np.random.RandomState(4))
    ref = getattr(jax_sim, name)(SIG, *args, np.random.RandomState(4))
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_awgn_snr_reference_power_matches_reference():
    got = port_sim.awgn_snr(SIG, 3.0, np.random.RandomState(5),
                            reference_power=0.25)
    ref = jax_sim.awgn_snr(SIG, 3.0, np.random.RandomState(5),
                           reference_power=0.25)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("make, args", [
    ("make_awgn_channel", (0.02, 9)),
    ("make_gain", (0.5,)),
    ("make_dc_offset", (0.1,)),
    ("make_dropout_channel", (0.3, 2, 64)),
])
def test_channel_factories_match_reference(make, args):
    port_fn = getattr(port_sim, make)(*args)
    ref_fn = getattr(jax_sim, make)(*args)
    for _ in range(3):                 # streaming: state carries
        np.testing.assert_array_equal(port_fn(SIG), ref_fn(SIG))


def test_make_chain_matches_reference():
    got = port_sim.make_chain(port_sim.make_gain(2.0),
                              port_sim.make_dc_offset(-0.5))(SIG)
    ref = jax_sim.make_chain(jax_sim.make_gain(2.0),
                             jax_sim.make_dc_offset(-0.5))(SIG)
    np.testing.assert_array_equal(got, ref)
    assert port_sim.signal_power(SIG) == jax_sim.signal_power(SIG)


def test_device_awgn_reproducible_and_uniform_model():
    """Mean within 4 standard errors of 0 and variance within 2 % of P
    over 2^18 draws (the standard error of the sample variance of a
    uniform variable is 0.0018 P there); every value within sqrt(3 P)."""
    P = 0.04
    fn = port_sim.make_device_awgn(P)
    frame = torch.zeros((4, 65536))

    def draw(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return fn(frame, g)

    a, b, c = draw(1), draw(1), draw(2)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    n = a.numel()
    assert abs(float(a.mean())) < 4 * np.sqrt(P / n)
    assert abs(float(a.var()) / P - 1) < 0.02
    assert float(a.abs().max()) <= np.sqrt(3 * P) * (1 + 1e-6)
    # noise adds to the frame
    x = torch.ones((4, 65536))
    g = torch.Generator()
    g.manual_seed(1)
    assert torch.allclose(fn(x, g) - 1.0, a, atol=1e-6)
