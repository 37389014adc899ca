"""On-device frame synthesis: the port's ``frames_synth_device_fn``
against the port's ``encode_frames_batch`` and the JAX package's
``frames_synth_device_fn``.

Against the port's host-framed path the samples must be EQUAL: the
phase prefixes are the same integers and the sine expansion is the same
function (``fsk_mod._synth_int``).  Against the reference the samples
agree within f32 rounding of the same exact integer phases
(``SAMPLE_ATOL``, as test_torch_soft_fsk.py), and both packages' frames
decode to the same payloads through the port's decoder."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_port.torch_port_helpers import configs
from webaudio_modem_tpu.ops import soft_fsk as jax_soft
from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams
from webaudio_modem_tpu_torch.ops import soft_fsk

B = 8
SAMPLE_ATOL = 2e-6
CONFIGS = {"default": {},
           "300_baud": dict(baud_rate=300, mark_frequency=1270,
                            space_frequency=1070)}


def _payload_plane(seed, pl):
    return np.random.default_rng(seed).integers(0, 256, (B, pl),
                                                dtype=np.uint8)


@pytest.mark.parametrize("pl", [1, 46])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_equals_host_framing_exactly(name, pl):
    _, _, params, _ = configs(**CONFIGS[name])
    pay = _payload_plane(pl, pl)
    host = soft_fsk.encode_frames_batch(
        params, [bytes(r) for r in pay], device="cpu")
    fn = soft_fsk.frames_synth_device_fn(params, pl)
    dev = fn(torch.from_numpy(pay), device="cpu")
    assert dev.dtype == torch.float32 and dev.shape == host.shape
    assert torch.equal(dev, host)
    # a numpy plane is taken as well, and the function is cached
    assert torch.equal(fn(pay, device="cpu"), host)
    assert soft_fsk.frames_synth_device_fn(params, pl) is fn
    assert dev.shape[1] == soft_fsk.frame_signal_length(params, pl)


@pytest.fixture(scope="module")
def both_packages():
    """Both packages' device synthesis at the default configuration for
    payloads of 1 and 46 bytes."""
    _, _, pp, jp = configs()
    out = {}
    for pl in (1, 46):
        pay = _payload_plane(100 + pl, pl)
        port = soft_fsk.frames_synth_device_fn(pp, pl)(pay, device="cpu")
        ref = np.asarray(jax_soft.frames_synth_device_fn(jp, pl)(
            jnp.asarray(pay)))
        out[pl] = (pay, port.numpy(), ref)
    return pp, out


@pytest.mark.parametrize("pl", [1, 46])
def test_matches_the_reference_within_f32_rounding(both_packages, pl):
    _, out = both_packages
    _, port, ref = out[pl]
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=0, atol=SAMPLE_ATOL)


@pytest.mark.parametrize("pl", [1, 46])
def test_both_packages_frames_decode_to_the_payloads(both_packages, pl):
    params, out = both_packages
    pay, port, ref = out[pl]
    got = soft_fsk.decode_frames_batch(
        params, np.concatenate([port, ref]), pl, device="cpu")
    want = [bytes(r) for r in pay]
    assert got == want + want


def test_non_integer_config_returns_none():
    params = FSKParams.from_config(FSKConfig(mark_frequency=1650.5))
    assert soft_fsk.frames_synth_device_fn(params, 4) is None


def test_rejects_a_plane_of_another_length():
    _, _, params, _ = configs()
    with pytest.raises(ValueError, match=r"\[B, 4\]"):
        soft_fsk.frames_synth_device_fn(params, 4)(
            np.zeros((2, 5), np.uint8), device="cpu")
