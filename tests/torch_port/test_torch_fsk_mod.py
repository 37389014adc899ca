"""The port's modulator against the reference's: framing bits exact,
signal length equal, samples within 1e-5 (float32 sin of the same
phase, evaluated by two libraries)."""

import numpy as np
import pytest

from torch_port_helpers import CONFIGS, configs, random_messages
from webaudio_modem_tpu.ops import fsk_mod as jax_mod
from webaudio_modem_tpu_torch.ops import fsk_mod as port_mod

ATOL = 1e-5


@pytest.mark.parametrize("name", ["default", "bench_300_mark_gt_space",
                                  "even_parity"])
def test_framing_bits_and_length(name):
    _, _, pp, jp = configs(**CONFIGS[name])
    msgs = random_messages(np.random.default_rng(1), 5, 7)
    np.testing.assert_array_equal(port_mod.frame_bits_batch(pp, msgs),
                                  jax_mod.frame_bits_batch(jp, msgs))
    bits = port_mod.frame_bits_batch(pp, msgs)
    np.testing.assert_array_equal(port_mod._phase_acc_int(pp, bits),
                                  jax_mod._phase_acc_int(jp, bits))
    for n in (0, 1, 13):
        assert port_mod.signal_length(pp, n) == jax_mod.signal_length(jp, n)


@pytest.mark.parametrize("name", ["default", "bench_300_mark_gt_space"])
def test_batch_samples(name):
    _, _, pp, jp = configs(**CONFIGS[name])
    msgs = random_messages(np.random.default_rng(2), 4, 3)
    port = port_mod.modulate_batch(pp, msgs, "cpu").numpy()
    ref = np.asarray(jax_mod.modulate_batch(jp, msgs))
    assert port.dtype == np.float32 and port.shape == ref.shape
    assert port.shape[1] == port_mod.signal_length(pp, 3)
    np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL)


def test_non_integer_frequencies_float64_tables():
    _, _, pp, jp = configs(mark_frequency=1650.5, space_frequency=1850.25)
    assert not port_mod._int_config(pp)
    port = port_mod.modulate(pp, b"\x5a\x01", "cpu")
    ref = np.asarray(jax_mod.modulate(jp, b"\x5a\x01"))
    np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL)


def test_unequal_lengths_rejected():
    _, _, pp, _ = configs()
    with pytest.raises(ValueError):
        port_mod.modulate_batch(pp, [b"a", b"bc"], "cpu")
