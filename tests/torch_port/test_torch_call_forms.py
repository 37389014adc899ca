"""The reference's own call forms on the port (ROADMAP queue 3, F1-F3).

``fsk_mod.modulate(params, data)``, ``fsk_demod.init_state(params,
batch=1)``, ``psk.init_state(params, batch=1)``, ``make_demod_chunk(
params, 0, donate=False)`` and ``fsk_demod.quality_from_state(...,
family="psk")`` are how the JAX package's own code calls its ops; the
port takes the same forms (with ``device="cpu"`` here, where there is no
card) and gives what the JAX package gives.
"""

import numpy as np
import pytest
import torch

from tests.torch_port.torch_port_helpers import configs, reference_fields
from webaudio_modem_tpu.ops import fsk_demod as jax_demod
from webaudio_modem_tpu.ops import fsk_mod as jax_mod
from webaudio_modem_tpu.ops import psk as jax_psk
from webaudio_modem_tpu_torch.ops import fsk_demod, fsk_mod, psk

PC, JC, PP, JP = configs()
PSK_PP = psk.psk_params()
PSK_JP = jax_psk.psk_params()


@pytest.mark.parametrize("family", ["fsk", "psk"])
def test_modulate_reference_call_form(family):
    """``modulate(params, data)`` and ``modulate_batch(params, msgs)``:
    positional params and data, the device by keyword."""
    port, ref, pp, jp = ((fsk_mod, jax_mod, PP, JP) if family == "fsk"
                         else (psk, jax_psk, PSK_PP, PSK_JP))
    sig = port.modulate(pp, b"Hello", device="cpu")
    want = np.asarray(ref.modulate(jp, b"Hello"))
    assert sig.shape == want.shape
    np.testing.assert_allclose(sig, want, atol=5e-4)
    batch = port.modulate_batch(pp, [b"ab", b"cd"], device="cpu")
    np.testing.assert_allclose(
        batch.numpy(), np.asarray(ref.modulate_batch(jp, [b"ab", b"cd"])),
        atol=5e-4)


@pytest.mark.parametrize("family", ["fsk", "psk"])
def test_init_state_reference_call_form(family):
    """``init_state(params, batch=1)`` and ``init_state(params)``: one
    channel, the reference's fresh state field for field."""
    port, ref, pp, jp = ((fsk_demod, jax_demod, PP, JP) if family == "fsk"
                         else (psk, jax_psk, PSK_PP, PSK_JP))
    want = reference_fields(ref.init_state(jp, batch=1))
    for state in (port.init_state(pp, batch=1, device="cpu"),
                  port.init_state(pp, device="cpu")):
        assert state.bit_fill.shape == (1,)
        got = port.state_to_reference(state)
        for name, value in want.items():
            np.testing.assert_array_equal(
                np.asarray(got[name], np.float32),
                np.asarray(value, np.float32), err_msg=name)


@pytest.mark.parametrize("family", ["fsk", "psk"])
@pytest.mark.parametrize("donate", [False, True])
def test_make_demod_chunk_donate(family, donate):
    """``make_demod_chunk(params, 0, donate=...)`` steps like
    ``demod_chunk`` and donates nothing: the state passed in stays
    valid and unchanged."""
    port, mod, pp = ((fsk_demod, fsk_mod, PP) if family == "fsk"
                     else (psk, psk, PSK_PP))
    x = torch.from_numpy(
        mod.modulate_batch(pp, [b"\x55\x0f", b"ok"], device="cpu")
        .numpy()[:, :1920].copy())
    state = port.init_state(pp, 2, device="cpu")
    before = {k: v.clone() for k, v in vars(state).items()}
    step = port.make_demod_chunk(pp, 0, donate=donate)
    got_state, got = step(state, x)
    want_state, want = port.demod_chunk(pp, 0, state, x)
    for k, v in vars(state).items():
        assert torch.equal(v, before[k]), k
    for k in vars(want):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    for k in vars(want_state):
        assert torch.equal(getattr(got_state, k), getattr(want_state, k)), k


def _psk_state_after_frame():
    msgs = [b"\x55\x0f\xa3", b"\xc1\x00\xff"]
    sig = torch.from_numpy(
        psk.modulate_batch(PSK_PP, msgs, device="cpu").numpy())
    state, _ = psk.demod_chunk(PSK_PP, 0,
                               psk.init_state(PSK_PP, 2, device="cpu"), sig)
    return state


def test_quality_from_state_family_psk():
    """``family="psk"`` equals ``psk.quality_from_state`` and the
    explicit DBPSK calibration, delay and separation; any other family
    than "fsk" or "psk" raises ``ValueError``."""
    state = _psk_state_after_frame()
    D = PSK_PP.ds_samples_per_bit
    got = fsk_demod.quality_from_state(PSK_PP, state, delay_ds=D,
                                       family="psk")
    explicit = fsk_demod.quality_from_state(
        PSK_PP, state, delay_ds=D,
        calibration=psk._quality_calibration(PSK_PP), separation=np.pi)
    for g, a, b in zip(got, psk.quality_from_state(PSK_PP, state),
                       explicit):
        np.testing.assert_array_equal(g, a)
        np.testing.assert_array_equal(g, b)
    assert float(got[3].max()) > 0.0  # an eye, so the check has teeth
    with pytest.raises(ValueError, match="family"):
        fsk_demod.quality_from_state(PSK_PP, state, D, family="qam")


def test_quality_family_psk_matches_the_jax_package():
    """The reference's DBPSK call form on both packages, on the same
    clean frames: the same estimates within float tolerance."""
    msgs = [b"\x55\x0f\xa3", b"\xc1\x00\xff"]
    x = psk.modulate_batch(PSK_PP, msgs, device="cpu").numpy()
    pstate, _ = psk.demod_chunk(PSK_PP, 0,
                                psk.init_state(PSK_PP, 2, device="cpu"),
                                torch.from_numpy(x))
    jstate, _ = jax_psk.demod_chunk(PSK_JP, 0,
                                    jax_psk.init_state(PSK_JP, batch=2),
                                    x)
    D = PSK_PP.ds_samples_per_bit
    got = fsk_demod.quality_from_state(PSK_PP, pstate, delay_ds=D,
                                       family="psk")
    want = jax_demod.quality_from_state(PSK_JP, jstate, delay_ds=D,
                                        family="psk")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-3)
