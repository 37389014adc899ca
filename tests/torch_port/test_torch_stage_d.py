"""K8's module: stage D with per-step events (``fsk_framing.stage_d`` and
``fsk_demod.stage_d``) against the reference — the Pallas ``stage_d``
kernel in interpret mode and the lax ``_stage_d`` — on the reference
pipeline's own intermediate streams (the template of
``tests/modems/test_pallas_framing.py``: 128 channels of a clean "Hi"
frame, so syncs, bytes and EODs occur).

The port runs from the reference's packed carry, so both start from
identical floats; planes (byte values, emits, EODs, fires) and carries
must then be exactly equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import configs, reference_fields
from webaudio_modem_tpu.ops import fsk_demod as jax_demod
from webaudio_modem_tpu.ops import fsk_mod as jax_mod
from webaudio_modem_tpu.ops.pallas import fsk_framing as jax_framing
from webaudio_modem_tpu_torch.ops import fsk_demod as port_demod
from webaudio_modem_tpu_torch.ops.kernels import fsk_framing as port_framing

B = 128


def _intermediates(jp, T, message=b"Hi"):
    """The reference pipeline's stage-D inputs over one chunk of T
    samples of ``message`` on every channel."""
    sig = np.asarray(jax_mod.modulate(jp, message))[:T]
    sig = np.pad(sig, (0, T - len(sig)))
    x = jnp.asarray(np.tile(sig, (B, 1)))
    state = jax_demod.init_state(jp, B)
    _, _, _, _, bits, amps, _ = jax_demod._sequential_stage(
        jp, 0, state, x, unroll=2)
    ext_bits = jnp.concatenate([state.bit_tail, bits], 0)
    ext_amps = jnp.concatenate([state.amp_tail, amps], 0)
    n_ds = bits.shape[0]
    ratios = jax_demod._sync_ratios(jp, ext_bits)
    t = jnp.arange(1, n_ds + 1, dtype=jnp.int32)
    gate = (t[:, None] + state.bit_fill[None, :]) >= jp.sync_window
    return state, bits, amps, ratios, ext_amps, gate


def _carry(jp, jstate):
    """The reference's packed carry (ints [10, B], flts [2, B])."""
    run_sum0, fillv0 = jax_demod._means_carry(jp, jstate)
    return jax_framing.pack_carry((
        jstate.started, jstate.counter, jstate.sil, jstate.threshold,
        jstate.accum, jstate.count, jstate.bsc, jstate.next_idx,
        jstate.byte_cur, jstate.pos, run_sum0, fillv0))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _port(pp, ints, flts, bit_fill, bits, amps, ratios, sub):
    return port_framing.stage_d(
        pp, torch.from_numpy(np.array(ints)), _t(flts),
        torch.from_numpy(np.array(bit_fill)), _t(bits, torch.bfloat16),
        _t(amps), _t(ratios), _t(sub))


def _assert_equal(port, carry_ref, outs_ref):
    (ints, flts), planes = port
    for name, got, want in zip(("byte_vals", "emits", "eods", "fires"),
                               planes, outs_ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    ref_ints, ref_flts = jax_framing.pack_carry(carry_ref)
    np.testing.assert_array_equal(ints.numpy(), np.asarray(ref_ints))
    np.testing.assert_array_equal(flts.numpy(), np.asarray(ref_flts))


@pytest.fixture(scope="module")
def default_config():
    _, _, pp, jp = configs()
    return pp, jp


@pytest.mark.parametrize("T", [2048, 4096])
def test_stage_d_matches_pallas_interpret(default_config, T):
    pp, jp = default_config
    state, bits, amps, ratios, ext_amps, gate = _intermediates(jp, T)
    n_ds = bits.shape[0]
    carry_ref, outs_ref = jax_framing.stage_d(
        jp, state, bits, amps, ratios, ext_amps[:n_ds], gate,
        T_blk_groups=256, interpret=True)
    assert int(np.asarray(outs_ref[3]).sum()) == B, "every channel syncs"
    ints, flts = _carry(jp, state)
    port = _port(pp, ints, flts, state.bit_fill, bits, amps, ratios,
                 ext_amps)
    assert port[1][0].dtype == torch.int32
    assert all(p.dtype == torch.bool for p in port[1][1:])
    _assert_equal(port, carry_ref, outs_ref)


def test_stage_d_matches_lax_with_streamed_carry(default_config):
    """The whole chunk against the lax scan, then two halves chained
    through the port's own carry equal to the whole."""
    pp, jp = default_config
    state, bits, amps, ratios, ext_amps, gate = _intermediates(jp, 4096)
    n_ds = bits.shape[0]
    carry_ref, outs_ref = jax_demod._stage_d(
        jp, state, bits, amps, ratios, ext_amps[:n_ds], gate, unroll=2)
    assert int(np.asarray(outs_ref[1]).sum()) == 2 * B, "two bytes each"
    ints, flts = _carry(jp, state)
    whole = _port(pp, ints, flts, state.bit_fill, bits, amps, ratios,
                  ext_amps)
    _assert_equal(whole, carry_ref, outs_ref)

    half = n_ds // 2 + 1            # odd split
    (ints1, flts1), planes1 = _port(
        pp, ints, flts, state.bit_fill, bits[:half], amps[:half],
        ratios[:half], ext_amps[:half])
    (ints2, flts2), planes2 = _port(
        pp, ints1.numpy(), flts1.numpy(),
        np.asarray(state.bit_fill) + half, bits[half:], amps[half:],
        ratios[half:], ext_amps[half:])
    for a, b, w in zip(planes1, planes2, whole[1]):
        assert torch.equal(torch.cat([a, b]), w)
    assert torch.equal(ints2, whole[0][0])
    assert torch.equal(flts2, whole[0][1])


@pytest.mark.parametrize("name,overrides", [
    ("default", {}),
    ("bench_300_mark_gt_space",
     dict(baud_rate=300, mark_frequency=1270, space_frequency=1070)),
])
def test_demod_stage_d_matches_reference_stage_d(name, overrides):
    """``fsk_demod.stage_d`` from the port's state (built from the
    reference's by ``state_from_reference``), mid-stream: the gate from
    ``bit_fill``, the window sum re-anchored from ``amp_tail``."""
    _, _, pp, jp = configs(**overrides)
    rng = np.random.default_rng(3)
    sig = np.asarray(jax_mod.modulate_batch(
        jp, [bytes(rng.integers(0, 256, 3, dtype=np.uint8))
             for _ in range(8)]))
    split = 3 * pp.samples_per_bit * pp.bits_per_byte
    step = jax_demod.make_demod_chunk(jp, 0, donate=False)
    jstate, _ = step(jax_demod.init_state(jp, 8), jnp.asarray(sig[:, :split]))
    _, _, _, _, bits, amps, _ = jax_demod._sequential_stage(
        jp, 0, jstate, jnp.asarray(sig[:, split:]), unroll=2)
    ext_bits = jnp.concatenate([jstate.bit_tail, bits], 0)
    ext_amps = jnp.concatenate([jstate.amp_tail, amps], 0)
    ratios = jax_demod._sync_ratios(jp, ext_bits)
    n_ds = bits.shape[0]
    t = jnp.arange(1, n_ds + 1, dtype=jnp.int32)
    gate = (t[:, None] + jstate.bit_fill[None, :]) >= jp.sync_window
    carry_ref, outs_ref = jax_demod._stage_d(
        jp, jstate, bits, amps, ratios, ext_amps[:n_ds], gate, unroll=2)
    assert int(np.asarray(outs_ref[1]).sum()) > 0, "no bytes in the chunk"

    pstate = port_demod.state_from_reference(reference_fields(jstate),
                                             "cpu")
    (ints, flts), planes = port_demod.stage_d(
        pp, pstate, _t(bits, torch.bfloat16), _t(amps), _t(ratios),
        _t(ext_amps))
    for got, want in zip(planes, outs_ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref_ints, ref_flts = jax_framing.pack_carry(carry_ref)
    np.testing.assert_array_equal(ints.numpy(), np.asarray(ref_ints))
    # the port re-anchors the window sum from amp_tail with its own f32
    # reduction order (test_torch_fsk_framing.py), hence the tolerance
    np.testing.assert_allclose(flts.numpy(), np.asarray(ref_flts),
                               rtol=1e-6, atol=0)
    # plain=True is the same plain version on CPU tensors
    again = port_demod.stage_d(pp, pstate, _t(bits, torch.bfloat16),
                               _t(amps), _t(ratios), _t(ext_amps),
                               plain=True)
    assert all(torch.equal(a, b) for a, b in zip(again[1], planes))


def test_compact_of_stage_d_is_stage_d_compact(default_config):
    """The TPU's long-chunk route (per-step planes, then the masked-sum
    compaction) gives K2's compacted outputs and carry."""
    pp, jp = default_config
    state, bits, amps, ratios, ext_amps, _ = _intermediates(jp, 4096)
    ints, flts = _carry(jp, state)
    args = (pp, torch.from_numpy(np.array(ints)), _t(flts),
            torch.from_numpy(np.array(state.bit_fill)),
            _t(bits, torch.bfloat16), _t(amps), _t(ratios), _t(ext_amps))
    maxb = port_demod.max_bytes(pp, bits.shape[0])
    (ints_d, flts_d), planes = port_framing.stage_d(*args)
    compacted = port_framing.compact(*planes, maxb)
    ref = port_framing.stage_d_compact(*args, maxb)
    assert torch.equal(ints_d, ref[0]) and torch.equal(flts_d, ref[1])
    for got, want in zip(compacted, ref[2:]):
        assert torch.equal(got, want)
    assert bytes(compacted[0][0, :int(compacted[1][0])].numpy()) == b"Hi"


def test_zero_steps_keep_the_carry(default_config):
    pp, _ = default_config
    state = port_demod.init_state(pp, 3, "cpu")
    z = torch.zeros((0, 3))
    (ints, flts), planes = port_demod.stage_d(
        pp, state, z.bfloat16(), z, z, state.amp_tail)
    want_ints, want_flts = port_demod._framing_carry(pp, state)
    assert torch.equal(ints, want_ints) and torch.equal(flts, want_flts)
    assert [tuple(p.shape) for p in planes] == [(0, 3)] * 4
    assert planes[0].dtype == torch.int32 and planes[1].dtype == torch.bool
