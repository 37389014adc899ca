"""K2's module: the plain framing state machine with byte compaction
against the reference — the compact Pallas kernel in interpret mode,
and the lax ``_stage_d`` plus masked compaction where maxb exceeds the
TPU kernel's slot bound.

Integer outputs and carries must be equal, the float carries (silence
threshold, rolling amp-window sum) within rtol 1e-6.  The window sum a
chunk starts from is a float32 reduction the two libraries order
differently, so it is compared on its own (rtol 1e-6) and both runs
then start from the reference's value.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import (CONFIGS, configs, random_messages,
                                reference_fields, signals)
from webaudio_modem_tpu.ops import fsk_demod as jax_demod
from webaudio_modem_tpu.ops.pallas import fsk_framing as jax_framing
from webaudio_modem_tpu_torch.ops import fsk_demod as port_demod
from webaudio_modem_tpu_torch.ops.kernels import fsk_framing as port_framing


def _reference_inputs(jp, jstate, x):
    """Stage-D inputs the reference pipeline makes from one chunk."""
    _, _, _, _, bits, amps, _ = jax_demod._sequential_stage(
        jp, 0, jstate, jnp.asarray(x))
    ext_bits = jnp.concatenate([jstate.bit_tail, bits], 0)
    ext_amps = jnp.concatenate([jstate.amp_tail, amps], 0)
    ratios = jax_demod._sync_ratios_cumsum(jp, ext_bits)
    return bits, amps, ratios, ext_amps


def _port_run(pp, jp, jstate, bits, amps, ratios, ext_amps, maxb):
    """The port's stage D on the reference's inputs.  The carry the port
    derives from the state matches the reference's (the window sum to
    rtol 1e-6); the run itself gets the reference's carry, so that both
    start from identical floats."""
    pstate = port_demod.state_from_reference(reference_fields(jstate),
                                             "cpu")
    ints, flts = port_demod._framing_carry(pp, pstate)
    run_sum0, fillv0 = jax_demod._means_carry(jp, jstate)
    ref_ints, ref_flts = jax_framing.pack_carry((
        jstate.started, jstate.counter, jstate.sil, jstate.threshold,
        jstate.accum, jstate.count, jstate.bsc, jstate.next_idx,
        jstate.byte_cur, jstate.pos, run_sum0, fillv0))
    np.testing.assert_array_equal(ints.numpy(), np.asarray(ref_ints))
    np.testing.assert_allclose(flts.numpy(), np.asarray(ref_flts),
                               rtol=1e-6, atol=0)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    return port_framing.stage_d_compact(
        pp, ints, t(ref_flts), pstate.bit_fill, t(bits).to(torch.bfloat16),
        t(amps), t(ratios), t(ext_amps), maxb)


def _check(port, carry, bytes_r, count_r, eod_r, sync_r, fire_t_r):
    ints, flts, bytes_p, count_p, eod_p, sync_p, fire_t_p = port
    np.testing.assert_array_equal(bytes_p.numpy(),
                                  np.asarray(bytes_r).astype(np.uint8))
    for got, want in ((count_p, count_r), (eod_p, eod_r), (sync_p, sync_r),
                      (fire_t_p, fire_t_r)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref_ints, ref_flts = jax_framing.pack_carry(carry)
    np.testing.assert_array_equal(ints.numpy(), np.asarray(ref_ints))
    np.testing.assert_allclose(flts.numpy(), np.asarray(ref_flts),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("name", ["default", "bench_300_mark_gt_space"])
def test_plain_matches_compact_kernel_interpret(name):
    """Mid-stream chunk (carried amp window, framing registers, fill) of
    128 noisy channels with distinct messages."""
    _, _, pp, jp = configs(**CONFIGS[name])
    B = 128
    rng = np.random.default_rng(7)
    x = signals(pp, random_messages(rng, B, 2), snr_db=15, rng=rng)
    split = 4 * pp.samples_per_bit * pp.bits_per_byte
    T2 = min(x.shape[1] - split, 4096)
    step = jax_demod.make_demod_chunk(jp, 0, donate=False)
    jstate, _ = step(jax_demod.init_state(jp, B), jnp.asarray(x[:, :split]))
    bits, amps, ratios, ext_amps = _reference_inputs(
        jp, jstate, x[:, split:split + T2])
    n_ds = bits.shape[0]
    maxb = jax_demod.max_bytes(jp, n_ds)
    carry, outs = jax_framing.stage_d_compact(
        jp, jstate, bits, amps, ratios, ext_amps, maxb,
        T_blk_groups=256, interpret=True)
    assert int(np.asarray(outs[1]).sum()) > 0, "no bytes in the window"
    port = _port_run(pp, jp, jstate, bits, amps, ratios, ext_amps, maxb)
    _check(port, carry, *outs)


def test_plain_matches_lax_beyond_slot_bound():
    """maxb > 64 (the TPU kernel's MAX_SLOTS): the reference takes its
    lax path; the port's compaction has no bound."""
    _, _, pp, jp = configs(**CONFIGS["2400_baud"])
    B = 4
    rng = np.random.default_rng(8)
    x = signals(pp, random_messages(rng, B, 40), snr_db=25, rng=rng)
    T = 11400
    x = np.pad(x, ((0, 0), (0, max(0, T - x.shape[1]))))[:, :T]
    jstate = jax_demod.init_state(jp, B)
    bits, amps, ratios, ext_amps = _reference_inputs(jp, jstate, x)
    n_ds = bits.shape[0]
    maxb = jax_demod.max_bytes(jp, n_ds)
    assert maxb > jax_framing.MAX_SLOTS

    t = jnp.arange(1, n_ds + 1, dtype=jnp.int32)
    gate = (t[:, None] + jstate.bit_fill[None, :]) >= jp.sync_window
    carry, (vals, emits, eods, fires) = jax_demod._stage_d(
        jp, jstate, bits, amps, ratios, ext_amps[:n_ds], gate)
    # the reference's masked-sum compaction (fsk_demod.demod_chunk)
    t_idx = jnp.arange(n_ds, dtype=jnp.int32)[:, None]
    fire_t_r = jnp.max(jnp.where(fires, t_idx, -1), axis=0)
    slot = jnp.where(emits, jnp.cumsum(emits.astype(jnp.int32), 0) - 1, -1)
    bytes_r = jnp.stack([jnp.sum(jnp.where(slot == j, vals, 0), axis=0)
                         for j in range(maxb)], axis=1)
    count_r = emits.astype(jnp.int32).sum(0)
    assert int(count_r.max()) == 40
    port = _port_run(pp, jp, jstate, bits, amps, ratios, ext_amps, maxb)
    _check(port, carry, bytes_r, count_r, eods.astype(jnp.int32).sum(0),
           fires.astype(jnp.int32).sum(0), fire_t_r)


@pytest.mark.parametrize("eod_after", [560.0, 559.3, 1.0, 0.5,
                                       2.0 ** 24 - 1.5])
def test_eod_steps_equals_the_float_compare(eod_after):
    """The kernels' ``sil1 >= eod_steps`` (eod_steps the ceiling of the
    f32 eod_after) decides as the plain version's ``float(sil1) >=
    eod_after`` for sil1 around the threshold and at the ends of int32."""
    _, _, pp, _ = configs()
    params = dataclasses.replace(pp, samples_for_eod=eod_after)
    n = port_framing._eod_steps(params)
    thr = np.float32(eod_after)
    sil = np.array([0, 1, n - 2, n - 1, n, n + 1, 2 ** 24 - 1, 2 ** 24,
                    2 ** 24 + 1, 2 ** 31 - 1], np.int64)
    sil = sil[(sil >= 0) & (sil < 2 ** 31)].astype(np.int32)
    np.testing.assert_array_equal(sil >= n, sil.astype(np.float32) >= thr)


def test_eod_steps_refuses_the_float_limit():
    _, _, pp, _ = configs()
    params = dataclasses.replace(pp, samples_for_eod=2.0 ** 24 + 1)
    with pytest.raises(ValueError, match="2\\^24"):
        port_framing._eod_steps(params)
