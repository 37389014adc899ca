"""K1's module: the plain sequential stage against the reference — the
Pallas kernel in interpret mode, and the lax ``_sequential_stage`` over
a stream of odd-length chunks with a ds_phase prefix.

Tolerances: softs, amps and the carried state within atol 1e-4 (float32
recurrences evaluated by two libraries, atan2 by a polynomial in the
Pallas kernel); a sliced bit may differ only where the soft value is
within 1e-5 of the threshold; R equals the ds-wide sums of the port's
own bits exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import (CONFIGS, configs, random_messages,
                                reference_fields, signals)
from webaudio_modem_tpu.ops import fsk_demod as jax_demod
from webaudio_modem_tpu.ops.pallas import fsk_seq as jax_seq
from webaudio_modem_tpu_torch.ops import fsk_demod as port_demod
from webaudio_modem_tpu_torch.ops.kernels import fsk_seq as port_seq

ATOL = 1e-4
FLIP_SOFT = 1e-5


def _check_bits(bits_port, bits_ref, softs_port):
    bp = np.asarray(bits_port, np.float32)
    br = np.asarray(bits_ref, np.float32)
    flips = bp != br
    assert np.all(np.abs(np.asarray(softs_port)[flips]) < FLIP_SOFT), \
        f"{flips.sum()} bits differ away from the threshold"


def _check_rsum(params, ring0, bits, rsum):
    ds = params.ds_samples_per_bit
    ext = np.concatenate([np.asarray(ring0, np.float64),
                          np.asarray(bits, np.float64)])
    cs = np.cumsum(ext, 0)
    np.testing.assert_array_equal(np.asarray(rsum, np.float64),
                                  cs[ds:] - cs[:-ds])


def _noisy_input(params, B, T, seed):
    rng = np.random.default_rng(seed)
    sig = signals(params, random_messages(rng, B, 4), snr_db=20, rng=rng)
    return np.ascontiguousarray(sig[:, :T])


@pytest.mark.parametrize("name", ["default", "bench_300_mark_gt_space"])
def test_plain_matches_pallas_kernel_interpret(name):
    _, _, pp, jp = configs(**CONFIGS[name])
    B, T = 128, 1200
    ds = pp.ds_samples_per_bit
    x = _noisy_input(pp, B, T, seed=3)
    ring = np.random.default_rng(4).integers(0, 2, (ds, B)).astype(
        np.float32)

    jstate = jax_demod.init_state(jp, B)
    fr = (jstate.agc_gain, jstate.pre, jstate.phi, jstate.iq_i,
          jstate.iq_q)
    dsc = (jstate.last_phase, jstate.post)
    ring_j = jnp.asarray(ring, jnp.bfloat16)
    fr2, dsc2, bits_r, amps_r, softs_r, rsum_r = jax_seq.seq_main(
        jp, fr, dsc, jnp.asarray(x).T, T_blk=400, interpret=True,
        ring0=ring_j, run0=jnp.sum(ring_j.astype(jnp.float32), 0))

    pstate = port_demod.init_state(pp, B, "cpu")
    ring_p = torch.from_numpy(ring).to(torch.bfloat16)
    front, acc, bits, amps, softs, rsum = port_seq.seq(
        pp, 0, pstate.front, pstate.ds_acc, ring_p,
        torch.from_numpy(x.T.copy()))

    np.testing.assert_allclose(softs.numpy(), np.asarray(softs_r),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(amps.numpy(), np.asarray(amps_r),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(front.numpy(),
                               np.asarray(jax_seq._pack_state(fr2, dsc2)),
                               rtol=0, atol=ATOL)
    _check_bits(bits.float(), np.asarray(bits_r, np.float32), softs)
    _check_rsum(pp, ring, bits.float().numpy(), rsum.float().numpy())
    assert np.all(acc.numpy() == 0)


@pytest.mark.parametrize("name", ["default", "bench_300_mark_gt_space"])
def test_plain_matches_lax_stream_with_prefix(name):
    """Odd chunk lengths: leftover samples pend across chunks and the
    next chunk completes their group first (ds_phase prefix)."""
    _, _, pp, jp = configs(**CONFIGS[name])
    B = 4
    ds = pp.ds_samples_per_bit
    W = pp.sync_window
    x = _noisy_input(pp, B, 2400, seed=5)
    jstate = jax_demod.init_state(jp, B)
    pstate = port_demod.state_from_reference(reference_fields(jstate),
                                             "cpu")
    front, acc = pstate.front, pstate.ds_acc
    tail = pstate.bit_tail
    ds_phase, start = 0, 0
    for T in (777, 800, 1, 2, 620):
        xc = x[:, start:start + T]
        start += T
        (fr, dsc, iacc, qacc, bits_r, amps_r, softs_r,
         rsum_r) = jax_demod._sequential_stage(
            jp, ds_phase, jstate, jnp.asarray(xc), with_rsum=True)
        ring = tail[-ds:]
        front, acc, bits, amps, softs, rsum = port_seq.seq(
            pp, ds_phase, front, acc, ring, torch.from_numpy(xc.T.copy()))
        assert bits.shape[0] == bits_r.shape[0] == \
            port_seq.n_decisions(pp, ds_phase, T)
        np.testing.assert_allclose(softs.numpy(), np.asarray(softs_r),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(amps.numpy(), np.asarray(amps_r),
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(
            front.numpy(), np.asarray(jax_seq._pack_state(fr, dsc)),
            rtol=0, atol=ATOL)
        np.testing.assert_allclose(
            acc.numpy(), np.stack([np.asarray(iacc), np.asarray(qacc)]),
            rtol=0, atol=ATOL)
        _check_bits(bits.float(), np.asarray(bits_r, np.float32), softs)
        _check_rsum(pp, ring.float().numpy(), bits.float().numpy(),
                    rsum.float().numpy())

        tail = torch.cat([tail, bits])[-W:]
        g, pre, phi, iq_i, iq_q = fr
        jstate = jstate._replace(
            agc_gain=g, pre=pre, phi=phi, iq_i=iq_i, iq_q=iq_q,
            ds_iacc=iacc, ds_qacc=qacc, last_phase=dsc[0], post=dsc[1],
            bit_tail=jnp.concatenate([jstate.bit_tail, bits_r], 0)[-W:])
        ds_phase = (ds_phase + T) % pp.downsample_ratio
    assert ds_phase == 0 and start == 2200


# -- stream flags (the soft path's csum mode, and K7) --------------------------

def _stream_run(pp, B, T, seed, ds_phase=0, **flags):
    x = _noisy_input(pp, B, T, seed)
    state = port_demod.init_state(pp, B, "cpu")
    ds = pp.ds_samples_per_bit
    ring = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, 2, (ds, B)).astype(np.float32)).to(torch.bfloat16)
    if ds_phase:
        state.ds_acc.copy_(torch.from_numpy(np.random.default_rng(
            seed + 2).standard_normal((2, B)).astype(np.float32)))
    return port_seq.seq(pp, ds_phase, state.front, state.ds_acc,
                        ring if flags.get("emit_rsum", True) else None,
                        torch.from_numpy(x.T.copy()), **flags)


@pytest.mark.parametrize("flags", [
    dict(emit_bits=False),
    dict(emit_amps=False),
    dict(emit_bits=False, emit_amps=False, emit_csum=True),
    dict(emit_rsum=False),
    dict(emit_amps=False, emit_rsum=False, emit_csum=True),
], ids=["no_bits", "no_amps", "csum_soft_path", "k7_no_rsum",
        "k7_csum_no_amps"])
def test_stream_flags_keep_retained_streams_exact(flags):
    """Every retained stream equals the full run's exactly; dropped ones
    come back as None; the csum slot is the strict f32 running sum of
    the full run's softs (a ds_phase prefix decision included)."""
    _, _, pp, _ = configs()
    full = _stream_run(pp, 4, 601, seed=9, ds_phase=1)
    got = _stream_run(pp, 4, 601, seed=9, ds_phase=1, **flags)
    names = ("front", "ds_acc", "bits", "amps", "softs", "rsum")
    keep = dict(bits=flags.get("emit_bits", True),
                amps=flags.get("emit_amps", True),
                rsum=flags.get("emit_rsum", True))
    for name, g, f in zip(names, got, full):
        if not keep.get(name, True):
            assert g is None, name
        elif name == "softs" and flags.get("emit_csum"):
            assert torch.equal(g, port_seq.csum_strict(f))
        else:
            assert torch.equal(g, f), name


def test_csum_is_a_strict_f32_loop_and_matches_pallas_interpret():
    """The csum mode against an explicit f32 loop (exact) and against
    the reference kernel's emit_csum stream in interpret mode (within
    the softs tolerance: two atan2 implementations)."""
    _, _, pp, jp = configs()
    B, T = 128, 1200
    ds = pp.ds_samples_per_bit
    x = _noisy_input(pp, B, T, seed=13)
    ring = np.zeros((ds, B), np.float32)

    jstate = jax_demod.init_state(jp, B)
    fr = (jstate.agc_gain, jstate.pre, jstate.phi, jstate.iq_i,
          jstate.iq_q)
    dsc = (jstate.last_phase, jstate.post)
    ring_j = jnp.asarray(ring, jnp.bfloat16)
    _, _, bits_r, amps_r, csum_r, rsum_r = jax_seq.seq_main(
        jp, fr, dsc, jnp.asarray(x).T, T_blk=400, interpret=True,
        ring0=ring_j, run0=jnp.sum(ring_j.astype(jnp.float32), 0),
        emit_bits=False, emit_amps=False, emit_csum=True)
    assert bits_r is None and amps_r is None

    pstate = port_demod.init_state(pp, B, "cpu")
    args = (pp, 0, pstate.front, pstate.ds_acc,
            torch.from_numpy(ring).to(torch.bfloat16),
            torch.from_numpy(x.T.copy()))
    _, _, _, _, csum, rsum = port_seq.seq(
        *args, emit_bits=False, emit_amps=False, emit_csum=True)
    softs = port_seq.seq(*args)[4].numpy()
    loop = np.empty_like(softs)
    acc = np.zeros(B, np.float32)
    for t in range(softs.shape[0]):
        acc = acc + softs[t]
        loop[t] = acc
    np.testing.assert_array_equal(csum.numpy(), loop)
    np.testing.assert_allclose(csum.numpy(), np.asarray(csum_r), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(rsum.float().numpy(),
                                  np.asarray(rsum_r, np.float32))


def test_demod_chunk_runs_k7_above_ds_256(monkeypatch):
    """ds > 256 (50 baud): demod_chunk asks K1 for no R stream (K7) and
    passes no ring; at ds <= 256 it keeps R."""
    seen = []
    real = port_seq.seq

    def spy(*args, **kwargs):
        seen.append((kwargs.get("emit_rsum", True), args[4] is None))
        return real(*args, **kwargs)

    monkeypatch.setattr(port_seq, "seq", spy)
    for name in ("ds_over_256", "default"):
        _, _, pp, _ = configs(**CONFIGS[name])
        state = port_demod.init_state(pp, 2, "cpu")
        x = torch.zeros((2, 1000))
        port_demod.demod_chunk(pp, 0, state, x)
    assert seen == [(False, True), (True, False)]
