"""K6's module: the plain DBPSK sequential stage against the reference —
the lax ``psk._sequential_stage`` over noisy DBPSK chunks (with and
without R, ds_phase 0 and 1, D = 20 and D = 480) and the Pallas kernel
in interpret mode — and the kernel build's header hashing.

Tolerances (the reference's own, ``tests/modems/test_pallas_psk_seq.py``):
a bit mismatch fraction <= 1e-4; amps, the front-end state and the delay
rings within rtol 1e-4, atol 5e-5 (float32 recurrences evaluated by two
libraries); softs within rtol 1e-3, atol 2e-3 where the bits agree (the
wrap to the nearest constellation point subtracts values near pi, and
the Pallas kernel's atan2 is a polynomial).  At 50 baud (D = 480) the
floats agree within the tolerance stated at that test, which a float64
witness justifies.
Rings are compared oldest first.  R equals the D-wide sums of the
port's own bits exactly.
"""

import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import add_noise, random_messages, reference_fields
from webaudio_modem_tpu.ops import psk as jax_psk
from webaudio_modem_tpu.ops.pallas import psk_seq as jax_psk_seq
from webaudio_modem_tpu_torch.ops import psk as port_psk
from webaudio_modem_tpu_torch.ops.kernels import _build
from webaudio_modem_tpu_torch.ops.kernels import psk_seq as port_seq

TOL = dict(rtol=1e-4, atol=5e-5)
SOFT_TOL = dict(rtol=1e-3, atol=2e-3)
MAX_BIT_MISMATCH = 1e-4
# 50 baud (D = 480) only: see test_plain_matches_lax_d_over_256_without_r
TOL_D480 = dict(rtol=1e-4, atol=1e-3)
SOFT_ATOL_D480 = 0.05
WITNESS_RATIO = 3.0


def _params(baud):
    return port_psk.psk_params(baud_rate=baud), jax_psk.psk_params(
        baud_rate=baud)


def _signal(pp, B, T, seed):
    """Noisy DBPSK [B, T] f32 numpy: distinct messages at 20 dB."""
    rng = np.random.default_rng(seed)
    sig = port_psk.modulate_batch(pp, random_messages(rng, B, 3),
                                  "cpu").numpy()
    sig = np.pad(sig, ((0, 0), (0, max(0, T - sig.shape[1]))))
    return add_noise(sig[:, :T], 20, rng)


def _warm_reference(jp, x, ds_phase, B, seed):
    """A reference state after a warm-up chunk that leaves ``ds_phase``
    samples pending and the ring index away from 0, with a random bit
    history (the R ring's seed)."""
    state = jax_psk.init_state(jp, B)
    warm = 333 if ds_phase else 334
    fr, dsc, iacc, qacc, _, _, _ = jax_psk._sequential_stage(
        jp, 0, state, jnp.asarray(x[:, :warm]), unroll=2)
    tail = np.random.default_rng(seed).integers(
        0, 2, (jp.sync_window, B)).astype(np.float32)
    g, pre, phi, iq_i, iq_q = fr
    zbi, zbq, zidx = dsc
    assert int(zidx) != 0
    return warm, state._replace(
        agc_gain=g, pre=pre, phi=phi, iq_i=iq_i, iq_q=iq_q, ds_iacc=iacc,
        ds_qacc=qacc, zbuf_i=zbi, zbuf_q=zbq, zidx=zidx,
        bit_tail=jnp.asarray(tail, jnp.bfloat16))


def _pack_front(fr):
    return np.asarray(jax_psk_seq._pack_fr(fr))


def _oldest_first(zbi, zbq, zidx):
    order = (np.arange(zbi.shape[0]) + int(zidx)) % zbi.shape[0]
    return np.concatenate([np.asarray(zbi)[order], np.asarray(zbq)[order]])


def _check_streams(bits, amps, softs, bits_r, amps_r, softs_r):
    bp = bits.float().numpy()
    br = np.asarray(bits_r, np.float32)
    assert bp.shape == br.shape
    agree = bp == br
    assert np.mean(~agree) <= MAX_BIT_MISMATCH, np.mean(~agree)
    np.testing.assert_allclose(amps.numpy(), np.asarray(amps_r), **TOL)
    np.testing.assert_allclose(softs.numpy()[agree],
                               np.asarray(softs_r)[agree], **SOFT_TOL)


def _check_rsum(D, ring0, bits, rsum):
    ext = np.concatenate([ring0, bits.float().numpy()]).astype(np.float64)
    cs = np.cumsum(ext, 0)
    np.testing.assert_array_equal(rsum.float().numpy(), cs[D:] - cs[:-D])


@pytest.mark.parametrize("ds_phase", [0, 1])
@pytest.mark.parametrize("with_rsum", [False, True], ids=["no_r", "r"])
@pytest.mark.parametrize("T", [256, 1000, 2048])
def test_plain_matches_lax(T, with_rsum, ds_phase):
    pp, jp = _params(1200)
    B, D = 8, pp.ds_samples_per_bit
    x = _signal(pp, B, 2400, seed=T + ds_phase)
    warm, jstate = _warm_reference(jp, x, ds_phase, B, seed=7)
    xc = x[:, warm:warm + T]
    out_r = jax_psk._sequential_stage(jp, ds_phase, jstate, jnp.asarray(xc),
                                      unroll=2, with_rsum=with_rsum)
    fr_r, (zbi, zbq, zidx), iacc, qacc, bits_r, amps_r, softs_r = out_r[:7]

    pstate = port_psk.state_from_reference(reference_fields(jstate), "cpu")
    ring0 = pstate.bit_tail[-D:] if with_rsum else None
    front, acc, ring, bits, amps, softs, rsum = port_seq.seq(
        pp, ds_phase, pstate.front, pstate.ds_acc, pstate.ring, ring0,
        torch.from_numpy(np.ascontiguousarray(xc.T)), emit_rsum=with_rsum)

    assert bits.shape[0] == port_seq.n_decisions(pp, ds_phase, T)
    _check_streams(bits, amps, softs, bits_r, amps_r, softs_r)
    np.testing.assert_allclose(front.numpy(), _pack_front(fr_r), **TOL)
    np.testing.assert_allclose(
        acc.numpy(), np.stack([np.asarray(iacc), np.asarray(qacc)]), **TOL)
    np.testing.assert_allclose(ring.numpy(), _oldest_first(zbi, zbq, zidx),
                               **TOL)
    if with_rsum:
        _check_rsum(D, ring0.float().numpy(), bits, rsum)
        if bool((bits.float().numpy() == np.asarray(bits_r, np.float32))
                .all()):
            np.testing.assert_array_equal(rsum.float().numpy(),
                                          np.asarray(out_r[7], np.float32))
    else:
        assert rsum is None


def test_plain_matches_lax_d_over_256_without_r():
    """50 baud: D = 480, no R (R is inexact in bf16 above 256); 1000
    decisions inside a message wrap the ring twice, from a ds_phase
    prefix.  The bits agree as at 1200 baud; the floats differ more: the
    I/Q low-pass cut at 50 Hz has its poles at radius 0.9954, and its
    noise gain lifts both libraries' float32 rounding.

    The witness: the plain version in float64 on the same inputs (the
    same float32-rounded coefficients).  Each float output of the port
    lies no farther from it than ``WITNESS_RATIO`` times the reference's
    own distance (measured: 1.4-2.0 times), so the gap is rounding on
    both sides and not a port fault.  Port and reference then agree
    within ``TOL_D480`` and ``SOFT_ATOL_D480``, set from the measured
    max abs gaps (front 7.6e-5; rings and amplitudes 2.0e-4; softs
    0.025 rad)."""
    pp, jp = _params(50)
    B = 16
    assert pp.ds_samples_per_bit == 480
    rng = np.random.default_rng(11)
    sig = port_psk.modulate_batch(pp, random_messages(rng, B, 3),
                                  "cpu").numpy()
    x = add_noise(sig, 20, rng)[:, 20000:22400]
    warm, jstate = _warm_reference(jp, x, 1, B, seed=12)
    xc = x[:, warm:warm + 2000]
    fr_r, (zbi, zbq, zidx), iacc, qacc, bits_r, amps_r, softs_r = \
        jax_psk._sequential_stage(jp, 1, jstate, jnp.asarray(xc), unroll=2)
    pstate = port_psk.state_from_reference(reference_fields(jstate), "cpu")
    x_t = torch.from_numpy(np.ascontiguousarray(xc.T))
    front, acc, ring, bits, amps, softs, rsum = port_seq.seq(
        pp, 1, pstate.front, pstate.ds_acc, pstate.ring, None, x_t,
        emit_rsum=False)
    assert rsum is None and bits.shape[0] == 1000
    w_front, _, w_ring, w_bits, w_amps, w_softs, _ = port_seq.seq_plain(
        pp, 1, pstate.front.double(), pstate.ds_acc.double(),
        pstate.ring.double(), None, x_t.double(), emit_rsum=False)
    assert w_softs.dtype == torch.float64
    bits_r = np.asarray(bits_r, np.float32)
    agree = bits.float().numpy() == bits_r
    assert np.mean(~agree) <= MAX_BIT_MISMATCH
    assert np.array_equal(w_bits.float().numpy(), bits_r)
    soft_tol = dict(rtol=0, atol=SOFT_ATOL_D480)
    for port, ref, witness, tol, where in (
            (front, _pack_front(fr_r), w_front, TOL_D480, ...),
            (ring, _oldest_first(zbi, zbq, zidx), w_ring, TOL_D480, ...),
            (amps, np.asarray(amps_r), w_amps, TOL_D480, ...),
            (softs, np.asarray(softs_r), w_softs, soft_tol, agree)):
        port, ref, witness = port.numpy()[where], ref[where], \
            witness.numpy()[where]
        port_gap = np.abs(port - witness).max()
        ref_gap = np.abs(ref - witness).max()
        assert port_gap <= WITNESS_RATIO * ref_gap, (port_gap, ref_gap)
        np.testing.assert_allclose(port, ref, **tol)


@pytest.mark.parametrize("with_rsum", [False, True], ids=["no_r", "r"])
def test_plain_matches_pallas_kernel_interpret(with_rsum):
    """The TPU kernel in interpret mode (B = 128, 600 groups: not a
    multiple of D, so its ring roll-back runs), from a ring left at a
    non-zero index."""
    pp, jp = _params(1200)
    B, T, D = 128, 1200, pp.ds_samples_per_bit
    x = _signal(pp, B, 1600, seed=21)
    warm, jstate = _warm_reference(jp, x, 0, B, seed=22)
    xc = x[:, warm:warm + T]
    fr = (jstate.agc_gain, jstate.pre, jstate.phi, jstate.iq_i,
          jstate.iq_q)
    dsc = (jstate.zbuf_i, jstate.zbuf_q, jstate.zidx)
    ring0 = jstate.bit_tail[-D:] if with_rsum else None
    out_r = jax_psk_seq.seq_main(jp, fr, dsc, jnp.asarray(xc).T, T_blk=400,
                                 interpret=True, ring0=ring0)
    fr_r, (zbi, zbq, zidx), bits_r, amps_r, softs_r = out_r[:5]
    assert int(zidx) == 0

    pstate = port_psk.state_from_reference(reference_fields(jstate), "cpu")
    front, acc, ring, bits, amps, softs, rsum = port_seq.seq(
        pp, 0, pstate.front, pstate.ds_acc, pstate.ring,
        pstate.bit_tail[-D:] if with_rsum else None,
        torch.from_numpy(np.ascontiguousarray(xc.T)), emit_rsum=with_rsum)
    _check_streams(bits, amps, softs, bits_r, amps_r, softs_r)
    np.testing.assert_allclose(front.numpy(), _pack_front(fr_r), **TOL)
    np.testing.assert_allclose(ring.numpy(),
                               np.concatenate([zbi, zbq]), **TOL)
    assert np.all(acc.numpy() == 0)
    if with_rsum:
        _check_rsum(D, np.asarray(ring0, np.float32), bits, rsum)


@pytest.mark.parametrize("baud,sample_rate", [(1200, 48000), (50, 48000),
                                              (50, 96000)])
def test_plain_chunking_is_exact(baud, sample_rate):
    """One chunk or the same samples cut at an odd point (a pending group
    across the cut, ring slots carried) give identical outputs, at D = 20
    (ring wrapped many times), 480 and 960 (each chunk's decisions fewer
    than D: the ring comes back rotated by part of its length)."""
    pp = port_psk.psk_params(baud_rate=baud, sample_rate=sample_rate)
    B, D = 4, pp.ds_samples_per_bit
    lead = 3 * pp.samples_per_bit          # past the leading silence
    x = torch.from_numpy(np.ascontiguousarray(
        _signal(pp, B, lead + 1001, 31)[:, lead:].T))
    state = port_psk.init_state(pp, B, "cpu")
    ring = torch.from_numpy(np.random.default_rng(32).standard_normal(
        (2 * D, B), dtype=np.float32))
    r = D <= 256
    ring0 = torch.randint(0, 2, (D, B)).to(torch.bfloat16) if r else None
    whole = port_seq.seq(pp, 0, state.front, state.ds_acc, ring, ring0, x,
                         emit_rsum=r)
    cut = 457
    f1, a1, r1, b1, m1, s1, _ = port_seq.seq(
        pp, 0, state.front, state.ds_acc, ring, ring0, x[:cut], emit_rsum=r)
    f2, a2, r2, b2, m2, s2, _ = port_seq.seq(
        pp, cut % 2, f1, a1, r1, torch.cat([ring0, b1])[-D:] if r else None,
        x[cut:], emit_rsum=r)
    for got, want in ((f2, whole[0]), (a2, whole[1]), (r2, whole[2]),
                      (torch.cat([b1, b2]), whole[3]),
                      (torch.cat([m1, m2]), whole[4]),
                      (torch.cat([s1, s2]), whole[5])):
        assert torch.equal(got, want)


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """A library is keyed by its source and every csrc header it
    includes: editing the front-end header K1 and K6 share rebuilds both,
    and only them; editing the pipelines' hand-over header rebuilds K1
    and K2, and only them."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    assert [h.name for h in _build.headers("psk_seq")] == ["seq_front.cuh"]
    assert [h.name for h in _build.headers("fsk_seq")] == ["seq_front.cuh",
                                                           "warp_pipe.cuh"]
    for name, rebuilt in (("seq_front.cuh", {"fsk_seq", "psk_seq"}),
                          ("warp_pipe.cuh", {"fsk_seq", "fsk_framing"})):
        before = {n: _build.library_path(n) for n in _build.names()}
        header = csrc / name
        header.write_bytes(header.read_bytes() + b"\n")
        after = {n: _build.library_path(n) for n in _build.names()}
        assert {n for n in before if before[n] != after[n]} == rebuilt
