"""The slice as a whole: multi-chunk streams through the port's
``demod_chunk`` against the reference's, and against the golden scalar
model.

Decoded bytes, sync and EOD counts, and the framing registers must be
equal chunk for chunk.  The SignalQuality estimates are sums over up to
W float32 discriminator values, each within 1e-4 of the reference's, so
they are compared within the tolerances in ``QUALITY_ATOL``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import (CONFIGS, configs, random_messages,
                                reference_fields, signals)
from webaudio_modem_tpu.golden import GoldenFSK
from webaudio_modem_tpu.ops import fsk_demod as jax_demod
from webaudio_modem_tpu_torch.ops import fsk_demod as port_demod

# ber, frequency offset (Hz), phase jitter (rad), eye opening
QUALITY_ATOL = (1e-6, 0.05, 2e-3, 2e-3)

MESSAGE_BYTES = {"default": 4, "bench_300_mark_gt_space": 2}


def _reference_stream(jp, x, chunk, state=None, ds_phase=0):
    """Run the reference over x [B, T] in chunks; per-chunk outputs."""
    state = jax_demod.init_state(jp, x.shape[0]) if state is None else state
    outs = []
    for s in range(0, x.shape[1], chunk):
        xc = x[:, s:s + chunk]
        step = jax_demod.make_demod_chunk(jp, ds_phase, donate=False)
        state, out = step(state, jnp.asarray(xc))
        ds_phase = (ds_phase + xc.shape[1]) % jp.downsample_ratio
        outs.append(out)
    return state, outs


def _port_stream(pp, x, chunk, state=None, ds_phase=0):
    state = port_demod.init_state(pp, x.shape[0], "cpu") \
        if state is None else state
    outs = []
    for s in range(0, x.shape[1], chunk):
        xc = torch.from_numpy(np.ascontiguousarray(x[:, s:s + chunk]))
        state, out = port_demod.make_demod_chunk(pp, ds_phase)(state, xc)
        ds_phase = (ds_phase + xc.shape[1]) % pp.downsample_ratio
        outs.append(out)
    return state, outs


def _collect(outs, port):
    B = int(outs[0].byte_count.shape[0])
    got = [bytearray() for _ in range(B)]
    for o in outs:
        counts = o.byte_count.numpy() if port else np.asarray(o.byte_count)
        vals = o.bytes_out.numpy() if port else np.asarray(o.bytes_out)
        for b in range(B):
            got[b] += bytes(vals[b, :counts[b]])
    return [bytes(g) for g in got]


def _check_outs(p_outs, j_outs):
    assert len(p_outs) == len(j_outs)
    for po, jo in zip(p_outs, j_outs):
        np.testing.assert_array_equal(po.bytes_out.numpy(),
                                      np.asarray(jo.bytes_out))
        for name in ("byte_count", "sync_fired", "eod_fired"):
            np.testing.assert_array_equal(getattr(po, name).numpy(),
                                          np.asarray(getattr(jo, name)))
        np.testing.assert_allclose(po.mean_amplitude.numpy(),
                                   np.asarray(jo.mean_amplitude),
                                   rtol=0, atol=1e-4)


def _check_states(pp, jp, pstate, jstate):
    ref = reference_fields(jstate)
    got = port_demod.state_to_reference(pstate)
    for name in ("started", "counter", "sil", "accum", "count", "bsc",
                 "next_idx", "byte_cur", "pos", "bit_fill", "amp_fill",
                 "sync_count", "eod_count"):
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    np.testing.assert_array_equal(got["r_tail"], ref["r_tail"])
    q_port = port_demod.quality_from_state(pp, pstate)
    q_ref = jax_demod.quality_from_state(jp, jstate)
    for a, b, tol in zip(q_port, q_ref, QUALITY_ATOL):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


@pytest.mark.parametrize("chunk", [4800, 3001])
@pytest.mark.parametrize("name", ["default", "bench_300_mark_gt_space"])
def test_stream_matches_reference_and_golden(name, chunk):
    pc, jc, pp, jp = configs(**CONFIGS[name])
    rng = np.random.default_rng(21)
    msgs = random_messages(rng, 4, MESSAGE_BYTES[name])
    x = signals(pp, msgs, snr_db=25, rng=rng)

    jstate, j_outs = _reference_stream(jp, x, chunk)
    pstate, p_outs = _port_stream(pp, x, chunk)
    _check_outs(p_outs, j_outs)
    _check_states(pp, jp, pstate, jstate)
    decoded = _collect(p_outs, port=True)
    assert decoded == msgs
    assert decoded == [GoldenFSK(jc).demodulate(row) for row in x]
    assert pstate.sync_count.tolist() == [1] * 4


def test_reference_stream_continued_by_port():
    """A reference stream handed over mid-message, with a sample pending
    in the downsample accumulator, decodes the same bytes in the port."""
    _, _, pp, jp = configs()
    rng = np.random.default_rng(22)
    msgs = random_messages(rng, 4, 6)
    x = signals(pp, msgs, snr_db=25, rng=rng)
    cut = 2001                          # odd: ds_phase 1 at the handover
    jstate, j_head = _reference_stream(jp, x[:, :cut], cut)
    fields = reference_fields(jstate)
    pstate = port_demod.state_from_reference(fields, "cpu")
    back = port_demod.state_to_reference(pstate)
    for name, value in fields.items():
        np.testing.assert_array_equal(np.asarray(back[name]), value,
                                      err_msg=name)

    jstate, j_tail = _reference_stream(jp, x[:, cut:], 1000, jstate, 1)
    pstate, p_tail = _port_stream(pp, x[:, cut:], 1000, pstate, 1)
    _check_outs(p_tail, j_tail)
    _check_states(pp, jp, pstate, jstate)
    head = _collect(j_head, port=False)
    got = [h + t for h, t in zip(head, _collect(p_tail, port=True))]
    assert got == msgs
    assert all(0 < len(h) < 6 for h in head)
