"""K4's module: the port's aligned LLR windows against the reference's.

The plain version of K4 (``ops/kernels/align.py:aligned_wsum_plain``,
what ``aligned_wsum`` runs on CPU tensors) must be EXACTLY equal to the
reference's Pallas kernel in interpret mode, ``aligned_wsum(...,
interpret=True)``: every output is the same single f32 subtraction of
the same two rows, then the +-1 multiply.  Stride 1 (header windows)
and ds (body windows), ``pad_lo``, ``virt0`` (the inclusive-cumsum
plane), base 0 and the maximum base.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from webaudio_modem_tpu.ops.pallas import align as jax_align
from webaudio_modem_tpu_torch.ops.kernels import align as port_align

B = 128          # one 128-lane block of the reference kernel


def _planes(seed, T):
    """(zero-prefixed cumsum [T, B], inclusive cumsum [T-1, B]) of
    random softs, numpy f32."""
    softs = np.random.default_rng(seed).standard_normal(
        (T - 1, B)).astype(np.float32)
    inc = np.cumsum(softs, axis=0, dtype=np.float32)
    full = np.concatenate([np.zeros((1, B), np.float32), inc])
    return full, inc


def _bases(seed, max_shift):
    base = np.random.default_rng(seed).integers(
        0, max(max_shift, 0) + 1, B).astype(np.int32)
    base[0] = 0                        # pin both edges
    base[1] = max(max_shift, 0)
    return base


def _both(csum, base, n_out, ds, **kw):
    ref = np.asarray(jax_align.aligned_wsum(
        jnp.asarray(csum), jnp.asarray(base), n_out, ds, interpret=True,
        **kw))
    got = port_align.aligned_wsum(torch.from_numpy(csum),
                                  torch.from_numpy(base), n_out, ds, **kw)
    return ref, got.numpy()


@pytest.mark.parametrize("virt0", [False, True])
@pytest.mark.parametrize("pad_lo", [0, 25])
def test_header_windows_exact(pad_lo, virt0):
    T, ds, n_out, pol = 2001, 20, 401, -1.0
    full, inc = _planes(7 + pad_lo, T)
    max_shift = pad_lo + (T - ds) - n_out
    base = _bases(8 + pad_lo, max_shift)
    ref, got = _both(inc if virt0 else full, base, n_out, ds, stride=1,
                     pad_lo=pad_lo, polarity=pol, virt0=virt0)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("virt0", [False, True])
def test_body_windows_strided_exact(virt0):
    T, ds, n_out, pol = 2001, 20, 91, 1.0
    full, inc = _planes(11, T)
    max_shift = (T - ds) - ((n_out - 1) * ds + 1)
    base = _bases(12, max_shift)
    ref, got = _both(inc if virt0 else full, base, n_out, ds, stride=ds,
                     polarity=pol, virt0=virt0)
    np.testing.assert_array_equal(got, ref)


def test_base_zero_reads_the_virtual_row():
    T, ds, n_out = 501, 4, 64
    full, inc = _planes(13, T)
    base = np.zeros(B, np.int32)
    ref, got = _both(inc, base, n_out, ds, virt0=True)
    np.testing.assert_array_equal(got, ref)
    assert got[0, 0] == full[ds, 0]


def test_short_plane_reads_zeros_past_the_end():
    """U longer than the plane: rows past it are exact zeros."""
    T, ds, n_out = 101, 4, 120
    full, _ = _planes(14, T)
    base = np.zeros(B, np.int32)
    ref, got = _both(full, base, n_out, ds)
    np.testing.assert_array_equal(got, ref)
    assert (got[T - ds:] == 0).all()
