"""K5, the zero-prefixed strict-order prefix sum: the plain version the
wrapper runs on CPU tensors, against the reference Pallas kernel in
interpret mode and against numpy's sequential float32 cumsum.  Both
comparisons are exact: the adds run in row order in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webaudio_modem_tpu.ops.pallas import cumsum0 as pcs
from webaudio_modem_tpu_torch.ops.kernels import cumsum0, fsk_seq


def _np_csum0(x):
    out = np.zeros((x.shape[0] + 1, x.shape[1]), np.float32)
    np.cumsum(x.astype(np.float32), axis=0, out=out[1:])
    return out


def _randn(seed, n, B, scale=1.0):
    return (np.random.RandomState(seed).randn(n, B) * scale) \
        .astype(np.float32)


@pytest.mark.parametrize("n, B", [(300, 128), (257, 256), (37, 128),
                                  (512, 256)])
def test_plain_equals_pallas_interpret(n, B):
    x = _randn(n + B, n, B)
    ref = np.asarray(pcs._call(jnp.asarray(x), True))
    got = cumsum0.csum0(torch.from_numpy(x))
    assert got.shape == ref.shape == (n + 1, B)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n, B, scale", [(0, 5, 1.0), (1, 3, 1.0),
                                         (37, 3, 1.0), (2000, 7, 1.0),
                                         (500, 4, 1e6)],
                         ids=["n0", "n1", "odd", "long", "large"])
def test_plain_equals_np_cumsum(n, B, scale):
    """n = 0 gives the zero row alone; large cancelling values stress the
    order contract."""
    x = _randn(n * 7 + B, n, B, scale)
    got = cumsum0.csum0_plain(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), _np_csum0(x))
    assert not got[0].any()


def test_wrapper_takes_cpu_tensors_without_launching():
    x = torch.from_numpy(_randn(5, 64, 4))
    before = cumsum0.launches
    got = cumsum0.csum0(x)
    assert cumsum0.launches == before
    assert torch.equal(got, cumsum0.csum0_plain(x))


def test_k1_csum_mode_plain_is_k5_without_its_zero_row():
    x = torch.from_numpy(_randn(6, 50, 3))
    np.testing.assert_array_equal(fsk_seq.csum_strict(x).numpy(),
                                  _np_csum0(x.numpy())[1:])


@pytest.mark.parametrize("rows, B, start, n", [(600, 7, 500, 300),
                                               (600, 7, 100, 300),
                                               (600, 7, 599, 600),
                                               (24, 3, 0, 24)],
                         ids=["wraps", "inside", "whole_ring_wrapped",
                              "whole_ring"])
def test_ring_window_equals_the_concatenated_rows(rows, B, start, n):
    """A window of a ring read in place (rows start.., then 0.. past the
    last row) gives bit for bit the prefix sum of the two row ranges
    concatenated, as the blind receiver copied them before."""
    ring = torch.from_numpy(_randn(rows, rows, B))
    cat = torch.cat([ring[start:start + n], ring[:max(0, start + n - rows)]])
    assert cat.shape[0] == n
    got = cumsum0.csum0(ring, start, n)
    assert torch.equal(got, cumsum0.csum0(cat))
    assert torch.equal(got, cumsum0.csum0_plain(ring, start, n))
    np.testing.assert_array_equal(got.numpy(), _np_csum0(cat.numpy()))


@pytest.mark.parametrize("start, n", [(-1, 3), (24, 1), (0, 25), (3, -1)])
def test_ring_window_must_fit_the_ring(start, n):
    ring = torch.zeros((24, 3))
    with pytest.raises(ValueError, match="does not fit"):
        cumsum0.csum0(ring, start, n)
