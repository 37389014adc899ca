"""Stage C, the frame-sync correlation: exact against the reference.

Every operand and partial sum is an integer below 2^24 and the last
step divides by the same window length, so the ratios must be equal,
not close."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torch_port_helpers import CONFIGS, configs
from webaudio_modem_tpu.ops import fsk_demod as jax_demod
from webaudio_modem_tpu_torch.ops import fsk_demod as port_demod


def _bits_and_r(params, n_ds, B, seed):
    """A random bit stream ext [W + n_ds, B] of long runs, with the sync
    pattern in channel 0, and its rolling ds-wide sums split as the
    carried r_tail [W - ds, B] and the fresh rsum [n_ds, B]."""
    rng = np.random.default_rng(seed)
    W, ds = params.sync_window, params.ds_samples_per_bit
    runs = rng.integers(1, 3 * ds, size=(W + n_ds, B))
    flips = rng.random((W + n_ds, B)) < 1.0 / runs
    ext = (np.cumsum(flips, 0) % 2).astype(np.float32)
    # channel 0 carries the sync pattern aligned with the window of
    # output n_ds // 2 (its first bit, compared with no window block, is
    # left out)
    start = n_ds // 2 + 1
    ext[start:start + W - ds, 0] = np.repeat(params.pattern_bits[1:], ds)
    cs = np.concatenate([np.zeros((1, B)), np.cumsum(ext, 0)])
    r = (cs[ds:] - cs[:-ds])[1:]        # r[k] = R(ext index ds + k)
    return ext, r[:W - ds].astype(np.float32), r[W - ds:].astype(np.float32)


@pytest.mark.parametrize("name", ["default", "bench_300_mark_gt_space"])
@pytest.mark.parametrize("n_ds", [2400, 777, 13])
def test_ratios_from_r_exact(name, n_ds):
    _, _, pp, jp = configs(**CONFIGS[name])
    ext, r_tail, rsum = _bits_and_r(pp, n_ds, 6, seed=n_ds)
    ref = np.asarray(jax_demod._sync_ratios_from_r(
        jp, jnp.asarray(r_tail, jnp.bfloat16), jnp.asarray(rsum,
                                                           jnp.bfloat16)))
    port = port_demod._sync_ratios_from_r(
        pp, torch.from_numpy(r_tail).to(torch.bfloat16),
        torch.from_numpy(rsum).to(torch.bfloat16)).numpy()
    np.testing.assert_array_equal(port, ref)
    # the same ratios from bits alone
    cumsum = port_demod._sync_ratios_cumsum(pp, torch.from_numpy(ext))
    np.testing.assert_array_equal(cumsum.numpy(), ref)
    assert ref[n_ds // 2, 0] > 0.95


@pytest.mark.parametrize("name", ["default", "ds_over_256"])
def test_ratios_cumsum_exact(name):
    _, _, pp, jp = configs(**CONFIGS[name])
    ext, _, _ = _bits_and_r(pp, 700, 3, seed=11)
    ref = np.asarray(jax_demod._sync_ratios_cumsum(
        jp, jnp.asarray(ext, jnp.bfloat16)))
    port = port_demod._sync_ratios_cumsum(
        pp, torch.from_numpy(ext).to(torch.bfloat16)).numpy()
    np.testing.assert_array_equal(port, ref)
