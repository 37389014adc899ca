"""K3's module: the port's Viterbi decoder against the reference's.

The plain version of K3 (``ops/kernels/viterbi.py:decode_plain``, what
the port's ``fec._viterbi_core`` runs on CPU tensors) must give EQUAL
bits to the reference's ``fec._viterbi_core`` (the lax scan on the CPU,
which its Pallas kernel equals bit for bit): the same single-add branch
terms, strict ``>`` tie-break and 16-step normalization schedule.  No
tolerance: decoded bits are compared exactly, on coded streams, pure
noise, near-ties and group-boundary lengths.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from webaudio_modem_tpu.ops import fec as jax_fec
from webaudio_modem_tpu_torch.ops import fec as port_fec

L = 12


def _decode_both(soft, n_bits, per_step_norm=False):
    ref = np.asarray(jax_fec._viterbi_core(jnp.asarray(soft), n_bits,
                                           per_step_norm))
    got = port_fec._viterbi_core(torch.from_numpy(soft), n_bits,
                                 per_step_norm).numpy()
    return ref, got


def _coded_soft(rng, n_bits, sigma):
    bits = rng.integers(0, 2, (L, n_bits), dtype=np.uint8)
    coded = port_fec.conv_encode_bits_batch(bits).astype(np.float32) * 2 - 1
    soft = coded + sigma * rng.standard_normal(coded.shape,
                                               dtype=np.float32)
    return bits, soft.reshape(L, -1, 2)


@pytest.mark.parametrize("T", [15, 16, 17, 38, 150])
def test_coded_streams_equal_bits(T):
    """Group-boundary lengths: below, at and above one 16-step group,
    the header trellis (38) and the bench body trellis (150)."""
    rng = np.random.default_rng(T)
    n_bits = T - (port_fec.K - 1)
    bits, soft = _coded_soft(rng, n_bits, sigma=0.9)
    ref, got = _decode_both(soft, n_bits)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.uint8 and got.shape == (L, n_bits)
    # the noise level decodes most lanes, so the comparison covers both
    # correct and mis-decoded trellises
    assert (got == bits).all(1).sum() >= L // 2


def test_pure_noise_equal_bits():
    rng = np.random.default_rng(1)
    soft = rng.standard_normal((L, 40, 2)).astype(np.float32)
    ref, got = _decode_both(soft, 34)
    np.testing.assert_array_equal(got, ref)


def test_near_ties_equal_bits():
    """Correlations on a coarse grid make many path metrics tie exactly:
    the strict ``c1 > c0`` must keep h = 0 in both."""
    rng = np.random.default_rng(2)
    soft = rng.integers(-1, 2, (L, 40, 2)).astype(np.float32) * 0.5
    ref, got = _decode_both(soft, 34)
    np.testing.assert_array_equal(got, ref)


def test_long_trellis_equal_bits():
    """A payload-100 body (T = 822): the reference's Pallas kernel fell
    back to the scan there; the port's kernel has no length gate."""
    rng = np.random.default_rng(3)
    bits, soft = _coded_soft(rng, 8 * 102, sigma=1.0)
    ref, got = _decode_both(soft[:4], 8 * 102)
    np.testing.assert_array_equal(got, ref)


def test_per_step_norm_schedule_equal_bits():
    rng = np.random.default_rng(4)
    _, soft = _coded_soft(rng, 32, sigma=1.0)
    ref, got = _decode_both(soft, 32, per_step_norm=True)
    np.testing.assert_array_equal(got, ref)


def test_batch_shape_is_kept():
    rng = np.random.default_rng(5)
    soft = rng.standard_normal((2, 3, 38, 2)).astype(np.float32)
    ref, got = _decode_both(soft, 32)
    assert got.shape == (2, 3, 32)
    np.testing.assert_array_equal(got, ref)


def test_conv_encode_batch_matches_reference():
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2, (5, 77), dtype=np.uint8)
    np.testing.assert_array_equal(port_fec.conv_encode_bits_batch(bits),
                                  jax_fec.conv_encode_bits_batch(bits))
    np.testing.assert_array_equal(port_fec.conv_encode_bits(bits[0]),
                                  jax_fec.conv_encode_bits(bits[0]))
    for got, ref in zip(port_fec._tables(), jax_fec._tables()):
        np.testing.assert_array_equal(got, ref)


def test_hard_decision_and_byte_round_trips():
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, 64).astype(np.uint8)
    coded = port_fec.conv_encode_bits(bits)
    coded[[5, 40, 90]] ^= 1                      # three channel errors
    np.testing.assert_array_equal(
        port_fec.viterbi_decode_bits(coded, 64, device="cpu"), bits)
    data = bytes(rng.integers(0, 256, 11, dtype=np.uint8))
    enc = port_fec.encode_bytes(data)
    assert enc == jax_fec.encode_bytes(data)
    assert len(enc) == port_fec.coded_length(11) == jax_fec.coded_length(11)
    assert port_fec.decode_bytes(enc, 11, device="cpu") == data
    soft = rng.standard_normal((3, 2 * (20 + 6))).astype(np.float32)
    np.testing.assert_array_equal(
        port_fec.viterbi_decode_soft(soft, 20, device="cpu"),
        jax_fec.viterbi_decode_soft(soft, 20))


def test_frame_builders_match_reference():
    for n in (0, 9, 300):
        assert port_fec.build_frame_header(n) == \
            jax_fec.build_frame_header(n)
    assert port_fec.build_frame_body(b"payload") == \
        jax_fec.build_frame_body(b"payload")
