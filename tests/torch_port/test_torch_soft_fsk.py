"""The soft-FEC farm slice as a whole: frame synthesis and the fused
batch decode of the port against the reference's, on the same noisy
numpy batches.

Samples agree within float32 rounding.  Payloads are compared at the
CRC gate, as the reference holds itself: the port's soft values come
from ``atan2f`` and its prefix sum is a strict f32 loop, the
reference's CPU path from its own atan2 and ``jnp.cumsum``, so single
LLRs differ in the last bits.  At clean and 8 dB the payload lists must
be identical; near the decode cliff no payload may be wrong and the
port may lose at most two more frames than the reference.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import configs
from webaudio_modem_tpu.ops import soft_fsk as jax_soft
from webaudio_modem_tpu.utils.crc16 import CRC16 as JaxCRC16
from webaudio_modem_tpu_torch.ops import soft_fsk as port_soft
from webaudio_modem_tpu_torch.utils.crc16 import CRC16

B = 12
PAYLOAD = 9
SAMPLE_ATOL = 2e-6        # f32 sin of the same exact integer phases


def _payloads(rng, n, length):
    return [bytes(rng.integers(0, 256, length, dtype=np.uint8))
            for _ in range(n)]


@pytest.fixture(scope="module")
def soft_case():
    """One clean batch (the reference's synthesis) plus its 8 dB copy
    (channel 0 erased) and a near-cliff copy (sigma 0.45), each decoded
    once by both packages."""
    _, _, pp, jp = configs()
    rng = np.random.default_rng(31)
    payloads = _payloads(rng, B, PAYLOAD)
    clean = np.asarray(jax_soft.encode_frames_batch(jp, payloads))
    power = np.mean(clean.astype(np.float64) ** 2)
    noisy = (clean + np.sqrt(power / 10 ** 0.8)
             * rng.standard_normal(clean.shape)).astype(np.float32)
    noisy[0] = 0.0
    cliff = (clean + 0.45 * rng.standard_normal(clean.shape)) \
        .astype(np.float32)
    out = {"payloads": payloads, "signal": clean}
    for name, x in (("clean", clean), ("8dB", noisy), ("cliff", cliff)):
        out[name] = (jax_soft.decode_frames_batch(jp, x, PAYLOAD),
                     port_soft.decode_frames_batch(pp, x, PAYLOAD,
                                                   device="cpu"))
    return out


@pytest.mark.parametrize("name", ["default", "bench_300"])
def test_encode_frames_batch_matches_reference(name):
    kw = {} if name == "default" else dict(
        baud_rate=300, mark_frequency=1270, space_frequency=1070)
    _, _, pp, jp = configs(**kw)
    payloads = _payloads(np.random.default_rng(32), 3, 5)
    ref = np.asarray(jax_soft.encode_frames_batch(jp, payloads))
    got = port_soft.encode_frames_batch(pp, payloads, device="cpu")
    assert got.shape == ref.shape == \
        (3, port_soft.frame_signal_length(pp, 5))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=SAMPLE_ATOL)


def test_encode_frame_signal_matches_reference():
    _, _, pp, jp = configs()
    ref = jax_soft.encode_frame_signal(jp, b"abc")
    got = port_soft.encode_frame_signal(pp, b"abc", device="cpu")
    np.testing.assert_allclose(got, ref, rtol=0, atol=SAMPLE_ATOL)
    assert port_soft.frame_signal_length(pp, 3) == \
        jax_soft.frame_signal_length(jp, 3) == len(got)


@pytest.mark.parametrize("n_bits", [16, 72, 128, 133])
def test_device_crc16_matches_table(n_bits):
    """Whole bytes through the table recurrence, a tail through the
    bit-serial form; the reference's device CRC agrees too."""
    rng = np.random.default_rng(n_bits)
    bits = rng.integers(0, 2, (7, n_bits)).astype(np.uint8)
    got = port_soft._crc16_bits_device(torch.from_numpy(bits)).numpy()
    ref = np.asarray(jax_soft._crc16_bits_device(bits))
    np.testing.assert_array_equal(got, ref)
    if n_bits % 8 == 0:
        rows = np.packbits(bits, axis=1)
        np.testing.assert_array_equal(got, CRC16.calculate_rows(rows))
        assert [CRC16.calculate(bytes(r)) for r in rows] == \
            [JaxCRC16.calculate(bytes(r)) for r in rows]


@pytest.mark.parametrize("name", ["clean", "8dB"])
def test_decode_payloads_identical_to_reference(soft_case, name):
    ref, got = soft_case[name]
    assert got == ref
    expect = list(soft_case["payloads"])
    if name == "8dB":
        expect[0] = None                 # the erased channel
    assert got == expect


def test_decode_near_cliff_crc_gate(soft_case):
    ref, got = soft_case["cliff"]
    payloads = soft_case["payloads"]
    for g, t in zip(got, payloads):
        assert g is None or g == t       # no wrong payload passes
    ok_port = sum(g == t for g, t in zip(got, payloads))
    ok_ref = sum(r == t for r, t in zip(ref, payloads))
    assert 0 < ok_ref < B                # a partly decoding regime
    assert ok_port >= ok_ref - 2, (ok_port, ok_ref)


def test_erased_channel_decodes_to_none(soft_case):
    ref, got = soft_case["8dB"]
    assert got[0] is None and ref[0] is None


def test_too_short_stream_decodes_nothing(soft_case):
    """Shorter than one coded header span: no decode runs at all; just
    past it, every candidate fails the body-span mask."""
    _, _, pp, _ = configs()
    clean = soft_case["signal"][:4]
    span = port_soft.HEADER_CODED_BITS * pp.ds_samples_per_bit \
        * pp.downsample_ratio
    for T in (span - 2, span + 16 * pp.ds_samples_per_bit):
        out = port_soft.decode_frames_batch(pp, clean[:, :T], PAYLOAD,
                                            device="cpu")
        assert out == [None] * 4


@pytest.mark.parametrize("kw", [dict(rs_parity=4),
                                dict(body_code=object())],
                         ids=["rs_parity", "body_code"])
def test_slice_e_options_raise(kw):
    _, _, pp, _ = configs()
    with pytest.raises(NotImplementedError, match="slice E"):
        port_soft.decode_frames_batch(pp, np.zeros((1, 64), np.float32),
                                      PAYLOAD, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="slice E"):
        port_soft.encode_frames_batch(pp, [b"x" * PAYLOAD], device="cpu",
                                      **kw)
