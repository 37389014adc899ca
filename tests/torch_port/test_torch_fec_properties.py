"""Property-based FEC invariants (hypothesis) for the port's FEC layer.

tests/transports/test_fec_properties.py asserts the contracts of the
reference's block codes (Reed-Solomon, its interleaver, LDPC, turbo);
those modules are slice E of the port (ROADMAP queue 1, item 14) and get
their copies with it.  The same kind of contract is held here over what
the port runs today, the rate-1/2 K=7 convolutional code (``ops/fec.py``)
and the frame codec over it (``transports/fec_frame.py``), against random
data, lengths and corruption patterns:

  * the frame codec round-trips any payload, byte-identical to the JAX
    package's encoder;
  * the terminated code corrects ANY pattern of up to 4 coded-bit errors
    (free distance 10: maximum-likelihood decoding is unique);
  * the batched encoder equals the per-row one and the reference's;
  * a frame after any junk is still found (lossless resync).
"""

import numpy as np
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from webaudio_modem_tpu.ops import fec as jax_fec
from webaudio_modem_tpu.transports import fec_frame as jax_fec_frame
from webaudio_modem_tpu_torch.ops import fec
from webaudio_modem_tpu_torch.transports.fec_frame import (FrameDecoder,
                                                           FrameEncoder)

# each example runs K3's plain version on the CPU (tens of ms a decode)
_SETTINGS = dict(max_examples=20, deadline=None, derandomize=True,
                 suppress_health_check=[HealthCheck.too_slow])


class TestFrameCodecProperties:
    @settings(**_SETTINGS)
    @given(payload=st.binary(min_size=0, max_size=80))
    def test_any_payload_roundtrips(self, payload):
        frame = FrameEncoder.encode_frame(payload)
        assert frame == jax_fec_frame.FrameEncoder.encode_frame(payload)
        assert len(frame) == FrameEncoder.coded_frame_length(len(payload))
        assert FrameDecoder(device="cpu").process(frame) == [payload]

    @settings(**_SETTINGS)
    @given(junk=st.binary(min_size=0, max_size=48),
           payload=st.binary(min_size=1, max_size=32))
    def test_frame_after_any_junk_is_found(self, junk, payload):
        dec = FrameDecoder(max_payload=64, device="cpu")
        got = dec.process(junk + FrameEncoder.encode_frame(payload))
        got += dec.process(b"\x00" * FrameEncoder.coded_frame_length(66))
        assert got == [payload]


class TestConvolutionalCodeProperties:
    @settings(**_SETTINGS)
    @given(n_bits=st.integers(1, 96), seed=st.integers(0, 2 ** 31 - 1),
           n_err=st.integers(0, 4))
    def test_corrects_any_up_to_four_bit_errors(self, n_bits, seed, n_err):
        rng = np.random.RandomState(seed)
        bits = rng.randint(0, 2, n_bits).astype(np.uint8)
        coded = fec.conv_encode_bits(bits)
        bad = coded.copy()
        pos = rng.choice(len(coded), size=n_err, replace=False)
        bad[pos] ^= 1
        dec = fec.viterbi_decode_bits(bad, n_bits, device="cpu")
        np.testing.assert_array_equal(dec, bits)

    @settings(**_SETTINGS)
    @given(rows=st.integers(1, 6), n_bits=st.integers(0, 70),
           seed=st.integers(0, 2 ** 31 - 1))
    def test_batched_encoder_equals_rows_and_reference(self, rows, n_bits,
                                                       seed):
        bits = np.random.RandomState(seed).randint(
            0, 2, (rows, n_bits)).astype(np.uint8)
        batch = fec.conv_encode_bits_batch(bits)
        for r in range(rows):
            np.testing.assert_array_equal(batch[r],
                                          fec.conv_encode_bits(bits[r]))
        np.testing.assert_array_equal(
            batch, np.asarray(jax_fec.conv_encode_bits_batch(bits)))
