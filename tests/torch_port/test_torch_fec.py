"""The reference's convolutional-code and normalization-schedule tests
(``tests/transports/test_fec.py`` ``TestConvolutionalCode``,
``TestViterbiNormSchedule``) on the port's ``ops/fec.py``, on the CPU.

On CPU tensors ``fec._viterbi_core`` runs K3's plain version
(``ops/kernels/viterbi.py:decode_plain`` over ``branch_sums``), which
``chip_smoke.py`` holds the kernel to bit for bit on the card.  Cases
that ``test_torch_viterbi.py`` already has (the batched encoder against
the reference, three channel errors, the per-step schedule's bits
against the reference's) are left out; where a decode here can be
compared with the reference's on the same input, it is, exactly.
"""

import numpy as np
import pytest

from webaudio_modem_tpu.ops import fec as jax_fec
from webaudio_modem_tpu_torch.ops import fec
from webaudio_modem_tpu_torch.utils.crc16 import CRC16

CPU = "cpu"


class TestConvolutionalCode:
    def test_all_zero_input_codes_to_zero(self):
        coded = fec.conv_encode_bits(np.zeros(32, np.uint8))
        assert not coded.any()

    def test_impulse_response_is_generator_pattern(self):
        # a single 1 emits the generator taps as it shifts through the
        # register (newest bit in the LSB, so tap i fires at step i)
        coded = fec.conv_encode_bits(np.asarray([1, 0, 0, 0, 0, 0, 0]))
        pairs = coded.reshape(-1, 2)[:7]
        assert pairs[:, 0].tolist() == [(0o171 >> i) & 1 for i in range(7)]
        assert pairs[:, 1].tolist() == [(0o133 >> i) & 1 for i in range(7)]

    @pytest.mark.parametrize("n", [1, 100])
    def test_rate_is_half_plus_flush(self, n):
        coded = fec.conv_encode_bits(np.ones(n, np.uint8))
        assert len(coded) == 2 * (n + fec.K - 1)

    @pytest.mark.parametrize("size", [1, 17, 128])
    def test_clean_roundtrip_bytes(self, size):
        rng = np.random.RandomState(size)
        data = bytes(rng.randint(0, 256, size, dtype=np.uint8))
        assert fec.decode_bytes(fec.encode_bytes(data), size,
                                device=CPU) == data

    def test_corrects_random_bit_errors(self):
        rng = np.random.RandomState(2)
        data = bytes(rng.randint(0, 256, 40, dtype=np.uint8))
        n_bits = 8 * 40
        bits = fec.bytes_to_bits(fec.encode_bytes(data))[
            :2 * (n_bits + fec.K - 1)]
        noisy = np.stack([bits] * 10)
        noisy[rng.uniform(size=noisy.shape) < 0.03] ^= 1
        dec = fec.viterbi_decode_bits(noisy, n_bits, device=CPU)
        np.testing.assert_array_equal(
            dec, jax_fec.viterbi_decode_bits(noisy, n_bits))
        ok = sum(fec.bits_to_bytes(row)[:40] == data for row in dec)
        assert ok >= 9   # 3% random coded-bit errors: essentially always

    def test_soft_decision_beats_hard(self):
        # the memo's core motivation: soft values buy ~2 dB
        rng = np.random.RandomState(0)
        data = bytes(rng.randint(0, 256, 40, dtype=np.uint8))
        n_bits = 8 * 40
        bits = fec.bytes_to_bits(fec.encode_bytes(data))[
            :2 * (n_bits + fec.K - 1)]
        tx = bits.astype(np.float64) * 2 - 1
        rx = (tx + 0.65 * rng.standard_normal((20, len(tx)))).astype(
            np.float32)
        soft = fec.viterbi_decode_soft(rx, n_bits, device=CPU)
        hard = fec.viterbi_decode_bits((rx > 0).astype(np.uint8), n_bits,
                                       device=CPU)
        np.testing.assert_array_equal(soft,
                                      jax_fec.viterbi_decode_soft(rx, n_bits))
        soft_ok = sum(fec.bits_to_bytes(r)[:40] == data for r in soft)
        hard_ok = sum(fec.bits_to_bytes(r)[:40] == data for r in hard)
        assert soft_ok >= 18
        assert soft_ok > hard_ok

    def test_batched_decode(self):
        # channel batching is a leading axis, like every other kernel
        rng = np.random.RandomState(3)
        B = 32
        datas = [bytes(rng.randint(0, 256, 20, dtype=np.uint8))
                 for _ in range(B)]
        softs = np.stack([
            fec.bytes_to_bits(fec.encode_bytes(d))[:2 * 166]
            .astype(np.float32) * 2 - 1 for d in datas])
        decs = fec.viterbi_decode_soft(softs, 160, device=CPU)
        assert decs.shape == (B, 160)
        for b in range(B):
            assert fec.bits_to_bytes(decs[b])[:20] == datas[b]


class TestViterbiNormSchedule:
    """The grouped normalization (every 16 steps, K3's schedule) against
    the per-step form (``per_step_norm=True``): decoded bytes agree at the
    CRC gate from clean through the decode cliff into pure noise, and
    bit for bit away from f32-borderline ties."""

    @staticmethod
    def _coded(rng, n_frames, payload_len):
        payloads = [bytes(rng.randint(0, 256, payload_len, dtype=np.uint8))
                    for _ in range(n_frames)]
        tx = np.stack([fec.conv_encode_bits(fec.bytes_to_bits(
            fec.build_frame_body(p))).astype(np.float64) * 2 - 1
            for p in payloads])
        return payloads, tx

    @staticmethod
    def _crc_gate(bits, payload_len):
        """bits [8*(pl+2)] -> payload bytes iff the CRC16 gate passes
        (exactly the soft path's acceptance rule)."""
        body = fec.bits_to_bytes(bits)
        payload = body[:payload_len]
        if CRC16.calculate(payload) == ((body[payload_len] << 8)
                                        | body[payload_len + 1]):
            return payload
        return None

    @pytest.mark.parametrize("sigma", [0.0, 0.5, 0.8, 1.0, 1.2, 2.0])
    def test_byte_agreement_at_crc_gate_across_snr(self, sigma):
        rng = np.random.RandomState(42 + int(10 * sigma))
        payload_len = 16
        n_bits = 8 * (payload_len + 2)
        payloads, tx = self._coded(rng, 24, payload_len)
        rx = (tx + sigma * rng.standard_normal(tx.shape)).astype(np.float32)
        new = fec.viterbi_decode_soft(rx, n_bits, device=CPU)
        old = fec.viterbi_decode_soft(rx, n_bits, per_step_norm=True,
                                      device=CPU)
        np.testing.assert_array_equal(new,
                                      jax_fec.viterbi_decode_soft(rx, n_bits))
        disagreements = 0
        for k, want in enumerate(payloads):
            pn = self._crc_gate(new[k], payload_len)
            po = self._crc_gate(old[k], payload_len)
            if (pn is None) != (po is None):
                # a borderline f32 flip turned a frame into a clean
                # erasure in one form: allowed, but rare
                disagreements += 1
                continue
            assert pn == po, f"CRC-passing payloads diverge at {sigma}"
            if pn is not None and sigma <= 0.5:
                assert pn == want
        assert disagreements <= 1

    @pytest.mark.parametrize("sigma", [0.0, 0.3])
    def test_clean_and_moderate_noise_bit_identical(self, sigma):
        # away from f32-borderline ties the two schedules are outright
        # bit-identical (same comparisons, same winners)
        rng = np.random.RandomState(7)
        payload_len = 32
        n_bits = 8 * (payload_len + 2)
        _, tx = self._coded(rng, 8, payload_len)
        rx = (tx + sigma * rng.standard_normal(tx.shape)).astype(np.float32)
        np.testing.assert_array_equal(
            fec.viterbi_decode_soft(rx, n_bits, device=CPU),
            fec.viterbi_decode_soft(rx, n_bits, per_step_norm=True,
                                    device=CPU))

    @pytest.mark.parametrize("size", [128, 255])
    def test_long_payload_grouped_form_roundtrips(self, size):
        # payload lengths driving many 16-step groups and a remainder
        rng = np.random.RandomState(3 + size)
        data = bytes(rng.randint(0, 256, size, dtype=np.uint8))
        assert fec.decode_bytes(fec.encode_bytes(data), size,
                                device=CPU) == data
