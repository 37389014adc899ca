"""The port's copy of tests/transports/test_soft_batch_internals.py: the
building blocks of the fused farm soft decode
(``soft_fsk._decode_frames_fused``) and the on-device frame synthesis.

The reference pins its barrel-shift aligners (``_aligned_rows`` /
``_aligned_strided``), which the port replaces by kernel K4
(``ops/kernels/align.py``: a direct per-channel gather of window sums).
The same contracts are held here through K4's entry point, with window
sums of width 1 over integer planes, which are the planes themselves
exactly: a stride-1 window is ``_aligned_rows``, a stride-ds one
``_aligned_strided``.  The reference's header-stage options that the
port does not have (``bits=None``, ``csum_mode``) map to what the port
runs in their place: K1's csum mode (bit and amp streams dropped) against
the full-stream run prefix-summed by K5, and K4 reading the inclusive
cumsum through its virtual zero row (``virt0``) against the zero-prefixed
plane.  Everything runs on the CPU (the plain versions)."""

import numpy as np
import pytest
import torch

from webaudio_modem_tpu_torch.models.config import (DEFAULT_FSK_CONFIG,
                                                    FSKConfig, FSKParams)
from webaudio_modem_tpu_torch.ops import fec, fsk_demod, soft_fsk
from webaudio_modem_tpu_torch.ops.kernels import align, fsk_seq
from webaudio_modem_tpu_torch.utils.crc16 import CRC16


def _gather(plane, base, n_out, stride):
    """K4 as a plain gather: width-1 window sums of an integer plane."""
    inc = torch.cumsum(torch.from_numpy(plane), 0)
    return align.aligned_wsum(inc, torch.from_numpy(base), n_out, 1,
                              stride=stride, virt0=True).numpy()


def _int_plane(rng, T, B):
    return rng.randint(-1000, 1000, (T, B)).astype(np.float32)


class TestAlignedRows:
    def test_matches_numpy_gather(self):
        rng = np.random.RandomState(0)
        T, B, U = 200, 16, 37
        plane = _int_plane(rng, T, B)
        base = rng.randint(0, T - U + 1, B).astype(np.int32)
        out = _gather(plane, base, U, 1)
        ref = np.stack([plane[base[b]:base[b] + U, b] for b in range(B)],
                       axis=1)
        assert (out == ref).all()

    def test_zero_base_is_identity_prefix(self):
        plane = np.arange(40, dtype=np.float32).reshape(10, 4)
        out = _gather(plane, np.zeros(4, np.int32), 6, 1)
        assert (out == plane[:6]).all()

    def test_short_plane_zero_pads(self):
        # T < U: the rows past the plane read zero, the slice never fails
        plane = np.ones((3, 4), np.float32)
        out = _gather(plane, np.zeros(4, np.int32), 5, 1)
        assert out.shape == (5, 4)
        assert (out[:3] == 1.0).all() and (out[3:] == 0.0).all()

    def test_max_shift(self):
        # every channel at the maximum legal base
        rng = np.random.RandomState(1)
        T, B, U = 64, 8, 16
        plane = _int_plane(rng, T, B)
        out = _gather(plane, np.full(B, T - U, np.int32), U, 1)
        assert (out == plane[T - U:]).all()


class TestAlignedStrided:
    @pytest.mark.parametrize("ds", [1, 2, 16, 20])
    def test_matches_numpy_gather(self, ds):
        rng = np.random.RandomState(ds)
        n_out = 23
        T, B = n_out * ds + 175, 16
        plane = _int_plane(rng, T, B)
        base = rng.randint(0, T - (n_out - 1) * ds - 1, B).astype(np.int32)
        out = _gather(plane, base, n_out, ds)
        ref = np.stack([plane[base[b] + np.arange(n_out) * ds, b]
                        for b in range(B)], axis=1)
        assert (out == ref).all()

    def test_max_base(self):
        ds, n_out = 20, 7
        T, B = 200, 8
        rng = np.random.RandomState(2)
        plane = _int_plane(rng, T, B)
        base = np.full(B, T - (n_out - 1) * ds - 1, np.int32)
        out = _gather(plane, base, n_out, ds)
        ref = np.stack([plane[base[b] + np.arange(n_out) * ds, b]
                        for b in range(B)], axis=1)
        assert (out == ref).all()

    def test_equals_dense_window_stride(self):
        # the body windows' form: a stride-ds read equals the dense
        # stride-1 window read every ds rows
        rng = np.random.RandomState(3)
        ds, n_out = 20, 30
        T, B = 1000, 32
        plane = _int_plane(rng, T, B)
        U = (n_out - 1) * ds + 1
        base = rng.randint(0, T - U, B).astype(np.int32)
        dense = _gather(plane, base, U, 1)[::ds]
        strided = _gather(plane, base, n_out, ds)
        assert (strided == dense).all()


class TestDeviceCRC16:
    @pytest.mark.parametrize("nbytes", [1, 2, 9, 16, 32])
    def test_matches_table_crc(self, nbytes):
        rng = np.random.RandomState(nbytes)
        data = rng.randint(0, 256, (17, nbytes), dtype=np.uint8)
        bits = np.unpackbits(data, axis=-1)
        dev = soft_fsk._crc16_bits_device(torch.from_numpy(bits)).numpy()
        ref = np.array([CRC16.calculate(bytes(r)) for r in data])
        assert (dev == ref).all()

    def test_reference_vectors(self):
        # the reference suite's vectors (crc16.node.test.ts:12-61)
        for data, want in ((b"A", 0xB915), (b"123456789", 0x29B1),
                           (b"\x00", 0xE1F0), (b"\xff", 0xFF00)):
            bits = np.unpackbits(np.frombuffer(data, np.uint8))
            got = int(soft_fsk._crc16_bits_device(torch.from_numpy(bits)))
            assert got == want, data


class TestViterbiButterfly:
    def test_roundtrip_random_payloads(self):
        rng = np.random.RandomState(3)
        for n_bits in (8, 33, 120):
            bits = rng.randint(0, 2, (5, n_bits)).astype(np.uint8)
            coded = fec.conv_encode_bits_batch(bits)
            soft = coded.astype(np.float32) * 2.0 - 1.0
            dec = fec.viterbi_decode_soft(soft, n_bits, device="cpu")
            assert (dec == bits).all()

    def test_corrects_burst_errors(self):
        rng = np.random.RandomState(4)
        bits = rng.randint(0, 2, 64).astype(np.uint8)
        coded = fec.conv_encode_bits(bits).astype(np.float32) * 2 - 1
        coded[10:14] = -coded[10:14]          # 4-bit burst flip
        dec = fec.viterbi_decode_soft(coded, 64, device="cpu")
        assert (dec == bits).all()


class TestFusedDecode:
    def test_packed_ok_column_and_erasures(self):
        params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
        payloads = [bytes((i * 13 + k) & 0xFF for k in range(9))
                    for i in range(8)]
        sigs = soft_fsk.encode_frames_batch(params, payloads, device="cpu")
        noisy = sigs.numpy().copy()
        noisy[3] = 0.0                        # erase one channel
        out = soft_fsk.decode_frames_batch(params, noisy, 9, device="cpu")
        assert out[3] is None
        for i in (0, 1, 2, 4, 5, 6, 7):
            assert out[i] == payloads[i]


def _batch(rng, n, payload_len, sigma):
    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    payloads = [bytes(rng.randint(0, 256, payload_len, dtype=np.uint8))
                for _ in range(n)]
    sigs = soft_fsk.encode_frames_batch(params, payloads,
                                        device="cpu").numpy()
    noisy = (sigs + sigma * rng.standard_normal(sigs.shape)) \
        .astype(np.float32)
    return params, payloads, noisy


class TestHeaderTopK:
    """Differential pin of the alignment-score candidate pruning
    (``soft_fsk.HEADER_TOP_K``) against the full-grid header search: the
    contract is payload-byte agreement per channel (which offset
    validates may differ, both being CRC-checked headers of the same
    frame)."""

    @staticmethod
    def _decode(params, noisy, payload_len, top_k):
        packed = soft_fsk._decode_frames_fused(
            params, torch.from_numpy(noisy), payload_len,
            top_k=top_k).numpy()
        return [bytes(packed[b, :payload_len])
                if packed[b, payload_len] else None
                for b in range(len(packed))]

    def test_clean_and_moderate_noise_payloads_identical(self):
        rng = np.random.RandomState(11)
        for sigma in (0.0, 0.05):
            params, payloads, noisy = _batch(rng, 16, 9, sigma)
            assert self._decode(params, noisy, 9, None) == payloads
            assert self._decode(params, noisy, 9, 0) == payloads

    def test_near_cliff_success_parity(self):
        # heavy noise: some frames erase in both forms; the pruned form
        # must not lose more than a hair against the full grid, and every
        # successful decode must be the true payload
        rng = np.random.RandomState(23)
        params, payloads, noisy = _batch(rng, 48, 9, 0.45)
        pruned = self._decode(params, noisy, 9, None)
        full = self._decode(params, noisy, 9, 0)
        ok_p = sum(p == t for p, t in zip(pruned, payloads))
        ok_f = sum(p == t for p, t in zip(full, payloads))
        for got in (pruned, full):
            for g, t in zip(got, payloads):
                assert g is None or g == t  # CRC gate: no wrong bytes
        # both forms in the partially decoding regime
        assert 0 < ok_f
        assert ok_p >= ok_f - 2, (ok_p, ok_f)

    def test_valid_mask_gates_pruning(self):
        # a stream too short for any body span: every candidate is
        # invalid, pruning must yield all-None (not garbage ranks)
        rng = np.random.RandomState(5)
        params, payloads, noisy = _batch(rng, 4, 9, 0.0)
        T_hdr = (soft_fsk.HEADER_CODED_BITS + 8) \
            * params.ds_samples_per_bit * params.downsample_ratio
        out = soft_fsk.decode_frames_batch(params, noisy[:, :T_hdr], 9,
                                           device="cpu")
        assert out == [None] * 4


@pytest.fixture(scope="module")
def stage_planes():
    """K1 over one noisy batch twice: every stream, and the fused
    decode's csum mode (bit and amp streams dropped, the softs' inclusive
    running sum in their slot)."""
    rng = np.random.RandomState(31)
    params, payloads, noisy = _batch(rng, 8, 9, 0.05)
    ds = params.ds_samples_per_bit
    state = fsk_demod.init_state(params, len(noisy), "cpu")
    x = torch.from_numpy(noisy).t().contiguous()
    full = fsk_seq.seq(params, 0, state.front, state.ds_acc,
                       state.bit_tail[-ds:], x)
    csum_mode = fsk_seq.seq(params, 0, state.front, state.ds_acc,
                            state.bit_tail[-ds:], x, emit_bits=False,
                            emit_amps=False, emit_csum=True)
    return params, full, csum_mode, rng


def _header_stage(params, csum, rsum, body_bits_n):
    """The fused decode's header stage: the sync peak, then the header
    candidates and their one batched Viterbi; (starts, headers, valid)."""
    t_peak, peak_ok = soft_fsk._sync_peak(params, rsum)
    return soft_fsk._candidate_headers(params, csum, t_peak, peak_ok,
                                       body_bits_n, soft_fsk.HEADER_TOP_K)


class TestHeaderStageBitsOptional:
    def test_csum_mode_matches_the_full_stream_run(self, stage_planes):
        # the fused path drops the bit stream (R carries sync) and reads
        # K1's running sum; the full run's softs prefix-summed by K5 must
        # give the same header stage, output for output
        params, full, csum_mode, _ = stage_planes
        body_bits_n = soft_fsk._body_coded_bits(9)
        _, _, bits, _, softs, rsum = full
        assert csum_mode[2] is None and csum_mode[3] is None
        torch.testing.assert_close(csum_mode[5], rsum, rtol=0, atol=0)
        with_bits = _header_stage(params, soft_fsk._csum0(softs)[1:],
                                  rsum, body_bits_n)
        without = _header_stage(params, csum_mode[4], csum_mode[5],
                                body_bits_n)
        for a, b in zip(with_bits, without):
            assert torch.equal(a, b)


class TestHeaderStageCsumModes:
    def test_full_mode_matches_softs_mode(self, stage_planes):
        # K4 reading the inclusive cumsum through its virtual zero row
        # equals K4 over the zero-prefixed plane, at the header windows
        params, full, _, _ = stage_planes
        softs, rsum = full[4], full[5]
        inc = soft_fsk._csum0(softs)[1:]
        zero_prefixed = soft_fsk._csum0(softs)
        t_peak, _ = soft_fsk._sync_peak(params, rsum)
        base, _, kw = soft_fsk._header_window(params, inc.shape[0], t_peak)
        assert kw["virt0"]
        via_inc = align.aligned_wsum(inc, base, **kw)
        via_full = align.aligned_wsum(zero_prefixed, base,
                                      **{**kw, "virt0": False})
        assert torch.equal(via_inc, via_full)

    def test_body_stage_full_plane_contract(self, stage_planes):
        # the same contract at the body windows (stride ds) for random
        # grid starts
        params, full, _, rng = stage_planes
        softs = full[4]
        inc = soft_fsk._csum0(softs)[1:]
        zero_prefixed = soft_fsk._csum0(softs)
        b_starts = torch.from_numpy(
            rng.randint(0, 40, softs.shape[1]).astype(np.int32))
        base, _, kw = soft_fsk._body_window(params, inc.shape[0], b_starts,
                                            9)
        got = align.aligned_wsum(inc, base, **kw)
        exp = align.aligned_wsum(zero_prefixed, base,
                                 **{**kw, "virt0": False})
        assert torch.equal(got, exp)
        bodies = soft_fsk._batch_body_stage(params, inc, b_starts, 9)
        assert bodies.shape == (softs.shape[1], 8 * (9 + 2))


class TestDeviceFrameSynthesis:
    """``frames_synth_device_fn`` == ``encode_frames_batch``, bit-exact in
    sample values: the same integer phase accumulators (an integer cumsum
    of the ones here, the reference's triangular matmul), the same f32
    sine expansion."""

    def test_matches_host_framing_exactly(self):
        rng = np.random.RandomState(11)
        for cfg in (DEFAULT_FSK_CONFIG,
                    FSKConfig(baud_rate=300, mark_frequency=1270,
                              space_frequency=1070)):
            params = FSKParams.from_config(cfg)
            for pl in (1, 46):
                B = 8
                payloads = [bytes(rng.randint(0, 256, pl, dtype=np.uint8))
                            for _ in range(B)]
                host = soft_fsk.encode_frames_batch(params, payloads,
                                                    device="cpu")
                fn = soft_fsk.frames_synth_device_fn(params, pl)
                pay = np.frombuffer(b"".join(payloads), np.uint8) \
                    .reshape(B, pl)
                dev = fn(torch.from_numpy(pay.copy()), device="cpu")
                assert torch.equal(host, dev)

    def test_non_integer_config_falls_back(self):
        params = FSKParams.from_config(FSKConfig(mark_frequency=1650.5))
        assert soft_fsk.frames_synth_device_fn(params, 4) is None
