"""The sync-peak kernel (``csrc/sync_peak.cu``) inside the soft decode on
the card, at the frames cell's shapes (B = 4096, 16 / 45 / 133-byte
frames at 8 dB): t_peak and the gate equal ``sync_peak_plain``'s on the
same R plane, ``soft.sync`` launches the kernel once and no matrix
product, and the packed plane equals that of the same decode through
the plain stage C.

Runs on a card only (``card``); from the root of a checkout, without the
JAX package's conftest:

    python3 -m pytest tests/torch_port/test_torch_sync_peak_card.py -m card \\
        --confcutdir=tests/torch_port -o addopts="" -p no:cacheprovider
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_crc16_card import _launches_under
from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams
from webaudio_modem_tpu_torch.ops import fsk_demod, soft_fsk
from webaudio_modem_tpu_torch.ops.kernels import fsk_seq, sync_peak

B = 4096
SNR_DB = 8.0


def _batch(params, payload_len, device):
    """B frames at 8 dB, every seventh channel silent (its peak a tie of
    the zero plane's ratios, under the gate)."""
    rng = np.random.default_rng(payload_len)
    payloads = [bytes(r) for r in
                rng.integers(0, 256, (B, payload_len), dtype=np.uint8)]
    sig = soft_fsk.encode_frames_batch(params, payloads, device=device)
    power = float(sig.double().pow(2).mean())
    gen = torch.Generator(device=device).manual_seed(payload_len)
    noise = torch.randn(sig.shape, generator=gen, device=device)
    x = sig + noise * (power / 10 ** (SNR_DB / 10)) ** 0.5
    x[torch.arange(B, device=device) % 7 == 0] = 0.0
    return x


@pytest.mark.card
@pytest.mark.parametrize("payload_len", [16, 45, 133])
def test_sync_kernel_in_the_soft_decode(cuda_device, tmp_path, monkeypatch,
                                        payload_len):
    params = FSKParams.from_config(FSKConfig())
    ds = params.ds_samples_per_bit
    x = _batch(params, payload_len, cuda_device)

    state = fsk_demod.init_state(params, B, cuda_device)
    rsum = fsk_seq.seq(params, 0, state.front, state.ds_acc,
                       state.bit_tail[-ds:], x.t().contiguous(),
                       emit_bits=False, emit_amps=False, emit_csum=True)[5]
    t_peak, peak_ok = sync_peak.sync_peak(params, rsum)
    t_plain, ok_plain = sync_peak.sync_peak_plain(params, rsum)
    assert torch.equal(t_peak, t_plain)
    assert torch.equal(peak_ok, ok_plain)
    silent = torch.arange(B, device=cuda_device) % 7 == 0
    assert not t_peak[silent].any() and not peak_ok[silent].any()
    assert peak_ok[~silent].float().mean() > 0.99
    del rsum, state

    for _ in range(2):                  # builds and warms every kernel
        soft_fsk.decode_frames_batch(params, x, payload_len,
                                     device=cuda_device)
    torch.cuda.synchronize()
    before = sync_peak.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = soft_fsk.decode_frames_batch(params, x, payload_len,
                                           device=cuda_device)
        torch.cuda.synchronize()
    assert sync_peak.launches == before + 1
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = json.loads((tmp_path / "trace.json").read_text())
    (sync,) = _launches_under(trace, "soft.sync")
    assert sum("sync_kernel" in k for k in sync) == 1, sync
    assert len(sync) <= 2, sync                 # the kernel and its keys' fill
    assert not any("gemm" in k.lower() for k in sync), sync

    packed = soft_fsk._decode_frames_fused(params, x, payload_len)
    monkeypatch.setattr(sync_peak, "sync_peak", sync_peak.sync_peak_plain)
    plain = soft_fsk._decode_frames_fused(params, x, payload_len)
    assert torch.equal(packed, plain)
    assert got == soft_fsk.decode_frames_batch(params, x, payload_len,
                                               device=cuda_device)
