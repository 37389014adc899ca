"""The CRC kernel (``csrc/crc16.cu``) inside the soft decode on the card:
at B = 4096 one decode launches it once under ``soft.select`` (the
header candidates' CRC) and once under ``soft.pack`` (the whole body
gate and packing), nothing else is launched under ``soft.pack``, and the
packed plane and the payloads equal those of the same decode with the
CRC's plain versions.

Runs on a card only (``card``); from the root of a checkout, without the
JAX package's conftest:

    python3 -m pytest tests/torch_port/test_torch_crc16_card.py -m card \\
        --confcutdir=tests/torch_port -o addopts="" -p no:cacheprovider
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams
from webaudio_modem_tpu_torch.ops import soft_fsk
from webaudio_modem_tpu_torch.ops.kernels import crc16

B = 4096
PAYLOAD = 45
SNR_DB = 8.0


def _batch(params, device):
    """B frames at 8 dB; every seventh channel erased (no header found),
    every seventh from the fourth with noise over its body (the header
    found, the body's CRC failing)."""
    rng = np.random.default_rng(15)
    payloads = [bytes(r) for r in
                rng.integers(0, 256, (B, PAYLOAD), dtype=np.uint8)]
    sig = soft_fsk.encode_frames_batch(params, payloads, device=device)
    power = float(sig.double().pow(2).mean())
    gen = torch.Generator(device=device).manual_seed(15)
    noise = torch.randn(sig.shape, generator=gen, device=device)
    x = sig + noise * (power / 10 ** (SNR_DB / 10)) ** 0.5
    rows = torch.arange(B, device=device)
    x[rows % 7 == 0] = 0.0
    body = soft_fsk.frame_signal_length(params, PAYLOAD) // 2
    x[rows % 7 == 3, body:] += 10.0 * noise[rows % 7 == 3, body:]
    return payloads, x


def _launches_under(trace, span):
    """The kernel names of every launch record inside each ``span``
    annotation (same thread), by the launch's correlation id."""
    ev = trace["traceEvents"]
    kernels = {e["args"]["correlation"]: e["name"] for e in ev
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
               and "correlation" in e.get("args", {})}
    out = []
    for s in (e for e in ev if e.get("cat") == "user_annotation"
              and e["name"] == span):
        out.append([kernels.get(e["args"].get("correlation"), e["name"])
                    for e in ev
                    if e.get("cat") == "cuda_runtime"
                    and e.get("tid") == s["tid"]
                    and s["ts"] <= e["ts"] <= s["ts"] + s["dur"]
                    and ("Launch" in e["name"] or "Memcpy" in e["name"]
                         or "Memset" in e["name"])])
    return out


@pytest.mark.card
def test_crc_kernel_in_the_soft_decode(cuda_device, tmp_path, monkeypatch):
    params = FSKParams.from_config(FSKConfig())
    payloads, x = _batch(params, cuda_device)
    for _ in range(2):                  # builds and warms every kernel
        soft_fsk.decode_frames_batch(params, x, PAYLOAD, device=cuda_device)
    torch.cuda.synchronize()

    before = crc16.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = soft_fsk.decode_frames_batch(params, x, PAYLOAD,
                                           device=cuda_device)
        torch.cuda.synchronize()
    assert crc16.launches == before + 2
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = json.loads((tmp_path / "trace.json").read_text())
    pack = _launches_under(trace, "soft.pack")
    select = _launches_under(trace, "soft.select")
    assert len(pack) == len(select) == 1
    assert len(pack[0]) == 1 and "crc_kernel" in pack[0][0], pack
    assert sum("crc_kernel" in k for k in select[0]) == 1, select

    packed = soft_fsk._decode_frames_fused(params, x, PAYLOAD)
    monkeypatch.setattr(crc16, "pack_bodies", crc16.pack_bodies_plain)
    monkeypatch.setattr(crc16, "crc_rows", crc16.crc_rows_plain)
    plain = soft_fsk._decode_frames_fused(params, x, PAYLOAD)
    assert torch.equal(packed, plain)
    assert got == soft_fsk.decode_frames_batch(params, x, PAYLOAD,
                                               device=cuda_device)
    ok = packed[:, PAYLOAD].cpu().numpy().astype(bool)
    rows = np.arange(B)
    # erased channels find no header; noisy bodies fail their CRC (a
    # garbage body passes it once in 65,536); the rest decode exact
    assert not ok[rows % 7 == 0].any()
    assert ok[rows % 7 == 3].sum() <= 1
    sound = rows[(rows % 7 != 0) & (rows % 7 != 3)]
    assert sum(got[b] == payloads[b] for b in sound) >= len(sound) - 7
    assert all(got[b] is None or got[b] == payloads[b] for b in sound)
