#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — streaming hard-decision FSK demodulation
of thousands of channels (300 baud, mark 1270 Hz / space 1070 Hz, 48 kHz,
0.1 s chunks) — through the hand-written kernels K1
(``webaudio_modem_tpu_torch/csrc/fsk_seq.cu``) and K2 (``csrc/
fsk_framing.cu``), which it builds with nvcc first.  Phases:

  1. the card: torch / CUDA versions, nvidia-smi name and power limit;
  2. build K1 and K2 for sm_90a;
  3. each kernel against its plain PyTorch version on the card, at
     B=2048 on noisy chunks of distinct messages, with state carried;
     K2 also at maxb > 64 (a 32768-sample piece at 1200 baud);
  4. the main path: ModemFarm(batch=4096, device="cuda") modulates and
     decodes 4096 distinct 13-byte messages exactly, counting launches;
     FSKCore round-trips b"Hello, World!";
  5. per-chunk times (CUDA events) of demod_chunk through the kernels
     and through the plain versions, at B=2048 and 4096.

Every phase raises on failure, so the exit code is non-zero.  Without a
CUDA device it fails in phase 1 and prints no result.  The last line is
one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import sys
import time

CHUNK = 4800                      # 0.1 s at 48 kHz
AUDIO_S_PER_CHUNK = CHUNK / 48000
MAIN_BATCH = 4096
CHECK_BATCH = 2048
ATOL = 1e-4                       # softs, amps and state, kernel vs plain
FLIP_SOFT = 1e-5                  # a bit may differ only this near 0


def _bench_config():
    from webaudio_modem_tpu_torch.models.config import FSKConfig

    return FSKConfig(baud_rate=300, mark_frequency=1270,
                     space_frequency=1070)


def _messages(rng, batch, n_bytes):
    msgs = [bytes(rng.integers(0, 256, n_bytes, dtype="uint8"))
            for _ in range(batch)]
    if len(set(msgs)) != batch:
        raise RuntimeError("random messages are not distinct")
    return msgs


def _awgn(sig, snr_db, rng, device):
    import numpy as np
    import torch

    power = float(torch.mean(sig.double() ** 2))
    noise = rng.standard_normal(tuple(sig.shape), dtype=np.float32)
    sigma = (power / 10 ** (snr_db / 10)) ** 0.5
    return sig + torch.from_numpy(noise).to(device) * sigma


def _cuda_ms(fn, reps):
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _check_k1(params, state, ds_phase, x, errs):
    """K1 vs plain on identical inputs; returns the kernel outputs."""
    import torch

    from webaudio_modem_tpu_torch.ops.kernels import fsk_seq

    ds = params.ds_samples_per_bit
    args = (params, ds_phase, state.front, state.ds_acc,
            state.bit_tail[-ds:], x)
    k = fsk_seq.seq(*args)
    p = fsk_seq.seq_plain(*args)
    torch.cuda.synchronize()
    front_k, acc_k, bits_k, amps_k, softs_k, rsum_k = k
    front_p, acc_p, bits_p, amps_p, softs_p, _ = p
    if bits_k.shape != bits_p.shape:
        raise RuntimeError(f"K1 shape {bits_k.shape} vs {bits_p.shape}")
    parts = {name: float((a - b).abs().max()) if a.numel() else 0.0
             for name, a, b in (("softs", softs_k, softs_p),
                                ("amps", amps_k, amps_p),
                                ("front", front_k, front_p),
                                ("ds_acc", acc_k, acc_p))}
    err = max(parts.values())
    errs.append(err)
    if err > ATOL:
        raise RuntimeError(f"K1 vs plain: max abs err {parts} > {ATOL}")
    flips = bits_k != bits_p
    n_flips = int(flips.sum())
    if n_flips and float(softs_p[flips].abs().max()) >= FLIP_SOFT:
        raise RuntimeError(f"K1: {n_flips} bits differ away from the "
                           "slicer threshold")
    ext = torch.cat([state.bit_tail[-ds:].float(), bits_k.float()])
    cs = torch.cumsum(ext, 0)
    if not torch.equal(cs[ds:] - cs[:-ds], rsum_k.float()):
        raise RuntimeError("K1: rsum differs from the R of its own bits")
    print(f"  K1 T={x.shape[0]} ds_phase={ds_phase}: max abs err {err:.3g}, "
          f"bits differing {n_flips} of {bits_k.numel()}, rsum exact")
    return k


def _check_k2(params, state, bits, amps, rsum, errs):
    """K2 vs plain on identical inputs (from K1's outputs)."""
    import torch

    from webaudio_modem_tpu_torch.ops import fsk_demod
    from webaudio_modem_tpu_torch.ops.kernels import fsk_framing

    n_ds = bits.shape[0]
    maxb = fsk_demod.max_bytes(params, n_ds)
    ratios = fsk_demod._sync_ratios_from_r(params, state.r_tail, rsum)
    ints, flts = fsk_demod._framing_carry(params, state)
    args = (params, ints, flts, state.bit_fill, bits, amps, ratios,
            torch.cat([state.amp_tail, amps]), maxb)
    k = fsk_framing.stage_d_compact(*args)
    p = fsk_framing.stage_d_compact_plain(*args)
    torch.cuda.synchronize()
    names = ("ints", "flts", "bytes_out", "byte_count", "eod_fired",
             "sync_fired", "fire_t")
    for name, a, b in zip(names, k, p):
        if not torch.equal(a, b):
            raise RuntimeError(f"K2 vs plain: {name} differs")
    errs.append(max(float((a.double() - b.double()).abs().max())
                    if a.numel() else 0.0 for a, b in zip(k, p)))
    print(f"  K2 n_ds={n_ds} maxb={maxb}: identical; bytes "
          f"{int(k[3].sum())}, syncs {int(k[5].sum())}, "
          f"EODs {int(k[4].sum())}")
    return k


def phase_kernels_vs_plain(device, rng):
    import torch

    from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams
    from webaudio_modem_tpu_torch.ops import fsk_demod, fsk_mod

    errs = {"fsk_seq": [], "fsk_framing": []}
    params = FSKParams.from_config(_bench_config())
    msgs = _messages(rng, CHECK_BATCH, 13)
    sig = fsk_mod.modulate_batch(params, msgs, device)
    x_all = _awgn(sig[:, :3 * CHUNK], 20.0, rng, device)
    state = fsk_demod.init_state(params, CHECK_BATCH, device)
    ds_phase, start = 0, 0
    for T in (CHUNK, CHUNK - 1, CHUNK):   # the odd chunk leaves a prefix
        x = x_all[:, start:start + T].t().contiguous()
        _, _, bits, amps, _, rsum = _check_k1(params, state, ds_phase, x,
                                              errs["fsk_seq"])
        _check_k2(params, state, bits, amps, rsum, errs["fsk_framing"])
        state, _ = fsk_demod.demod_chunk(params, ds_phase, state,
                                         x_all[:, start:start + T])
        ds_phase = (ds_phase + T) % params.downsample_ratio
        start += T

    # K2 beyond the TPU kernel's 64 byte slots: one 32768-sample piece
    # at 1200 baud holding a whole 70-byte message per channel
    params = FSKParams.from_config(FSKConfig())
    msgs = _messages(rng, CHECK_BATCH, 70)
    sig = fsk_mod.modulate_batch(params, msgs, device)
    x = torch.nn.functional.pad(sig, (0, 32768 - sig.shape[1]))
    state = fsk_demod.init_state(params, CHECK_BATCH, device)
    ds = params.ds_samples_per_bit
    _, _, bits, amps, _, rsum = _check_k1(params, state, 0,
                                          x.t().contiguous(),
                                          errs["fsk_seq"])
    k = _check_k2(params, state, bits, amps, rsum, errs["fsk_framing"])
    if k[2].shape[1] <= 64:
        raise RuntimeError("maxb check did not exceed 64 slots")
    counts = k[3].cpu().numpy()
    vals = k[2].cpu().numpy()
    got = [bytes(vals[b, :counts[b]]) for b in range(CHECK_BATCH)]
    if got != msgs:
        bad = sum(g != m for g, m in zip(got, msgs))
        raise RuntimeError(f"maxb > 64 piece: {bad} channels decoded wrong")
    print(f"  maxb {k[2].shape[1]} > 64: {CHECK_BATCH} x 70 bytes exact "
          f"(ds={ds})")
    return {name: max(v) for name, v in errs.items()}


def phase_main_path(device, rng):
    from webaudio_modem_tpu_torch.models.config import FSKConfig
    from webaudio_modem_tpu_torch.models.farm import ModemFarm
    from webaudio_modem_tpu_torch.models.fsk import FSKCore
    from webaudio_modem_tpu_torch.ops.kernels import fsk_framing, fsk_seq

    farm = ModemFarm(_bench_config(), MAIN_BATCH, device=device)
    msgs = _messages(rng, MAIN_BATCH, 13)
    sig = farm.modulate(msgs)
    n_chunks = -(-sig.shape[1] // CHUNK)
    fsk_seq.launches = 0
    fsk_framing.launches = 0
    t0 = time.perf_counter()
    decoded = farm.demodulate(sig, chunk_size=CHUNK)
    seconds = time.perf_counter() - t0
    launches = {"fsk_seq": fsk_seq.launches,
                "fsk_framing": fsk_framing.launches}
    exact = sum(d == m for d, m in zip(decoded, msgs))
    print(f"  ModemFarm B={MAIN_BATCH}: {exact}/{MAIN_BATCH} messages "
          f"exact over {n_chunks} chunks of {CHUNK} samples "
          f"({seconds:.2f} s host wall, bytes collected per chunk); "
          f"launches {launches}")
    if exact != MAIN_BATCH:
        raise RuntimeError(f"only {exact}/{MAIN_BATCH} decoded exactly")
    if launches != {"fsk_seq": n_chunks, "fsk_framing": n_chunks}:
        raise RuntimeError(f"launches {launches} != {n_chunks} chunk steps")
    status = farm.get_status()
    if not (status["sync_detections"] == 1).all():
        raise RuntimeError("a channel did not sync exactly once")
    print(f"  channel 0 quality: {farm.get_signal_quality()[0]}")

    core = FSKCore(FSKConfig(), device=device)
    message = b"Hello, World!"
    out = core.demodulate_data(core.modulate_data(message))
    print(f"  FSKCore round trip: {out!r}")
    if out != message:
        raise RuntimeError(f"FSKCore decoded {out!r}")
    return launches


def phase_timings(device, rng, card):
    import torch

    from webaudio_modem_tpu_torch.models.config import FSKParams
    from webaudio_modem_tpu_torch.ops import fsk_demod, fsk_mod
    from webaudio_modem_tpu_torch.ops.kernels import fsk_framing, fsk_seq

    params = FSKParams.from_config(_bench_config())
    ds = params.ds_samples_per_bit
    kernel_ms = {}
    for B in (CHECK_BATCH, MAIN_BATCH):
        sig = fsk_mod.modulate_batch(params, _messages(rng, B, 13), device)
        n = sig.shape[1] // CHUNK
        chunks = [sig[:, i * CHUNK:(i + 1) * CHUNK] for i in range(n)]
        for plain, reps in ((False, 25), (True, 2)):
            st = [fsk_demod.init_state(params, B, device), 0]

            def step():
                st[0], _ = fsk_demod.demod_chunk(
                    params, 0, st[0], chunks[st[1] % n], plain=plain)
                st[1] += 1
            if not plain:
                for _ in range(3):
                    step()
            ms = _cuda_ms(step, reps)
            path = "plain" if plain else "kernels"
            print(f"  demod_chunk B={B} {path}: {ms:.3f} ms per 0.1 s "
                  f"chunk, {B * AUDIO_S_PER_CHUNK / (ms / 1e3):,.0f} "
                  f"realtime channels [{card}]")

        if B == MAIN_BATCH:
            # each kernel beside its plain version at the main path's shape
            state = st[0]
            x = chunks[0].t().contiguous()
            args = (params, 0, state.front, state.ds_acc,
                    state.bit_tail[-ds:], x)
            out = fsk_seq.seq(*args)
            kernel_ms["fsk_seq"] = (_cuda_ms(lambda: fsk_seq.seq(*args), 20),
                                    _cuda_ms(lambda: fsk_seq.seq_plain(*args),
                                             1))
            _, _, bits, amps, _, rsum = out
            ratios = fsk_demod._sync_ratios_from_r(params, state.r_tail,
                                                   rsum)
            ints, flts = fsk_demod._framing_carry(params, state)
            dargs = (params, ints, flts, state.bit_fill, bits, amps, ratios,
                     torch.cat([state.amp_tail, amps]),
                     fsk_demod.max_bytes(params, bits.shape[0]))
            kernel_ms["fsk_framing"] = (
                _cuda_ms(lambda: fsk_framing.stage_d_compact(*dargs), 20),
                _cuda_ms(lambda: fsk_framing.stage_d_compact_plain(*dargs),
                         1))
            for name, (k, p) in kernel_ms.items():
                print(f"  {name} B={B} T={CHUNK}: kernel {k:.3f} ms, plain "
                      f"{p:.1f} ms [{card}]")
    return kernel_ms


def main() -> int:
    import numpy as np
    import torch

    from webaudio_modem_tpu_torch.ops.kernels import _build
    from webaudio_modem_tpu_torch.utils.device import require_cuda

    print("phase 1: device")
    device, card = require_cuda()
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    print(f"  {card}")

    print("phase 2: build")
    t0 = time.perf_counter()
    path = _build.build()
    print(f"  {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  {line.strip()}")

    rng = np.random.default_rng(0)
    print("phase 3: kernels vs plain on the card")
    max_err = phase_kernels_vs_plain(device, rng)
    print("phase 4: main path")
    launches = phase_main_path(device, rng)
    print("phase 5: timings")
    kernel_ms = phase_timings(device, rng, card)

    if "jax" in sys.modules:
        raise RuntimeError("the port imported jax")
    sources = {"fsk_seq": ("webaudio_modem_tpu_torch/csrc/fsk_seq.cu",
                           "webaudio_modem_tpu/ops/pallas/fsk_seq.py:131"),
               "fsk_framing": ("webaudio_modem_tpu_torch/csrc/fsk_framing.cu",
                               "webaudio_modem_tpu/ops/pallas/"
                               "fsk_framing.py:208")}
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                "max_abs_err": max_err[name], "ms": kernel_ms[name][0],
                "plain_ms": kernel_ms[name][1]}
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
