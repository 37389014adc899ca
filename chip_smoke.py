#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths through the hand-written kernels, which
it builds with nvcc first (one nvcc per source, all at once):

  * streaming hard-decision FSK demodulation of thousands of channels
    (300 baud, mark 1270 Hz / space 1070 Hz, 48 kHz, 0.1 s chunks):
    K1 (``webaudio_modem_tpu_torch/csrc/fsk_seq.cu``) and K2
    (``csrc/fsk_framing.cu``);
  * the farm soft-FEC frame decode (1200 baud, 16-byte payloads at
    8 dB, ``soft_fsk.decode_frames_batch``): K1 in its csum mode, K4
    (``csrc/align.cu``) and K3 (``csrc/viterbi.cu``);
  * streaming DBPSK demodulation of thousands of channels (1200 baud,
    1800 Hz carrier, 48 kHz, 0.1 s chunks, ``bench.py --family psk``):
    K6 (``csrc/psk_seq.cu``) and K2;
  * blind soft-frame acquisition (1200 baud, 0.1 s quanta,
    ``soft_blind.BlindSoftBatchReceiver``): K1 per quantum, then K5
    (``csrc/cumsum0.cu``), K4 and K3 in every header and body program;
    and the streaming single-channel decoder (``SoftFrameDecoder``);
  * BASELINE config 2, Bell-202 BER sweeps at B=4096
    (``sim.ber.ber_sweep`` over ``ModemFarm``, whole signals: K1, K2),
    and after them the TPU's long-chunk route over the same signals:
    K8 (``csrc/fsk_stage_d.cu``) through its entry point
    ``fsk_demod.stage_d`` and the masked-sum compaction (no other entry
    point of the port reaches K8; its launches are reported under the
    path "tpu_route (chip_smoke)"); BASELINE config 4 (V.21 full
    duplex), the impairment sweeps and checkpoints.

Phases:

  1. the card: torch / CUDA versions, nvidia-smi name and power limit;
  2. build every kernel for sm_90a;
  3. K1 and K2 against their plain PyTorch versions on the card, every
     output exactly, at B=2048 on noisy chunks of distinct messages, with
     state carried; K2 also at maxb > 64 (a 32768-sample piece at 1200
     baud); the pipelines' edges: K1 and K7 at B = 1000 and 1 over
     pieces of 1, 17, 0, 4801 and 65 samples (every stream mode on the
     short ones) at ds = 80, 256 and 480, and K2 at B = 1001 and 1 with
     an odd n_ds whose last, partial tile holds a firing step;
  4. the hard main path: ModemFarm(batch=4096, device="cuda") modulates
     and decodes 4096 distinct 13-byte messages exactly, counting
     launches; FSKCore round-trips b"Hello, World!";
  5. per-chunk times (CUDA events) of demod_chunk through the kernels
     and through the plain versions, at B=2048 and 4096;
  6. the soft path's kernels against their plain versions, exactly, on
     the decode's own intermediate planes at B=2048: K1 with the bit
     and amp streams dropped and the softs' inclusive running sum (also
     held against a strict f32 loop over the full run's softs), K4 at
     the header and body windows and at the extreme bases, K3 at the
     header, body and a payload-100 trellis (read in place as soft
     views); K3 and K4 at their edges (K3 at each width and record
     placement its wrapper picks, reached by L and T: T = 1, 15, 16,
     17, 38, 40 and each width's shared-memory switch and one step
     more, L from the first and to the last lane count of each width,
     partial blocks, both soft-view layouts, near-ties; K4: stride 1, ds
     and one not dividing ds, virt0, pad_lo, bases at and past the
     plane's edges, n_wsum <= 0, B = 1, 5, 129);
     K7 (K1 without R) at 50 baud (ds = 480), timed beside its plain
     version, and 50-baud streams decoding exactly;
  7. the soft main path: 2048 distinct random payloads at 8 dB decode
     exactly with 1 / 2 / 2 launches of K1 / K4 / K3, and an erased
     channel decodes to None;
  8. soft timings at B=2048 and 4096 (per decode, realtime channels,
     each kernel beside its plain version and, for K4, torch.gather over
     window sums made beforehand, which is not K4's function; K3's and
     K4's device time in a CUDA graph beside it, ``graph_ms``),
     peak device memory, and a torch.profiler breakdown;
  9. K6 against its plain version on the card, every output exactly, at
     B=2048: noisy DBPSK chunks of distinct messages with state carried
     over three chunks, one of odd length (a ds_phase prefix); K6
     without R at 50 baud (D = 480, rings in shared memory) and at 50
     baud and 96 kHz (D = 960, rings in device memory); the pipeline's
     edges: B = 1001 and 1 over pieces of 1, 17, 0, 4801 and 65 samples
     with state carried, at D = 20, at D = 5 (shorter than a G tile) and
     at D = 960;
 10. the DBPSK main path: ModemFarm(PSKConfig(), batch=4096) decodes 4096
     distinct 13-byte messages exactly, counting launches; PSKCore
     round-trips b"Hello, World!"; the signal quality is finite;
 11. DBPSK timings: demod_chunk per chunk at B=2048 and 4096 (and its
     plain version once), K6 beside its plain version and its bound at
     D = 20 (also on tools/turns.py seq's shorter input), 480 and 960,
     and K6's ring placement timed in turns against a copy built with its
     rings in device memory at every D;
 12. K5 against its plain version, exactly (0 mismatches), at the blind
     path's window shapes [7200 / 14400 / 91200, 4096] and at [37, 3]
     and [0, 5]; against np.cumsum of the host copy at two of them; at
     its edges (B = 1 and 4097, a base only 4-byte aligned, ring windows
     that wrap past the last row at B = 4096 and 1001);
 13. the blind main path at B=4096, two 16-byte frames per channel at
     random offsets (silence gaps of 2000-9000 samples): clean (every
     payload exact and in per-channel order; a frame not delivered only
     inside a false sync's refractory span, the reference's rule),
     launches counted (K1 per quantum; K5, K4, K3 once per program); at
     8 dB with noise drawn on the card (no wrong payload); mixed lengths
     1-64 from the headers alone; SoftFrameDecoder equal to the receiver
     on single channels; 256 channels through the kernels and through
     the plain versions (CPU) delivering the same payloads;
 14. blind timings: K5 beside its plain version, torch.cumsum and its
     bound; the steady-state host wall per feed of a cyclic 16-byte
     stream at 8 dB (realtime channels), its host stages and a profile;
     the detector, header and body programs alone (CUDA events);
 15. K8 against its plain version, exactly (planes and carry), with
     compact(K8) equal to K2 and two halves chained through the carry
     equal to one call: the hard bench chunk (n_ds = 2400, B = 4096; K2
     and K8 timed there in turns), the 128-byte Bell-202 messages at
     10 dB (n_ds = 26,440, B = 4096; K8's row numbers, the wrapper
     timed beside the kernel alone), an odd n_ds with syncs, bytes and
     EODs (B = 1000), and n_ds = 0;
 16. BASELINE config 2: Bell-202 sweeps at 30 ... -6 dB, B = 4096, of
     the harness's 4-byte message and a 128-byte one (maxb 148), with
     launches counted (K1 and K2 per point and message); after the
     sweeps, the TPU route (K1 and K8, launches counted apart) over
     every long-sweep batch, which must decode the same bytes; the
     golden comparator on 64 / 8 messages per point
     (every one equal at >= 10 dB; below, each differing message decoded
     the same by the plain versions on the CPU); 0 bit errors at 30 dB;
     peak device memory; whole-signal K1 + sync + stage D by K2 and by
     K8 + compaction, timed;
 17. V.21 full duplex both ways with and without the reference suite's
     noise; carrier-offset and clock-skew sweeps at B = 1024 (golden
     parity on 8 messages per point) and a soft-column point through
     SoftModemCore; a B = 4096 farm saved after 3 chunks, restored into
     a new farm and run on, equal to an uninterrupted run.

Every phase raises on failure, so the exit code is non-zero.  Without a
CUDA device it fails in phase 1 and prints no result.  The line before
the last two is {"kernels": [...]}, then the nvidia-smi name and power
limit; the last line is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import re
import sys
import time

CHUNK = 4800                      # 0.1 s at 48 kHz
AUDIO_S_PER_CHUNK = CHUNK / 48000
MAIN_BATCH = 4096
CHECK_BATCH = 2048
SOFT_BATCHES = (2048, 4096)
SOFT_PAYLOAD = 16                 # bytes (bench.py --family soft)
SOFT_SNR_DB = 8.0
LONG_PAYLOAD = 100                # the long-trellis check: T = 822
# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM bytes/s, f32 ops/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# operations per element, counted from the kernels' sources: K1 does
# ~54 per full-rate sample (AGC 10, band-pass 9, mix 2, NCO rotation
# and renorm 13, I/Q low-passes 18, downsample sums 2) and ~40 per
# decision (two divides, atan2f counted as 20, amplitude 4, wrap 3,
# post biquad 9, slicer 2, R 2); K2 ~40 per step (`_d_step`'s state
# machine); K3 256 per lane-step (64 states x 2 adds, 1 compare,
# 1 select) plus 128 per lane per 16 steps (max and subtract); K4 2 per
# output (a subtract and the +-1 multiply)
K1_OPS_PER_SAMPLE = 54
K1_OPS_PER_DECISION = 40
# K6: K1's front end per sample, and ~39 per decision (two divides, re and
# im 6, atan2f counted as 20, sign and wrap 4, slicer 1, amplitude 4, R 2)
K6_OPS_PER_DECISION = 39
K2_OPS_PER_STEP = 40
K3_OPS_PER_STEP = 256
K3_OPS_PER_NORM = 128
K4_OPS_PER_OUT = 2


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


def _graph_ms(fn, reps):
    """Device time per call of ``fn``: ``reps`` calls captured in one CUDA
    graph, replayed between two CUDA events, so the wrappers' host work
    leaves no gaps between the kernels (``_cuda_ms`` times what a caller
    enqueuing them one by one sees)."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = _cuda_ms(graph.replay, 3) / reps
    graph.reset()       # its private memory pool back to the allocator
    return ms


def _resident(after):
    """Print the device memory still allocated after a phase, before and
    after ``gc.collect()``, and the largest CUDA tensors alive then."""
    import gc

    import torch

    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2 ** 20
    gc.collect()
    sizes = {}
    for obj in gc.get_objects():
        try:
            if not (isinstance(obj, torch.Tensor) and obj.is_cuda):
                continue
        except Exception:      # objects that fail isinstance (proxies)
            continue
        key = (tuple(obj.shape), str(obj.dtype).replace("torch.", ""))
        n, mib = sizes.get(key, (0, 0.0))
        sizes[key] = (n + 1, mib + obj.numel() * obj.element_size() / 2 ** 20)
    top = sorted(sizes.items(), key=lambda kv: -kv[1][1])[:4]
    print(f"  device memory held after {after}: {held:.1f} MiB allocated, "
          f"{torch.cuda.memory_allocated() / 2 ** 20:.1f} after "
          "gc.collect(); largest live CUDA tensors: " + (", ".join(
              f"{n} x {list(shape)} {dtype} ({mib:.1f} MiB)"
              for (shape, dtype), (n, mib) in top) or "none"))


def _nbytes(*tensors):
    """Bytes of the tensors (None for a dropped stream counts 0)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _bound(n_bytes, n_ops):
    """(ms, "bytes" | "operations"): the least time the card could take,
    the larger of the bytes over HBM bandwidth and the operations over
    the f32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _timing(shape, ms, plain_ms, n_bytes, n_ops, library_ms=None):
    bound_ms, bound_by = _bound(n_bytes, n_ops)
    return {"shape": shape, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "bytes": n_bytes, "ops": n_ops}


def _print_timing(name, t, card):
    lib = ("" if t["library_ms"] is None
           else f", library {t['library_ms']:.4f} ms")
    print(f"  {name} {t['shape']}: kernel {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.3f} ms{lib}, bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}; {t['bytes'] / 1e6:.1f} MB, "
          f"{t['ops'] / 1e6:.1f} M ops) [{card}]")


def _check_k1(params, state, ds_phase, x, errs, quiet=False, **flags):
    """K1 (or K7, ``emit_rsum=False``) vs plain on identical inputs, every
    output exactly; returns the kernel outputs."""
    import torch

    from webaudio_modem_tpu_torch.ops.kernels import fsk_seq

    ds = params.ds_samples_per_bit
    rsum = flags.get("emit_rsum", True)
    args = (params, ds_phase, state.front, state.ds_acc,
            state.bit_tail[-ds:] if rsum else None, x)
    k = fsk_seq.seq(*args, **flags)
    p = fsk_seq.seq_plain(*args, **flags)
    torch.cuda.synchronize()
    B = x.shape[1]
    what = f"K1 T={x.shape[0]} B={B} ds={ds} ds_phase={ds_phase} {flags}"
    for name, a, b in zip(("front", "ds_acc", "bits", "amps", "softs",
                           "rsum"), k, p):
        errs.append(_equal_or_raise(f"{what} {name}", a, b))
    if rsum and k[2] is not None and ds <= 256:    # R exact in bf16
        ext = torch.cat([state.bit_tail[-ds:].float(), k[2].float()])
        cs = torch.cumsum(ext, 0)
        if not torch.equal(cs[ds:] - cs[:-ds], k[5].float()):
            raise RuntimeError(f"{what}: rsum differs from the R of its "
                               "own bits")
    if not quiet:
        print(f"  {what}: every output identical to plain")
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


# K1's pipeline hands tiles of 32 samples between its warps
# (csrc/fsk_seq.cu kTile); K2 copies tiles of 16 steps ahead
# (csrc/fsk_framing.cu kTile)
K1_TILE = 32
K2_TILE = 16
EDGE_BATCHES = (1000, 1)
# pieces carried through one state: T = 1 opens a group and decides
# nothing, T < K1_TILE completes it (a ds_phase prefix), T = 0, a T that
# is not a multiple of K1_TILE, and a short piece after it
EDGE_PIECES = (1, 17, 0, CHUNK + 1, 2 * K1_TILE + 1)
K2_EDGE_BATCH = 1001


def _k1_edges(device, rng, errs):
    """K1 and K7 exactly equal to plain at the pipeline's edges: B = 1000
    and 1 (partial and nearly empty blocks), the EDGE_PIECES lengths with
    the state and ds_phase carried, at the bench configuration (ds = 80),
    at ds = 256 (1200 baud at 614.4 kHz, the largest R ring) and at ds =
    480 (50 baud; R there needs more than 48 KB of shared memory).  Every
    stream mode on the short pieces; the long piece in the all-streams
    mode (K7 at ds = 480)."""
    import itertools

    from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams
    from webaudio_modem_tpu_torch.ops import fsk_demod, fsk_mod

    modes = [dict(emit_bits=b, emit_amps=a, emit_csum=c, emit_rsum=r)
             for b, a, c, r in itertools.product((True, False), repeat=4)]
    cases = ((_bench_config(), EDGE_BATCHES),
             (FSKConfig(sample_rate=614400), EDGE_BATCHES[:1]),
             (FSKConfig(baud_rate=50, mark_frequency=1270,
                        space_frequency=1070), EDGE_BATCHES))
    for config, batches in cases:
        params = FSKParams.from_config(config)
        ds = params.ds_samples_per_bit
        long_mode = dict(emit_rsum=ds <= 256)
        for B in batches:
            sig = fsk_mod.modulate_batch(params, _messages(rng, B, 4),
                                         device)
            x_all = _awgn(sig, 20.0, rng, device)
            if x_all.shape[1] < sum(EDGE_PIECES):
                raise RuntimeError("edge signal too short")
            state = fsk_demod.init_state(params, B, device)
            ds_phase, start, n_checks = 0, 0, 0
            for T in EDGE_PIECES:
                piece = x_all[:, start:start + T]
                x = piece.t().contiguous()
                for flags in modes if T <= 4 * K1_TILE else [long_mode]:
                    _check_k1(params, state, ds_phase, x, errs, quiet=True,
                              **flags)
                    n_checks += 1
                state, _ = fsk_demod.demod_chunk(params, ds_phase, state,
                                                 piece)
                ds_phase = (ds_phase + T) % params.downsample_ratio
                start += T
            print(f"  K1 edges ds={ds} B={B}: pieces {EDGE_PIECES} with "
                  f"state carried, {n_checks} calls (16 stream modes on "
                  f"the short pieces, {long_mode} on the long one) "
                  "identical to plain")


def _k2_edges(device, rng, errs):
    """K2 exactly equal to plain at an odd B and an odd n_ds whose last,
    partial K2_TILE holds a firing step, and at B = 1 on that channel."""
    import torch

    from webaudio_modem_tpu_torch.models.config import FSKParams
    from webaudio_modem_tpu_torch.ops import fsk_demod, fsk_mod
    from webaudio_modem_tpu_torch.ops.kernels import fsk_framing, fsk_seq

    params = FSKParams.from_config(_bench_config())
    ds = params.ds_samples_per_bit
    B = K2_EDGE_BATCH
    sig = fsk_mod.modulate_batch(params, _messages(rng, B, 13), device)
    # each channel delayed by its own 0..4095 samples, so that syncs
    # fall on many steps
    L = sig.shape[1]
    delays = torch.from_numpy(rng.integers(0, 4096, B)).to(device)
    idx = torch.arange(L + 4096, device=device)[None, :] - delays[:, None]
    shifted = torch.where((idx >= 0) & (idx < L),
                          sig.gather(1, idx.clamp(0, L - 1)), 0.0)
    x_all = _awgn(shifted, 20.0, rng, device)
    state = fsk_demod.init_state(params, B, device)
    for c in range(x_all.shape[1] // CHUNK):
        piece = x_all[:, c * CHUNK:(c + 1) * CHUNK]
        _, _, bits, amps, _, rsum = fsk_seq.seq(
            params, 0, state.front, state.ds_acc, state.bit_tail[-ds:],
            piece.t().contiguous())
        ratios = fsk_demod._sync_ratios_from_r(params, state.r_tail, rsum)
        ints, flts = fsk_demod._framing_carry(params, state)
        planes = (bits, amps, ratios, torch.cat([state.amp_tail, amps]))
        full = fsk_framing.stage_d_compact(
            params, ints, flts, state.bit_fill, *planes,
            fsk_demod.max_bytes(params, bits.shape[0]))
        fire_t = full[6].cpu().numpy()
        ok = [(int(f), b) for b, f in enumerate(fire_t)
              if f >= K2_TILE and (f + 1) % K2_TILE]
        if ok:
            break
        state, _ = fsk_demod.demod_chunk(params, 0, state, piece)
    else:
        raise RuntimeError("K2 edges: no fire to place in a partial tile")
    f, b_fire = max(ok)
    n_ds = f + 1 if (f + 1) % 2 else f + 2       # odd, f in its last tile
    assert n_ds % 2 and (n_ds - 1) // K2_TILE * K2_TILE <= f < n_ds
    for label, cols in ((f"B={B}", slice(None)),
                        ("B=1", slice(b_fire, b_fire + 1))):
        def cut(t, rows=n_ds):
            return t[:rows, cols].contiguous()
        args = (params, cut(ints, None), cut(flts, None),
                state.bit_fill[cols].contiguous(), cut(bits), cut(amps),
                cut(ratios), cut(planes[3], params.amp_window + n_ds),
                fsk_demod.max_bytes(params, n_ds))
        k = fsk_framing.stage_d_compact(*args)
        p = fsk_framing.stage_d_compact_plain(*args)
        torch.cuda.synchronize()
        for name, a, b in zip(("ints", "flts", "bytes_out", "byte_count",
                               "eod_fired", "sync_fired", "fire_t"), k, p):
            errs.append(_equal_or_raise(f"K2 edges {label} {name}", a, b))
        col = b_fire if label != "B=1" else 0
        if int(k[6][col]) != f:
            raise RuntimeError(f"K2 edges {label}: the fire at step {f} "
                               "did not run in the last tile")
        print(f"  K2 edges {label} n_ds={n_ds} (last tile of "
              f"{n_ds % K2_TILE} steps holds the fire at step {f}): "
              f"identical to plain; syncs {int(k[5].sum())}")


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
    _k1_edges(device, rng, errs["fsk_seq"])
    _k2_edges(device, rng, errs["fsk_framing"])
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
            if B == MAIN_BATCH and not plain:
                try:
                    _profile(f"hard demod_chunk B={B}",
                             lambda: [step() for _ in range(10)], 10, ms,
                             card)
                except RuntimeError as exc:     # a measurement, not a check
                    print(f"  profile: torch.profiler failed: {exc}")

        if B == MAIN_BATCH:
            # each kernel beside its plain version at the main path's shape
            state = st[0]
            x = chunks[0].t().contiguous()
            args = (params, 0, state.front, state.ds_acc,
                    state.bit_tail[-ds:], x)
            out = fsk_seq.seq(*args)
            n = out[2].shape[0]
            kernel_ms["fsk_seq"] = _timing(
                f"T={CHUNK} B={B}, all streams",
                _cuda_ms(lambda: fsk_seq.seq(*args), 20),
                _cuda_ms(lambda: fsk_seq.seq_plain(*args), 1),
                _nbytes(*args[2:], *out),
                CHUNK * B * K1_OPS_PER_SAMPLE + n * B * K1_OPS_PER_DECISION)
            _, _, bits, amps, _, rsum = out
            ratios = fsk_demod._sync_ratios_from_r(params, state.r_tail,
                                                   rsum)
            ints, flts = fsk_demod._framing_carry(params, state)
            sub_amps = torch.cat([state.amp_tail, amps])
            dargs = (params, ints, flts, state.bit_fill, bits, amps, ratios,
                     sub_amps, fsk_demod.max_bytes(params, n))
            dout = fsk_framing.stage_d_compact(*dargs)
            kernel_ms["fsk_framing"] = _timing(
                f"n_ds={n} B={B}",
                _cuda_ms(lambda: fsk_framing.stage_d_compact(*dargs), 20),
                _cuda_ms(lambda: fsk_framing.stage_d_compact_plain(*dargs),
                         1),
                _nbytes(ints, flts, state.bit_fill, bits, amps, ratios,
                        sub_amps[:n], *dout),
                n * B * K2_OPS_PER_STEP)
            for name, t in kernel_ms.items():
                _print_timing(name, t, card)
    return kernel_ms


# ---------------------------------------------------------------------------
# The soft-FEC path
# ---------------------------------------------------------------------------

def _soft_params():
    from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams

    return FSKParams.from_config(FSKConfig())     # 1200 baud, ds = 20


def _soft_batch(params, rng, B, device):
    """(payloads, noisy [B, T] f32 on the card): B distinct random
    payloads framed and synthesized by the port, AWGN at SOFT_SNR_DB."""
    from webaudio_modem_tpu_torch.ops import soft_fsk

    payloads = _messages(rng, B, SOFT_PAYLOAD)
    sig = soft_fsk.encode_frames_batch(params, payloads, device=device)
    return payloads, _awgn(sig, SOFT_SNR_DB, rng, device)


def _soft_planes(params, noisy):
    """The soft decode's intermediate planes, through the kernels, as
    ``_decode_frames_fused`` computes them: K1's csum and R, the header
    candidates' LLRs and the body LLRs as the soft views [L, T, 2] that
    K3 reads in place."""
    import torch

    from webaudio_modem_tpu_torch.ops import fec, fsk_demod, soft_fsk
    from webaudio_modem_tpu_torch.ops.kernels import fsk_seq

    B = noisy.shape[0]
    ds = params.ds_samples_per_bit
    state = fsk_demod.init_state(params, B, noisy.device)
    seq_args = (params, 0, state.front, state.ds_acc, state.bit_tail[-ds:],
                noisy.t().contiguous())
    out = fsk_seq.seq(*seq_args, **CSUM_FLAGS)
    csum, rsum = out[4], out[5]
    body_bits_n = soft_fsk._body_coded_bits(SOFT_PAYLOAD)
    t_peak, peak_ok = soft_fsk._sync_peak(params, rsum)
    starts, h_llr, valid = soft_fsk._header_llrs(params, csum, t_peak,
                                                 peak_ok, body_bits_n)
    L = h_llr.shape[0] * h_llr.shape[1]
    h_soft = h_llr.reshape(L, -1, 2)
    headers = fec._viterbi_core(h_soft, 8 * soft_fsk.HEADER_PLAIN).reshape(
        B, -1, 8 * soft_fsk.HEADER_PLAIN)
    found, _, st = soft_fsk._select_candidate(headers, starts, valid,
                                              payload_len=SOFT_PAYLOAD)
    b_starts = torch.where(found, st + soft_fsk.HEADER_CODED_BITS * ds,
                           torch.zeros_like(st))
    b_llr = soft_fsk._body_llrs(params, csum, b_starts, SOFT_PAYLOAD)
    b_soft = b_llr.t().reshape(B, -1, 2)          # a view of [T * 2, B]
    n_ds = csum.shape[0]
    align_calls = {
        "header": soft_fsk._header_window(params, n_ds, t_peak),
        "body": soft_fsk._body_window(params, n_ds, b_starts, SOFT_PAYLOAD)}
    return dict(seq_args=seq_args, csum=csum, rsum=rsum,
                header=(h_soft, 8 * soft_fsk.HEADER_PLAIN),
                body=(b_soft, 8 * (SOFT_PAYLOAD + 2)),
                align_calls=align_calls)


CSUM_FLAGS = dict(emit_bits=False, emit_amps=False, emit_csum=True)


def _long_trellis(rng, L, device):
    """The soft view [L, 822, 2] of payload-100 bodies: random coded
    streams as +-1 correlations plus Gaussian noise (sigma 0.5), with
    n_bits and the true bits."""
    import numpy as np
    import torch

    from webaudio_modem_tpu_torch.ops import fec

    n_bits = 8 * (LONG_PAYLOAD + 2)
    bits = rng.integers(0, 2, (L, n_bits), dtype=np.uint8)
    coded = fec.conv_encode_bits_batch(bits).astype(np.float32) * 2 - 1
    coded += 0.5 * rng.standard_normal(coded.shape, dtype=np.float32)
    soft = torch.from_numpy(coded).to(device).reshape(L, -1, 2)
    return soft, n_bits, torch.from_numpy(bits).to(device)


def _equal_or_raise(what, got, want):
    """Raise unless ``got`` equals ``want`` exactly; return their max abs
    difference (0.0 for two dropped streams)."""
    import torch

    if got is None or want is None:
        if got is not want:
            raise RuntimeError(f"{what}: a stream is dropped on one side "
                               "only")
        return 0.0
    if got.shape != want.shape or not torch.equal(got, want):
        raise RuntimeError(f"{what}: kernel differs from its plain version")
    return (float((got.double() - want.double()).abs().max())
            if got.numel() else 0.0)


def _align_bytes(csum, base, n_out, ds, stride, pad_lo, virt0, **_):
    """Bytes K4 must move for these inputs: the distinct csum rows its
    windows read (per channel), base, and the output."""
    import torch

    from webaudio_modem_tpu_torch.ops.kernels import align

    r = align.rows(base, n_out, stride, pad_lo)           # [n_out, B]
    n_wsum = csum.shape[0] + (1 if virt0 else 0) - ds
    n_in = ((r >= 0) & (r < n_wsum)).sum(0)               # [B]
    if stride == 1:        # one contiguous run: rows r0 .. r_last + ds
        reads = torch.where(n_in > 0, n_in + ds, 0)
    elif stride == ds:     # a chain: the hi row of j is the lo row of j+1
        reads = torch.where(n_in > 0, n_in + 1, 0)
    else:
        reads = 2 * n_in
    return int(reads.sum()) * 4 + _nbytes(base) + n_out * base.numel() * 4


# K3's edge cases: (name, T, lanes past the first that ``pick`` gives the
# width, from the trellises a block, soft-view layout, near-ties); T
# "switch" is the longest trellis whose records fit a block's shared
# memory at that width, "switch+1" one step more (device memory)
K3_EDGE_CASES = (
    ("T1_L1", 1, lambda tb: 0, "header", False),
    ("T15_L3", 15, lambda tb: 2, "body", False),
    ("T16_odd_L", 16, lambda tb: 5, "header", False),
    ("T17_partial_block", 17, lambda tb: tb + 3, "body", False),
    ("T38_header", 38, lambda tb: tb - 1, "header", False),
    ("T40_ties", 40, lambda tb: 7, "body", True),
    ("shared_switch", "switch", lambda tb: 3, "body", False),
    ("past_the_switch", "switch+1", lambda tb: 3, "header", False),
)


def _k3_edge(case, threads):
    """(L, T, layout, ties) of K3 edge case ``case`` at a width that
    ``viterbi.pick`` chooses: L counts from the fewest lanes for which it
    picks ``threads`` threads a trellis at that T."""
    from webaudio_modem_tpu_torch.ops.kernels import viterbi

    _, T, lanes, layout, ties = next(c for c in K3_EDGE_CASES
                                     if c[0] == case)
    if isinstance(T, str):
        T = viterbi.shared_max_steps(threads) + (T == "switch+1")
    first = next(n for n in range(1, 1 << 17)
                 if viterbi.pick(n, T)[0] == threads)
    return first + lanes(viterbi.THREADS // threads), T, layout, ties


def _k3_soft(rng, L, T, layout, ties, device):
    """A soft view [L, T, 2]: ``header`` a contiguous plane, ``body`` the
    transposed view of a time-major [2T, L] plane, as the decode hands
    K3 its two calls; coded +-1 pairs plus noise (sigma 0.8), or with
    ``ties`` correlations on a coarse grid whose path metrics tie
    exactly."""
    import numpy as np
    import torch

    from webaudio_modem_tpu_torch.ops import fec

    if ties:
        x = rng.integers(-1, 2, (L, T, 2)).astype(np.float32) * 0.5
    else:
        bits = rng.integers(0, 2, (L, max(T - fec.K + 1, 0)), dtype=np.uint8)
        coded = (fec.conv_encode_bits_batch(bits).astype(np.float32) * 2 - 1
                 if T >= fec.K else np.ones((L, 2 * T), np.float32))
        x = (coded.reshape(L, T, 2) + 0.8 * rng.standard_normal(
            (L, T, 2))).astype(np.float32)
    if layout == "header":
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    plane = torch.from_numpy(np.ascontiguousarray(
        x.reshape(L, 2 * T).T)).to(device)
    return plane.t().reshape(L, T, 2)


def _k3_edges(device, errs):
    """K3 bit for bit equal to plain at every width the wrapper picks,
    reached through ``pick`` by L and T: each case of ``K3_EDGE_CASES``,
    and the last lane count before the next width.  Its inputs come from
    a generator of its own, so the phases after it see the same data
    whatever the cases."""
    import numpy as np
    import torch

    from webaudio_modem_tpu_torch.ops.kernels import viterbi

    rng = np.random.default_rng(3)
    seen = set()
    for g in viterbi.GROUPS:
        cases = [_k3_edge(c[0], g) for c in K3_EDGE_CASES]
        last = next((n - 1 for n in range(2, 1 << 17)
                     if viterbi.pick(n - 1, 38)[0] == g
                     and viterbi.pick(n, 38)[0] != g), None)
        if last is not None:
            cases.append((last, 38, "header", False))
        for L, T, layout, ties in cases:
            soft = _k3_soft(rng, L, T, layout, ties, device)
            n_bits = max(T - 6, 0)
            picked = viterbi.pick(L, T)
            want = viterbi.decode_plain(*viterbi.branch_sums(soft), n_bits)
            got = viterbi.decode(soft, n_bits)
            torch.cuda.synchronize()
            errs.append(_equal_or_raise(
                f"K3 edge L={L} T={T} {layout} ties={ties} pick={picked}",
                got, want))
            seen.add(picked)
    want = {(g, sh) for g in viterbi.GROUPS for sh in (True, False)}
    if seen != want:
        raise RuntimeError(f"K3 edges reached {sorted(seen)}, not every "
                           f"(threads, shared) of {sorted(want)}")
    print(f"  K3 edges: {len(K3_EDGE_CASES)} cases at each width "
          f"{viterbi.GROUPS} the wrapper picks (T = 1, 15, 16, 17, 38, 40, "
          "the shared-memory switch and one step more; L from the first "
          "lane of the width's band, partial blocks, near-ties, both "
          "soft-view layouts) and the last lanes before the next width: "
          "bits equal to plain at every (threads, shared) instantiation")


def _k4_case(rng, case, device):
    """csum [n_rows, B] and K4's keywords of ``K4_EDGE_CASES[case]``,
    with its four base vectors: random ones inside and past both plane
    edges, zeros, the top base and one below -pad_lo."""
    import numpy as np
    import torch

    n_rows, B, n_out, ds, stride, pad_lo, virt0, pol = K4_EDGE_CASES[case]
    csum = torch.from_numpy(np.cumsum(rng.standard_normal(
        (n_rows, B)).astype(np.float32), 0, dtype=np.float32)).to(device)
    top = max(n_rows + int(virt0) - ds, 1)
    kw = dict(n_out=n_out, ds=ds, stride=stride, pad_lo=pad_lo,
              polarity=pol, virt0=virt0)
    bases = [torch.from_numpy(np.asarray(b, np.int32)).to(device)
             for b in (rng.integers(-3, top + 3, B), np.zeros(B),
                       np.full(B, top - 1), np.full(B, -pad_lo - 1))]
    return csum, kw, bases


# K4's edge cases: (n_rows, B, n_out, ds, stride, pad_lo, virt0, polarity)
K4_EDGE_CASES = {
    "header_stride1_virt0": (300, 37, 150, 20, 1, 0, True, 1.0),
    "body_stride_ds_virt0": (300, 37, 14, 20, 20, 0, True, -1.0),
    "stride1_pad_lo": (90, 5, 60, 6, 1, 7, False, 1.0),
    "stride_ds_pad_lo": (90, 5, 20, 6, 6, 5, False, -1.0),
    "B1": (64, 1, 40, 4, 1, 0, True, 1.0),
    "B129_two_blocks": (40, 129, 9, 4, 2, 1, False, 1.0),
    # stride 4 does not divide ds 6: two loads an output
    "stride_not_dividing_ds": (70, 9, 17, 6, 4, 2, True, -1.0),
    "n_out_below_ds": (50, 3, 5, 20, 1, 0, False, 1.0),
    "n_wsum_zero": (20, 4, 9, 20, 1, 0, False, 1.0),
    "n_wsum_negative": (10, 4, 9, 20, 5, 0, True, 1.0),
}


def _k4_edges(device, errs):
    """K4 exactly equal to plain at every case of ``K4_EDGE_CASES``:
    stride 1 and ds (chains) and a stride that does not divide ds, virt0
    on and off, pad_lo > 0, bases inside, at both plane edges and past
    them, n_wsum <= 0, B = 1, odd B and two blocks of channels (inputs
    from a generator of its own)."""
    import numpy as np
    import torch

    from webaudio_modem_tpu_torch.ops.kernels import align

    rng = np.random.default_rng(4)
    n = 0
    for case in K4_EDGE_CASES:
        csum, kw, bases = _k4_case(rng, case, device)
        for base in bases:
            got = align.aligned_wsum(csum, base, **kw)
            want = align.aligned_wsum_plain(csum, base, **kw)
            torch.cuda.synchronize()
            errs.append(_equal_or_raise(f"K4 edge {case} {kw}", got, want))
            n += 1
    print(f"  K4 edges: {n} calls (stride 1, ds and one not dividing ds, "
          "virt0 on / off, pad_lo > 0, bases inside and past both plane "
          "edges, n_wsum <= 0, B = 1, odd B, B = 129): identical to plain")


def phase_soft_kernels_vs_plain(device, rng):
    import torch

    from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams
    from webaudio_modem_tpu_torch.models.farm import ModemFarm
    from webaudio_modem_tpu_torch.ops import fsk_demod, fsk_mod
    from webaudio_modem_tpu_torch.ops.kernels import align, fsk_seq, viterbi

    params = _soft_params()
    B = SOFT_BATCHES[0]
    _, noisy = _soft_batch(params, rng, B, device)
    planes = _soft_planes(params, noisy)
    seq_args = planes["seq_args"]
    errs = {"fsk_seq": [], "align": [], "viterbi": []}

    # K1, csum mode: kernel vs plain, and the csum vs a strict f32 loop
    # over the full run's softs
    k = fsk_seq.seq(*seq_args, **CSUM_FLAGS)
    p = fsk_seq.seq_plain(*seq_args, **CSUM_FLAGS)
    full = fsk_seq.seq(*seq_args)
    torch.cuda.synchronize()
    for name, a, b in zip(("front", "ds_acc", "bits", "amps", "csum",
                           "rsum"), k, p):
        errs["fsk_seq"].append(_equal_or_raise(f"K1 csum mode {name}", a, b))
    for i in (0, 1, 5):
        _equal_or_raise("K1 csum mode vs full run", k[i], full[i])
    _equal_or_raise("K1 csum vs strict f32 loop", k[4],
                    fsk_seq.csum_strict(full[4]))
    print(f"  K1 csum mode T={seq_args[-1].shape[0]} B={B}: identical to "
          "plain (bits/amps dropped), csum == strict f32 loop over the "
          "full run's softs, R and state == full run")

    # K3 at the header, body and long-trellis shapes, read in place
    for name, (soft, n_bits) in (("header", planes["header"]),
                                 ("body", planes["body"]),
                                 ("payload-100", _long_trellis(
                                     rng, B, device)[:2])):
        L, T = soft.shape[:2]
        pb = viterbi.decode_plain(*viterbi.branch_sums(soft), n_bits)
        threads, shared = viterbi.pick(L, T)
        kb = viterbi.decode(soft, n_bits)
        torch.cuda.synchronize()
        errs["viterbi"].append(_equal_or_raise(f"K3 {name}", kb, pb))
        print(f"  K3 {name} L={L} T={T} (soft view strides "
              f"{tuple(soft.stride())}), {threads} threads a trellis, "
              f"records in {'shared' if shared else 'device'} memory: bits "
              f"equal ({kb.numel()} bits)")
    soft, n_bits, truth = _long_trellis(rng, B, device)
    wrong = int((viterbi.decode(soft, n_bits) != truth).any(1).sum())
    print(f"  K3 payload-100 at sigma 0.5: {wrong} of {B} trellises "
          "with a bit error")
    _k3_edges(device, errs["viterbi"])

    # K4 at the header and body windows, and at base 0 / the max base
    csum = planes["csum"]
    for name, (base, max_base, kw) in planes["align_calls"].items():
        for label, b in (("decode's bases", base),
                         ("base 0", torch.zeros_like(base)),
                         (f"max base {max_base}",
                          torch.full_like(base, max_base))):
            ka = align.aligned_wsum(csum, b, **kw)
            pa = align.aligned_wsum_plain(csum, b, **kw)
            torch.cuda.synchronize()
            errs["align"].append(_equal_or_raise(f"K4 {name} {label}",
                                                 ka, pa))
        print(f"  K4 {name} window {kw}: torch.equal at the decode's "
              "bases, base 0 and the max base")

    _k4_edges(device, errs["align"])

    # K7: K1 without R, at ds > 256
    p50 = FSKParams.from_config(FSKConfig(baud_rate=50,
                                          mark_frequency=1270,
                                          space_frequency=1070))
    ds50 = p50.ds_samples_per_bit
    msgs = _messages(rng, B, 4)
    sig = fsk_mod.modulate_batch(p50, msgs, device)
    x = _awgn(sig[:, CHUNK:2 * CHUNK], 20.0, rng, device).t().contiguous()
    st = fsk_demod.init_state(p50, B, device)
    args = (p50, 0, st.front, st.ds_acc, None, x)
    k = fsk_seq.seq(*args, emit_rsum=False)
    p = fsk_seq.seq_plain(*args, emit_rsum=False)
    full = fsk_seq.seq(p50, 0, st.front, st.ds_acc, st.bit_tail[-ds50:], x)
    torch.cuda.synchronize()
    for name, a, b, f in zip(("front", "ds_acc", "bits", "amps", "softs",
                              "rsum"), k, p, full):
        errs["fsk_seq"].append(_equal_or_raise(f"K7 {name}", a, b))
        if a is not None:
            _equal_or_raise(f"K7 {name} vs full run", a, f)
    print(f"  K7 (emit_rsum=False) ds={ds50} T={CHUNK} B={B}: identical to "
          "plain and to the full run's streams")
    n = k[4].shape[0]
    k7 = _timing(f"ds={ds50} T={CHUNK} B={B}, emit_rsum=False",
                 _cuda_ms(lambda: fsk_seq.seq(*args, emit_rsum=False), 20),
                 _cuda_ms(lambda: fsk_seq.seq_plain(*args, emit_rsum=False),
                          1),
                 _nbytes(*args[2:4], x, *k),
                 CHUNK * B * K1_OPS_PER_SAMPLE + n * B * K1_OPS_PER_DECISION)
    farm = ModemFarm(p50.config, B, device=device)
    sig = farm.modulate(msgs)
    n_chunks = -(-sig.shape[1] // CHUNK)
    before = fsk_seq.launches
    decoded = farm.demodulate(sig, chunk_size=CHUNK)
    exact = sum(g == m for g, m in zip(decoded, msgs))
    print(f"  ModemFarm at 50 baud B={B}: {exact}/{B} exact over "
          f"{n_chunks} chunks, {fsk_seq.launches - before} K7 launches")
    if exact != B or fsk_seq.launches - before != n_chunks:
        raise RuntimeError("50-baud decode through K7 failed")
    return {name: max(v) for name, v in errs.items()}, k7


def phase_soft_main_path(device, rng):
    from webaudio_modem_tpu_torch.ops import soft_fsk
    from webaudio_modem_tpu_torch.ops.kernels import align, fsk_seq, viterbi

    params = _soft_params()
    B = SOFT_BATCHES[0]
    payloads, noisy = _soft_batch(params, rng, B, device)
    fsk_seq.launches = align.launches = viterbi.launches = 0
    t0 = time.perf_counter()
    out = soft_fsk.decode_frames_batch(params, noisy, SOFT_PAYLOAD,
                                         device=device)
    seconds = time.perf_counter() - t0
    launches = {"fsk_seq": fsk_seq.launches, "align": align.launches,
                "viterbi": viterbi.launches}
    exact = sum(o == p for o, p in zip(out, payloads))
    print(f"  decode_frames_batch B={B}, {SOFT_PAYLOAD}-byte payloads at "
          f"{SOFT_SNR_DB:g} dB, T={noisy.shape[1]}: {exact}/{B} exact "
          f"({seconds:.3f} s host wall, first call); launches {launches}")
    if exact != B:
        raise RuntimeError(f"soft decode: only {exact}/{B} exact")
    if launches != {"fsk_seq": 1, "align": 2, "viterbi": 2}:
        raise RuntimeError(f"soft decode launches {launches}")
    erased = noisy.clone()
    erased[0] = 0.0
    out = soft_fsk.decode_frames_batch(params, erased, SOFT_PAYLOAD,
                                         device=device)
    if out[0] is not None or out[1:] != payloads[1:]:
        raise RuntimeError("erased channel: expected None there and the "
                           "other payloads exact")
    print("  erased channel 0 -> None, the other channels exact")
    return launches


def _profile(label, run, calls, wall_ms, card):
    """torch.profiler over ``run()``, which makes ``calls`` calls: device
    time per call by kernel, and the device's busy share of ``wall_ms``,
    the unprofiled time per call (the profiler's own host cost would
    dilute it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()

    def dev_us(ev):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(ev, attr, None)
            if v is not None:
                return v
        return 0.0

    # device-side events only (kernels, copies, fills): an operator's own
    # row would count its kernels' time a second time
    rows = sorted(((dev_us(e), e.key, e.count) for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA
                   and dev_us(e) > 0), reverse=True)
    if not rows:
        print("  profile: the profiler recorded no device time")
        return
    total_ms = sum(r[0] for r in rows) / 1e3 / calls
    print(f"  profile {label}: device {total_ms:.3f} ms per call, busy "
          f"{100 * total_ms / wall_ms:.1f} % of the {wall_ms:.3f} ms "
          f"unprofiled time per call [{card}]")
    for us, key, count in rows[:12]:
        print(f"    {us / 1e3 / calls:8.4f} ms/call  {count // calls:4d} "
              f"launches  {key[:70]}")


def phase_soft_timings(device, rng, card):
    import torch

    from webaudio_modem_tpu_torch.ops import soft_fsk
    from webaudio_modem_tpu_torch.ops.kernels import align, fsk_seq, viterbi

    params = _soft_params()
    timings = {}
    for B in SOFT_BATCHES:
        payloads, noisy = _soft_batch(params, rng, B, device)
        T = noisy.shape[1]
        audio_s = T / params.sample_rate
        for _ in range(2):
            soft_fsk.decode_frames_batch(params, noisy, SOFT_PAYLOAD,
                                         device=device)
        torch.cuda.synchronize()
        reps = 10
        t0 = time.perf_counter()
        pending = [soft_fsk.decode_frames_batch_async(
            params, noisy, SOFT_PAYLOAD, device=device)
            for _ in range(reps)]
        outs = [p() for p in pending]
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        if any(o != payloads for o in outs):
            raise RuntimeError("timed decodes were not exact")
        dev_ms = _cuda_ms(lambda: soft_fsk._decode_frames_fused(
            params, noisy, SOFT_PAYLOAD), reps)
        print(f"  soft decode B={B} T={T} ({audio_s:.4f} s of audio): "
              f"{wall_ms:.3f} ms per decode pipelined (host wall), "
              f"{dev_ms:.3f} ms enqueue-to-done (CUDA events); "
              f"{B * audio_s / (wall_ms / 1e3):,.0f} realtime channels "
              f"[{card}]")
        timings[f"decode_B{B}"] = {"wall_ms": wall_ms, "event_ms": dev_ms,
                                   "realtime_channels":
                                       B * audio_s / (wall_ms / 1e3)}
        if B != SOFT_BATCHES[-1]:
            continue

        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        soft_fsk.decode_frames_batch(params, noisy, SOFT_PAYLOAD,
                                         device=device)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        print(f"  peak device memory, decode at B={B}: {peak / 2**20:.1f} "
              f"MiB ({(peak - base_mem) / 2**20:.1f} MiB above the "
              f"{base_mem / 2**20:.1f} MiB held before) [{card}]")
        timings["peak_mib"] = peak / 2 ** 20

        planes = _soft_planes(params, noisy)
        seq_args = planes["seq_args"]
        out = fsk_seq.seq(*seq_args, **CSUM_FLAGS)
        n = out[4].shape[0]
        timings["fsk_seq_csum"] = _timing(
            f"T={T} B={B}, csum mode (bits/amps dropped)",
            _cuda_ms(lambda: fsk_seq.seq(*seq_args, **CSUM_FLAGS), 5),
            _cuda_ms(lambda: fsk_seq.seq_plain(*seq_args, **CSUM_FLAGS), 1),
            _nbytes(*seq_args[2:], *out),
            T * B * K1_OPS_PER_SAMPLE + n * B * K1_OPS_PER_DECISION)
        for name, (soft, n_bits) in (("header", planes["header"]),
                                     ("body", planes["body"]),
                                     ("payload-100", _long_trellis(
                                         rng, B // 2, device)[:2])):
            L, steps = soft.shape[:2]
            threads, shared = viterbi.pick(L, steps)
            a, d = viterbi.branch_sums(soft)
            t = timings[f"viterbi_{name}"] = _timing(
                f"{name}: L={L} T={steps}, {threads} threads a trellis, "
                f"records in {'shared' if shared else 'device'} memory",
                _cuda_ms(lambda: viterbi.decode(soft, n_bits), 20),
                _cuda_ms(lambda: viterbi.decode_plain(a, d, n_bits), 1),
                soft.numel() * 4 + steps * L,      # u8 bits out
                L * (steps * K3_OPS_PER_STEP
                     + (steps // 16) * K3_OPS_PER_NORM))
            t["graph_ms"] = _graph_ms(lambda: viterbi.decode(soft, n_bits),
                                      20)
            del a, d
        csum = planes["csum"]
        for name, (base, _, kw) in planes["align_calls"].items():
            wsum = align.window_sums(csum, kw["ds"], kw["polarity"],
                                     kw["virt0"])
            idx = align.rows(base, kw["n_out"], kw["stride"],
                             kw["pad_lo"]).clamp(0, wsum.shape[0] - 1)
            # no one PyTorch call computes K4's function (the windows'
            # difference over the csum plane, then the gather): its library
            # time is none, and torch.gather over window sums made
            # beforehand is timed beside it as a reference only
            t = _timing(
                f"{name} window: {kw['n_out']} x {B}, stride "
                f"{kw['stride']}",
                _cuda_ms(lambda: align.aligned_wsum(csum, base, **kw), 20),
                _cuda_ms(lambda: align.aligned_wsum_plain(csum, base, **kw),
                         5),
                _align_bytes(csum, base, **kw),
                kw["n_out"] * B * K4_OPS_PER_OUT)
            t["gather_only_ms"] = _cuda_ms(
                lambda: torch.gather(wsum, 0, idx), 20)
            t["graph_ms"] = _graph_ms(
                lambda: align.aligned_wsum(csum, base, **kw), 20)
            timings[f"align_{name}"] = t
        for name, t in timings.items():
            if isinstance(t, dict) and "shape" in t:
                _print_timing(name, t, card)
                if "gather_only_ms" in t:
                    print(f"    torch.gather alone, over window sums made "
                          f"beforehand: {t['gather_only_ms']:.4f} ms")
                if "graph_ms" in t:
                    print(f"    the kernel's device time in a CUDA graph "
                          f"(no host gaps): {t['graph_ms']:.4f} ms a call")
        try:
            _profile(f"soft decode B={B}", lambda: [
                soft_fsk.decode_frames_batch(params, noisy, SOFT_PAYLOAD,
                                             device=device)
                for _ in range(3)], 3, wall_ms, card)
        except RuntimeError as exc:     # a measurement, not a check
            print(f"  profile: torch.profiler failed: {exc}")
    return timings


# ---------------------------------------------------------------------------
# The DBPSK path
# ---------------------------------------------------------------------------

# K6 keeps its I/Q rings in shared memory up to D = 764
# (psk_seq.SHARED_RING_MAX_D) and in device memory beyond: D = 960
# (50 baud at 96 kHz) holds the device placement
PSK_DEVICE_RING_CONFIG = dict(sample_rate=96000, baud_rate=50)


def _psk_params(**overrides):
    from webaudio_modem_tpu_torch.models.psk import (PSKConfig,
                                                     params_from_config)

    return params_from_config(PSKConfig(**overrides))


def _psk_args(state, ds_phase, x, emit_rsum):
    D = state.ring.shape[0] // 2
    return (ds_phase, state.front, state.ds_acc, state.ring,
            state.bit_tail[-D:] if emit_rsum else None, x)


def _check_k6(params, state, ds_phase, x, errs, emit_rsum=True,
              quiet=False):
    """K6 vs plain on identical inputs: every output exactly."""
    from webaudio_modem_tpu_torch.ops.kernels import psk_seq

    args = (params, *_psk_args(state, ds_phase, x, emit_rsum))
    p = psk_seq.seq_plain(*args, emit_rsum=emit_rsum)
    k = psk_seq.seq(*args, emit_rsum=emit_rsum)
    for name, a, b in zip(("front", "ds_acc", "ring", "bits", "amps",
                           "softs", "rsum"), k, p):
        errs.append(_equal_or_raise(f"K6 {name}", a, b))
    D = params.ds_samples_per_bit
    where = "device" if D > psk_seq.SHARED_RING_MAX_D else "shared"
    if not quiet:
        print(f"  K6 T={x.shape[0]} ds_phase={ds_phase} D={D} R={emit_rsum} "
              f"B={x.shape[1]} (rings in {where} memory): every output "
              "identical to plain")


# K6 at its pipeline's edges: partial blocks (B = 1001, 1) over the
# EDGE_PIECES with state carried, at D = 20 (PSKConfig()), D = 5 (4800
# baud: the delayed sample lies in the same G tile) and D = 960 (rings
# in device memory, where lanes past B must leave lane B - 1's ring alone)
K6_EDGE_CASES = (({}, 1001), ({}, 1), ({"baud_rate": 4800}, 1001),
                 (PSK_DEVICE_RING_CONFIG, 1001))


def _k6_edges(device, rng, errs):
    import torch

    from webaudio_modem_tpu_torch.ops import psk

    for overrides, B in K6_EDGE_CASES:
        params = _psk_params(**overrides)
        D = params.ds_samples_per_bit
        sig = psk.modulate_batch(params, _messages(rng, B, 4), device)
        sig = torch.nn.functional.pad(
            sig, (0, max(0, sum(EDGE_PIECES) - sig.shape[1])))
        x_all = _awgn(sig, 20.0, rng, device)
        state = psk.init_state(params, B, device)
        ds_phase = start = 0
        for T in EDGE_PIECES:
            piece = x_all[:, start:start + T]
            _check_k6(params, state, ds_phase, piece.t().contiguous(), errs,
                      emit_rsum=D <= 256, quiet=True)
            state, _ = psk.demod_chunk(params, ds_phase, state, piece)
            ds_phase = (ds_phase + T) % params.downsample_ratio
            start += T
        print(f"  K6 edges D={D} B={B} R={D <= 256}: pieces {EDGE_PIECES} "
              "with state carried identical to plain")


def phase_psk_kernels_vs_plain(device, rng):
    import torch

    from webaudio_modem_tpu_torch.ops import psk

    errs = []
    params = _psk_params()
    msgs = _messages(rng, CHECK_BATCH, 13)
    # half a chunk of silence first: the 0.14 s messages then span the
    # first two chunks, and the third holds their end of data
    sig = torch.nn.functional.pad(psk.modulate_batch(params, msgs, device),
                                  (CHUNK // 2, 3 * CHUNK))[:, :3 * CHUNK]
    x_all = _awgn(sig, 20.0, rng, device)
    state = psk.init_state(params, CHECK_BATCH, device)
    ds_phase, start = 0, 0
    for T in (CHUNK, CHUNK - 1, CHUNK):   # the odd chunk leaves a prefix
        x = x_all[:, start:start + T]
        _check_k6(params, state, ds_phase, x.t().contiguous(), errs)
        state, _ = psk.demod_chunk(params, ds_phase, state, x)
        ds_phase = (ds_phase + T) % params.downsample_ratio
        start += T
    syncs = torch.bincount(state.sync_count.long().cpu(), minlength=3)
    print(f"  channels by syncs over the three chunks (0, 1, 2+): "
          f"{syncs[0]}, {syncs[1]}, {syncs[2:].sum()}")

    # K6 without R: D = 480 (50 baud, rings in shared memory) and D = 960
    # (50 baud at 96 kHz, rings in device memory), on a chunk inside the
    # message after three carried ones
    for p50 in (_psk_params(baud_rate=50),
                _psk_params(**PSK_DEVICE_RING_CONFIG)):
        msgs = _messages(rng, CHECK_BATCH, 4)
        sig = psk.modulate_batch(p50, msgs, device)[:, :4 * CHUNK]
        state = psk.init_state(p50, CHECK_BATCH, device)
        state, _ = psk.demod_chunk(p50, 0, state, sig[:, :3 * CHUNK])
        x = _awgn(sig[:, 3 * CHUNK:], 20.0, rng, device)
        _check_k6(p50, state, 0, x.t().contiguous(), errs, emit_rsum=False)
        del sig
    _k6_edges(device, rng, errs)
    return {"psk_seq": max(errs)}


def phase_psk_main_path(device, rng):
    import math

    from webaudio_modem_tpu_torch.models.farm import ModemFarm
    from webaudio_modem_tpu_torch.models.psk import PSKConfig, PSKCore
    from webaudio_modem_tpu_torch.ops.kernels import fsk_framing, psk_seq

    farm = ModemFarm(PSKConfig(), MAIN_BATCH, device=device)
    msgs = _messages(rng, MAIN_BATCH, 13)
    sig = farm.modulate(msgs)
    n_chunks = -(-sig.shape[1] // CHUNK)
    psk_seq.launches = 0
    fsk_framing.launches = 0
    t0 = time.perf_counter()
    decoded = farm.demodulate(sig, chunk_size=CHUNK)
    seconds = time.perf_counter() - t0
    launches = {"psk_seq": psk_seq.launches,
                "fsk_framing": fsk_framing.launches}
    exact = sum(d == m for d, m in zip(decoded, msgs))
    print(f"  ModemFarm(PSKConfig()) B={MAIN_BATCH}: {exact}/{MAIN_BATCH} "
          f"messages exact over {n_chunks} chunks of {CHUNK} samples "
          f"({seconds:.2f} s host wall, bytes collected per chunk); "
          f"launches {launches}")
    if exact != MAIN_BATCH:
        raise RuntimeError(f"DBPSK: only {exact}/{MAIN_BATCH} exact")
    if launches != {"psk_seq": n_chunks, "fsk_framing": n_chunks}:
        raise RuntimeError(f"launches {launches} != {n_chunks} chunk steps")
    if not (farm.get_status()["sync_detections"] == 1).all():
        raise RuntimeError("a DBPSK channel did not sync exactly once")
    quality = farm.get_signal_quality()[0]
    print(f"  channel 0 quality: {quality}")

    core = PSKCore(PSKConfig(), device=device)
    message = b"Hello, World!"
    out = core.demodulate_data(core.modulate_data(message))
    core_quality = core.get_signal_quality()
    print(f"  PSKCore round trip: {out!r}; quality {core_quality}")
    if out != message:
        raise RuntimeError(f"PSKCore decoded {out!r}")
    for q in (quality, core_quality):
        values = [q.snr, q.ber, q.eye_opening, q.phase_jitter,
                  q.frequency_offset]
        if not all(math.isfinite(v) for v in values):
            raise RuntimeError(f"signal quality not finite: {q}")
    return launches


def phase_psk_timings(device, rng, card):
    import numpy as np
    import torch

    from webaudio_modem_tpu_torch.ops import psk
    from webaudio_modem_tpu_torch.ops.kernels import psk_seq

    params = _psk_params()
    timings, placement_cases = {}, {}
    for B in (CHECK_BATCH, MAIN_BATCH):
        sig = psk.modulate_batch(params, _messages(rng, B, 13), device)
        n = sig.shape[1] // CHUNK
        chunks = [sig[:, i * CHUNK:(i + 1) * CHUNK] for i in range(n)]
        # the plain version once, at the smaller B; ``step`` closes over
        # ``plain``, so the loop must end on the kernels' run at MAIN_BATCH
        runs = ((False, 25), (True, 1)) if B == CHECK_BATCH else ((False, 25),)
        for plain, reps in runs:
            st = [psk.init_state(params, B, device), 0]

            def step():
                st[0], _ = psk.demod_chunk(params, 0, st[0],
                                           chunks[st[1] % n], plain=plain)
                st[1] += 1
            if not plain:
                for _ in range(3):
                    step()
            ms = _cuda_ms(step, reps)
            path = "plain" if plain else "kernels"
            channels = B * AUDIO_S_PER_CHUNK / (ms / 1e3)
            print(f"  DBPSK demod_chunk B={B} {path}: {ms:.3f} ms per 0.1 s "
                  f"chunk, {channels:,.0f} realtime channels [{card}]")
            timings[f"demod_chunk_B{B}{'_plain' if plain else ''}"] = {
                "ms": ms, "realtime_channels": channels}

        if B == MAIN_BATCH:
            # K6 on two inputs: the first chunk after the 28 cycled chunk
            # steps above (its row's input) and, as tools/turns.py seq,
            # the rest of the messages after the first chunk from a fresh
            # state (T = 2080)
            args = (params, *_psk_args(st[0], 0, chunks[0].t().contiguous(),
                                       True))
            st1, _ = psk.demod_chunk(params, 0, psk.init_state(params, B,
                                                               device),
                                     chunks[0])
            turns = (params, *_psk_args(
                st1, 0, sig[:, CHUNK:2 * CHUNK].t().contiguous(), True))
            out = psk_seq.seq(*args)
            n_dec = out[3].shape[0]
            plain_ms = _cuda_ms(lambda: psk_seq.seq_plain(*args), 1)
            try:
                _profile(f"DBPSK demod_chunk B={B}",
                         lambda: [step() for _ in range(10)], 10,
                         timings[f"demod_chunk_B{B}"]["ms"], card)
            except RuntimeError as exc:     # a measurement, not a check
                print(f"  profile: torch.profiler failed: {exc}")
            timings["psk_seq"] = _timing(
                f"T={CHUNK} B={B} D={params.ds_samples_per_bit}, with R, "
                "rings in shared memory",
                _cuda_ms(lambda: psk_seq.seq(*args), 20), plain_ms,
                _nbytes(*args[2:], *out),
                CHUNK * B * K1_OPS_PER_SAMPLE
                + n_dec * B * K6_OPS_PER_DECISION)
            timings["psk_seq"]["turns_input_ms"] = _cuda_ms(
                lambda: psk_seq.seq(*turns), 20)
            print(f"  psk_seq D=20 B={B} on the turns' input "
                  f"(T={turns[-1].shape[0]}): "
                  f"{timings['psk_seq']['turns_input_ms']:.4f} ms [{card}]")
            _print_timing("psk_seq", timings["psk_seq"], card)
            placement_cases[f"D=20, with R, B={B}"] = (args, {})
    # without R at D = 480 (rings in shared memory) and D = 960 (in
    # device memory), on noise
    for name, p50 in (("d480", _psk_params(baud_rate=50)),
                      ("d960", _psk_params(**PSK_DEVICE_RING_CONFIG))):
        D = p50.ds_samples_per_bit
        st = psk.init_state(p50, CHECK_BATCH, device)
        x = torch.from_numpy(rng.standard_normal(
            (CHUNK, CHECK_BATCH), dtype=np.float32)).to(device)
        args = (p50, *_psk_args(st, 0, x, False))
        out = psk_seq.seq(*args, emit_rsum=False)
        where = "device" if name == "d960" else "shared"
        t = _timing(f"T={CHUNK} B={CHECK_BATCH} D={D}, no R, rings in "
                    f"{where} memory",
                    _cuda_ms(lambda: psk_seq.seq(*args, emit_rsum=False), 20),
                    _cuda_ms(lambda: psk_seq.seq_plain(*args,
                                                       emit_rsum=False), 1),
                    _nbytes(*args[2:5], x, *out),
                    CHUNK * CHECK_BATCH * K1_OPS_PER_SAMPLE
                    + out[3].shape[0] * CHECK_BATCH * K6_OPS_PER_DECISION)
        timings[f"psk_seq_{name}"] = t
        _print_timing("psk_seq", t, card)
        if name == "d480":
            placement_cases[f"D={D}, no R, B={CHECK_BATCH}"] = (
                args, {"emit_rsum": False})
    timings["placements"] = _time_placements(placement_cases, card)
    return timings


def _time_placements(cases, card):
    """K6's ring placement, measured: each case through the kernel as
    built (rings in shared memory at these D) and through a copy built
    with -DWAM_PSK_SHARED_LIMIT=0 (rings in device memory at every D),
    in turns (shared, device, device, shared; 20 launches each).  The
    two builds' outputs must be equal.  Returns {case: {where: mean
    ms}}."""
    import ctypes
    import subprocess

    from webaudio_modem_tpu_torch.ops.kernels import _build, psk_seq

    path = _build.BUILD_DIR / "libwam_psk_seq_device_rings.so"
    built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                            "-DWAM_PSK_SHARED_LIMIT=0", "-o", str(path),
                            str(_build.CSRC_DIR / "psk_seq.cu")],
                           capture_output=True, text=True)
    if built.returncode != 0:
        raise RuntimeError(f"nvcc failed ({built.returncode}):\n"
                           f"{built.stdout}{built.stderr}")
    builds = {"shared": _build.library("psk_seq"),
              "device": ctypes.CDLL(str(path))}
    result = {}
    try:
        for case, (args, kw) in cases.items():
            ms, outs = {"shared": [], "device": []}, {}
            for where in ("shared", "device", "device", "shared"):
                _build._libs["psk_seq"] = builds[where]
                outs[where] = psk_seq.seq(*args, **kw)
                ms[where].append(_cuda_ms(lambda: psk_seq.seq(*args, **kw),
                                          20))
            for a, b in zip(outs["shared"], outs["device"]):
                _equal_or_raise(f"K6 {case}, shared vs device rings", a, b)
            result[case] = {w: sum(v) / len(v) for w, v in ms.items()}
            print(f"  psk_seq {case}, rings in shared / device memory (in "
                  f"turns): {ms['shared'][0]:.4f}, {ms['device'][0]:.4f}, "
                  f"{ms['device'][1]:.4f}, {ms['shared'][1]:.4f} ms; "
                  "outputs equal [" + card + "]")
    finally:
        _build._libs["psk_seq"] = builds["shared"]
    return result


# ---------------------------------------------------------------------------
# Soft-frame acquisition: K5, the blind receiver, the streaming decoder
# ---------------------------------------------------------------------------

# K5's shapes at B=4096 on the blind path: the header window (3 quanta of
# 2400 ticks), the 16-byte body window (6 quanta) and the 255-byte one
# (38 quanta, the receiver's max_payload)
CSUM_SHAPES = ((7200, 4096), (14400, 4096), (91200, 4096))
CSUM_SMALL_SHAPES = ((37, 3), (0, 5))
# K5's edges, windows of a ring as the blind receiver reads them:
# (ring rows, B, first row, rows, base offset in floats); B = 1 and 4097
# (partial blocks), a base only 4-byte aligned, windows that wrap past
# the ring's last row at B = 4096 and at an odd B (rows misaligned for
# 16-byte copies), and a partial last stage (n not a multiple of 128)
CSUM_EDGE_CASES = ((14400, 1, 0, 14400, 0), (7200, 4097, 0, 7200, 0),
                   (7200, 4096, 0, 7157, 1),
                   (38400, 4096, 33600, 14400, 0),
                   (38400, 1001, 33600, 7200, 3))
BLIND_GAPS = (2000, 9000)         # silence between frames, samples
PLAIN_RUN_BATCH = 256
DECODER_CHANNELS = 4              # single channels through SoftFrameDecoder


def _csum_bound(n, B):
    """K5's least time: read x once, write the [n + 1, B] output once."""
    return (n * B + (n + 1) * B) * 4, n * B


def phase_cumsum_vs_plain(device):
    """K5 against its plain version, exactly, at the blind path's shapes
    and two small ones; also against np.cumsum of the host copy."""
    import numpy as np
    import torch

    from webaudio_modem_tpu_torch.ops.kernels import cumsum0

    gen = torch.Generator(device=device)
    gen.manual_seed(12)
    for n, B in CSUM_SHAPES + CSUM_SMALL_SHAPES:
        x = torch.randn((n, B), generator=gen, device=device)
        k = cumsum0.csum0(x)
        p = cumsum0.csum0_plain(x)
        torch.cuda.synchronize()
        if k.shape != (n + 1, B):
            raise RuntimeError(f"K5 [{n}, {B}]: output shape {k.shape}")
        bad = int((k != p).sum())
        line = f"  K5 [{n}, {B}]: {bad} mismatches vs plain"
        if (n, B) in ((37, 3), (7200, 4096)):
            ref = np.zeros((n + 1, B), np.float32)
            np.cumsum(x.cpu().numpy(), axis=0, out=ref[1:])
            bad_np = int((k.cpu().numpy() != ref).sum())
            line += f", {bad_np} vs np.cumsum of the host copy"
            bad += bad_np
        print(line)
        if bad:
            raise RuntimeError(f"K5 [{n}, {B}] is not exact")
        del x, k, p
    for rows, B, start, n, offset in CSUM_EDGE_CASES:
        flat = torch.randn(offset + rows * B, generator=gen, device=device)
        ring = flat[offset:].view(rows, B)
        k = cumsum0.csum0(ring, start, n)
        p = cumsum0.csum0_plain(ring, start, n)
        torch.cuda.synchronize()
        _equal_or_raise(f"K5 window of {n} rows from {start} of a "
                        f"[{rows}, {B}] ring", k, p)
        wraps = start + n > rows
        print(f"  K5 window of {n} rows from row {start} of a [{rows}, {B}] "
              f"ring (base {ring.data_ptr() % 16} bytes past 16-byte "
              f"alignment{', wrapping' if wraps else ''}): identical to "
              "plain")
        del flat, ring, k, p
    return 0.0


def _place_frames(params, rng, rows, device, gaps=BLIND_GAPS):
    """[B, T] stream on the card, as the reference test's ``_place``: per
    channel, silence, then the frames of ``rows`` (rows[k][b] is channel
    b's k-th payload) each followed by silence, at random gaps; T is a
    whole number of quanta.  Frames of one length are synthesized in one
    ``encode_frames_batch``.  Returns (stream, expected payload lists,
    frame offsets [K, B] in samples)."""
    import numpy as np
    import torch

    from webaudio_modem_tpu_torch.ops import soft_fsk

    B = len(rows[0])
    lens = np.array([[len(r[b]) for b in range(B)] for r in rows])  # [K, B]
    sig_len = np.vectorize(
        lambda n: soft_fsk.frame_signal_length(params, int(n)))(lens)
    gap = rng.integers(gaps[0], gaps[1], (len(rows) + 1, B))
    offs = gap[0] + np.concatenate(
        [np.zeros((1, B), np.int64),
         np.cumsum(sig_len + gap[1:], 0)[:-1]])                  # [K, B]
    ends = offs[-1] + sig_len[-1] + gap[-1]
    T = -(-int(ends.max()) // CHUNK) * CHUNK
    stream = torch.zeros((B, T), dtype=torch.float32, device=device)
    for k, row in enumerate(rows):
        for n in np.unique(lens[k]).tolist():
            chs = np.nonzero(lens[k] == n)[0]
            sig = soft_fsk.encode_frames_batch(
                params, [row[b] for b in chs], device=device)
            idx = (torch.from_numpy(offs[k, chs]).to(device)[:, None]
                   + torch.arange(sig.shape[1], device=device)[None, :])
            ch_t = torch.from_numpy(chs).to(device)[:, None]
            stream[ch_t, idx] = sig
    return stream, [[r[b] for r in rows] for b in range(B)], offs


def _run_blind(rx, stream):
    """Feed ``stream`` quantum by quantum, then flush; per-channel payload
    lists in delivery order, and the host wall per feed (ms)."""
    import torch

    B, T = stream.shape
    got = [[] for _ in range(B)]
    t0 = time.perf_counter()
    for off in range(0, T, CHUNK):
        for ch, pl in rx.feed(stream[:, off:off + CHUNK]):
            got[ch].append(pl)
    for ch, pl in rx.flush():
        got[ch].append(pl)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / rx.get_status()["fed_quanta"]
    return got, wall_ms


def _score(got, expected):
    """(delivered, wrong, channels exact and in order): a wrong payload is
    one its channel never sent."""
    delivered = sum(len(g) for g in got)
    wrong = sum(p not in e for g, e in zip(got, expected) for p in g)
    exact = sum(g == e for g, e in zip(got, expected))
    return delivered, wrong, exact


def _blind_launch_counters():
    from webaudio_modem_tpu_torch.ops.kernels import (align, cumsum0,
                                                      fsk_seq, viterbi)

    return {"fsk_seq": fsk_seq, "cumsum0": cumsum0, "align": align,
            "viterbi": viterbi}


def _reset_launches():
    for mod in _blind_launch_counters().values():
        mod.launches = 0


def _read_launches():
    return {name: mod.launches
            for name, mod in _blind_launch_counters().items()}


def _program_args(rx, device):
    """All channels active with a peak one quantum and 700 ticks into the
    header window, and body starts after that header: arguments of
    ``_header_prog`` / ``_body_prog`` for launch counts and timings."""
    import torch

    from webaudio_modem_tpu_torch.ops import soft_fsk

    B = rx.batch
    t_rel = torch.full((B,), rx._n_ds + 700, dtype=torch.int32, device=device)
    b_rel = t_rel + 1 + soft_fsk.HEADER_CODED_BITS \
        * rx._params.ds_samples_per_bit
    act = torch.ones((B,), dtype=torch.bool, device=device)
    return t_rel, b_rel, act


def _record_emits(rx):
    """Keep each quantum's detector emits (an int32 [4, B] plane on the
    card: emit_a, pos1, emit_b, pos_b) for the checks after the run.
    The wrapper reaches the receiver through a weak reference: a bound
    method would make a cycle, and the receiver's planes (GiBs at
    B=4096) would then outlive ``del rx`` until the cyclic collector
    runs."""
    import weakref

    emits = []
    detect = type(rx)._detect
    owner = weakref.ref(rx)

    def step(*args):
        out = detect(owner(), *args)
        emits.append(out)
        return out

    rx._detect = step
    return emits


def _check_delivery(label, rx, emits, got, expected, offs, limit=4):
    """Hold a clean run to the receiver's contract: no payload a channel
    did not send, each channel's payloads in the order sent, and every
    frame not delivered explained by the reference's refractory rule:
    any event, true or false, holds off the next one for refract_span
    ticks, so a false sync late in a body hides a frame that follows
    within that span.  A frame is explained when an event that is no sent
    frame's own peak lies within refract_span ticks before its expected
    peak.  Returns (delivered, lost frames explained, failures)."""
    import numpy as np
    import torch

    params = rx._params
    ds = params.ds_samples_per_bit
    # expected sync peaks: the end of lead + pattern, in ticks
    head = (2 + len(params.pattern_bits)) * params.samples_per_bit
    ev = torch.stack(emits).cpu().numpy()                  # [Q, 4, B]
    delivered, wrong, explained, failures = 0, 0, 0, []
    for b, (g, e) in enumerate(zip(got, expected)):
        delivered += len(g)
        if g == e:
            continue
        if any(p not in e for p in g) or g != [p for p in e if p in g]:
            wrong += 1
            continue
        peaks = (offs[:, b] + head) // params.downsample_ratio
        pos = np.concatenate([ev[ev[:, 0, b] != 0, 1, b],
                              ev[ev[:, 2, b] != 0, 3, b]])
        false = [q for q in pos if np.abs(peaks - q).min() > 2 * ds]
        for k, p in enumerate(peaks):
            if e[k] in g:
                continue
            holders = [q for q in false if p - rx._refract_span <= q < p]
            if holders:
                explained += 1
                if explained <= limit:
                    print(f"    {label} channel {b}: frame {k} (sent at "
                          f"sample {offs[k, b]}, peak near tick {p}) inside "
                          f"the refractory span of a false sync at tick "
                          f"{holders[-1]}")
            else:
                failures.append(f"{label} channel {b}: frame {k} lost "
                                "without a refractory explanation")
    if wrong:
        failures.append(f"{label}: {wrong} channels delivered a payload "
                        "not sent, or out of order")
    return delivered, explained, failures


def phase_blind_main_path(device, rng, card):
    """The blind receiver at B=4096 (clean, 8 dB, mixed lengths), the
    streaming decoder on single channels, and the kernels against the
    plain versions on a 256-channel run.  Every check runs; the phase
    raises at its end if any failed."""
    import torch

    from webaudio_modem_tpu_torch.ops import soft_fsk
    from webaudio_modem_tpu_torch.ops.soft_blind import BlindSoftBatchReceiver
    from webaudio_modem_tpu_torch.sim import make_device_awgn

    params = _soft_params()
    B = MAIN_BATCH
    failures = []
    rows = [_messages(rng, B, SOFT_PAYLOAD) for _ in range(2)]
    stream, expected, offs = _place_frames(params, rng, rows, device)
    n_q = stream.shape[1] // CHUNK
    print(f"  stream [{B}, {stream.shape[1]}] ({n_q} quanta of {CHUNK}): "
          f"2 frames of {SOFT_PAYLOAD} bytes per channel at random offsets")
    out = {}

    # clean: the main path, launches counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rx = BlindSoftBatchReceiver(params, B, CHUNK, device=device)
    emits = _record_emits(rx)
    _reset_launches()
    got, wall_ms = _run_blind(rx, stream)
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    status = rx.get_status()
    delivered, lost, fails = _check_delivery("clean", rx, emits, got,
                                             expected, offs)
    failures += fails
    out["clean"] = {"delivered": delivered, "sent": 2 * B,
                    "lost_to_refractory": lost}
    print(f"  clean B={B}: {delivered}/{2 * B} payloads delivered exact and "
          f"in per-channel order, {lost} lost to a false sync's refractory "
          f"span (the reference's rule); {status['fed_quanta']} feeds, "
          f"{wall_ms:.3f} ms host wall per feed (first run); launches "
          f"{launches}; status {status}")
    programs = status["programs"]
    n_prog = programs["header"] + programs["body"]
    if launches != {"fsk_seq": status["fed_quanta"], "cumsum0": n_prog,
                    "align": n_prog, "viterbi": n_prog}:
        failures.append(f"blind launches {launches} vs {programs}")
    out["peak_mib"] = peak / 2 ** 20
    print(f"  peak device memory, clean run: {out['peak_mib']:.1f} MiB "
          f"(ring {rx._rx.ring.numel() * 4 / 2 ** 20:.1f} MiB) [{card}]")

    # one header and one body program alone: launches per program
    t_rel, b_rel, act = _program_args(rx, device)
    per = {}
    for name, call in (("header", lambda: rx._header_prog(1, t_rel, act)),
                       ("body", lambda: rx._body_prog(SOFT_PAYLOAD, 1, b_rel,
                                                      act))):
        _reset_launches()
        call()
        per[name] = _read_launches()
    print(f"  launches per header program {per['header']}, per body "
          f"program {per['body']}")
    for name, n in per.items():
        if n != {"fsk_seq": 0, "cumsum0": 1, "align": 1, "viterbi": 1}:
            failures.append(f"{name} program launches {n}")
    del rx

    # 8 dB: uniform noise drawn on the card inside the detector
    sig_power = float(torch.mean(soft_fsk.encode_frames_batch(
        params, rows[0][:16], device=device).double() ** 2))
    noise_power = sig_power / 10 ** (SOFT_SNR_DB / 10)
    rx = BlindSoftBatchReceiver(params, B, CHUNK, seed=1, device=device,
                                channel_fn=make_device_awgn(noise_power))
    got8, _ = _run_blind(rx, stream)
    delivered, wrong, exact = _score(got8, expected)
    print(f"  {SOFT_SNR_DB:g} dB B={B}: {delivered}/{2 * B} payloads "
          f"delivered, {wrong} wrong, {exact}/{B} channels complete; "
          f"status {rx.get_status()}")
    if wrong:
        failures.append(f"8 dB run: {wrong} wrong payloads")
    out["delivered_8db"] = delivered
    del rx

    # mixed lengths 1-64, from the decoded headers only
    lens = [[1 + (b + 32 * k) % 64 for b in range(B)] for k in range(2)]
    rows_m = [[bytes(rng.integers(0, 256, n, dtype="uint8")) for n in ln]
              for ln in lens]
    stream_m, expected_m, offs_m = _place_frames(params, rng, rows_m, device)
    rx = BlindSoftBatchReceiver(params, B, CHUNK, device=device)
    emits = _record_emits(rx)
    got_m, _ = _run_blind(rx, stream_m)
    delivered, lost, fails = _check_delivery("mixed", rx, emits, got_m,
                                             expected_m, offs_m)
    failures += fails
    out["mixed"] = {"delivered": delivered, "sent": 2 * B,
                    "lost_to_refractory": lost}
    print(f"  mixed lengths 1-64 B={B} ({stream_m.shape[1] // CHUNK} "
          f"quanta): {delivered}/{2 * B} delivered exact and in order, "
          f"{lost} lost to a false sync's refractory span; status "
          f"{rx.get_status()}")
    del rx, stream_m

    # the streaming decoder on single channels, in 4800-sample chunks
    feed_ms, dec_bad = [], 0
    for b in range(DECODER_CHANNELS):
        dec = soft_fsk.SoftFrameDecoder(params, device=device)
        x = stream[b].cpu().numpy()
        single = []
        for off in range(0, len(x), CHUNK):
            t0 = time.perf_counter()
            single += dec.feed(x[off:off + CHUNK])
            feed_ms.append((time.perf_counter() - t0) * 1e3)
        if single != got[b]:
            dec_bad += 1
            failures.append(f"SoftFrameDecoder channel {b}: {single} vs the "
                            f"receiver's {got[b]}")
    steady = sorted(feed_ms[4:])
    out["decoder_feed_ms"] = sum(steady) / len(steady)
    print(f"  SoftFrameDecoder on channels 0-{DECODER_CHANNELS - 1}: "
          f"{DECODER_CHANNELS - dec_bad} equal to the receiver; "
          f"{out['decoder_feed_ms']:.3f} ms host wall per "
          f"{CHUNK}-sample feed (median {steady[len(steady) // 2]:.3f}) "
          f"[{card}]")

    # kernels against plain: 256 channels through the kernels, then
    # through the plain versions (device="cpu")
    Bp = PLAIN_RUN_BATCH
    sub = stream[:Bp]
    runs = {}
    for where in ("cuda", "cpu"):
        rx = BlindSoftBatchReceiver(params, Bp, CHUNK,
                                    device=device if where == "cuda" else
                                    "cpu")
        t0 = time.perf_counter()
        runs[where] = (_run_blind(rx, sub if where == "cuda" else
                                  sub.cpu())[0], rx.get_status())
        print(f"  B={Bp} through the "
              f"{'kernels' if where == 'cuda' else 'plain versions (CPU)'}: "
              f"{time.perf_counter() - t0:.1f} s, status {runs[where][1]}")
    same = runs["cuda"][0] == runs["cpu"][0]
    if not same:
        failures.append(f"B={Bp}: kernels and plain versions delivered "
                        "different payloads")
    print(f"  B={Bp}: kernels {sum(len(g) for g in runs['cuda'][0])} "
          f"payloads, plain versions {sum(len(g) for g in runs['cpu'][0])}; "
          f"{'the same' if same else 'DIFFERENT'}")
    if failures:
        raise RuntimeError("phase 13: " + "; ".join(failures))
    return launches, out


def _cycle_stream(params, rng, B, device):
    """A cyclic [B, period * CHUNK] stream: one 16-byte frame per channel
    at a random phase (wrapping), as ``bench.py --family blind`` builds
    it, so frames close on every feed in steady state."""
    import torch

    from webaudio_modem_tpu_torch.ops import soft_fsk

    payloads = _messages(rng, B, SOFT_PAYLOAD)
    sigs = soft_fsk.encode_frames_batch(params, payloads, device=device)
    T_f = sigs.shape[1]
    period = -(-T_f // CHUNK) + 3
    T = period * CHUNK
    offs = torch.from_numpy(rng.integers(0, T, B)).to(device)
    idx = (torch.arange(T, device=device)[None, :] - offs[:, None]) % T
    vals = torch.gather(sigs, 1, idx.clamp_max(T_f - 1))
    return payloads, torch.where(idx < T_f, vals, 0.0), period


def phase_blind_timings(device, rng, card):
    import torch

    from webaudio_modem_tpu_torch.ops.kernels import cumsum0
    from webaudio_modem_tpu_torch.ops.soft_blind import BlindSoftBatchReceiver
    from webaudio_modem_tpu_torch.ops import soft_fsk
    from webaudio_modem_tpu_torch.sim import make_device_awgn
    from webaudio_modem_tpu_torch.utils.trace import metrics

    params = _soft_params()
    timings = {}
    gen = torch.Generator(device=device)
    gen.manual_seed(14)
    for n, B in CSUM_SHAPES:
        x = torch.randn((n, B), generator=gen, device=device)
        n_bytes, n_ops = _csum_bound(n, B)
        timings[f"cumsum0_{n}"] = _timing(
            f"[{n}, {B}]", _cuda_ms(lambda: cumsum0.csum0(x), 20),
            _cuda_ms(lambda: cumsum0.csum0_plain(x), 1), n_bytes, n_ops,
            library_ms=_cuda_ms(lambda: torch.cumsum(x, 0), 20))
        _print_timing("cumsum0", timings[f"cumsum0_{n}"], card)
        del x

    B = MAIN_BATCH
    payloads, cycle, period = _cycle_stream(params, rng, B, device)
    sig_power = float(torch.mean(soft_fsk.encode_frames_batch(
        params, payloads[:16], device=device).double() ** 2))
    noise_power = sig_power / 10 ** (SOFT_SNR_DB / 10)
    rx = BlindSoftBatchReceiver(params, B, CHUNK, seed=3, device=device,
                                channel_fn=make_device_awgn(noise_power))
    quanta = [cycle[:, j * CHUNK:(j + 1) * CHUNK] for j in range(period)]
    wrong = delivered = 0

    def feeds(n):
        nonlocal wrong, delivered
        for j in range(n):
            for ch, pl in rx.feed(quanta[rx._fed % period]):
                delivered += 1
                wrong += pl != payloads[ch]

    feeds(2 * period)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    metrics.reset()
    walls = {}
    for n_cycles in (2, 4):
        t0 = time.perf_counter()
        feeds(n_cycles * period)
        torch.cuda.synchronize()
        walls[n_cycles] = time.perf_counter() - t0
    per_feed_ms = (walls[4] - walls[2]) / (2 * period) * 1e3
    channels = B * AUDIO_S_PER_CHUNK / (per_feed_ms / 1e3)
    if wrong or delivered < 6 * B:
        raise RuntimeError(f"blind steady state: {wrong} wrong, "
                           f"{delivered} delivered over {8 * period} feeds")
    snap = metrics.snapshot()["timings"]
    stages = {k.split(".", 1)[1]: v["mean_ms"] for k, v in snap.items()
              if k.startswith("blind_rx.")}
    timings["feed"] = {"per_feed_ms": per_feed_ms,
                       "realtime_channels": channels,
                       "walls_s": walls, "host_stage_ms": stages,
                       "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}
    print(f"  blind feed B={B}, 16-byte frames at {SOFT_SNR_DB:g} dB, cyclic "
          f"period {period} quanta: {per_feed_ms:.3f} ms host wall per feed "
          f"(slope of 2 and 4 cycles: {walls[2]:.3f} / {walls[4]:.3f} s), "
          f"{channels:,.0f} realtime channels; {delivered} payloads, "
          f"{wrong} wrong; peak {timings['feed']['peak_mib']:.1f} MiB "
          f"[{card}]")
    print("  host stages, mean ms per feed: " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))

    # the device programs alone
    j = rx._fed
    x = quanta[j % period]
    timings["detector_ms"] = _cuda_ms(
        lambda: rx._detect(x, j * rx._n_ds, (j % rx._n_slots) * rx._n_ds), 20)
    t_rel, b_rel, act = _program_args(rx, device)
    timings["header_prog_ms"] = _cuda_ms(
        lambda: rx._header_prog(1, t_rel, act), 10)
    timings["body_prog_ms"] = _cuda_ms(
        lambda: rx._body_prog(SOFT_PAYLOAD, 1, b_rel, act), 10)
    print(f"  detector {timings['detector_ms']:.3f} ms per quantum, header "
          f"program {timings['header_prog_ms']:.3f} ms, body program "
          f"({SOFT_PAYLOAD} B) {timings['body_prog_ms']:.3f} ms, all "
          f"{B} channels active (CUDA events) [{card}]")
    for name, call in (("header", lambda: rx._header_prog(1, t_rel, act)),
                       ("body", lambda: rx._body_prog(SOFT_PAYLOAD, 1, b_rel,
                                                      act))):
        enq = done = 0.0
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            enq += (t1 - t0) * 1e3 / 5
            done += (time.perf_counter() - t0) * 1e3 / 5
        timings[f"{name}_prog_host"] = {"enqueue_ms": enq, "done_ms": done}
        print(f"  {name} program alone: host enqueue {enq:.3f} ms, enqueue "
              f"to done {done:.3f} ms (host clock) [{card}]")

    # no call inside feed may wait for the device: PyTorch's sync debug
    # mode raises on the synchronizing calls it knows of (not every kind)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        feeds(period)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"  sync debug mode 'error' over {period} feeds: no synchronizing "
          "call inside feed")
    try:
        _profile(f"blind feed B={B}", lambda: feeds(period), period,
                 per_feed_ms, card)
        timings["host_ops"] = _host_ops(f"blind feed B={B}",
                                        lambda: feeds(period), period)
    except RuntimeError as exc:     # a measurement, not a check
        print(f"  profile: torch.profiler failed: {exc}")
    return timings


# ---------------------------------------------------------------------------
# K8, BASELINE configs 2 (BER) and 4 (V.21), impairments, checkpoints
# ---------------------------------------------------------------------------

# BASELINE config 2: Bell-202 (1200 baud, mark 1200 / space 2200 Hz)
BELL202 = dict(baud_rate=1200, mark_frequency=1200.0, space_frequency=2200.0)
BER_SNRS = (30.0, 20.0, 15.0, 10.0, 5.0, 0.0, -6.0)
BER_BATCH = 4096
# the harness's default message (T = 3,280, maxb 11) and a 128-byte one
# (T = 52,880, maxb 148: the shape at which the TPU took K8)
BER_MESSAGES = {"short": b"\x55\x0f\xa3\xc1", "long": bytes(range(128))}
GOLDEN_SUBSET = {"short": 64, "long": 8}
IMPAIR_BATCH = 1024
CARRIER_OFFSETS_HZ = (0.0, 120.0, 250.0)
CLOCK_SKEWS = (0.0, 0.002, 0.01)
# K8 per step: the state machine's ~40 operations and the packing's 6
K8_OPS_PER_STEP = 46


def _bell202():
    from webaudio_modem_tpu_torch.models.config import FSKConfig

    return FSKConfig(**BELL202)


def _stage_d_inputs(params, state, x):
    """K1's planes for the f32 [T, B] samples ``x`` from ``state`` and the
    stage-D operands made from them: (bits, amps, ratios, sub_amps)."""
    import torch

    from webaudio_modem_tpu_torch.ops import fsk_demod
    from webaudio_modem_tpu_torch.ops.kernels import fsk_seq

    ds = params.ds_samples_per_bit
    _, _, bits, amps, _, rsum = fsk_seq.seq(
        params, 0, state.front, state.ds_acc, state.bit_tail[-ds:], x)
    ratios = fsk_demod._sync_ratios_from_r(params, state.r_tail, rsum)
    return bits, amps, ratios, torch.cat([state.amp_tail, amps])


def _route(params, x, per_step):
    """Whole-signal stage D of f32 [B, T] samples from a fresh state: K1
    and the sync matmul, then K2 (the port's path) or, ``per_step``, K8
    and the masked-sum compaction (the TPU's route for long chunks).
    Returns (bytes_out, byte_count)."""
    from webaudio_modem_tpu_torch.ops import fsk_demod
    from webaudio_modem_tpu_torch.ops.kernels import fsk_framing

    state = fsk_demod.init_state(params, x.shape[0], x.device)
    planes = _stage_d_inputs(params, state, x.t().contiguous())
    maxb = fsk_demod.max_bytes(params, planes[0].shape[0])
    if per_step:
        _, k_planes = fsk_demod.stage_d(params, state, *planes)
        return fsk_framing.compact(*k_planes, maxb)[:2]
    ints, flts = fsk_demod._framing_carry(params, state)
    out = fsk_framing.stage_d_compact(params, ints, flts, state.bit_fill,
                                      *planes, maxb)
    return out[2], out[3]


def _k8_bytes(n_ds, B):
    """Bytes K8 must move: bits bf16, amps, ratios and the delayed amps
    f32 in, the packed i32 word out, per step and channel; the carry in
    and out and bit_fill."""
    return n_ds * B * 18 + B * (2 * (10 + 2) * 4 + 4)


def _k8_kernel_only(params, state, planes):
    """A call that launches K8's kernel alone on ``planes`` into outputs
    made once: no carry build, no unpacking of the packed plane, no
    launch counted; to time the kernel beside its wrapper."""
    import ctypes

    import torch

    from webaudio_modem_tpu_torch.ops import fsk_demod
    from webaudio_modem_tpu_torch.ops.kernels import _build, fsk_framing

    bits = planes[0]
    n_ds, B = bits.shape
    ints, flts = fsk_demod._framing_carry(params, state)
    outs = [torch.empty((fsk_framing.N_I32, B), dtype=torch.int32,
                        device=bits.device),
            torch.empty((fsk_framing.N_F32, B), dtype=torch.float32,
                        device=bits.device),
            torch.empty((n_ds, B), dtype=torch.int32, device=bits.device)]
    p = _build.ptr
    coef = fsk_framing._kernel_coef(params)
    entry = fsk_framing._stage_d_entry()

    def launch():
        _build.raise_on_error(entry(
            *map(p, planes), n_ds, B, p(ints), p(flts), p(state.bit_fill),
            *map(p, outs), ctypes.byref(coef), _build.stream()),
            "fsk_stage_d")
    return launch


def _check_k8(params, state, planes, label, need=()):
    """K8 against its plain version on the same CUDA tensors (planes and
    carries exactly equal), ``compact`` of its planes against K2, and two
    halves chained through the carry against the whole call; raises
    unless each event named in ``need`` ("bytes", "syncs", "EODs")
    occurred.  Returns (the plain version's ms, the largest difference
    from it)."""
    import torch

    from webaudio_modem_tpu_torch.ops import fsk_demod
    from webaudio_modem_tpu_torch.ops.kernels import fsk_framing

    bits, amps, ratios, sub = planes
    n_ds, B = bits.shape
    (ints, flts), k_planes = fsk_demod.stage_d(params, state, *planes)
    plain = []
    plain_ms = _cuda_ms(lambda: plain.append(fsk_demod.stage_d(
        params, state, *planes, plain=True)), 1)
    (p_ints, p_flts), p_planes = plain[0]
    err = max(_equal_or_raise(f"K8 {label} {name}", a, b)
              for name, a, b in (("ints", ints, p_ints),
                                 ("flts", flts, p_flts),
                                 *zip(("byte_vals", "emits", "eods", "fires"),
                                      k_planes, p_planes)))

    maxb = fsk_demod.max_bytes(params, n_ds)
    c_ints, c_flts = fsk_demod._framing_carry(params, state)
    k2 = fsk_framing.stage_d_compact(params, c_ints, c_flts, state.bit_fill,
                                     *planes, maxb)
    compacted = fsk_framing.compact(*k_planes, maxb)
    for name, a, b in (("ints", ints, k2[0]), ("flts", flts, k2[1]),
                       *zip(("bytes_out", "byte_count", "eod_fired",
                             "sync_fired", "fire_t"), compacted, k2[2:])):
        _equal_or_raise(f"compact(K8) vs K2 {label} {name}", a, b)

    if n_ds > 1:
        h = n_ds // 2 + 1
        (ints1, flts1), first = fsk_framing.stage_d(
            params, c_ints, c_flts, state.bit_fill, bits[:h], amps[:h],
            ratios[:h], sub[:h])
        (ints2, flts2), second = fsk_framing.stage_d(
            params, ints1, flts1, state.bit_fill + h, bits[h:], amps[h:],
            ratios[h:], sub[h:])
        for name, a, b, w in zip(("byte_vals", "emits", "eods", "fires"),
                                 first, second, k_planes):
            _equal_or_raise(f"K8 {label} halves {name}", torch.cat([a, b]),
                            w)
        _equal_or_raise(f"K8 {label} halves ints", ints2, ints)
        _equal_or_raise(f"K8 {label} halves flts", flts2, flts)
    torch.cuda.synchronize()
    events = {"bytes": int(compacted[1].sum()),
              "syncs": int(compacted[3].sum()),
              "EODs": int(compacted[2].sum())}
    print(f"  K8 {label} n_ds={n_ds} B={B}: planes and carry equal to the "
          f"plain version ({plain_ms:.1f} ms); compact(K8) equal to K2 "
          f"(maxb {maxb}); " + ", ".join(f"{k} {v}" for k, v in
                                         events.items()))
    missing = [k for k in need if not events[k]]
    if missing:
        raise RuntimeError(f"K8 {label}: no {missing} in the check")
    return plain_ms, err


def _time_k8_kernel_only(timing, params, state, planes, reps, card):
    """Add K8's kernel alone (``kernel_only_ms``) to a timing made of its
    wrapper (``ms``: the carry, the kernel and the unpacking)."""
    launch = _k8_kernel_only(params, state, planes)
    launch()
    timing["kernel_only_ms"] = _cuda_ms(launch, reps)
    print(f"  fsk_stage_d K8 {timing['shape']}: kernel alone "
          f"{timing['kernel_only_ms']:.4f} ms, wrapper {timing['ms']:.4f} ms "
          f"[{card}]")


def phase_k8_vs_plain(device, rng, card):
    import torch

    from webaudio_modem_tpu_torch.models.config import FSKParams
    from webaudio_modem_tpu_torch.ops import fsk_demod, fsk_mod
    from webaudio_modem_tpu_torch.ops.kernels import fsk_framing
    from webaudio_modem_tpu_torch.sim import ber

    launches0 = fsk_framing.stage_d_launches
    out = {}
    errs = []
    # the hard bench planes: the second 0.1 s chunk of 13-byte messages
    params = FSKParams.from_config(_bench_config())
    sig = fsk_mod.modulate_batch(params, _messages(rng, MAIN_BATCH, 13),
                                 device)
    state, _ = fsk_demod.demod_chunk(
        params, 0, fsk_demod.init_state(params, MAIN_BATCH, device),
        sig[:, :CHUNK])
    planes = _stage_d_inputs(params, state,
                             sig[:, CHUNK:2 * CHUNK].t().contiguous())
    bench_plain_ms, err = _check_k8(params, state, planes, "bench chunk",
                                    need=("bytes",))
    errs.append(err)
    n = planes[0].shape[0]
    c_ints, c_flts = fsk_demod._framing_carry(params, state)
    k2_args = (params, c_ints, c_flts, state.bit_fill, *planes,
               fsk_demod.max_bytes(params, n))
    turns = [("K2", lambda: fsk_framing.stage_d_compact(*k2_args)),
             ("K8", lambda: fsk_demod.stage_d(params, state, *planes))] * 2
    for _, fn in turns:
        fn()
    out["bench_turns_ms"] = [(label, _cuda_ms(fn, 20)) for label, fn in turns]
    print(f"  n_ds={n} B={MAIN_BATCH}, K2 and K8 in turns: "
          + ", ".join(f"{label} {ms:.4f}" for label, ms in
                      out["bench_turns_ms"]) + f" ms [{card}]")
    out["bench"] = _timing(
        f"n_ds={n} B={MAIN_BATCH} (bench chunk, mean of the K8 turns)",
        sum(ms for label, ms in out["bench_turns_ms"] if label == "K8") / 2,
        bench_plain_ms, _k8_bytes(n, MAIN_BATCH),
        n * MAIN_BATCH * K8_OPS_PER_STEP)
    _print_timing("fsk_stage_d K8", out["bench"], card)
    _time_k8_kernel_only(out["bench"], params, state, planes, 20, card)

    # the long BER planes: 128-byte Bell-202 messages at 10 dB
    params = FSKParams.from_config(_bell202())
    clean = ber.clean_signal(_bell202(), BER_MESSAGES["long"])
    x = torch.from_numpy(ber.noisy_batch(clean, 10.0, MAIN_BATCH)).to(device)
    state = fsk_demod.init_state(params, MAIN_BATCH, device)
    planes = _stage_d_inputs(params, state, x.t().contiguous())
    del x
    plain_ms, err = _check_k8(params, state, planes, "long BER 10 dB",
                              need=("bytes", "syncs"))
    errs.append(err)
    n = planes[0].shape[0]
    k8_ms = _cuda_ms(lambda: fsk_demod.stage_d(params, state, *planes), 10)
    out["timing"] = _timing(f"n_ds={n} B={MAIN_BATCH} (128-byte Bell-202 "
                            "at 10 dB)", k8_ms, plain_ms,
                            _k8_bytes(n, MAIN_BATCH),
                            n * MAIN_BATCH * K8_OPS_PER_STEP)
    _print_timing("fsk_stage_d K8", out["timing"], card)
    _time_k8_kernel_only(out["timing"], params, state, planes, 10, card)
    del planes

    # whole clean 4-byte Bell-202 messages with silence after them, so
    # every channel ends its frame (EOD), at an odd n_ds and a batch that
    # is no multiple of the block; and no step at all
    B = 1000
    params = FSKParams.from_config(_bell202())
    sig = fsk_mod.modulate_batch(params, _messages(rng, B, 4), device)
    x = torch.nn.functional.pad(sig, (0, 2 * 1837 + 1 - sig.shape[1]))
    state = fsk_demod.init_state(params, B, device)
    errs.append(_check_k8(params, state, _stage_d_inputs(
        params, state, x.t().contiguous()), "odd", need=(
            "bytes", "syncs", "EODs"))[1])
    z = torch.zeros((0, B), device=device)
    errs.append(_check_k8(params, state,
                          (z.bfloat16(), z, z, state.amp_tail), "empty")[1])
    out["max_abs_err"] = max(errs)
    print(f"  K8 launched {fsk_framing.stage_d_launches - launches0} times "
          "in these comparisons (not counted for the path)")
    return out


def _launch_counts():
    """The launch counters of the kernels on the BER sweep's paths."""
    from webaudio_modem_tpu_torch.ops.kernels import fsk_framing, fsk_seq

    return {"fsk_seq": fsk_seq.launches, "fsk_framing": fsk_framing.launches,
            "fsk_stage_d": fsk_framing.stage_d_launches}


class _SweepRecorder:
    """``ber_sweep``'s demodulator: ``ModemFarm(config, B).demodulate`` on
    the card, as the sweep's default, keeping what the checks need — the
    decodes, the golden subset's signals, the host wall and, where
    ``keep``, the whole host batch (for the TPU's route after the
    sweep)."""

    def __init__(self, config, device, subset, keep):
        self.config, self.device = config, device
        self.subset, self.keep = subset, keep
        self.points = []

    def __call__(self, batch):
        import torch

        from webaudio_modem_tpu_torch.models.farm import ModemFarm

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = torch.from_numpy(batch).to(self.device)
        decoded = ModemFarm(self.config, len(batch),
                            device=self.device).demodulate(x)
        wall = time.perf_counter() - t0
        self.points.append(dict(decoded=decoded, wall_s=wall,
                                rows=batch[:self.subset].copy(),
                                batch=batch if self.keep else None))
        return decoded


def phase_ber(device, card):
    """BASELINE config 2 at B=4096: both Bell-202 sweeps through
    ``sim.ber.ber_sweep`` (the port's ModemFarm on the card), the golden
    comparator on a subset of each point, the plain versions on the CPU
    for every message that differs from the golden model; after the
    sweeps, the TPU's route for long chunks (K8 through
    ``fsk_demod.stage_d``, then ``compact``) over every long-sweep batch,
    which must decode as the sweep did, and whole-signal stage D timed by
    its two routes.  Returns the sweeps' launches, the route's launches
    and the results."""
    import numpy as np
    import torch

    from webaudio_modem_tpu_torch.models.config import FSKParams
    from webaudio_modem_tpu_torch.models.farm import ModemFarm
    from webaudio_modem_tpu_torch.ops.kernels import fsk_framing, fsk_seq
    from webaudio_modem_tpu_torch.sim import ber

    config = _bell202()
    golden = ber.golden_demodulate(config)
    fsk_seq.launches = fsk_framing.launches = 0
    fsk_framing.stage_d_launches = 0
    sweeps, peak_mib, golden_s = {}, {}, 0.0
    for name, message in BER_MESSAGES.items():
        rec = _SweepRecorder(config, device, GOLDEN_SUBSET[name],
                             keep=name == "long")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        points = ber.ber_sweep(config, BER_SNRS, message,
                               messages_per_point=BER_BATCH, demodulate=rec)
        sweep_s = time.perf_counter() - t0
        peak_mib[name] = torch.cuda.max_memory_allocated() / 2 ** 20
        T = len(ber.clean_signal(config, message))
        print(f"  {name} message ({len(message)} bytes, T={T}), B="
              f"{BER_BATCH}: sweep {sweep_s:.1f} s host wall (noise drawn on "
              f"the host), peak device memory {peak_mib[name]:.1f} MiB")
        differing = []
        for pt, rp in zip(points, rec.points):
            t0 = time.perf_counter()
            gold = golden(rp["rows"])
            golden_s += time.perf_counter() - t0
            ours = rp["decoded"][:len(gold)]
            diff = [k for k, (o, g) in enumerate(zip(ours, gold)) if o != g]
            print(f"    {pt.snr_db:5.1f} dB: BER {pt.ber:.6f}, FER "
                  f"{pt.fer:.6f} ({pt.byte_errors}/{pt.messages}); "
                  f"demodulate {rp['wall_s'] * 1e3:.1f} ms host wall; golden "
                  f"subset {len(gold)}: {len(diff)} differ")
            if diff and pt.snr_db >= 10.0:
                raise RuntimeError(f"{name} at {pt.snr_db} dB: {len(diff)} "
                                   "subset messages decode otherwise than "
                                   "the golden model")
            differing += [(rp["rows"][k], ours[k]) for k in diff]
        if points[0].bit_errors:
            raise RuntimeError(f"{name}: bit errors at {points[0].snr_db} dB")
        if differing:
            rows = torch.from_numpy(np.stack([r for r, _ in differing]))
            plain = ModemFarm(config, len(differing),
                              device="cpu").demodulate(rows)
            if plain != [d for _, d in differing]:
                raise RuntimeError(f"{name}: a message that differs from "
                                   "the golden model decodes otherwise "
                                   "through the plain versions (CPU)")
            print(f"    the {len(differing)} messages that differ from the "
                  "golden model decode the same through the plain versions "
                  "on the CPU")
        sweeps[name] = dict(
            T=T, peak_mib=peak_mib[name], sweep_s=sweep_s,
            points=[dict(snr_db=p.snr_db, ber=p.ber, fer=p.fer,
                         bit_errors=p.bit_errors, byte_errors=p.byte_errors,
                         demodulate_ms=rp["wall_s"] * 1e3)
                    for p, rp in zip(points, rec.points)],
            golden_differ_below_10db=len(differing))
        if name == "long":
            long_points = rec.points
    launches = _launch_counts()
    n = len(BER_SNRS)
    print(f"  sweep launches {launches}; golden comparator {golden_s:.1f} s")
    if launches != {"fsk_seq": 2 * n, "fsk_framing": 2 * n,
                    "fsk_stage_d": 0}:
        raise RuntimeError(f"BER path launches {launches}")

    # the TPU's route over every long-sweep batch, outside the sweep's
    # timed window: no entry point of the port sends a chunk to K8, so
    # these are K8's only launches on a driven path
    params = FSKParams.from_config(config)
    fsk_seq.launches = fsk_framing.launches = 0
    fsk_framing.stage_d_launches = 0
    t0 = time.perf_counter()
    x10 = None
    for snr, rp in zip(BER_SNRS, long_points):
        x = torch.from_numpy(rp.pop("batch")).to(device)
        vals, counts = _route(params, x, per_step=True)
        counts, vals = counts.cpu().numpy(), vals.cpu().numpy()
        routed = [bytes(vals[b, :counts[b]]) for b in range(len(x))]
        if routed != rp["decoded"]:
            bad = sum(r != d for r, d in zip(routed, rp["decoded"]))
            raise RuntimeError(f"K8 + compact at {snr} dB: {bad} channels "
                               "decode otherwise than the K2 path")
        if snr == 10.0:
            x10 = x
    route_launches = _launch_counts()
    print(f"  the TPU's route (K8 + compact) decodes all {n} long batches "
          f"as the sweep did ({time.perf_counter() - t0:.1f} s host wall); "
          f"launches {route_launches}")
    if route_launches != {"fsk_seq": n, "fsk_framing": 0, "fsk_stage_d": n}:
        raise RuntimeError(f"TPU route launches {route_launches}")

    # whole-signal stage D of the long sweep's 10 dB batch, by route
    routes = {"K2 (the port's path)": False, "K8 + compact (TPU route)": True}
    for per_step in routes.values():
        _route(params, x10, per_step)
    times = {label: _cuda_ms(lambda p=p: _route(params, x10, p), 5)
             for label, p in routes.items()}
    print("  whole-signal K1 + sync + stage D, long batch at 10 dB: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in times.items())
          + f" [{card}]")
    return launches, route_launches, dict(sweeps=sweeps, route_ms=times,
                                          golden_s=golden_s)


def phase_v21_impairments_checkpoints(device, rng, card):
    import os
    import tempfile

    import numpy as np
    import torch

    from webaudio_modem_tpu_torch.models.config import FSKConfig
    from webaudio_modem_tpu_torch.models.farm import ModemFarm
    from webaudio_modem_tpu_torch.models.v21 import V21Duplex
    from webaudio_modem_tpu_torch.sim import ber, impairments

    out = {}
    # BASELINE config 4: V.21 full duplex, each station B=1; the second
    # exchange with the reference suite's line noise
    for d1, d2, noisy in ((b"ping!", b"pong.", False),
                          (b"\x11\x22", b"\x33\x44", True)):
        link = V21Duplex(device=device)
        noise = None
        if noisy:
            sig_len = len(link.calling.modulate(d1))
            link.calling.reset()
            noise = (np.random.RandomState(9).uniform(
                -1, 1, sig_len + 48000) * 0.02).astype(np.float32)
        t0 = time.perf_counter()
        got = link.exchange(d1, d2, noise=noise)
        wall = time.perf_counter() - t0
        print(f"  V.21 exchange {d1!r} / {d2!r}"
              f"{' with noise' if noise is not None else ''}: decoded "
              f"{got[0]!r} / {got[1]!r} ({wall * 1e3:.1f} ms host wall)")
        if got != (d1, d2):
            raise RuntimeError("V.21: a direction decoded wrong")
    out["v21_exact"] = True

    # impairments on the Bell-202 config, hard column at B=1024, and the
    # golden model's verdicts on the first 8 messages of every point
    config = _bell202()
    golden = ber.golden_demodulate(config)
    for sweep, values in ((impairments.carrier_offset_sweep,
                           CARRIER_OFFSETS_HZ),
                          (impairments.clock_skew_sweep, CLOCK_SKEWS)):
        t0 = time.perf_counter()
        pts = sweep(config, values, messages_per_point=IMPAIR_BATCH,
                    device=device)
        wall = time.perf_counter() - t0
        ours8 = sweep(config, values, messages_per_point=8, device=device)
        gold8 = sweep(config, values, messages_per_point=8,
                      demodulate=golden)
        name = sweep.__name__
        print(f"  {name} B={IMPAIR_BATCH} at 30 dB ({wall:.1f} s): "
              + ", ".join(f"{p.value:g}: FER {p.fer:.4f} BER {p.ber:.5f}"
                          for p in pts))
        if [(p.fer, p.ber) for p in ours8] != [(p.fer, p.ber)
                                               for p in gold8]:
            raise RuntimeError(f"{name}: the first 8 messages decode "
                               "otherwise than the golden model")
        if pts[0].fer:
            raise RuntimeError(f"{name}: errors without impairment")
        out[name] = [(p.value, p.fer, p.ber) for p in pts]
    (soft,) = impairments.carrier_offset_sweep(
        config, [40.0], messages_per_point=16, snr_db=None, soft=True,
        device=device)
    print(f"  soft column (SoftModemCore), 40 Hz offset, 16 messages: "
          f"FER {soft.fer}")
    if soft.fer:
        raise RuntimeError("soft column: frames lost at 40 Hz offset")
    out["soft_40hz_fer"] = soft.fer

    # a checkpoint mid-stream at B=4096: 3 chunks, save, restore into a new
    # farm, the rest; against an uninterrupted run
    farm = ModemFarm(_bench_config(), MAIN_BATCH, device=device)
    msgs = _messages(rng, MAIN_BATCH, 13)
    sig = farm.modulate(msgs)
    cut = 3 * CHUNK
    whole = ModemFarm(_bench_config(), MAIN_BATCH,
                      device=device).demodulate(sig, chunk_size=CHUNK)
    part1 = farm.demodulate(sig[:, :cut], chunk_size=CHUNK)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/farm.npz"
        t0 = time.perf_counter()
        farm.save(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = ModemFarm.restore(path, device=device)
        restore_s = time.perf_counter() - t0
        size_mb = os.path.getsize(path) / 1e6
    for name, x in vars(farm.state).items():
        if not torch.equal(x, getattr(restored.state, name)):
            raise RuntimeError(f"checkpoint: {name} differs after restore")
    part2 = restored.demodulate(sig[:, cut:], chunk_size=CHUNK)
    resumed = [a + b for a, b in zip(part1, part2)]
    print(f"  checkpoint B={MAIN_BATCH} after 3 chunks: {size_mb:.1f} MB "
          f"file, save {save_s * 1e3:.0f} ms, restore {restore_s * 1e3:.0f} "
          f"ms; resumed decode equal to the uninterrupted run: "
          f"{resumed == whole}, exact {sum(r == m for r, m in zip(resumed, msgs))}"
          f"/{MAIN_BATCH}")
    if resumed != whole or whole != msgs:
        raise RuntimeError("checkpoint: the resumed stream decodes "
                           "otherwise than the uninterrupted run")
    out["checkpoint"] = dict(file_mb=size_mb, save_ms=save_s * 1e3,
                             restore_ms=restore_s * 1e3)
    return out


def _host_ops(label, run, calls, top=8):
    """The host side of ``run()`` (``calls`` calls) under torch.profiler,
    CPU only: kernel launches per call and the operators with the most
    self CPU time, with their counts per call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    rows = sorted(((e.self_cpu_time_total, e.key, e.count)
                   for e in prof.key_averages()), reverse=True)
    launches = sum(c for _, k, c in rows if k == "cudaLaunchKernel")
    total_ms = sum(r[0] for r in rows) / 1e3 / calls
    print(f"  host ops {label}: {launches / calls:.0f} kernel launches and "
          f"{total_ms:.3f} ms of operator self CPU time per call")
    for us, key, count in rows[:top]:
        print(f"    {us / 1e3 / calls:8.4f} ms/call  {count / calls:7.1f} "
              f"calls  {key[:60]}")
    return {"launches_per_call": launches / calls,
            "self_cpu_ms_per_call": total_ms,
            "top": [(key, us / 1e3 / calls, count / calls)
                    for us, key, count in rows[:top]]}


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
    paths = _build.build()
    print(f"  {len(paths)} libraries in {time.perf_counter() - t0:.1f} s "
          "(one nvcc per source, started together)")
    for name, log in sorted(_build.build_log.items()):
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill", log)]
        if not regs:
            raise RuntimeError(f"{name}: no ptxas report in the build log")
        print(f"  {name}: {len(regs)} kernel(s), at most {max(regs)} "
              f"registers, {sum(spills)} bytes of spill stores and loads")

    rng = np.random.default_rng(0)
    print("phase 3: hard-path kernels vs plain on the card")
    max_err = phase_kernels_vs_plain(device, rng)
    _resident("phase 3")
    print("phase 4: hard main path")
    hard_launches = phase_main_path(device, rng)
    _resident("phase 4")
    print("phase 5: hard-path timings")
    kernel_ms = phase_timings(device, rng, card)
    _resident("phase 5")
    print("phase 6: soft-path kernels vs plain on the card")
    soft_errs, k7_timing = phase_soft_kernels_vs_plain(device, rng)
    for name, err in soft_errs.items():
        max_err[name] = max(max_err.get(name, 0.0), err)
    _print_timing("fsk_seq K7", k7_timing, card)
    _resident("phase 6")
    print("phase 7: soft main path")
    soft_launches = phase_soft_main_path(device, rng)
    _resident("phase 7")
    print("phase 8: soft-path timings")
    soft = phase_soft_timings(device, rng, card)
    _resident("phase 8")
    print("phase 9: DBPSK kernel vs plain on the card")
    for name, err in phase_psk_kernels_vs_plain(device, rng).items():
        max_err[name] = max(max_err.get(name, 0.0), err)
    _resident("phase 9")
    print("phase 10: DBPSK main path")
    psk_launches = phase_psk_main_path(device, rng)
    _resident("phase 10")
    print("phase 11: DBPSK timings")
    psk = phase_psk_timings(device, rng, card)
    _resident("phase 11")
    print("phase 12: K5 vs plain on the card")
    max_err["cumsum0"] = phase_cumsum_vs_plain(device)
    _resident("phase 12")
    print("phase 13: blind acquisition and the streaming soft decoder")
    blind_launches, blind_out = phase_blind_main_path(device, rng, card)
    _resident("phase 13")
    print("phase 14: blind timings")
    blind = phase_blind_timings(device, rng, card)
    print("phase 15: K8 vs plain on the card")
    k8 = phase_k8_vs_plain(device, rng, card)
    max_err["fsk_stage_d"] = k8["max_abs_err"]
    print("phase 16: BASELINE config 2, Bell-202 BER sweeps at B=4096")
    ber_launches, route_launches, ber_out = phase_ber(device, card)
    print("phase 17: V.21 full duplex, impairments, checkpoints")
    slice_out = phase_v21_impairments_checkpoints(device, rng, card)

    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib",
                                        "webaudio_modem_tpu"))
    if bad:
        raise RuntimeError(f"the port imported {bad[:5]}")

    def row(name, src, rep, t, extra):
        by_path = {"hard_fsk": hard_launches.get(name, 0),
                   "soft_fec": soft_launches.get(name, 0),
                   "dbpsk": psk_launches.get(name, 0),
                   "blind": blind_launches.get(name, 0),
                   "ber": ber_launches.get(name, 0),
                   "tpu_route (chip_smoke)": route_launches.get(name, 0)}
        if not any(by_path.values()):
            raise RuntimeError(f"{name}: no launch on a main path")
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return {"name": name, "route": "cuda",
                "source": f"webaudio_modem_tpu_torch/csrc/{src}",
                "replaces": f"webaudio_modem_tpu/ops/pallas/{rep}",
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": max_err[name],
                **{k: t[k] for k in keys}, "shape": t["shape"], **extra}

    def others(*names):
        return {"other_shapes": [
            {k: soft[n][k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}
            for n in names]}

    kernels = [
        row("fsk_seq", "fsk_seq.cu", "fsk_seq.py:131", kernel_ms["fsk_seq"],
            {"modes": {
                "all streams (hard path)": "the row's numbers",
                "emit_csum, bits/amps dropped (soft path)":
                    {k: soft["fsk_seq_csum"][k]
                     for k in ("shape", "ms", "plain_ms", "bound_ms",
                               "bound_by")},
                "emit_rsum=False: K7, fsk_seq.py:61 (ds > 256)":
                    {k: k7_timing[k]
                     for k in ("shape", "ms", "plain_ms", "bound_ms",
                               "bound_by")}}}),
        row("fsk_framing", "fsk_framing.cu", "fsk_framing.py:208",
            kernel_ms["fsk_framing"], {}),
        row("viterbi", "viterbi.cu", "viterbi.py:82", soft["viterbi_header"],
            {**others("viterbi_body", "viterbi_payload-100"),
             "graph_ms": {n: soft[f"viterbi_{n}"]["graph_ms"]
                          for n in ("header", "body", "payload-100")}}),
        row("align", "align.cu", "align.py:75", soft["align_header"],
            {**others("align_body"),
             "graph_ms": {n: soft[f"align_{n}"]["graph_ms"]
                          for n in ("header", "body")},
             "gather_only_ms": {n: soft[f"align_{n}"]["gather_only_ms"]
                                for n in ("header", "body")}}),
        row("psk_seq", "psk_seq.cu", "psk_seq.py:54", psk["psk_seq"],
            {"modes": {
                "D=20 with R (the DBPSK path)": "the row's numbers",
                **{psk[n]["shape"]: {k: psk[n][k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by")}
                   for n in ("psk_seq_d480", "psk_seq_d960")}},
             "turns_input_ms": psk["psk_seq"]["turns_input_ms"],
             "ring_placement_ms": psk["placements"],
             "demod_chunk_ms": {n: psk[n]["ms"] for n in (
                 "demod_chunk_B2048", "demod_chunk_B4096",
                 "demod_chunk_B2048_plain")}}),
        row("cumsum0", "cumsum0.cu", "cumsum0.py:59",
            blind[f"cumsum0_{CSUM_SHAPES[1][0]}"],
            {"other_shapes": [
                {k: blind[f"cumsum0_{n}"][k] for k in (
                    "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}
                for n, _ in (CSUM_SHAPES[0], CSUM_SHAPES[2])],
             "blind_feed": {k: blind["feed"][k] for k in (
                 "per_feed_ms", "realtime_channels", "peak_mib")},
             "blind_programs_ms": {k: blind[k] for k in (
                 "detector_ms", "header_prog_ms", "body_prog_ms")},
             "blind_main_path": blind_out}),
        row("fsk_stage_d", "fsk_stage_d.cu", "fsk_framing.py:47",
            k8["timing"],
            {"kernel_only_ms": k8["timing"]["kernel_only_ms"],
             "other_shapes": [{k: k8["bench"][k] for k in (
                 "shape", "ms", "kernel_only_ms", "plain_ms", "bound_ms",
                 "bound_by", "library_ms")}],
             "bench_turns_ms": k8["bench_turns_ms"],
             "ber_main_path": ber_out,
             "v21_impairments_checkpoints": slice_out}),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
