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
    K8 (K2's kernel body in its planes mode, ``csrc/fsk_framing.cu``)
    through its entry point
    ``fsk_demod.stage_d`` and the masked-sum compaction (no other entry
    point of the port reaches K8; its launches are reported under the
    path "tpu_route (chip_smoke)"); BASELINE config 4 (V.21 full
    duplex), the impairment sweeps and checkpoints;
  * BASELINE config 3, XModem end to end over simulated audio: two
    ``FSKProcessor``s on one ``AudioGraph`` at B = 1, over ``FSKCore``
    (K1 + K2), ``PSKCore`` (K6 + K2) and ``SoftModemCore`` (K1 in its
    csum mode + K3);
  * the BASELINE north-star topology: 4096 concurrent XModem sessions
    over one ``DeviceFarmHub`` (the wire a tensor ring on the card, K1 +
    K2 per direction a quantum, the native deframer on the host), a
    256-session ``FarmLoopbackHub`` and a DBPSK hub (K6 + K2);
  * the same topology over the soft-FEC wire: 4096 sessions over
    ``SoftFarmHub`` (cohorts framed and synthesized on the card, one
    fused window decode per transmission: K1 in its csum mode, K4 twice,
    K3 twice) and over ``BlindSoftFarmHub`` (K1 per quantum and
    direction, K5 + K4 + K3 per header or body program), and the FEC
    frame layer's ``FrameDecoder`` (K3 per decode).

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
     at B=2048 and 4096;
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
     exactly with 1 / 2 / 2 / 2 launches of K1 / K4 / K3 / the CRC kernel
     (header select, body gate and packing) and 1 of the sync-peak
     kernel, and an erased channel decodes to None;
  8. soft timings at B=2048 and 4096 (per decode, realtime channels,
     each kernel beside its plain version and, for K4, torch.gather over
     window sums made beforehand, which is not K4's function; K3's and
     K4's device time in a CUDA graph beside it, ``graph_ms``),
     peak device memory, and a torch.profiler breakdown;
  8b. the CRC kernel (``csrc/crc16.cu``) against its plain versions,
     bit for bit, at the frames cell's shapes (B = 4096, payloads of 16,
     45 and 133 bytes): ``pack_bodies`` over bodies in K3's layout
     (sound, one flipped bit in every third, every fifth not found),
     ``crc_rows`` over the payload rows, tails of 3 and 7 bits and the
     header candidates [B, 8, 16]; timed against its byte bound and its
     plain versions, enqueued and in a CUDA graph;
  8c. the sync-peak kernel (``csrc/sync_peak.cu``) against its plain
     version (the band GEMM and its glue), t_peak and the gate bit for
     bit in both lanes (the reference's pattern by its recurrence in
     fp16, two channels a thread; any pattern in f32, one), at the
     frames cell's shapes (B = 4096, 16 / 45 / 133-byte frames at 8 dB,
     R from K1 over the batch); timed against its byte bound and the
     plain version, enqueued and in a CUDA graph, the f32 lane beside;
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
 11. DBPSK timings: demod_chunk per chunk at B=2048 and 4096, K6
     beside its plain version and its bound at D = 20 (also on
     tools/turns.py seq's shorter input), 480 and 960, and K6's ring
     placement timed in turns against a copy built with its rings in
     device memory at every D;
 12. K5 against its plain version, exactly (0 mismatches), at the blind
     path's window shapes [7200 / 14400 / 91200, 4096] and at [37, 3]
     and [0, 5]; against np.cumsum of the host copy at two of them; at
     its edges (B = 1 and 4097, a base only 4-byte aligned, ring windows
     that wrap past the last row at B = 4096 and 1001);
 13. the blind main path at B=4096, two 16-byte frames per channel at
     random offsets (silence gaps of 2000-9000 samples): clean (every
     payload exact and in per-channel order; a frame not delivered only
     inside a false sync's refractory span, the reference's rule),
     launches counted (K1 per quantum; K5, K4, K3 and the CRC kernel
     once per program); at
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
     and K8 timed there in turns, enqueued and in a CUDA graph, and K8's
     wrapper profiled: one kernel launch a call, nothing beside it), the
     128-byte Bell-202 messages at 10 dB (n_ds = 26,440, B = 4096; K8's
     row numbers, the wrapper timed beside the kernel alone and in a
     graph), an odd n_ds with syncs, bytes and EODs (B = 1000), and
     n_ds = 0; then K8 and K2 at ``FRAMING_EDGE_CASES`` on synthetic
     planes (B = 1001 and 1 with the bits plane one element past
     alignment, n_ds = 0, 1, 17, a fire in a partial last tile, a counter
     a few steps below its wrap, sil at 2^24 - 3 on a silent stream, an
     EOD threshold of 559.3 steps);
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
     a new farm and run on, equal to an uninterrupted run;
 18. BASELINE config 3: XModem over two FSKProcessors(device="cuda") on
     one AudioGraph(quantum=512) with the reference suites' transfers
     (``XMODEM_TRANSFERS``): hello, 500 bytes (fragments 1-4 in order),
     the payload whose own CRC tail is a NAK (no retransmission), 80
     bytes at payload 32, AWGN, burst loss (payload 24, 8 retries), the
     same with one quantum lost inside fragment 1 (recovered by
     retransmission at XModem's 3 s default timeout), DBPSK (PSKCore)
     and the soft-FEC modem (SoftModemCore); every payload
     exact, launches counted per transfer (each core's kernels launched),
     no ERROR record from the processor, every core's state on the card;
     per transfer the audio and wall seconds and the median / p99 of one
     graph step against the 10.67 ms quantum; the hello again paced at
     the audio clock (late quanta counted); the hello receiver's quanta
     replayed through the plain versions on the CPU, equal call by call;
 19. the farm hubs (``runtime/device_hub.py``, ``runtime/farm_channel.py``):
     (a) DeviceFarmHub at B = 4096 with farm_endurance's settings
     (40-byte payloads, on-device AWGN 1e-4, quantum 4800, a 16-quantum
     ring), a warm-up transfer, then one round of 4096 XModem transfers
     each way, every payload exact: retransmissions, audio and wall
     seconds, the quantum's wall (median / p99) against 100 ms, the
     hub's timers, K1 and K2 launches a quantum (one each per
     direction), peak device memory, and a torch.profiler capture of a
     third round (the device's busy share); (b) FarmLoopbackHub at
     B = 256, one round exact; (c) a DBPSK FarmLoopbackHub at B = 16,
     exact, launching K6 and K2 and no K1; (d) wire 0's first 16 quanta
     of (a), as its demodulator got them, replayed through the plain
     versions on the CPU, the same bytes and frames quantum by quantum;
     (e) (a)'s drained bytes through the native deframer and the Python
     one (``force_python``), the same events as the hub's.  Any ERROR
     record of the port's loggers fails the phase;
 20. the soft and blind farm hubs (``runtime/soft_hub.py``): (c)
     ``soft_fsk.frames_synth_device_fn`` equal to ``encode_frames_batch``
     (torch.equal) at B = 4096 for 1, 46 and 133-byte payloads, both
     routes timed, and the host-side launches of one TX cohort and of its
     CRC; (a) SoftFarmHub at B = 4096 with farm_endurance --soft's
     settings (40-byte payloads, on-device AWGN 1e-4, quantum 4800, a
     22-quantum ring): a warm-up transfer, one round of 4096 XModem
     transfers each way, every payload exact, the quantum's wall (median
     / p99 over the quanta in which a window decodes or a cohort is
     written), the timers (host_tx / chunk / fetch_wait /
     soft_finalize), one K1, two K4 and two K3 launches per window
     decode, frames decoded and erased, peak device memory, and a
     torch.profiler capture of a third round's first 12 quanta (busy
     share); (e) wire 0's first 3 windows of side b (channel noise
     included) replayed through the plain versions on the CPU, the same
     packed bytes; (b) BlindSoftFarmHub (max_payload 160) the same way:
     one K1 per direction a quantum, one K5, K4 and K3 per program, the
     receivers' status (erasures reported); (d) FrameDecoder on the card
     and on the CPU over 8 coded frames with junk between them: every
     payload, K3 launched once per decode, the wall.  Any ERROR record of
     the port's loggers fails (a) and (b).

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
# the CRC kernel per bit: the constant masked in (sub, and, xor), the
# constant's step by x^-1 (and, sub, and, shift, xor), the byte's shift
# and or
CRC_OPS_PER_BIT = 10
CRC_PAYLOADS = (16, 45, 133)      # the frames cell's payload lengths
CRC_BATCH = 4096


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
    the f32 peak outside the tensor cores (the benchmark's published
    peaks, ``wam_bench/peaks.json``)."""
    from wam_bench.stats import peaks

    peak = peaks()
    t_bytes = n_bytes / peak["hbm_bytes_per_s"]
    t_ops = n_ops / peak["f32_ops_per_s"]
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
        st = [fsk_demod.init_state(params, B, device), 0]

        def step():
            st[0], _ = fsk_demod.demod_chunk(params, 0, st[0],
                                             chunks[st[1] % n])
            st[1] += 1
        for _ in range(3):
            step()
        ms = _cuda_ms(step, 25)
        print(f"  demod_chunk B={B} kernels: {ms:.3f} ms per 0.1 s "
              f"chunk, {B * AUDIO_S_PER_CHUNK / (ms / 1e3):,.0f} "
              f"realtime channels [{card}]")
        if B == MAIN_BATCH:
            try:
                _profile(f"hard demod_chunk B={B}",
                         lambda: [step() for _ in range(10)], 10, ms, card)
            except RuntimeError as exc:     # a measurement, not a check
                print(f"  profile: torch.profiler failed: {exc}")
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
            kernel_ms["fsk_framing"]["graph_ms"] = _graph_ms(
                lambda: fsk_framing.stage_d_compact(*dargs), 20)
            print(f"  fsk_framing K2 n_ds={n} B={B} in a CUDA graph (no "
                  f"host gaps): {kernel_ms['fsk_framing']['graph_ms']:.4f} "
                  f"ms a call [{card}]")
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
    from webaudio_modem_tpu_torch.ops.kernels import (align, crc16, fsk_seq,
                                                      sync_peak, viterbi)

    params = _soft_params()
    B = SOFT_BATCHES[0]
    payloads, noisy = _soft_batch(params, rng, B, device)
    fsk_seq.launches = align.launches = viterbi.launches = 0
    crc16.launches = sync_peak.launches = 0
    t0 = time.perf_counter()
    out = soft_fsk.decode_frames_batch(params, noisy, SOFT_PAYLOAD,
                                         device=device)
    seconds = time.perf_counter() - t0
    launches = {"fsk_seq": fsk_seq.launches, "align": align.launches,
                "viterbi": viterbi.launches, "crc16": crc16.launches,
                "sync_peak": sync_peak.launches}
    exact = sum(o == p for o, p in zip(out, payloads))
    print(f"  decode_frames_batch B={B}, {SOFT_PAYLOAD}-byte payloads at "
          f"{SOFT_SNR_DB:g} dB, T={noisy.shape[1]}: {exact}/{B} exact "
          f"({seconds:.3f} s host wall, first call); launches {launches}")
    if exact != B:
        raise RuntimeError(f"soft decode: only {exact}/{B} exact")
    if launches != {"fsk_seq": 1, "align": 2, "viterbi": 2, "crc16": 2,
                    "sync_peak": 1}:
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


def _is_span(ev):
    """A ``record_function`` span (the port's ``metrics`` timers open one
    while a profiler records): on the host its self time is the span's
    own Python, on the device its extent over what it launched.  Neither
    is an operator, kernel or copy, and torch's own tables leave them
    out."""
    return bool(getattr(ev, "is_user_annotation", False))


def _profile(label, run, calls, wall_ms, card):
    """torch.profiler over ``run()``, which makes ``calls`` calls: device
    time per call by kernel, and the device's busy share of ``wall_ms``,
    the unprofiled time per call (the profiler's own host cost would
    dilute it).  Returns the rows (device us, kernel name, launches),
    longest first; none where the profiler recorded no device time."""
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
    # row would count its kernels' time a second time, and so would a
    # span's extent on the device
    rows = sorted(((dev_us(e), e.key, e.count) for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA
                   and not _is_span(e) and dev_us(e) > 0), reverse=True)
    if not rows:
        print("  profile: the profiler recorded no device time")
        return rows
    total_ms = sum(r[0] for r in rows) / 1e3 / calls
    print(f"  profile {label}: device {total_ms:.3f} ms per call, busy "
          f"{100 * total_ms / wall_ms:.1f} % of the {wall_ms:.3f} ms "
          f"unprofiled time per call [{card}]")
    for us, key, count in rows[:12]:
        print(f"    {us / 1e3 / calls:8.4f} ms/call  {count // calls:4d} "
              f"launches  {key[:70]}")
    return rows


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


def _crc_bodies(rng, B, pl, device):
    """B frames' decoded body bits in K3's layout (a view of the first
    8 (pl + 2) steps of a [T, B] plane): random payloads with their CRC,
    one bit flipped in every third frame, every fifth frame not found.
    Returns (bodies, found, the payload rows [B, 8 pl] uint8)."""
    import numpy as np
    import torch

    from webaudio_modem_tpu_torch.ops.kernels import crc16

    pay = torch.from_numpy(rng.integers(0, 256, (B, pl), dtype=np.uint8))
    pbits = ((pay[:, :, None] >> torch.arange(7, -1, -1)) & 1).reshape(B, -1)
    crc = crc16.crc_rows_plain(pbits)
    tbits = (crc[:, None] >> torch.arange(15, -1, -1)) & 1
    bits = torch.cat([pbits, tbits], 1).to(torch.uint8)
    rows = torch.arange(B)
    flip = rows % 3 == 1
    cols = torch.from_numpy(rng.integers(0, bits.shape[1], B))
    bits[rows[flip], cols[flip]] ^= 1
    plane = torch.zeros((bits.shape[1] + 6, B), dtype=torch.uint8)
    plane[:bits.shape[1]] = bits.t()
    plane = plane.to(device)
    found = (rows % 5 != 2).to(device)
    return plane[:bits.shape[1]].t(), found, pbits.to(torch.uint8).to(device)


def phase_crc_vs_plain(device, rng, card):
    """The CRC kernel against its plain versions, bit for bit, at the
    frames cell's shapes, and timed: ``pack_bodies`` (one launch for the
    soft decode's whole body gate and packing) and ``crc_rows`` (the
    header select's CRC, the TX cohort's).  Returns (the largest
    difference, 0, or it raises; the timings)."""
    import torch

    from webaudio_modem_tpu_torch.ops.kernels import crc16

    B = CRC_BATCH
    timings, errs = {}, []
    for pl in CRC_PAYLOADS:
        bodies, found, pbits = _crc_bodies(rng, B, pl, device)
        n = bodies.shape[1]
        before = crc16.launches
        got = crc16.pack_bodies(bodies, found, pl)
        torch.cuda.synchronize()
        if crc16.launches != before + 1:
            raise RuntimeError("pack_bodies: not one launch")
        errs.append(_equal_or_raise(
            f"pack_bodies B={B} payload {pl}", got,
            crc16.pack_bodies_plain(bodies, found, pl)))
        ok = int(got[:, pl].sum())
        for label, rows in (("payload rows", pbits),
                            ("K3's layout", bodies[:, :8 * pl]),
                            ("a 3-bit tail", bodies[:, :8 * pl + 3]),
                            ("a 7-bit tail", bodies[:, :8 * pl + 7])):
            errs.append(_equal_or_raise(
                f"crc_rows {label} B={B} payload {pl}",
                crc16.crc_rows(rows), crc16.crc_rows_plain(rows)))
        print(f"  CRC kernel B={B} payload {pl}: pack_bodies and crc_rows "
              f"(payload rows, K3's layout, 3- and 7-bit tails) equal to "
              f"their plain versions; {ok} of {B} frames pass", flush=True)
        nbytes = n * B + B + (pl + 1) * B   # bits in, found, packed out
        t = timings[f"pack_{pl}"] = _timing(
            f"pack_bodies B={B} payload {pl} (bits [{B}, {n}] in K3's "
            "layout)",
            _cuda_ms(lambda: crc16.pack_bodies(bodies, found, pl), 50),
            _cuda_ms(lambda: crc16.pack_bodies_plain(bodies, found, pl), 3),
            nbytes, n * B * CRC_OPS_PER_BIT)
        t["graph_ms"] = _graph_ms(
            lambda: crc16.pack_bodies(bodies, found, pl), 50)
        del bodies, found, pbits
    heads = _crc_bodies(rng, 8 * B, 2, device)[0][:, :32]
    heads = heads.reshape(B, 8, 32)[..., :16]
    errs.append(_equal_or_raise(
        f"crc_rows header candidates {list(heads.shape)}",
        crc16.crc_rows(heads), crc16.crc_rows_plain(heads)))
    t = timings["rows_header"] = _timing(
        f"crc_rows header candidates {list(heads.shape)} (a view of K3's "
        "plane)",
        _cuda_ms(lambda: crc16.crc_rows(heads), 50),
        _cuda_ms(lambda: crc16.crc_rows_plain(heads), 3),
        heads.numel() + 4 * B * 8, heads.numel() * CRC_OPS_PER_BIT)
    t["graph_ms"] = _graph_ms(lambda: crc16.crc_rows(heads), 50)
    print("  crc_rows over the header candidates [B, 8, 16] read in place: "
          "equal to its plain version")
    for name, t in timings.items():
        _print_timing(f"crc16 {name}", t, card)
        print(f"    in a CUDA graph (no host gaps): {t['graph_ms']:.4f} ms "
              "a call")
    return max(errs), timings


def phase_sync_vs_plain(device, rng, card):
    """The sync-peak kernel against its plain version, bit for bit, at the
    frames cell's shapes: R from K1 over B = 4096 frames at 8 dB of each
    payload length, t_peak and the gate of both lanes equal to the plain
    version's, one launch each; timed enqueued and in a CUDA graph beside
    its byte bound (R read once, t_peak and the gate written) and the
    plain version (the band GEMM and its glue), no library call.
    Returns (the largest difference, 0, or it raises; the timings)."""
    import torch

    from webaudio_modem_tpu_torch.ops import fsk_demod, soft_fsk
    from webaudio_modem_tpu_torch.ops.kernels import fsk_seq, sync_peak

    params = _soft_params()
    ds = params.ds_samples_per_bit
    taps = len(params.pattern_bits) - 1
    B = CRC_BATCH
    timings, errs = {}, []
    for pl in CRC_PAYLOADS:
        sig = soft_fsk.encode_frames_batch(params, _messages(rng, B, pl),
                                           device=device)
        sigma = (float(sig.double().pow(2).mean())
                 / 10 ** (SOFT_SNR_DB / 10)) ** 0.5
        gen = torch.Generator(device=device).manual_seed(pl)
        x = sig + sigma * torch.randn(sig.shape, generator=gen,
                                      device=device)
        del sig
        state = fsk_demod.init_state(params, B, device)
        rsum = fsk_seq.seq(params, 0, state.front, state.ds_acc,
                           state.bit_tail[-ds:], x.t().contiguous(),
                           **CSUM_FLAGS)[5]
        del x, state
        n_ds = rsum.shape[0]
        want = sync_peak.sync_peak_plain(params, rsum)
        for lane, fast in (("fast", True), ("f32", False)):
            before = sync_peak.launches
            got = sync_peak._launch(params, rsum, fast=fast)
            torch.cuda.synchronize()
            if sync_peak.launches != before + 1:
                raise RuntimeError("sync_peak: not one launch")
            for name, g, w in zip(("t_peak", "peak_ok"), got, want):
                errs.append(_equal_or_raise(
                    f"sync_peak {lane} lane B={B} payload {pl} {name}", g, w))
        if not sync_peak._fast(params, rsum):
            raise RuntimeError("sync_peak: the cell's shape left the fast "
                               "lane")
        print(f"  sync_peak B={B} payload {pl} (R [{n_ds}, {B}]): t_peak and "
              f"the gate of both lanes equal to the plain version's; "
              f"{int(want[1].sum())} of {B} peaks over the gate", flush=True)
        t = timings[f"sync_{pl}"] = _timing(
            f"sync_peak B={B} payload {pl} (R [{n_ds}, {B}] bf16)",
            _cuda_ms(lambda: sync_peak.sync_peak(params, rsum), 50),
            _cuda_ms(lambda: sync_peak.sync_peak_plain(params, rsum), 5),
            rsum.numel() * 2 + 9 * B, n_ds * B * taps)
        t["graph_ms"] = _graph_ms(lambda: sync_peak.sync_peak(params, rsum),
                                  50)
        t["f32_graph_ms"] = _graph_ms(
            lambda: sync_peak._launch(params, rsum, fast=False), 20)
        del rsum, want, got
    for name, t in timings.items():
        _print_timing(name, t, card)
        print(f"    in a CUDA graph (no host gaps): {t['graph_ms']:.4f} ms "
              f"a call; the f32 lane {t['f32_graph_ms']:.4f} ms")
    return max(errs), timings


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
        st = [psk.init_state(params, B, device), 0]

        def step():
            st[0], _ = psk.demod_chunk(params, 0, st[0], chunks[st[1] % n])
            st[1] += 1
        for _ in range(3):
            step()
        ms = _cuda_ms(step, 25)
        channels = B * AUDIO_S_PER_CHUNK / (ms / 1e3)
        print(f"  DBPSK demod_chunk B={B} kernels: {ms:.3f} ms per 0.1 s "
              f"chunk, {channels:,.0f} realtime channels [{card}]")
        timings[f"demod_chunk_B{B}"] = {"ms": ms,
                                        "realtime_channels": channels}

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
    from webaudio_modem_tpu_torch.ops.kernels import (align, crc16, cumsum0,
                                                      fsk_seq, viterbi)

    return {"fsk_seq": fsk_seq, "cumsum0": cumsum0, "align": align,
            "viterbi": viterbi, "crc16": crc16}


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
                    "align": n_prog, "viterbi": n_prog, "crc16": n_prog}:
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
        if n != {"fsk_seq": 0, "cumsum0": 1, "align": 1, "viterbi": 1,
                 "crc16": 1}:
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
# K8 per step: the state machine's ~40 operations (as K2) and the four
# plane stores
K8_OPS_PER_STEP = 44


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
    f32 in (14 B), the byte value i32 and the three event bools out
    (7 B), per step and channel; the carry in and out and bit_fill."""
    return n_ds * B * 21 + B * (2 * (10 + 2) * 4 + 4)


def _k8_kernel_only(params, state, planes):
    """A call that launches K8's kernel alone on ``planes`` into outputs
    made once: no carry build, no allocation, no launch counted; to time
    the kernel beside its wrapper."""
    import ctypes

    import torch

    from webaudio_modem_tpu_torch.ops import fsk_demod
    from webaudio_modem_tpu_torch.ops.kernels import _build, fsk_framing

    bits = planes[0]
    n_ds, B = bits.shape
    ints, flts = fsk_demod._framing_carry(params, state)
    new = dict(device=bits.device)
    outs = [torch.empty((fsk_framing.N_I32, B), dtype=torch.int32, **new),
            torch.empty((fsk_framing.N_F32, B), dtype=torch.float32, **new),
            torch.empty((n_ds, B), dtype=torch.int32, **new),
            *torch.empty((3, n_ds, B), dtype=torch.bool, **new)]
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
    plain_ms = _cuda_ms(lambda: plain.append(fsk_framing.stage_d_plain(
        params, *fsk_demod._framing_carry(params, state), state.bit_fill,
        *planes)), 1)
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
    """Add K8's kernel alone (``kernel_only_ms``, enqueued) and its
    wrapper and kernel in a CUDA graph (``graph_ms``,
    ``kernel_only_graph_ms``) to a timing of its wrapper (``ms``: the
    carry, the allocations and the launch, enqueued one by one)."""
    from webaudio_modem_tpu_torch.ops import fsk_demod

    launch = _k8_kernel_only(params, state, planes)
    launch()
    timing["kernel_only_ms"] = _cuda_ms(launch, reps)
    timing["graph_ms"] = _graph_ms(
        lambda: fsk_demod.stage_d(params, state, *planes), reps)
    timing["kernel_only_graph_ms"] = _graph_ms(launch, reps)
    print(f"  fsk_stage_d K8 {timing['shape']}: wrapper {timing['ms']:.4f} "
          f"ms enqueued, {timing['graph_ms']:.4f} in a graph; kernel alone "
          f"{timing['kernel_only_ms']:.4f} enqueued, "
          f"{timing['kernel_only_graph_ms']:.4f} in a graph [{card}]")


# K2 / K8 edge cases on synthetic planes at the bench configuration:
# (label, B, n_ds, carry, bits plane one element past alignment, events
# the case must hold).  Carries: "random" puts every register in range
# at random (decisions, bytes, EODs and fires within a few steps),
# "wrap" sets the counter 1-5 steps below ``_wrap(params)`` with the gate
# open and every ratio above the threshold (each channel fires where the
# counter wraps to 0), "silent" sets sil at 2^24 - 3 over amplitudes of
# 0, "eod" makes eod_after 559.3 (its ceiling 560 is the kernels'
# integer threshold) and sil 1-5 below 560 over amplitudes of 0, so each
# channel's EOD lands on the step where sil reaches 560.  "last tile" is
# a fire in the partial last tile of K2_TILE steps.
FRAMING_EDGE_CASES = (
    ("B=1001", 1001, 2 * K2_TILE + 5, "random", True,
     ("bytes", "syncs", "EODs", "last tile")),
    ("B=1", 1, 2 * K2_TILE + 5, "random", True, ()),
    ("n_ds=0", 33, 0, "random", False, ()),
    ("n_ds=1", 33, 1, "random", True, ()),
    ("n_ds=17", 33, 17, "random", False, ("syncs", "EODs")),
    ("fire in a partial last tile", 64, 2 * K2_TILE + 5, "random", False,
     ("syncs", "last tile")),
    ("counter below its wrap", 33, 2 * K2_TILE + 3, "wrap", True,
     ("syncs",)),
    ("sil at 2^24 - 3, silent", 33, K2_TILE + 4, "silent", False,
     ("EODs",)),
    ("EOD after 559.3 steps", 33, K2_TILE + 4, "eod", True, ("EODs",)),
)


def _framing_case(case, device):
    """(params, (ints, flts, bit_fill, bits, amps, ratios, sub_amps)) of
    ``FRAMING_EDGE_CASES`` entry ``case`` (its label), from a generator
    seeded by the case's index, so that no other phase's data depend on
    the cases."""
    import dataclasses

    import numpy as np
    import torch

    from webaudio_modem_tpu_torch.models.config import FSKParams
    from webaudio_modem_tpu_torch.ops.kernels import fsk_framing

    index = next(i for i, c in enumerate(FRAMING_EDGE_CASES)
                 if c[0] == case)
    _, B, n, carry, odd_bits, _ = FRAMING_EDGE_CASES[index]
    rng = np.random.default_rng(100 + index)
    params = FSKParams.from_config(_bench_config())
    if carry == "eod":
        params = dataclasses.replace(params, samples_for_eod=559.3)
    ds, A = params.ds_samples_per_bit, params.amp_window
    W, wrap = params.sync_window, fsk_framing._wrap(params)
    eod = fsk_framing._eod_steps(params)

    def ri(lo, hi):
        return rng.integers(lo, hi, B)

    bsc = ri(0, 4 * ds)
    ints = np.stack([
        ri(0, 2), ri(0, wrap), ri(0, 2 * eod), ri(0, ds), ri(0, ds), bsc,
        bsc + ri(-3, n + 3), ri(0, 256), ri(0, params.stop_bit_position + 2),
        ri(0, A + 1)])
    flts = np.stack([rng.uniform(0.2, 0.8, B),
                     rng.uniform(0.0, A, B)])
    bit_fill = ri(W - n - 2, W + 2)
    bits = rng.integers(0, 2, (n, B))
    amps = rng.uniform(0.0, 1.0, (n, B))
    ratios = rng.uniform(0.7, 1.0, (n, B))
    if carry == "wrap":
        ints[:] = 0
        ints[1] = wrap - ri(1, 6)
        ints[9] = A
        flts = np.stack([np.full(B, 0.1), np.full(B, float(A))])
        bit_fill[:] = W
        amps[:] = 1.0
        ratios[:] = 0.95
    elif carry == "silent":
        ints[2] = 2 ** 24 - 3
        amps[:] = 0.0
    elif carry == "eod":
        ints[2] = eod - ri(1, 6)
        amps[:] = 0.0
    sub_amps = rng.uniform(0.0, 1.0, (n + 3, B))

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device)
    bits_t = f32(bits).to(torch.bfloat16)
    if odd_bits:
        flat = torch.zeros(n * B + 1, dtype=torch.bfloat16, device=device)
        flat[1:] = bits_t.reshape(-1)
        bits_t = flat[1:].view(n, B)
    return params, (
        torch.from_numpy(ints.astype(np.int32)).to(device), f32(flts),
        torch.from_numpy(bit_fill.astype(np.int32)).to(device), bits_t,
        f32(amps), f32(ratios), f32(sub_amps))


def _framing_check(params, args, label):
    """K2 and K8 on ``args`` (``_framing_case``'s) against their plain
    versions, every output exactly; compact(K8) against K2; two halves of
    K8 chained through the carry against one call.  Returns (the largest
    difference from plain, the events the plain planes hold: "bytes",
    "syncs", "EODs" and "last tile", a fire in the last, partial tile of
    K2_TILE steps)."""
    import torch

    from webaudio_modem_tpu_torch.ops import fsk_demod
    from webaudio_modem_tpu_torch.ops.kernels import fsk_framing

    ints, flts, bit_fill, bits, amps, ratios, sub = args
    n_ds = bits.shape[0]
    maxb = fsk_demod.max_bytes(params, n_ds)
    errs = []
    k2 = fsk_framing.stage_d_compact(params, *args, maxb)
    p2 = fsk_framing.stage_d_compact_plain(params, *args, maxb)
    for name, a, b in zip(("ints", "flts", "bytes_out", "byte_count",
                           "eod_fired", "sync_fired", "fire_t"), k2, p2):
        errs.append(_equal_or_raise(f"K2 edge {label} {name}", a, b))
    (ints8, flts8), k8 = fsk_framing.stage_d(params, *args)
    (p_ints, p_flts), p8 = fsk_framing.stage_d_plain(params, *args)
    names = ("byte_vals", "emits", "eods", "fires")
    for name, a, b in (("ints", ints8, p_ints), ("flts", flts8, p_flts),
                       *zip(names, k8, p8)):
        errs.append(_equal_or_raise(f"K8 edge {label} {name}", a, b))
    for name, a, b in (("ints", ints8, k2[0]), ("flts", flts8, k2[1]),
                       *zip(("bytes_out", "byte_count", "eod_fired",
                             "sync_fired", "fire_t"),
                            fsk_framing.compact(*k8, maxb), k2[2:])):
        _equal_or_raise(f"compact(K8) vs K2 edge {label} {name}", a, b)
    if n_ds > 1:
        h = n_ds // 2 + 1
        (ints1, flts1), first = fsk_framing.stage_d(
            params, ints, flts, bit_fill, bits[:h], amps[:h], ratios[:h],
            sub[:h])
        (ints2, flts2), second = fsk_framing.stage_d(
            params, ints1, flts1, bit_fill + h, bits[h:], amps[h:],
            ratios[h:], sub[h:])
        for name, a, b, w in zip(names, first, second, k8):
            _equal_or_raise(f"K8 edge {label} halves {name}",
                            torch.cat([a, b]), w)
        _equal_or_raise(f"K8 edge {label} halves ints", ints2, ints8)
        _equal_or_raise(f"K8 edge {label} halves flts", flts2, flts8)
    last = (n_ds - 1) // K2_TILE * K2_TILE
    events = {"bytes": int(p8[1].sum()), "syncs": int(p8[3].sum()),
              "EODs": int(p8[2].sum()),
              "last tile": int(p8[3][last:].sum()) if n_ds % K2_TILE else 0}
    return max(errs), events


def _framing_edges(device, errs):
    """K2 and K8 at every case of ``FRAMING_EDGE_CASES``; raises unless
    each case holds the events it names."""
    for case, B, n_ds, _, odd_bits, need in FRAMING_EDGE_CASES:
        params, args = _framing_case(case, device)
        assert (args[3].data_ptr() % 4 != 0) == (odd_bits and n_ds > 0)
        err, events = _framing_check(params, args, case)
        errs.append(err)
        missing = [k for k in need if not events[k]]
        if missing:
            raise RuntimeError(f"framing edge {case}: no {missing}")
        print(f"  K2 / K8 edge {case} (B={B}, n_ds={n_ds}"
              f"{', bits one element past alignment' if odd_bits else ''})"
              ": identical to plain, compact(K8) == K2, halves == whole; "
              + ", ".join(f"{k} {v}" for k, v in events.items()))


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
    out["bench_turns_graph_ms"] = [(label, _graph_ms(fn, 20))
                                   for label, fn in turns]
    for key, how in (("bench_turns_ms", "enqueued"),
                     ("bench_turns_graph_ms", "in a CUDA graph")):
        print(f"  n_ds={n} B={MAIN_BATCH}, K2 and K8 in turns, {how}: "
              + ", ".join(f"{label} {ms:.4f}" for label, ms in out[key])
              + f" ms [{card}]")
    out["bench"] = _timing(
        f"n_ds={n} B={MAIN_BATCH} (bench chunk, mean of the K8 turns)",
        sum(ms for label, ms in out["bench_turns_ms"] if label == "K8") / 2,
        bench_plain_ms, _k8_bytes(n, MAIN_BATCH),
        n * MAIN_BATCH * K8_OPS_PER_STEP)
    _print_timing("fsk_stage_d K8", out["bench"], card)
    _time_k8_kernel_only(out["bench"], params, state, planes, 20, card)
    # K8's wrapper is one launch (its counter) and nothing else: the
    # entry point's kernels (profiler) are the carry's (``_framing_carry``)
    # and K8's, no unpacking
    def launched(label, run):
        return {key: n for _, key, n in _profile(
            label, lambda: [run() for _ in range(5)], 5, out["bench"]["ms"],
            card)}
    before = fsk_framing.stage_d_launches
    entry = launched("fsk_demod.stage_d (K8) x 5",
                     lambda: fsk_demod.stage_d(params, state, *planes))
    if fsk_framing.stage_d_launches != before + 5:
        raise RuntimeError("fsk_demod.stage_d: not one K8 launch a call")
    carry = launched("fsk_demod._framing_carry x 5",
                     lambda: fsk_demod._framing_carry(params, state))
    beside = sorted(set(entry) - set(carry))
    if entry and (len(beside) != 1 or "fsk_framing_kernel" not in beside[0]):
        raise RuntimeError(f"fsk_demod.stage_d launched {beside} beside "
                           "the carry's kernels, not K8 alone")
    print("  K8's entry point: one K8 launch a call (counter); kernels "
          "beside the carry's: "
          f"{beside or 'none recorded by the profiler'}")

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
    _framing_edges(device, errs)
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


# ---------------------------------------------------------------------------
# Phase 18: BASELINE config 3, XModem over simulated audio at B = 1
# ---------------------------------------------------------------------------

XMODEM_QUANTUM = 512              # AudioGraph(quantum=512), as the suites
XMODEM_TIMEOUT_MS = 20000         # tests/runtime/conftest.py's harness
SOFT_TIMEOUT_MS = 60000           # tests/runtime/test_soft_integration.py's
AUDIO_QUANTUM_MS = XMODEM_QUANTUM / 48000 * 1e3
# the reference suites' transfers (tests/runtime/test_integration.py, the
# DBPSK one of tests/modems/test_psk.py, the hello of
# test_soft_integration.py): name, core, payload, channel, sender and
# receiver settings, and what each must show besides exact bytes
XMODEM_TRANSFERS = (
    dict(name="hello", data=b"Hello, World!", replay=True),
    dict(name="500_bytes",
         data=bytes((i * 7 + 13) & 0xFF for i in range(500)),
         progress=[1, 2, 3, 4]),
    dict(name="crc_tail", data=b"VECDRAIN-" * 40, no_retransmit=True),
    dict(name="80_bytes_payload_32", data=bytes(range(80)),
         sender={"max_payload_size": 32}),
    dict(name="noisy", data=b"noisy channel payload",
         channel=("awgn", 5e-4, 3)),
    dict(name="lossy", data=bytes(range(96)),
         channel=("dropout", 0.004, 11, 256),
         sender={"max_payload_size": 24, "max_retries": 8},
         receiver={"max_retries": 8}),
    # the same transfer with one loss placed inside fragment 1 (the 16th
    # quantum that carries a tone: the NAK takes ~4, the fragment ~26),
    # so it must recover by retransmission; at XModem's own default
    # timeout, 3 s, which the card's steps never come near
    dict(name="lossy_in_fragment_1", data=bytes(range(96)),
         channel=("drop_active", 16),
         sender={"max_payload_size": 24, "max_retries": 8,
                 "timeout_ms": 3000},
         receiver={"max_retries": 8, "timeout_ms": 3000},
         retransmit=True),
    dict(name="dbpsk", core="psk", data=b"PSK over XModem!"),
    dict(name="soft", core="soft", data=b"Hello, soft ARQ!"),
)
# the kernels each core's transfers must launch (K1 + K2, K6 + K2, K1 in
# its csum mode + K3)
XMODEM_KERNELS = {"fsk": ("fsk_seq", "fsk_framing"),
                  "psk": ("psk_seq", "fsk_framing"),
                  "soft": ("fsk_seq", "viterbi")}


def _kernel_modules():
    from webaudio_modem_tpu_torch.ops.kernels import (align, cumsum0,
                                                      fsk_framing, fsk_seq,
                                                      psk_seq, viterbi)

    return {"fsk_seq": fsk_seq, "fsk_framing": fsk_framing,
            "viterbi": viterbi, "align": align, "psk_seq": psk_seq,
            "cumsum0": cumsum0}


def _zero_all_launches():
    for mod in _kernel_modules().values():
        mod.launches = 0
    _kernel_modules()["fsk_framing"].stage_d_launches = 0


def _all_launches():
    out = {n: m.launches for n, m in _kernel_modules().items()}
    out["fsk_stage_d"] = _kernel_modules()["fsk_framing"].stage_d_launches
    return out


class _ErrorRecords:
    """A logging handler on the processor's logger: the processor logs a
    failed demodulation and goes on (as the JAX package's does), so a
    kernel that fails on the card would show only as a stalled transfer;
    every step checks this list and raises."""

    def __init__(self):
        import logging

        class Handler(logging.Handler):
            def emit(inner, record):
                self.records.append(inner.format(record))

        self.records = []
        self.handler = Handler(logging.ERROR)
        logging.getLogger("webaudio_modem_tpu_torch.processor").addHandler(
            self.handler)

    def close(self):
        import logging

        logging.getLogger(
            "webaudio_modem_tpu_torch.processor").removeHandler(self.handler)


def _xmodem_core(kind, device):
    """(core factory, config) of a transfer's modem core."""
    from webaudio_modem_tpu_torch.models.config import DEFAULT_FSK_CONFIG
    from webaudio_modem_tpu_torch.models.psk import (DEFAULT_PSK_CONFIG,
                                                     PSKCore)
    from webaudio_modem_tpu_torch.models.soft_modem import SoftModemCore

    if kind == "psk":
        return (lambda: PSKCore(device=device)), DEFAULT_PSK_CONFIG
    if kind == "soft":
        return (lambda: SoftModemCore(device=device)), DEFAULT_FSK_CONFIG
    return None, DEFAULT_FSK_CONFIG


def _xmodem_processor(name, kind, device):
    """A configured processor whose core has decoded one quantum of
    silence: the path's first use (library loads, the sync tables) is
    done before a wall-clock protocol timeout runs."""
    import numpy as np

    from webaudio_modem_tpu_torch.runtime import FSKProcessor

    factory, config = _xmodem_core(kind, device)
    proc = FSKProcessor(name=name, device=device,
                        core=None if factory is None else factory())
    proc.configure(config)
    proc.fsk_core.demodulate_data(np.zeros(XMODEM_QUANTUM, np.float32))
    return proc


def _xmodem_channel(spec):
    from webaudio_modem_tpu_torch.sim import (make_awgn_channel,
                                              make_dropout_channel)

    if spec is None:
        return None
    if spec[0] == "drop_active":
        return _drop_active_quantum(spec[1])
    if spec[0] == "awgn":
        return make_awgn_channel(noise_power=spec[1], seed=spec[2])
    return make_dropout_channel(drop_probability=spec[1], seed=spec[2],
                                block=spec[3])


def _drop_active_quantum(k):
    """A channel that zeroes the ``k``-th quantum carrying a tone (peak
    above 0.1), once."""
    import numpy as np

    seen = [0]

    def fn(x):
        x = np.array(x, np.float32, copy=True)
        if np.abs(x).max() > 0.1:
            seen[0] += 1
            if seen[0] == k:
                x[:] = 0.0
        return x

    return fn


class _RxRecorder:
    """Per quantum the receiver got: its input, the post-TX guard before
    it, and each (sample count, bytes) its core's ``demodulate_data``
    returned inside that ``process()``."""

    def __init__(self, proc):
        self.quanta = []
        process, demodulate = proc.process, proc.fsk_core.demodulate_data

        def recording_process(inputs, outputs):
            self.quanta.append((inputs.copy(), proc._rx_guard, []))
            return process(inputs, outputs)

        def recording_demodulate(samples):
            out = demodulate(samples)
            self.quanta[-1][2].append((len(samples), out))
            return out

        proc.process = recording_process
        proc.fsk_core.demodulate_data = recording_demodulate

    def calls(self):
        return [calls for _, _, calls in self.quanta]


def _core_state_devices(core):
    """The device types of a core's carried state tensors."""
    import dataclasses

    import torch

    state = getattr(core, "_state", None)
    if state is None:
        state = core._decoder._state
    return {getattr(state, f.name).device.type
            for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)}


async def _xmodem_drive(graph, sender, receiver, data, trap,
                        realtime=False, timeout_s=300):
    """Run one send_data / receive_data pair while the graph plays;
    returns (received, per-step ms, late quanta).  Each step is timed to
    the card's end of its work and checks the error records; a late
    quantum is one whose step finished after its audio deadline (only
    counted when ``realtime``)."""
    import asyncio

    import torch

    step = graph.step
    step_ms, late = [], [0]
    t_start = time.monotonic()

    def timed_step():
        t0 = time.perf_counter()
        mix = step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if realtime and time.monotonic() > t_start + \
                graph.steps * graph.quantum / graph.sample_rate:
            late[0] += 1
        if trap.records:
            raise RuntimeError(f"processor error: {trap.records[0]}")
        return mix

    graph.step = timed_step
    t_start = time.monotonic()
    drive = asyncio.ensure_future(graph.run(realtime=realtime))
    send = asyncio.ensure_future(sender.send_data(data))
    recv = asyncio.ensure_future(receiver.receive_data())
    try:
        done, _ = await asyncio.wait({drive, recv}, timeout=timeout_s,
                                     return_when=asyncio.FIRST_COMPLETED)
        if drive in done:
            drive.result()
            raise RuntimeError("the audio graph stopped mid-transfer")
        if recv not in done:
            raise TimeoutError(f"no transfer within {timeout_s} s")
        recv.result()                   # the receiver's error raises here
        await asyncio.wait_for(send, 60)
        graph.stop()
        await drive                     # a failed last step raises here
        return recv.result(), step_ms, late[0]
    finally:
        graph.stop()
        for task in (drive, send, recv):
            if not task.done():
                task.cancel()


def _xmodem_transfer(spec, device, trap, realtime=False):
    """One transfer of ``XMODEM_TRANSFERS`` on a fresh stack: two
    processors on one AudioGraph(quantum=512), each with an
    XModemTransport; launches counted from 0 over the transfer."""
    import asyncio

    import torch

    from webaudio_modem_tpu_torch.runtime import AudioGraph
    from webaudio_modem_tpu_torch.transports.xmodem import XModemTransport

    kind = spec.get("core", "fsk")
    procs = [_xmodem_processor(n, kind, device)
             for n in ("sender", "receiver")]
    graph = AudioGraph(quantum=XMODEM_QUANTUM,
                       channel_fn=_xmodem_channel(spec.get("channel")))
    sender, receiver = (XModemTransport(p) for p in procs)
    timeout_ms = SOFT_TIMEOUT_MS if kind == "soft" else XMODEM_TIMEOUT_MS
    for t, extra in ((sender, spec.get("sender")),
                     (receiver, spec.get("receiver"))):
        graph.connect(t.data_channel)
        t.configure({"timeout_ms": timeout_ms, "max_retries": 3,
                     **(extra or {})})
    progress = []
    receiver.on("fragmentReceived",
                lambda ev: progress.append(ev.data["seq_num"]))
    recorder = (_RxRecorder(procs[1]) if spec.get("replay") and not realtime
                else None)

    torch.cuda.synchronize()
    _zero_all_launches()
    t0 = time.perf_counter()
    received, step_ms, late = asyncio.run(_xmodem_drive(
        graph, sender, receiver, spec["data"], trap, realtime=realtime))
    wall_s = time.perf_counter() - t0
    launches = _all_launches()

    name = spec["name"] + (" (realtime)" if realtime else "")
    stats = sender.get_statistics()
    if received != spec["data"]:
        raise RuntimeError(f"xmodem {name}: received {received[:40]!r}...")
    if stats.bytes_transferred != len(spec["data"]):
        raise RuntimeError(f"xmodem {name}: {stats}")
    if "progress" in spec and progress != spec["progress"]:
        raise RuntimeError(f"xmodem {name}: fragments {progress}")
    if spec.get("no_retransmit") and stats.packets_retransmitted:
        raise RuntimeError(f"xmodem {name}: {stats.packets_retransmitted} "
                           "retransmissions")
    if spec.get("retransmit") and not stats.packets_retransmitted:
        raise RuntimeError(f"xmodem {name}: no retransmission")
    missing = [k for k in XMODEM_KERNELS[kind] if not launches[k]]
    if missing:
        raise RuntimeError(f"xmodem {name}: no launch of {missing}")
    devices = set().union(*(_core_state_devices(p.fsk_core) for p in procs))
    if devices != {device.type}:
        raise RuntimeError(f"xmodem {name}: core state on {devices}")
    ms = sorted(step_ms)
    out = {"transfer": name, "core": kind, "bytes": len(spec["data"]),
           "steps": graph.steps,
           "audio_s": graph.steps * XMODEM_QUANTUM / 48000,
           "wall_s": wall_s, "step_median_ms": ms[len(ms) // 2],
           "step_p99_ms": ms[min(len(ms) - 1, int(0.99 * len(ms)))],
           "step_max_ms": ms[-1], "late_quanta": late if realtime else None,
           "packets_sent": stats.packets_sent,
           "retransmitted": stats.packets_retransmitted,
           "receiver_dropped": receiver.get_statistics().packets_dropped,
           "fragments": progress, "launches": launches}
    return out, recorder


def _replay_on_cpu(recorder):
    """The receiver's quanta of the hello transfer through an FSKProcessor
    on the CPU (the plain versions), each with the post-TX guard the card
    run had before it: the same (sample count, bytes) per core call."""
    import torch

    replay = _xmodem_processor("replay", "fsk", torch.device("cpu"))
    got = _RxRecorder(replay)
    for inputs, guard, _ in recorder.quanta:
        replay._rx_guard = guard
        replay.process(inputs, None)
    want = recorder.calls()
    for i, (a, b) in enumerate(zip(got.calls(), want)):
        if a != b:
            raise RuntimeError(f"quantum {i}: plain {a} != kernels {b}")
    if len(got.calls()) != len(want):
        raise RuntimeError("replay length differs")
    return len(want), sum(len(out) for calls in want for _, out in calls)


def _xmodem_step_profile(device, trap, card, step_wall_ms):
    """torch.profiler over one more hello transfer: per graph step (both
    processors), the device's kernels, copies to the host and busy time
    against ``step_wall_ms``, the unprofiled median step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out, _ = _xmodem_transfer(XMODEM_TRANSFERS[0], device, trap)
    steps = out["steps"]
    dev = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == DeviceType.CUDA
           and not _is_span(e)]

    def us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if getattr(e, attr, None) is not None:
                return getattr(e, attr)
        return 0.0

    copies = [e for e in dev if "Memcpy" in e.key or "Memset" in e.key]
    kernels = [e for e in dev if e not in copies]
    dtoh = sum(e.count for e in copies if "DtoH" in e.key)
    busy_ms = sum(us(e) for e in dev) / 1e3 / steps
    res = {"steps": steps,
           "kernels_per_step": sum(e.count for e in kernels) / steps,
           "copies_to_host_per_step": dtoh / steps,
           "device_ms_per_step": busy_ms,
           "busy_share": busy_ms / step_wall_ms,
           "top": [(e.key[:60], us(e) / 1e3 / steps, e.count / steps)
                   for e in sorted(dev, key=us, reverse=True)[:6]]}
    print(f"  profile of a hello transfer, per graph step (two processors, "
          f"{steps} steps): {res['kernels_per_step']:.1f} kernels, "
          f"{res['copies_to_host_per_step']:.1f} copies to the host, "
          f"{busy_ms:.4f} ms of device time: busy "
          f"{100 * res['busy_share']:.1f} % of the {step_wall_ms:.3f} ms "
          f"median step [{card}]")
    for key, ms, n in res["top"]:
        print(f"    {ms:8.4f} ms/step  {n:6.2f} per step  {key}")
    return res


def phase_xmodem_audio(device, card):
    """BASELINE config 3: XModem end to end over simulated audio through
    the port's processor and audio graph at B = 1 (the reference suites'
    transfers); the hello transfer again with the graph paced at the
    audio clock; the hello's receiver quanta replayed through the plain
    versions on the CPU.  Returns the launches summed over the
    transfers and the per-transfer results."""
    trap = _ErrorRecords()
    results, total = [], {}
    t_phase = time.perf_counter()
    try:
        runs = [(spec, False) for spec in XMODEM_TRANSFERS]
        runs.append((XMODEM_TRANSFERS[0], True))
        for spec, realtime in runs:
            out, recorder = _xmodem_transfer(spec, device, trap,
                                             realtime=realtime)
            results.append(out)
            for k, v in out["launches"].items():
                total[k] = total.get(k, 0) + v
            late = ("" if not realtime else
                    f", {out['late_quanta']} of {out['steps']} quanta "
                    "finished after their deadline")
            print(f"  {out['transfer']} ({out['core']}, {out['bytes']} B): "
                  f"exact; {out['audio_s']:.3f} s of audio in "
                  f"{out['wall_s']:.3f} s wall, {out['steps']} steps; step "
                  f"median {out['step_median_ms']:.3f} ms, p99 "
                  f"{out['step_p99_ms']:.3f} ms, max "
                  f"{out['step_max_ms']:.3f} ms against "
                  f"{AUDIO_QUANTUM_MS:.2f} ms of audio{late}; sent "
                  f"{out['packets_sent']}, retransmitted "
                  f"{out['retransmitted']}, receiver dropped "
                  f"{out['receiver_dropped']}, fragments {out['fragments']}"
                  f"; launches {out['launches']} [{card}]")
            if recorder is not None:
                t0 = time.perf_counter()
                n, n_bytes = _replay_on_cpu(recorder)
                print(f"  {spec['name']}: the receiver's {n} quanta replayed "
                      f"through the plain versions on the CPU decode the "
                      f"same {n_bytes} bytes call by call "
                      f"({time.perf_counter() - t0:.1f} s)")
        results.append({"hello_step_profile": _xmodem_step_profile(
            device, trap, card, results[0]["step_median_ms"])})
    finally:
        trap.close()
    if trap.records:
        raise RuntimeError(f"processor errors: {trap.records[:3]}")
    print(f"  phase 18: {time.perf_counter() - t_phase:.1f} s, launches "
          f"{total} [{card}]")
    return total, results


# ---------------------------------------------------------------------------
# Phase 19: the farm hubs
# ---------------------------------------------------------------------------

HUB_BATCH = 4096                  # examples/farm_endurance.py's defaults
HUB_PAYLOAD = 40
HUB_NOISE = 1e-4
HUB_QUANTUM = 4800
HUB_RING_QUANTA = 16
# XModem's timeout in the measured rounds: four times the longest
# protocol wait seen at B = 4096 (~10 quanta of up to ~250 ms while 4096
# sessions handle their events; a 3 s timeout fired spuriously there),
# and a third of farm_endurance's 30 s: the hub runs ~20 x faster than
# real time between events, so each lost packet's resend idles the
# whole timeout in wall time
HUB_TIMEOUT_MS = 10000
LOOPBACK_BATCH = 256              # the host-playout milestone
PSK_HUB_BATCH = 16
REPLAY_QUANTA = 16                # wire 0's first quanta, replayed on the CPU
PROFILE_QUANTA = 6                # quanta of the third round under the profiler
HUB_TIMERS = ("farm_hub.host_tx", "farm_hub.chunk", "farm_hub.fetch_wait",
              "farm_hub.host_drain", "farm_hub.yield_pump")


class _HubTrap:
    """A logging handler on the port's loggers (the hub, XModem): any
    ERROR record fails the phase."""

    def __init__(self):
        import logging

        class Handler(logging.Handler):
            def emit(inner, record):
                self.records.append(inner.format(record))

        self.records = []
        self.handler = Handler(logging.ERROR)
        logging.getLogger("webaudio_modem_tpu_torch").addHandler(self.handler)

    def close(self):
        import logging

        logging.getLogger("webaudio_modem_tpu_torch").removeHandler(
            self.handler)
        if self.records:
            raise RuntimeError(f"hub errors: {self.records[:3]}")


class _HubRecorder:
    """Spies on a hub: the host wall of every ``step()``, the period
    between step starts and whether the step was busy (a transmission
    queued or playing, as ``run()`` decides idleness); for side b, per
    quantum the bytes drained and the deframer's events (``quanta``:
    [counts, bytes, events]) and, in order with them, the resets of its
    channels (``log``: ("drain", quantum) / ("reset", channel)); the
    frames wire ``wire`` handed its demodulator over the first ``keep``
    quanta (copied on the device, no sync).  ``activity``: a counter the
    step is busy for when it moves (default: a transmission queued or
    playing before the step)."""

    def __init__(self, hub, wire=0, keep=0, activity=None):
        import torch

        self.step_ms, self.period_ms, self.busy = [], [], []
        self.quanta, self.log = [], []
        self.frames = (torch.empty((keep, hub.quantum), dtype=torch.float32,
                                   device=hub.device) if keep else None)
        self.n_frames = 0
        self._last = None
        self._waiters = []
        step, drain = hub.step, hub._drain
        dfr = hub._deframers["b"]
        dfr_drain, dfr_reset = dfr.drain, dfr.reset

        def timed_step():
            t0 = time.perf_counter()
            if self._last is not None:
                self.period_ms.append((t0 - self._last) * 1e3)
            self._last = t0
            if activity is None:
                self.busy.append(hub._tx_active())
            else:
                a0 = activity()
            step()
            if activity is not None:
                self.busy.append(activity() != a0)
            self.step_ms.append((time.perf_counter() - t0) * 1e3)
            for w in [w for w in self._waiters if w[0] <= hub.steps]:
                self._waiters.remove(w)
                if not w[1].done():
                    w[1].set_result(None)

        def spy_drain(rx_side, pending):
            if rx_side == "b":
                counts, vals = pending.ready()
                self.log.append(("drain", len(self.quanta)))
                self.quanta.append([counts.copy(), vals.copy()
                                    if counts.any() else None, []])
            drain(rx_side, pending)

        def spy_reset(channel):
            self.log.append(("reset", channel))
            dfr_reset(channel)

        def spy_deframer(vals, counts):
            ev = dfr_drain(vals, counts)
            self.quanta[-1][2] = ev
            return ev

        hub.step, hub._drain = timed_step, spy_drain
        dfr.drain, dfr.reset = spy_deframer, spy_reset
        if keep and hasattr(hub, "_inner"):
            inner = hub._inner

            def spy_inner(state, frame):
                if state is hub._states["b"] and self.n_frames < keep:
                    self.frames[self.n_frames].copy_(frame[wire])
                    self.n_frames += 1
                return inner(state, frame)

            hub._inner = spy_inner

    def reset_timing(self):
        self.step_ms, self.period_ms, self.busy = [], [], []
        self._last = None

    def stats(self):
        """Median / p99 of the quantum's period over the busy steps and
        over all, and of ``step()`` alone over the busy steps."""
        busy_p = [p for p, b in zip(self.period_ms, self.busy[:-1]) if b]
        busy_s = [t for t, b in zip(self.step_ms, self.busy) if b]
        return {"busy_steps": sum(self.busy), "steps": len(self.busy),
                "max_period_ms": max(self.period_ms, default=float("nan")),
                "period_median_ms": _pct(busy_p, 0.5),
                "period_p99_ms": _pct(busy_p, 0.99),
                "all_period_median_ms": _pct(self.period_ms, 0.5),
                "all_period_p99_ms": _pct(self.period_ms, 0.99),
                "step_median_ms": _pct(busy_s, 0.5),
                "step_p99_ms": _pct(busy_s, 0.99)}

    def after_steps(self, hub, n):
        """A future resolved once ``n`` more hub steps have run."""
        import asyncio

        fut = asyncio.get_running_loop().create_future()
        self._waiters.append((hub.steps + n, fut))
        return fut


async def _hub_round(hub, senders, receivers, payloads):
    """One round: every receiver's ``receive_data`` and every sender's
    ``send_data`` concurrently; returns the received payloads."""
    import asyncio

    recv = [asyncio.ensure_future(r.receive_data()) for r in receivers]
    await asyncio.sleep(0)
    await asyncio.gather(*(s.send_data(p)
                           for s, p in zip(senders, payloads)))
    return await asyncio.gather(*recv)


def _pct(values, q):
    v = sorted(values)
    return v[min(len(v) - 1, int(q * len(v)))] if v else float("nan")


def _timer_deltas(before, names=HUB_TIMERS):
    from webaudio_modem_tpu_torch.utils.trace import metrics

    now = metrics.snapshot()["timings"]
    out = {}
    for name in names:
        a, b = before.get(name), now.get(name)
        if b is None:
            continue
        n = b["count"] - (a["count"] if a else 0)
        tot = b["total_s"] - (a["total_s"] if a else 0.0)
        out[name] = {"count": n, "mean_ms": tot * 1e3 / max(n, 1)}
    return out


def _hub_profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _hub_profile(prof, steps, step_wall_ms):
    """From a torch.profiler capture of ``steps`` hub steps: per step
    (both directions) the device's kernels, copies and busy time,
    against ``step_wall_ms``, the unprofiled median period of a step."""
    from torch.autograd import DeviceType

    dev = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == DeviceType.CUDA
           and not _is_span(e)]

    def us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if getattr(e, attr, None) is not None:
                return getattr(e, attr)
        return 0.0

    copies = [e for e in dev if "Memcpy" in e.key or "Memset" in e.key]
    busy_ms = sum(us(e) for e in dev) / 1e3 / steps
    return {"steps": steps,
            "kernels_per_step": sum(e.count for e in dev
                                    if e not in copies) / steps,
            "copies_per_step": sum(e.count for e in copies) / steps,
            "device_ms_per_step": busy_ms,
            "busy_share": busy_ms / step_wall_ms,
            "top": [(e.key[:60], us(e) / 1e3 / steps, e.count / steps)
                    for e in sorted(dev, key=us, reverse=True)[:6]]}


def _replay_wire(rec, params, wire=0):
    """Wire ``wire``'s first recorded quanta (side b, the frames its
    demodulator was handed, channel noise included) through the plain
    versions on the CPU: the bytes per quantum and the deframer's events
    (the port's Python parser) must equal what the hub drained."""
    import numpy as np
    import torch

    from webaudio_modem_tpu_torch.native.deframer import Deframer
    from webaudio_modem_tpu_torch.ops import fsk_demod

    frames = rec.frames[:rec.n_frames].cpu()
    state = fsk_demod.init_state(params, 1, "cpu")
    dfr = Deframer(1, force_python=True)
    n_bytes = 0
    for k in range(rec.n_frames):
        state, out = fsk_demod.demod_chunk(params, 0, state, frames[k][None])
        got = bytes(out.bytes_out[0, :int(out.byte_count[0])].numpy())
        counts, vals, events = rec.quanta[k]
        want = b"" if vals is None else bytes(vals[wire, :counts[wire]])
        if got != want:
            raise RuntimeError(f"replay quantum {k}: plain {got!r} != "
                               f"kernels {want!r}")
        ev = dfr.drain(np.frombuffer(got, np.uint8)[None].copy()
                       if got else np.zeros((1, 1), np.uint8),
                       np.asarray([len(got)], np.int32))
        hub_ev = [f for ch, f in events if ch == wire]
        if [f for _, f in ev] != hub_ev:
            raise RuntimeError(f"replay quantum {k}: frames {ev} != "
                               f"{hub_ev}")
        n_bytes += len(got)
    return rec.n_frames, n_bytes


def _deframer_check(rec, batch):
    """Every drained quantum of side b, with the channel resets between
    them, through a native deframer and a ``force_python`` one: the same
    events, and the hub's own."""
    from webaudio_modem_tpu_torch.native.deframer import Deframer

    native, plain = Deframer(batch), Deframer(batch, force_python=True)
    n_events = 0
    for op, k in rec.log:
        if op == "reset":       # XModem flushed a channel after an error
            native.reset(k)
            plain.reset(k)
            continue
        counts, vals, hub_ev = rec.quanta[k]
        if not counts.any():    # the hub does not drain an empty quantum
            continue
        a = native.drain(vals, counts)
        b = plain.drain(vals, counts)
        if a != b or a != hub_ev:
            raise RuntimeError(f"quantum {k}: native deframer {a[:3]} != "
                               f"force_python {b[:3]} or the hub's "
                               f"{hub_ev[:3]}")
        n_events += len(a)
    return len(rec.quanta), n_events


def _print_round(r, B, card):
    """Print one round of (a) and check its launches."""
    want = {"fsk_seq": 2 * r["steps"], "fsk_framing": 2 * r["steps"]}
    got = {k: v for k, v in r["launches"].items() if v}
    if got != want:
        raise RuntimeError(f"hub launches {got} != {want} "
                           "(one K1 and one K2 per direction a step)")
    tm = r["timers"]
    print(f"  DeviceFarmHub B={B} round {r['direction']}: {B} payloads "
          f"exact, {r['retransmitted']} retransmissions; "
          f"{r['audio_s']:.1f} s of audio in {r['wall_s']:.3f} s "
          f"wall, {r['steps']} quanta ({r['busy_steps']} busy); per busy "
          f"quantum (both directions) median {r['period_median_ms']:.2f} "
          f"ms, p99 {r['period_p99_ms']:.2f} ms against 100 ms (all "
          f"quanta {r['all_period_median_ms']:.2f} / "
          f"{r['all_period_p99_ms']:.2f}, max {r['max_period_ms']:.2f}; "
          f"step() alone "
          f"{r['step_median_ms']:.2f} / {r['step_p99_ms']:.2f}); "
          "timers per call: " + ", ".join(
              f"{k.split('.')[1]} {v['mean_ms']:.2f} ms x {v['count']}"
              for k, v in tm.items())
          + f"; K1 {r['k1_per_quantum']:.2f} and K2 "
          f"{r['k2_per_quantum']:.2f} launches a quantum [{card}]",
          flush=True)


def _device_hub_run(device, card):
    """(a) DeviceFarmHub at B = 4096: warm-up, then one round each way."""
    import asyncio

    import torch

    from webaudio_modem_tpu_torch.examples.farm_endurance import \
        round_payloads
    from webaudio_modem_tpu_torch.models.config import (DEFAULT_FSK_CONFIG,
                                                        FSKParams)
    from webaudio_modem_tpu_torch.runtime.device_hub import DeviceFarmHub
    from webaudio_modem_tpu_torch.sim import make_device_awgn
    from webaudio_modem_tpu_torch.transports.xmodem import XModemTransport
    from webaudio_modem_tpu_torch.utils.trace import metrics

    B = HUB_BATCH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hub = DeviceFarmHub(DEFAULT_FSK_CONFIG, B, quantum=HUB_QUANTUM,
                        ring_quanta=HUB_RING_QUANTA,
                        device_channel_fn=make_device_awgn(HUB_NOISE),
                        device=device)
    rec = _HubRecorder(hub, wire=0, keep=REPLAY_QUANTA)
    ta = [XModemTransport(hub.channel("a", i)) for i in range(B)]
    tb = [XModemTransport(hub.channel("b", i)) for i in range(B)]
    out = {"batch": B}

    async def drive():
        pump = asyncio.ensure_future(hub.run())
        try:
            for t in (ta[0], tb[0]):
                t.configure({"timeout_ms": 600000})
            got = await _hub_round(hub, [ta[0]], [tb[0]],
                                   [bytes(HUB_PAYLOAD)])
            if got != [bytes(HUB_PAYLOAD)]:
                raise RuntimeError("hub warm-up transfer failed")
            out["warmup_steps"] = hub.steps
            print(f"  warm-up transfer on wire 0: {hub.steps} quanta, step "
                  f"median {_pct(rec.step_ms, 0.5):.2f} ms", flush=True)
            for t in ta + tb:
                t.configure({"timeout_ms": HUB_TIMEOUT_MS})
            rounds = []
            for rnd, (snd, rcv) in enumerate(((ta, tb), (tb, ta))):
                payloads = round_payloads(rnd, B, HUB_PAYLOAD)
                rec.reset_timing()
                before = metrics.snapshot()["timings"]
                _zero_all_launches()
                retx0 = sum(t.get_statistics().packets_retransmitted
                            for t in snd)
                steps0, t0 = hub.steps, time.perf_counter()
                got = await _hub_round(hub, snd, rcv, payloads)
                wall = time.perf_counter() - t0
                launches = _all_launches()
                steps = hub.steps - steps0
                bad = sum(g != p for g, p in zip(got, payloads))
                if bad:
                    raise RuntimeError(f"round {rnd}: {bad} payloads wrong")
                window = rec.period_ms[:PROFILE_QUANTA]
                rounds.append({
                    **rec.stats(),
                    # the quanta the profiled round captures, unprofiled
                    "window_ms": sum(window) / max(len(window), 1),
                    "direction": "a->b" if rnd == 0 else "b->a",
                    "steps": steps, "audio_s": steps * HUB_QUANTUM / 48000,
                    "wall_s": wall, "launches": launches,
                    "k1_per_quantum": launches["fsk_seq"] / steps,
                    "k2_per_quantum": launches["fsk_framing"] / steps,
                    "retransmitted": sum(
                        t.get_statistics().packets_retransmitted
                        for t in snd) - retx0,
                    "timers": _timer_deltas(before)})
                _print_round(rounds[-1], B, card)
            out["rounds"] = rounds
            # one more round a->b, its first PROFILE_QUANTA quanta under
            # torch.profiler, in the same event loop: the channels' queues
            # keep the loop they first waited on (the reference's
            # _LeanQueue, copied; ROADMAP queue 3).  The profiler starts
            # before any session waits (its start held the loop for
            # seconds, past the timeouts of every waiting session)
            out["retransmitted"] = sum(
                t.get_statistics().packets_retransmitted for t in ta + tb)
            payloads = round_payloads(2, B, HUB_PAYLOAD)
            prof = _hub_profiler()
            t0 = time.perf_counter()
            prof.start()
            start_s = time.perf_counter() - t0
            task = asyncio.ensure_future(_hub_round(hub, ta, tb, payloads))
            t0 = time.perf_counter()
            await rec.after_steps(hub, PROFILE_QUANTA)
            wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_QUANTA
            t0 = time.perf_counter()
            prof.stop()
            stop_s = time.perf_counter() - t0
            if await task != payloads:
                raise RuntimeError("profiled round: payloads wrong")
            out["profiled_round_retransmitted"] = sum(
                t.get_statistics().packets_retransmitted
                for t in ta + tb) - out["retransmitted"]
            out["profile"] = _hub_profile(
                prof, PROFILE_QUANTA, rounds[0]["window_ms"])
            out["profile"].update(profiled_quantum_wall_ms=wall_ms,
                                  start_s=start_s, stop_s=stop_s)
        finally:
            hub.stop()
            await pump

    asyncio.run(drive())
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f"  retransmissions {out['retransmitted']} in the warm-up and "
          f"the two rounds, {out['profiled_round_retransmitted']} in the "
          f"profiled round; peak device memory "
          f"{out['peak_mib']:.1f} MiB, warm-up {out['warmup_steps']} quanta")

    prof = out["profile"]
    print(f"  profile of {prof['steps']} quanta of a round, per quantum "
          f"(both directions; {prof['profiled_quantum_wall_ms']:.2f} ms "
          f"of wall each under the profiler): "
          f"{prof['kernels_per_step']:.1f} "
          f"kernels, {prof['copies_per_step']:.1f} copies, "
          f"{prof['device_ms_per_step']:.4f} ms of device time: busy "
          f"{100 * prof['busy_share']:.1f} % of the same quanta of round "
          f"a->b unprofiled ({out['rounds'][0]['window_ms']:.2f} ms each), "
          f"{100 * prof['device_ms_per_step'] / prof['profiled_quantum_wall_ms']:.1f}"
          f" % of the profiled quanta's wall; the profiler's start "
          f"{prof['start_s']:.2f} s, stop {prof['stop_s']:.2f} s "
          f"[{card}]")
    for key, ms, n in prof["top"]:
        print(f"    {ms:8.4f} ms/quantum  {n:6.2f} per quantum  {key}")
    t0 = time.perf_counter()
    n_q, n_bytes = _replay_wire(rec, FSKParams.from_config(
        DEFAULT_FSK_CONFIG))
    out["replay"] = {"quanta": n_q, "bytes": n_bytes,
                     "seconds": time.perf_counter() - t0}
    print(f"  (d) wire 0's first {n_q} quanta replayed through the plain "
          f"versions on the CPU: the same {n_bytes} bytes and frames "
          f"quantum by quantum ({out['replay']['seconds']:.1f} s)")
    t0 = time.perf_counter()
    n_drains, n_events = _deframer_check(rec, B)
    out["deframer"] = {"drains": n_drains, "events": n_events,
                       "seconds": time.perf_counter() - t0}
    print(f"  (e) native deframer == force_python deframer == the hub's "
          f"events over {n_drains} drained quanta of side b, {n_events} "
          f"events ({out['deframer']['seconds']:.1f} s)")
    return out


def _loopback_hub_run(device, card, config, batch, label, kernels):
    """(b) / (c): one round a->b over a FarmLoopbackHub on the card."""
    import asyncio

    from webaudio_modem_tpu_torch.runtime.farm_channel import FarmLoopbackHub
    from webaudio_modem_tpu_torch.transports.xmodem import XModemTransport

    hub = FarmLoopbackHub(config, batch, device=device)
    ta = [XModemTransport(hub.channel("a", i)) for i in range(batch)]
    tb = [XModemTransport(hub.channel("b", i)) for i in range(batch)]
    for t in ta + tb:
        t.configure({"timeout_ms": HUB_TIMEOUT_MS})
    payloads = [bytes([i & 0xFF]) + f"{label} {i:04d} ".encode()
                + bytes((i + j) & 0xFF for j in range(24))
                for i in range(batch)]

    async def drive():
        pump = asyncio.ensure_future(hub.run())
        try:
            return await _hub_round(hub, ta, tb, payloads)
        finally:
            hub.stop()
            await pump

    _zero_all_launches()
    t0 = time.perf_counter()
    got = asyncio.run(drive())
    wall = time.perf_counter() - t0
    launches = _all_launches()
    if got != payloads:
        raise RuntimeError(f"{label}: {sum(g != p for g, p in zip(got, payloads))}"
                           " payloads wrong")
    want = {k: 2 * hub.steps for k in kernels}
    if {k: v for k, v in launches.items() if v} != want:
        raise RuntimeError(f"{label} launches {launches} != {want}")
    retx = sum(t.get_statistics().packets_retransmitted for t in ta)
    out = {"batch": batch, "steps": hub.steps,
           "audio_s": hub.steps * hub.quantum / 48000, "wall_s": wall,
           "launches": launches, "retransmitted": retx}
    print(f"  {label} B={batch}: {batch} payloads exact; "
          f"{out['audio_s']:.1f} s of audio in {wall:.3f} s wall, "
          f"{hub.steps} quanta, {retx} retransmissions; launches "
          f"{ {k: v for k, v in launches.items() if v} } [{card}]")
    return out


def phase_farm_hubs(device, card):
    """(a) DeviceFarmHub at B = 4096, farm_endurance's settings, one round
    each way, measured; (b) FarmLoopbackHub at B = 256; (c) a DBPSK
    FarmLoopbackHub (K6 + K2, no K1); (d) wire 0's first quanta of (a)
    replayed on the CPU; (e) the native deframer against the Python one
    on (a)'s drained bytes.  Returns the launches by path and the
    results."""
    from webaudio_modem_tpu_torch.models.config import DEFAULT_FSK_CONFIG
    from webaudio_modem_tpu_torch.models.psk import PSKConfig

    trap = _HubTrap()
    t_phase = time.perf_counter()
    try:
        dev = _device_hub_run(device, card)
        loop = _loopback_hub_run(device, card, DEFAULT_FSK_CONFIG,
                                 LOOPBACK_BATCH, "FarmLoopbackHub",
                                 ("fsk_seq", "fsk_framing"))
        psk = _loopback_hub_run(device, card, PSKConfig(), PSK_HUB_BATCH,
                                "DBPSK FarmLoopbackHub",
                                ("psk_seq", "fsk_framing"))
    finally:
        trap.close()
    seconds = time.perf_counter() - t_phase
    print(f"  phase 19: {seconds:.1f} s [{card}]")
    launches = {"farm_hub_device": {}, "farm_hub_loopback": loop["launches"],
                "farm_hub_dbpsk": psk["launches"]}
    for r in dev["rounds"]:
        for k, v in r["launches"].items():
            launches["farm_hub_device"][k] = \
                launches["farm_hub_device"].get(k, 0) + v
    return launches, {"device_hub": dev, "loopback_hub": loop,
                      "dbpsk_hub": psk, "seconds": seconds}


# -- phase 20: the soft and blind farm hubs ---------------------------------

SOFT_HUB_BATCH = 4096             # farm_endurance.py --soft / --blind
SOFT_RING_QUANTA = 22             # ceil(frame_signal_length(133) / 4800) + 2
BLIND_MAX_PAYLOAD = 160           # BlindSoftFarmHub's default
SOFT_REPLAY_WINDOWS = 3           # wire 0's first side-b windows, on the CPU
SOFT_PROFILE_QUANTA = 12          # quanta of a third round under the profiler
SYNTH_BATCH = 4096
SYNTH_PAYLOADS = (1, 46, 133)     # a control byte, the tests' 46, a packet
SYNTH_REPS = 3
FRAME_STREAM = 8                  # coded frames in (d)'s junk-laden stream
SOFT_HUB_TIMERS = HUB_TIMERS + ("farm_hub.soft_finalize",)


class _SoftSpy:
    """Spies on a ``SoftFarmHub``'s device work: counts its cohort writes
    and window decodes (the recorder's activity), and keeps the first
    ``keep`` windows side b decoded with wire ``wire`` active (its row of
    the window after the channel function, and its packed row, copied on
    the device)."""

    def __init__(self, hub, keep=0, wire=0):
        self.writes = self.decodes = 0
        self.kept = []              # (window row, payload_len, packed row)
        self._ctx = None
        write, dispatch = hub._write_group, hub._dispatch_group
        decode = hub._decode_window

        def spy_write(*args):
            self.writes += 1
            return write(*args)

        def spy_dispatch(tx_side, rx_side, group):
            self._ctx = (rx_side, group)
            try:
                return dispatch(tx_side, rx_side, group)
            finally:
                self._ctx = None

        def spy_decode(window, payload_len):
            packed = decode(window, payload_len)
            self.decodes += 1
            rx_side, group = self._ctx
            if (rx_side == "b" and len(self.kept) < keep
                    and wire in group.slot_of
                    and group.active[group.slot_of[wire]]):
                self.kept.append((window[wire].clone(), payload_len,
                                  packed[wire].clone()))
            return packed

        hub._write_group, hub._dispatch_group = spy_write, spy_dispatch
        hub._decode_window = spy_decode

    def activity(self):
        return self.writes + self.decodes


def _soft_counters(hub, spy):
    """The hub's cumulative work counters: window decodes and frames for
    the scheduled hub, programs and receiver counters for the blind one."""
    if spy is not None:
        return {"decodes": spy.decodes, "writes": spy.writes,
                "frames_decoded": hub.frames_decoded,
                "frames_erased": hub.frames_erased}
    st = [hub._rx[s].get_status() for s in ("a", "b")]
    out = {"programs": sum(r["programs"]["header"] + r["programs"]["body"]
                           for r in st)}
    for k in ("events_detected", "frames_decoded", "frames_erased",
              "headers_failed", "dropped_ring"):
        out[k] = sum(r[k] for r in st)
    return out


def _soft_launches_want(r):
    """The kernels one round must launch, exactly: per window decode one
    K1 (csum mode), two K4 and two K3 (SoftFarmHub); per quantum one K1
    per direction (the detector) and per header or body program one K5,
    one K4 and one K3 (BlindSoftFarmHub)."""
    c = r["counters"]
    if "decodes" in c:
        d = c["decodes"]
        return {"fsk_seq": d, "align": 2 * d, "viterbi": 2 * d}
    p = c["programs"]
    return {"fsk_seq": 2 * r["steps"], "cumsum0": p, "align": p,
            "viterbi": p}


def _print_soft_round(label, r, B, card):
    want = _soft_launches_want(r)
    got = {k: v for k, v in r["launches"].items() if v}
    if got != want:
        raise RuntimeError(f"{label} launches {got} != {want}")
    c = r["counters"]
    if c["frames_erased"]:
        print(f"  {label}: {c['frames_erased']} frames erased in round "
              f"{r['direction']} (AWGN {HUB_NOISE}), resent by XModem")
    tm = r["timers"]
    print(f"  {label} B={B} round {r['direction']}: {B} payloads exact, "
          f"{r['retransmitted']} retransmissions; {r['audio_s']:.1f} s of "
          f"audio in {r['wall_s']:.3f} s wall, {r['steps']} quanta "
          f"({r['busy_steps']} busy); per busy quantum (both directions) "
          f"median {r['period_median_ms']:.2f} ms, p99 "
          f"{r['period_p99_ms']:.2f} ms against 100 ms (all quanta "
          f"{r['all_period_median_ms']:.2f} / "
          f"{r['all_period_p99_ms']:.2f}, max {r['max_period_ms']:.2f}; "
          f"step() alone {r['step_median_ms']:.2f} / "
          f"{r['step_p99_ms']:.2f}); counters {c}; timers per call: "
          + ", ".join(f"{k.split('.')[1]} {v['mean_ms']:.2f} ms x "
                      f"{v['count']}" for k, v in tm.items())
          + f"; launches {got} [{card}]", flush=True)


def _replay_windows(spy, params):
    """(e) The kept windows of wire 0 (side b, channel noise included)
    through the plain versions on the CPU: the packed row (payload bytes
    and CRC flag) must equal what the kernels gave."""
    import torch

    from webaudio_modem_tpu_torch.ops import soft_fsk

    if len(spy.kept) < SOFT_REPLAY_WINDOWS:
        raise RuntimeError(f"only {len(spy.kept)} windows of wire 0 kept")
    t0 = time.perf_counter()
    n_ok = 0
    for k, (win, pl, packed) in enumerate(spy.kept):
        got = soft_fsk._decode_frames_fused(params, win.cpu()[None], pl)[0]
        want = packed.cpu()
        if not torch.equal(got, want):
            raise RuntimeError(f"replay window {k} (payload {pl}): plain "
                               f"{got.tolist()} != kernels {want.tolist()}")
        n_ok += int(want[pl])
    if not n_ok:
        raise RuntimeError("no replayed window decoded a frame")
    return {"windows": len(spy.kept), "frames": n_ok,
            "samples": sum(int(w.shape[0]) for w, _, _ in spy.kept),
            "seconds": time.perf_counter() - t0}


def _soft_wire_run(kind, device, card):
    """(a) SoftFarmHub or (b) BlindSoftFarmHub at B = 4096 with
    farm_endurance's settings: warm-up, one round each way, then a third
    round's first quanta under torch.profiler; for (a) also (e)."""
    import asyncio

    import torch

    from webaudio_modem_tpu_torch.examples.farm_endurance import \
        round_payloads
    from webaudio_modem_tpu_torch.models.config import (DEFAULT_FSK_CONFIG,
                                                        FSKParams)
    from webaudio_modem_tpu_torch.runtime.soft_hub import (BlindSoftFarmHub,
                                                           SoftFarmHub)
    from webaudio_modem_tpu_torch.sim import make_device_awgn
    from webaudio_modem_tpu_torch.transports.xmodem import XModemTransport
    from webaudio_modem_tpu_torch.utils.trace import metrics

    B = SOFT_HUB_BATCH
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kw = dict(quantum=HUB_QUANTUM, ring_quanta=SOFT_RING_QUANTA,
              device_channel_fn=make_device_awgn(HUB_NOISE), device=device)
    if kind == "soft":
        hub = SoftFarmHub(DEFAULT_FSK_CONFIG, B, **kw)
        spy = _SoftSpy(hub, keep=SOFT_REPLAY_WINDOWS)
        rec = _HubRecorder(hub, activity=spy.activity)
    else:
        hub = BlindSoftFarmHub(DEFAULT_FSK_CONFIG, B,
                               max_payload=BLIND_MAX_PAYLOAD, **kw)
        spy = None
        rec = _HubRecorder(hub)
    label = type(hub).__name__
    ta = [XModemTransport(hub.channel("a", i)) for i in range(B)]
    tb = [XModemTransport(hub.channel("b", i)) for i in range(B)]
    out = {"batch": B, "ring_quanta": hub.ring_len // hub.quantum}

    async def drive():
        pump = asyncio.ensure_future(hub.run())
        try:
            for t in (ta[0], tb[0]):
                t.configure({"timeout_ms": 600000})
            got = await _hub_round(hub, [ta[0]], [tb[0]],
                                   [bytes(HUB_PAYLOAD)])
            if got != [bytes(HUB_PAYLOAD)]:
                raise RuntimeError(f"{label} warm-up transfer failed")
            out["warmup_steps"] = hub.steps
            print(f"  {label} warm-up transfer on wire 0: {hub.steps} "
                  f"quanta, step median {_pct(rec.step_ms, 0.5):.2f} ms",
                  flush=True)
            for t in ta + tb:
                t.configure({"timeout_ms": HUB_TIMEOUT_MS})
            rounds = []
            for rnd, (snd, rcv) in enumerate(((ta, tb), (tb, ta))):
                payloads = round_payloads(rnd, B, HUB_PAYLOAD)
                rec.reset_timing()
                before = metrics.snapshot()["timings"]
                c0 = _soft_counters(hub, spy)
                _zero_all_launches()
                retx0 = sum(t.get_statistics().packets_retransmitted
                            for t in snd)
                steps0, t0 = hub.steps, time.perf_counter()
                got = await _hub_round(hub, snd, rcv, payloads)
                wall = time.perf_counter() - t0
                launches = _all_launches()
                c1 = _soft_counters(hub, spy)
                steps = hub.steps - steps0
                bad = sum(g != p for g, p in zip(got, payloads))
                if bad:
                    raise RuntimeError(f"{label} round {rnd}: {bad} "
                                       "payloads wrong")
                window = rec.period_ms[:SOFT_PROFILE_QUANTA]
                rounds.append({
                    **rec.stats(),
                    "window_ms": sum(window) / max(len(window), 1),
                    "direction": "a->b" if rnd == 0 else "b->a",
                    "steps": steps, "audio_s": steps * HUB_QUANTUM / 48000,
                    "wall_s": wall, "launches": launches,
                    "counters": {k: c1[k] - c0[k] for k in c1},
                    "retransmitted": sum(
                        t.get_statistics().packets_retransmitted
                        for t in snd) - retx0,
                    "timers": _timer_deltas(before, SOFT_HUB_TIMERS)})
                _print_soft_round(label, rounds[-1], B, card)
            out["rounds"] = rounds
            out["retransmitted"] = sum(
                t.get_statistics().packets_retransmitted for t in ta + tb)
            # a third round a->b, its first quanta under torch.profiler,
            # in the same event loop (the channels' queues keep the loop
            # they first waited on); the profiler starts before any
            # session waits
            payloads = round_payloads(2, B, HUB_PAYLOAD)
            prof = _hub_profiler()
            t0 = time.perf_counter()
            prof.start()
            start_s = time.perf_counter() - t0
            task = asyncio.ensure_future(_hub_round(hub, ta, tb, payloads))
            t0 = time.perf_counter()
            await rec.after_steps(hub, SOFT_PROFILE_QUANTA)
            wall_ms = (time.perf_counter() - t0) * 1e3 / SOFT_PROFILE_QUANTA
            prof.stop()
            if await task != payloads:
                raise RuntimeError(f"{label} profiled round: payloads "
                                   "wrong")
            out["profiled_round_retransmitted"] = sum(
                t.get_statistics().packets_retransmitted
                for t in ta + tb) - out["retransmitted"]
            out["profile"] = _hub_profile(prof, SOFT_PROFILE_QUANTA,
                                          rounds[0]["window_ms"])
            out["profile"].update(profiled_quantum_wall_ms=wall_ms,
                                  start_s=start_s)
        finally:
            hub.stop()
            await pump

    asyncio.run(drive())
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
    status = hub.get_status()
    prof = out["profile"]
    print(f"  {label}: retransmissions {out['retransmitted']} in the "
          f"warm-up and the two rounds, "
          f"{out['profiled_round_retransmitted']} in the profiled round; "
          f"peak device memory {out['peak_mib']:.1f} MiB; status "
          f"{status}")
    print(f"  {label} profile of the first {prof['steps']} quanta of a "
          f"round, per quantum (both directions; "
          f"{prof['profiled_quantum_wall_ms']:.2f} ms of wall each under "
          f"the profiler): {prof['kernels_per_step']:.1f} kernels, "
          f"{prof['copies_per_step']:.1f} copies, "
          f"{prof['device_ms_per_step']:.4f} ms of device time: busy "
          f"{100 * prof['busy_share']:.1f} % of the same quanta of round "
          f"a->b unprofiled ({out['rounds'][0]['window_ms']:.2f} ms each); "
          f"the profiler's start {prof['start_s']:.2f} s [{card}]")
    for key, ms, n in prof["top"]:
        print(f"    {ms:8.4f} ms/quantum  {n:6.2f} per quantum  {key}")
    if spy is not None:
        out["replay"] = _replay_windows(spy, FSKParams.from_config(
            DEFAULT_FSK_CONFIG))
        r = out["replay"]
        print(f"  (e) wire 0's first {r['windows']} windows of side b "
              f"({r['samples']} samples, {r['frames']} frames) replayed "
              f"through the plain versions on the CPU: the same packed "
              f"bytes ({r['seconds']:.1f} s)")
    return out


def _synth_check(device, card):
    """(c) frames_synth_device_fn against encode_frames_batch on the card,
    exactly, at B = 4096 for 1, 46 and 133-byte payloads, both routes
    timed (CUDA events around the whole call: the host framing of the
    second route included); the host-side launches of one TX cohort of
    the hubs' data packet and of its CRC alone."""
    import numpy as np
    import torch

    from webaudio_modem_tpu_torch.models.config import (DEFAULT_FSK_CONFIG,
                                                        FSKParams)
    from webaudio_modem_tpu_torch.ops import soft_fsk

    params = FSKParams.from_config(DEFAULT_FSK_CONFIG)
    rng = np.random.default_rng(20)
    out = {}
    for pl in SYNTH_PAYLOADS:
        pay = rng.integers(0, 256, (SYNTH_BATCH, pl), dtype=np.uint8)
        payloads = [bytes(r) for r in pay]
        fn = soft_fsk.frames_synth_device_fn(params, pl)
        pay_dev = torch.from_numpy(pay).to(device)
        dev = fn(pay_dev, device=device)
        host = soft_fsk.encode_frames_batch(params, payloads, device=device)
        if not torch.equal(dev, host):
            raise RuntimeError(f"frames_synth_device_fn pl={pl}: "
                               f"{int((dev != host).sum())} samples differ "
                               "from encode_frames_batch")
        shape = list(dev.shape)
        del dev, host
        dev_ms = _cuda_ms(lambda: fn(pay_dev, device=device), SYNTH_REPS)
        host_ms = _cuda_ms(lambda: soft_fsk.encode_frames_batch(
            params, payloads, device=device), SYNTH_REPS)
        out[pl] = {"shape": shape, "device_route_ms": dev_ms,
                   "host_framed_ms": host_ms}
        print(f"  (c) frames_synth_device_fn == encode_frames_batch, "
              f"exactly, {shape} (payload {pl}): device route "
              f"{dev_ms:.3f} ms, host-framed route {host_ms:.3f} ms a "
              f"cohort [{card}]", flush=True)
    pl = HUB_PAYLOAD + 5                    # the hubs' XModem data packet
    fn = soft_fsk.frames_synth_device_fn(params, pl)
    pay = torch.from_numpy(rng.integers(0, 256, (SYNTH_BATCH, pl),
                                        dtype=np.uint8)).to(device)
    fn(pay, device=device)
    bits = ((pay.to(torch.int64)[:, :, None]
             >> torch.arange(7, -1, -1, device=pay.device)) & 1) \
        .reshape(SYNTH_BATCH, -1)
    out["cohort_host_ops"] = _host_ops(
        f"one TX cohort, frames_synth_device_fn payload {pl}",
        lambda: fn(pay, device=device), 1, top=4)
    out["crc_host_ops"] = _host_ops(
        f"its CRC alone, _crc16_bits_device over {pl} bytes (crc16."
        "crc_rows: the bits cast to uint8, one kernel launch)",
        lambda: soft_fsk._crc16_bits_device(bits), 1, top=3)
    return out


def _frame_decoder_check(device, card):
    """(d) FrameDecoder on the card and on the CPU over one stream of
    coded frames with junk between them: the right payloads, the same
    counters, K3 launched once per decode (each resync slide one launch
    and one copy back), the wall of the junk-laden process()."""
    import numpy as np

    from webaudio_modem_tpu_torch.ops.kernels import viterbi
    from webaudio_modem_tpu_torch.transports.fec_frame import (FrameDecoder,
                                                               FrameEncoder)

    rng = np.random.default_rng(21)
    payloads, stream = [], b""
    for _ in range(FRAME_STREAM):
        junk = bytes(rng.integers(0, 256, int(rng.integers(0, 40)),
                                  dtype=np.uint8))
        p = bytes(rng.integers(0, 256, int(rng.integers(1, 64)),
                               dtype=np.uint8))
        payloads.append(p)
        stream += junk + FrameEncoder.encode_frame(p)
    stream += bytes(FrameEncoder.coded_frame_length(258))
    res = {}
    for name, dev in (("card", device), ("cpu", "cpu")):
        dec = FrameDecoder(max_payload=256, device=dev)
        _zero_all_launches()
        t0 = time.perf_counter()
        got = dec.process(stream)
        calls = 1
        while dec.scan_pending:
            got += dec.process(b"")
            calls += 1
        wall = time.perf_counter() - t0
        res[name] = {"payloads": got, "wall_s": wall, "calls": calls,
                     "k3_launches": viterbi.launches,
                     "headers_resynced": dec.headers_resynced,
                     "bodies_dropped": dec.bodies_dropped,
                     "frames_decoded": dec.frames_decoded,
                     "waiting_body": dec._body_coded_len is not None}
    card_r, cpu_r = res["card"], res["cpu"]
    if card_r["payloads"] != payloads or cpu_r["payloads"] != payloads:
        raise RuntimeError("FrameDecoder: wrong payloads")
    counters = ("headers_resynced", "bodies_dropped", "frames_decoded")
    if any(card_r[k] != cpu_r[k] for k in counters):
        raise RuntimeError(f"FrameDecoder: card {card_r} != cpu {cpu_r}")
    decodes = (card_r["headers_resynced"] + 2 * card_r["frames_decoded"]
               + card_r["bodies_dropped"] + int(card_r["waiting_body"]))
    if card_r["k3_launches"] != decodes:
        raise RuntimeError(f"FrameDecoder: {card_r['k3_launches']} K3 "
                           f"launches for {decodes} decodes")
    out = {"stream_bytes": len(stream), "frames": len(payloads),
           **{f"{name}_{k}": r[k] for name, r in res.items()
              for k in ("wall_s", "k3_launches", "calls")},
           **{k: card_r[k] for k in counters}}
    print(f"  (d) FrameDecoder over {len(stream)} bytes ({len(payloads)} "
          f"frames, junk between): every payload exact on the card and on "
          f"the CPU, {card_r['headers_resynced']} resync slides; card "
          f"{card_r['wall_s'] * 1e3:.1f} ms wall for "
          f"{card_r['k3_launches']} K3 launches "
          f"({card_r['wall_s'] * 1e3 / card_r['k3_launches']:.3f} ms a "
          f"decode), CPU {cpu_r['wall_s'] * 1e3:.1f} ms [{card}]")
    return out


def phase_soft_hubs(device, card):
    """(c) on-device frame synthesis against the host-framed route; (a)
    SoftFarmHub and (b) BlindSoftFarmHub at B = 4096, a round each way,
    measured, with (e) a replay of (a)'s windows on the CPU; (d) the FEC
    frame layer's decoder on the card.  Any ERROR record of the port's
    loggers fails the phase.  Returns the launches by path and the
    results."""
    from webaudio_modem_tpu_torch.ops.kernels import crc16

    t_phase = time.perf_counter()
    synth = _synth_check(device, card)
    trap = _HubTrap()
    crc_launches = [crc16.launches]
    try:
        soft = _soft_wire_run("soft", device, card)
        crc_launches.append(crc16.launches)
        blind = _soft_wire_run("blind", device, card)
        crc_launches.append(crc16.launches)
    finally:
        trap.close()
    frames = _frame_decoder_check(device, card)
    seconds = time.perf_counter() - t_phase
    print(f"  phase 20: {seconds:.1f} s [{card}]")
    launches = {"soft_hub": {}, "blind_hub": {},
                "fec_frame": {"viterbi": frames["card_k3_launches"]}}
    for i, (path, run) in enumerate((("soft_hub", soft),
                                     ("blind_hub", blind))):
        for r in run["rounds"]:
            for k, v in r["launches"].items():
                launches[path][k] = launches[path].get(k, 0) + v
        # the CRC kernel over the whole run (warm-up and profiled round
        # included): the TX cohorts' CRC and the decodes' select and pack
        launches[path]["crc16"] = crc_launches[i + 1] - crc_launches[i]
        print(f"  {path}: {launches[path]['crc16']} CRC kernel launches "
              "over its run (TX cohorts, header selects, body packs)")
    return launches, {"soft_hub": soft, "blind_hub": blind,
                      "frames_synth": synth, "frame_decoder": frames,
                      "seconds": seconds}


def _host_ops(label, run, calls, top=8):
    """The host side of ``run()`` (``calls`` calls) under torch.profiler,
    CPU only: kernel launches per call and the operators with the most
    self CPU time, with their counts per call."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    rows = sorted(((e.self_cpu_time_total, e.key, e.count)
                   for e in prof.key_averages() if not _is_span(e)),
                  reverse=True)
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

    from webaudio_modem_tpu_torch.ops import fsk_demod
    from webaudio_modem_tpu_torch.ops.kernels import _build
    from webaudio_modem_tpu_torch.utils.device import require_cuda

    print("phase 1: device")
    device, card = require_cuda()
    # the facades would build the quality calibration on a host thread
    # (K1's plain version over a clean frame) beside the timed phases;
    # the CPU tests drive that path
    fsk_demod.AUTO_WARM_QUALITY = False
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
    print("phase 8b: the CRC kernel vs plain on the card, timed")
    max_err["crc16"], crc = phase_crc_vs_plain(device, rng, card)
    _resident("phase 8b")
    print("phase 8c: the sync-peak kernel vs plain on the card, timed")
    max_err["sync_peak"], sync = phase_sync_vs_plain(device, rng, card)
    _resident("phase 8c")
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
    print("phase 18: BASELINE config 3, XModem over simulated audio")
    xmodem_launches, xmodem_out = phase_xmodem_audio(device, card)
    print("phase 19: the farm hubs, thousands of XModem sessions")
    hub_launches, hub_out = phase_farm_hubs(device, card)
    print("phase 20: the soft and blind farm hubs")
    soft_hub_launches, soft_hub_out = phase_soft_hubs(device, card)
    hub_launches.update(soft_hub_launches)

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
                   "tpu_route (chip_smoke)": route_launches.get(name, 0),
                   "xmodem_audio": xmodem_launches.get(name, 0),
                   **{path: counts.get(name, 0)
                      for path, counts in hub_launches.items()}}
        if not any(by_path.values()):
            raise RuntimeError(f"{name}: no launch on a main path")
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        return {"name": name, "route": "cuda",
                "source": f"webaudio_modem_tpu_torch/csrc/{src}",
                "replaces": (f"webaudio_modem_tpu/ops/pallas/{rep}" if rep
                             else None),
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
            {"xmodem_audio_main_path": xmodem_out,
             "farm_hubs_main_path": hub_out,
             "modes": {
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
            kernel_ms["fsk_framing"],
            {"graph_ms": kernel_ms["fsk_framing"]["graph_ms"],
             "k8_bench_turns_ms": {"enqueued": k8["bench_turns_ms"],
                                   "graph": k8["bench_turns_graph_ms"]}}),
        row("viterbi", "viterbi.cu", "viterbi.py:82", soft["viterbi_header"],
            {**others("viterbi_body", "viterbi_payload-100"),
             "soft_hubs_main_path": soft_hub_out,
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
                 "demod_chunk_B2048", "demod_chunk_B4096")}}),
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
        row("crc16", "crc16.cu", None, crc["pack_133"],
            {"other_shapes": [
                {k: crc[n][k] for k in ("shape", "ms", "plain_ms",
                                        "bound_ms", "bound_by", "graph_ms")}
                for n in ("pack_16", "pack_45", "rows_header")],
             "graph_ms": crc["pack_133"]["graph_ms"]}),
        row("sync_peak", "sync_peak.cu", None, sync["sync_133"],
            {"other_shapes": [
                {k: sync[n][k] for k in ("shape", "ms", "plain_ms",
                                         "bound_ms", "bound_by", "graph_ms")}
                for n in ("sync_16", "sync_45")],
             "graph_ms": sync["sync_133"]["graph_ms"],
             "f32_lane_graph_ms": {n: sync[n]["f32_graph_ms"]
                                   for n in sync}}),
        row("fsk_stage_d", "fsk_framing.cu", "fsk_framing.py:47",
            k8["timing"],
            {**{k: k8["timing"][k] for k in (
                "graph_ms", "kernel_only_ms", "kernel_only_graph_ms")},
             "other_shapes": [{k: k8["bench"][k] for k in (
                 "shape", "ms", "graph_ms", "kernel_only_ms",
                 "kernel_only_graph_ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")}],
             "bench_turns_ms": k8["bench_turns_ms"],
             "bench_turns_graph_ms": k8["bench_turns_graph_ms"],
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
