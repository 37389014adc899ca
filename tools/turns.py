#!/usr/bin/env python3
"""Time one piece of several checkouts in turns, on one card.

    python3 tools/turns.py WHAT parent=DIR change=. change=. parent=DIR

It first prints the card's name, power limit and top SM clock.

Each LABEL=DIR turn runs in its own process, importing that checkout's
``webaudio_modem_tpu_torch`` and ``chip_smoke.py`` (each builds its own
kernels).  Turns in one call on one card are what two versions may be
compared by.  WHAT is one of:

* ``framing`` — K2 (``stage_d_compact``) and K8 (``fsk_demod.stage_d``,
  the wrapper, and ``chip_smoke._k8_kernel_only``, its kernel alone) on
  the planes ``chip_smoke.py`` phase 15 times them on: the second 0.1 s
  chunk of 4096 distinct 13-byte messages at the hard bench
  configuration (300 baud, n_ds = 2400), and K8 also on 4096 128-byte
  Bell-202 messages at 10 dB (n_ds = 26,440, the reference's noise from
  ``sim.ber.noisy_batch``).  Each five times over 20 launches between
  two CUDA events (enqueued one by one) and three times over 20
  launches captured in a CUDA graph (device time without host gaps).
  It prints a hash of K2's and of K8's outputs (carry and planes), so
  the turns also show whether two checkouts compute the same.
* ``seq`` — the sequential-DSP kernels and the hard chunk step, on the
  inputs ``chip_smoke.py`` times them on: K1 with all streams on the
  second 0.1 s chunk of 4096 distinct 13-byte messages at the hard bench
  configuration (T = 4800), K1 in csum mode on the soft decode's 16-byte
  frames at 8 dB (T = 16,720, B = 4096), K7 (K1 without R) at 50 baud
  (ds = 480, T = 4800, B = 2048), K6 at ``PSKConfig()`` (D = 20,
  B = 4096, with R) on two inputs: the second 0.1 s chunk of 4096
  distinct 13-byte messages after the first (the turns' input; the
  messages end there, so T = 2080), and the first chunk after 28 chunk
  steps cycling through the messages' chunks (T = 4800, the input
  ``chip_smoke.py`` phase 11 times K6 on), each five
  times over 20 launches (5 for the csum mode) between two CUDA events,
  and the hard ``demod_chunk`` at B = 4096 over 25 chunks.  It prints a
  hash of each one's outputs.
* ``cumsum`` — K5 at ``chip_smoke.CSUM_SHAPES`` (the blind receiver's
  header and body windows, B = 4096) on normal random planes, five times
  over 20 launches between two CUDA events, beside ``torch.cumsum`` of
  the same plane and K5's byte bound (one read of x, one write of the
  output at 3.35 TB/s), with a hash of K5's output.
* ``fec`` — K3 and K4 on the soft decode's own planes, as
  ``chip_smoke.py`` phase 8 times them: 4096 distinct 16-byte payloads
  at 8 dB through K1's csum mode, then K4's header window (1532 x 4096,
  stride 1) and body window (300 x 4096, stride ds), K3 on the header
  candidates (L = 32,768, T = 38) and on the bodies (L = 4096, T = 150),
  and K3 on 2048 payload-100 bodies (T = 822, coded +-1 pairs plus noise
  of sigma 0.5 from seed 8), each five times over 20 launches between
  two CUDA events and three times over 20 launches captured in a CUDA
  graph (device time without the wrappers' host gaps), with a hash of
  each one's outputs.  K3 is given the
  soft view [L, T, 2] where its wrapper takes it, else (the parent) the
  branch sums a = x0 + x1, d = x0 - x1 made beforehand; ``_viterbi_core``
  on the soft view, glue included, is timed beside it.
* ``blind`` — the blind receiver's ``feed`` as ``chip_smoke.py`` phase
  14 drives it, in a fresh process: B = 4096 channels of a cyclic stream
  of one 16-byte frame each at 8 dB (noise drawn on the card from seed
  3), two cycles of warm-up, then the host wall per feed over two cycles,
  three times, the peak device memory of those feeds, a hash of the
  delivered (channel, payload) sequence, and a ``torch.profiler``
  breakdown of one cycle (device time per feed by kernel, and the
  busy share of the fastest unprofiled wall).
* ``soft_decode`` — the farm soft-FEC decode of 2048 and 4096 distinct
  16-byte payloads at 8 dB, as ``chip_smoke.py`` phase 8 makes them,
  decoded exactly three times over as ten pipelined
  ``decode_frames_batch_async`` calls (host wall per decode), then ten
  ``_decode_frames_fused`` calls between two CUDA events.
"""

import os
import subprocess
import sys

PRELUDE = r"""
import hashlib, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import chip_smoke as cs
from webaudio_modem_tpu_torch.ops import fsk_demod
assert fsk_demod.__file__.startswith(sys.argv[1]), fsk_demod.__file__
dev = torch.device("cuda", 0)
"""

TURNS = {
    "framing": r"""
from webaudio_modem_tpu_torch.models.config import FSKParams
from webaudio_modem_tpu_torch.ops import fsk_mod
from webaudio_modem_tpu_torch.ops.kernels import fsk_framing
from webaudio_modem_tpu_torch.sim import ber


def digest(out):
    h = hashlib.sha256()
    todo = [out]
    while todo:
        o = todo.pop(0)
        if isinstance(o, (tuple, list)):
            todo[:0] = list(o)
        else:
            h.update(o.cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def timed(name, fn, n, out=None):
    for _ in range(3):
        fn()
    ms = [cs._cuda_ms(fn, 20) for _ in range(5)]
    graph = [cs._graph_ms(fn, 20) for _ in range(3)]
    print(f"turn {sys.argv[2]} {name} n_ds={n} B={B}: enqueued "
          f"{', '.join(f'{m:.4f}' for m in ms)}; graph "
          f"{', '.join(f'{m:.4f}' for m in graph)} ms per launch"
          + (f"; outputs sha256 {digest(out)}" if out is not None else ""),
          flush=True)


B = 4096
params = FSKParams.from_config(cs._bench_config())
sig = fsk_mod.modulate_batch(
    params, cs._messages(np.random.default_rng(5), B, 13), dev)
state, _ = fsk_demod.demod_chunk(
    params, 0, fsk_demod.init_state(params, B, dev), sig[:, :cs.CHUNK])
planes = cs._stage_d_inputs(params, state,
                            sig[:, cs.CHUNK:2 * cs.CHUNK].t().contiguous())
n = planes[0].shape[0]
ints, flts = fsk_demod._framing_carry(params, state)
args = (params, ints, flts, state.bit_fill, *planes,
        fsk_demod.max_bytes(params, n))
timed("K2", lambda: fsk_framing.stage_d_compact(*args), n,
      fsk_framing.stage_d_compact(*args))
timed("K8", lambda: fsk_demod.stage_d(params, state, *planes), n,
      fsk_demod.stage_d(params, state, *planes))
timed("K8 kernel alone", cs._k8_kernel_only(params, state, planes), n)
del sig, planes

params = FSKParams.from_config(cs._bell202())
clean = ber.clean_signal(cs._bell202(), cs.BER_MESSAGES["long"])
x = torch.from_numpy(ber.noisy_batch(clean, 10.0, B)).to(dev)
state = fsk_demod.init_state(params, B, dev)
planes = cs._stage_d_inputs(params, state, x.t().contiguous())
del x
n = planes[0].shape[0]
timed("K8", lambda: fsk_demod.stage_d(params, state, *planes), n,
      fsk_demod.stage_d(params, state, *planes))
timed("K8 kernel alone", cs._k8_kernel_only(params, state, planes), n)
""",
    "seq": r"""
from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams
from webaudio_modem_tpu_torch.ops import fsk_mod, psk
from webaudio_modem_tpu_torch.ops.kernels import fsk_seq, psk_seq


def digest(out, h=None):
    # sha256 of the tensors in ``out`` (tuples, dataclasses, None)
    top = h is None
    h = h or hashlib.sha256()
    if out is None:
        h.update(b"-")
    elif isinstance(out, torch.Tensor):
        h.update(out.cpu().contiguous().view(torch.uint8).numpy().tobytes())
    else:
        for t in out if isinstance(out, tuple) else vars(out).values():
            digest(t, h)
    return h.hexdigest()[:16] if top else None


rng = np.random.default_rng(5)
B = 4096
params = FSKParams.from_config(cs._bench_config())
ds = params.ds_samples_per_bit
sig = fsk_mod.modulate_batch(params, cs._messages(rng, B, 13), dev)
state, _ = fsk_demod.demod_chunk(
    params, 0, fsk_demod.init_state(params, B, dev), sig[:, :cs.CHUNK])
x = sig[:, cs.CHUNK:2 * cs.CHUNK].t().contiguous()
k1 = (params, 0, state.front, state.ds_acc, state.bit_tail[-ds:], x)
soft = cs._soft_params()
_, noisy = cs._soft_batch(soft, rng, B, dev)
csum = cs._soft_planes(soft, noisy)["seq_args"]
p50 = FSKParams.from_config(FSKConfig(baud_rate=50, mark_frequency=1270,
                                      space_frequency=1070))
sig50 = fsk_mod.modulate_batch(p50, cs._messages(rng, 2048, 4), dev)
x50 = cs._awgn(sig50[:, cs.CHUNK:2 * cs.CHUNK], 20.0, rng,
               dev).t().contiguous()
st50 = fsk_demod.init_state(p50, 2048, dev)
k7 = (p50, 0, st50.front, st50.ds_acc, None, x50)
pp = cs._psk_params()
psig = psk.modulate_batch(pp, cs._messages(rng, B, 13), dev)
pstate, _ = psk.demod_chunk(pp, 0, psk.init_state(pp, B, dev),
                            psig[:, :cs.CHUNK])
k6 = (pp, *cs._psk_args(pstate, 0, psig[:, cs.CHUNK:2 * cs.CHUNK]
                        .t().contiguous(), True))
# phase 11's input: the first chunk after 28 steps cycling the chunks
pchunks = [psig[:, i * cs.CHUNK:(i + 1) * cs.CHUNK]
           for i in range(psig.shape[1] // cs.CHUNK)]
pstate = psk.init_state(pp, B, dev)
for i in range(28):
    pstate, _ = psk.demod_chunk(pp, 0, pstate, pchunks[i % len(pchunks)])
k6_cycled = (pp, *cs._psk_args(pstate, 0, pchunks[0].t().contiguous(), True))
chunks = [sig[:, i * cs.CHUNK:(i + 1) * cs.CHUNK]
          for i in range(sig.shape[1] // cs.CHUNK)]
run = [fsk_demod.init_state(params, B, dev), 0]


def chunk_step():
    run[0], _ = fsk_demod.demod_chunk(params, 0, run[0],
                                      chunks[run[1] % len(chunks)])
    run[1] += 1


cases = (
    ("K1 all streams T=4800 B=4096", lambda: fsk_seq.seq(*k1), 20),
    (f"K1 csum T={csum[-1].shape[0]} B=4096",
     lambda: fsk_seq.seq(*csum, **cs.CSUM_FLAGS), 5),
    ("K7 ds=480 T=4800 B=2048",
     lambda: fsk_seq.seq(*k7, emit_rsum=False), 20),
    (f"K6 D=20 T={k6[-1].shape[0]} B=4096", lambda: psk_seq.seq(*k6), 20),
    (f"K6 D=20 T={k6_cycled[-1].shape[0]} B=4096, phase 11's input",
     lambda: psk_seq.seq(*k6_cycled), 20),
    ("demod_chunk hard B=4096",
     lambda: fsk_demod.demod_chunk(params, 0, state, chunks[1]), 0),
)
for name, fn, reps in cases:
    out = fn()
    digest_s = digest(out)
    if reps == 0:      # the chunk step: a carried stream, as phase 5
        fn, reps = chunk_step, 25
    for _ in range(3):
        fn()
    ms = [cs._cuda_ms(fn, reps) for _ in range(5)]
    print(f"turn {sys.argv[2]} {name}: "
          f"{', '.join(f'{m:.4f}' for m in ms)} ms per call; outputs "
          f"sha256 {digest_s}", flush=True)
""",
    "cumsum": r"""
from webaudio_modem_tpu_torch.ops.kernels import cumsum0
gen = torch.Generator(device=dev)
gen.manual_seed(14)
for n, B in cs.CSUM_SHAPES:
    x = torch.randn((n, B), generator=gen, device=dev)
    out = cumsum0.csum0(x)
    digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
    del out
    for _ in range(3):
        cumsum0.csum0(x)
    ms = [cs._cuda_ms(lambda: cumsum0.csum0(x), 20) for _ in range(5)]
    lib = cs._cuda_ms(lambda: torch.cumsum(x, 0), 20)
    n_bytes = cs._csum_bound(n, B)[0]
    bound = n_bytes / cs.HBM_BYTES_PER_S * 1e3
    print(f"turn {sys.argv[2]} K5 [{n}, {B}]: "
          f"{', '.join(f'{m:.4f}' for m in ms)} ms per call "
          f"(best {n_bytes / min(ms) / 1e6:.1f} GB/s, "
          f"{100 * bound / min(ms):.1f} % of the byte bound "
          f"{bound:.4f} ms); torch.cumsum {lib:.4f} ms; outputs sha256 "
          f"{digest}", flush=True)
    del x
""",
    "fec": r"""
import inspect
from webaudio_modem_tpu_torch.ops import fec, fsk_demod, soft_fsk
from webaudio_modem_tpu_torch.ops.kernels import align, fsk_seq, viterbi
params = cs._soft_params()
rng = np.random.default_rng(8)
B = 4096
_, noisy = cs._soft_batch(params, rng, B, dev)
ds = params.ds_samples_per_bit
state = fsk_demod.init_state(params, B, dev)
out = fsk_seq.seq(params, 0, state.front, state.ds_acc, state.bit_tail[-ds:],
                  noisy.t().contiguous(), emit_bits=False, emit_amps=False,
                  emit_csum=True)
csum, rsum = out[4], out[5]
body_n = soft_fsk._body_coded_bits(16)
t_peak, ok = soft_fsk._sync_peak(params, rsum)
starts, h_llr, valid = soft_fsk._header_llrs(params, csum, t_peak, ok, body_n)
L = h_llr.shape[0] * h_llr.shape[1]
h_soft = h_llr.reshape(L, -1, 2)
headers = fec._viterbi_core(h_soft, 8 * soft_fsk.HEADER_PLAIN).reshape(
    B, -1, 8 * soft_fsk.HEADER_PLAIN)
found, _, st = soft_fsk._select_candidate(headers, starts, valid,
                                          payload_len=16)
b_starts = torch.where(found, st + soft_fsk.HEADER_CODED_BITS * ds,
                       torch.zeros_like(st))
n_ds = csum.shape[0]
windows = {"header": soft_fsk._header_window(params, n_ds, t_peak),
           "body": soft_fsk._body_window(params, n_ds, b_starts, 16)}
b_soft = soft_fsk._body_llrs(params, csum, b_starts, 16).t().reshape(
    B, -1, 2)
bits = rng.integers(0, 2, (2048, 8 * 102), dtype=np.uint8)
coded = fec.conv_encode_bits_batch(bits).astype(np.float32) * 2 - 1
coded += 0.5 * rng.standard_normal(coded.shape, dtype=np.float32)
long_soft = torch.from_numpy(coded).to(dev).reshape(2048, -1, 2)
in_place = next(iter(inspect.signature(viterbi.decode).parameters)) == "soft"


def digest(t):
    return hashlib.sha256(t.cpu().contiguous().numpy().tobytes()).hexdigest()[:16]


def graph_ms(fn, reps):
    # device time a call: reps calls in one CUDA graph, replayed between
    # two CUDA events (chip_smoke._graph_ms; a parent may lack it)
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return cs._cuda_ms(graph.replay, 3) / reps


def report(name, fn, reps=20):
    out = fn()
    d = digest(out)
    del out
    for _ in range(3):
        fn()
    ms = [cs._cuda_ms(fn, reps) for _ in range(5)]
    graph = [graph_ms(fn, reps) for _ in range(3)]
    print(f"turn {sys.argv[2]} {name}: "
          f"{', '.join(f'{m:.4f}' for m in ms)} ms per call enqueued one by "
          f"one; {', '.join(f'{m:.4f}' for m in graph)} ms per call in a "
          f"CUDA graph; outputs sha256 {d}", flush=True)


for name, (base, _, kw) in windows.items():
    report(f"K4 {name} {kw['n_out']} x {B} stride {kw['stride']}",
           lambda: align.aligned_wsum(csum, base, **kw))
for name, soft, n in (("header", h_soft, 8 * soft_fsk.HEADER_PLAIN),
                      ("body", b_soft, 8 * 18),
                      ("payload-100", long_soft, 8 * 102)):
    label = f"K3 {name} L={soft.shape[0]} T={soft.shape[1]}"
    if in_place:
        report(label, lambda: viterbi.decode(soft, n))
    else:
        a, d = fec.branch_sums(soft)        # the parent's fec has it
        report(label, lambda: viterbi.decode(a, d, n))
    report(f"{label} _viterbi_core (glue included)",
           lambda: fec._viterbi_core(soft, n))
""",
    "blind": r"""
from webaudio_modem_tpu_torch.ops import soft_fsk
from webaudio_modem_tpu_torch.ops.soft_blind import BlindSoftBatchReceiver
from webaudio_modem_tpu_torch.sim import make_device_awgn
params = cs._soft_params()
rng = np.random.default_rng(8)
B = cs.MAIN_BATCH
payloads, cycle, period = cs._cycle_stream(params, rng, B, dev)
sig_power = float(torch.mean(soft_fsk.encode_frames_batch(
    params, payloads[:16], device=dev).double() ** 2))
rx = BlindSoftBatchReceiver(
    params, B, cs.CHUNK, seed=3, device=dev,
    channel_fn=make_device_awgn(sig_power / 10 ** (cs.SOFT_SNR_DB / 10)))
quanta = [cycle[:, j * cs.CHUNK:(j + 1) * cs.CHUNK] for j in range(period)]
got = hashlib.sha256()
count = [0, 0]


def feeds(n):
    for _ in range(n):
        for ch, pl in rx.feed(quanta[rx._fed % period]):
            got.update(int(ch).to_bytes(4, "little") + pl)
            count[0] += 1
            count[1] += pl != payloads[ch]


feeds(2 * period)                       # warm-up
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
walls = []
for _ in range(3):
    t0 = time.perf_counter()
    feeds(2 * period)
    torch.cuda.synchronize()
    walls.append((time.perf_counter() - t0) * 1e3 / (2 * period))
peak = torch.cuda.max_memory_allocated() / 2 ** 20
print(f"turn {sys.argv[2]} blind feed B={B}, period {period}: host wall "
      f"{', '.join(f'{w:.3f}' for w in walls)} ms per feed over "
      f"{2 * period} feeds; peak {peak:.1f} MiB; {count[0]} payloads, "
      f"{count[1]} wrong, sha256 {got.hexdigest()[:16]}", flush=True)
cs._profile(f"turn {sys.argv[2]} blind feed", lambda: feeds(period), period,
            min(walls), torch.cuda.get_device_name(0))
""",
    "soft_decode": r"""
from webaudio_modem_tpu_torch.ops import soft_fsk
params = cs._soft_params()
rng = np.random.default_rng(8)
for B in (2048, 4096):
    payloads, noisy = cs._soft_batch(params, rng, B, dev)
    for _ in range(3):
        soft_fsk.decode_frames_batch(params, noisy, 16, device=dev)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        pending = [soft_fsk.decode_frames_batch_async(params, noisy, 16,
                                                      device=dev)
                   for _ in range(10)]
        outs = [p() for p in pending]
        walls.append((time.perf_counter() - t0) * 1e3 / 10)
        if any(o != payloads for o in outs):
            raise RuntimeError("a timed decode was not exact")
    ev = cs._cuda_ms(lambda: soft_fsk._decode_frames_fused(params, noisy, 16),
                     10)
    print(f"turn {sys.argv[2]} B={B}: host wall per pipelined decode "
          f"{', '.join(f'{w:.3f}' for w in walls)} ms; CUDA events "
          f"{ev:.3f} ms per decode", flush=True)
""",
}


def main(argv) -> int:
    if len(argv) < 2 or argv[0] not in TURNS:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        end="", flush=True)
    for turn in argv[1:]:
        label, _, tree = turn.partition("=")
        tree = os.path.abspath(tree)
        proc = subprocess.run(
            [sys.executable, "-c", PRELUDE + TURNS[argv[0]], tree, label],
            capture_output=True, text=True)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stderr.write(proc.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
