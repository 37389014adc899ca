"""The CUDA sources of K1 / K7, K2 / K8, K6, K5, K3 and K4 built for the CPU with g++
over a host emulation of CUDA (``host_cuda/``), against their plain
versions, through the port's own wrappers.

The card is the only place a kernel is timed or held exactly to its
plain version (``chip_smoke.py``).  Here the emulation runs each block's
threads as threads of the host, so the warp-specialised pipelines' hand
over (named barriers, cp.async copies that land only at their wait) and
their edges (partial blocks, partial tiles, T = 0, odd B, a misaligned
bits plane) are exercised by the CPU suite: a barrier that never
completes fails the launch instead of hanging.  K3's warp shuffles and
ballots meet the warp's 32 emulated threads, so every group width and
both placements of its decision records run here (with a smaller
shared budget than the card's, so that the placements switch at short
trellises).

Tolerances: K2, K8, K5, K3 and K4 exactly (integer state machine and IEEE f32
arithmetic, no transcendental).  K1 and K6 run ``atan2f`` from the
host's C library where the plain versions run torch's, which may round
differently: floats within atol 1e-4, a sliced bit may differ only where
the plain soft value is within 1e-5 of the threshold, and R equals the
ds-wide sums of the kernel's own bits exactly.
"""

import contextlib
import ctypes
import dataclasses
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_helpers import random_messages, signals
from webaudio_modem_tpu_torch.models import psk as psk_model
from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams
from webaudio_modem_tpu_torch.ops import fec, fsk_demod, psk
from webaudio_modem_tpu_torch.ops.kernels import (_build, align, cumsum0,
                                                  fsk_framing, fsk_seq,
                                                  psk_seq, viterbi)

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
import chip_smoke as cs  # noqa: E402  (the card's edge cases, shared)

HOST = Path(__file__).resolve().parent / "host_cuda"
NAMES = ("fsk_seq", "fsk_framing", "psk_seq", "cumsum0", "viterbi",
         "align")
LAUNCH = re.compile(r"(\w+(?:<[^<>]*>)?(?:\[[^\]]+\])?)\s*<<<(.*?)>>>\s*\(",
                    re.S)
SHARED = re.compile(r"extern __shared__ ([\w ]+?)\s+(\w+)\[\];")
ATOL = 1e-4
FLIP_SOFT = 1e-5
# K3 is built here with a 16 KiB shared budget (the card's is 112 KiB),
# so that each width's shared / device switch lies at a T the emulation
# runs in seconds: 16 steps at G = 1 to 512 at G = 32
K3_BUDGET = re.compile(r"kSmemBudget = [^;]+;")
HOST_K3_BUDGET = 16 * 1024


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """The kernels' sources, launches and dynamic shared arrays rewritten
    for the emulation, built with g++ (one process per source)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the host emulation needs a C++17 "
                    "compiler")
    out = tmp_path_factory.mktemp("host_kernels")
    for src in _build.CSRC_DIR.iterdir():
        if src.suffix not in (".cu", ".cuh"):
            continue
        text = LAUNCH.sub(r"wam_launch(\1, \2, ", src.read_text())
        text = SHARED.sub(r"\1* \2 = reinterpret_cast<\1*>(wam_smem);", text)
        if src.name == "viterbi.cu":
            text, n = K3_BUDGET.subn(f"kSmemBudget = {HOST_K3_BUDGET};", text)
            assert n == 1, "K3's shared-memory budget moved"
        (out / (src.stem + (".cpp" if src.suffix == ".cu" else ".cuh"))
         ).write_text(text)
    shutil.copy(HOST / "warp_pipe.cuh", out / "warp_pipe.cuh")

    def build(name):
        lib = out / f"lib{name}.so"
        # -ffp-contract=off: no fused multiply-adds, as -fmad=false
        cmd = [gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
               "-shared", "-pthread", "-include", str(HOST / "cuda_shim.h"),
               "-I", str(HOST), "-I", str(out), "-o", str(lib),
               str(out / f"{name}.cpp"), str(HOST / "shim.cpp")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return name, ctypes.CDLL(str(lib))

    with ThreadPoolExecutor(len(NAMES)) as pool:
        return dict(pool.map(build, NAMES))


@pytest.fixture
def on_host(host_libs, monkeypatch):
    """The wrappers launch the emulated kernels on CPU tensors."""
    monkeypatch.setattr(_build, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(_build, "library", lambda name: host_libs[name])
    monkeypatch.setattr(_build, "stream", lambda: ctypes.c_void_p(None))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(viterbi, "SMEM_BUDGET", HOST_K3_BUDGET)


def _bench():
    return FSKParams.from_config(FSKConfig(baud_rate=300, mark_frequency=1270,
                                           space_frequency=1070))


def _signal(params, B, seed, modulate=None, n_bytes=4):
    rng = np.random.default_rng(seed)
    msgs = random_messages(rng, B, n_bytes)
    if modulate is None:
        sig = signals(params, msgs, snr_db=20, rng=rng)
    else:
        sig = modulate.modulate_batch(params, msgs, "cpu").numpy()
    return torch.from_numpy(np.ascontiguousarray(sig)), rng


def _close(label, got, want, softs=None):
    """Floats within ATOL; bits equal but for flips at the threshold."""
    if want is None:
        assert got is None, label
        return
    assert got.shape == want.shape, label
    if want.dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                   rtol=0, err_msg=label)
        return
    flips = (got != want).numpy()
    if softs is not None and flips.any():
        assert np.all(np.abs(softs.numpy()[flips]) < FLIP_SOFT), label
    else:
        assert not flips.any(), label


def _k1_run(params, B, pieces, flags, seed, start=1000):
    """Emulated K1 against plain over pieces carried through one state."""
    sig, rng = _signal(params, B, seed)
    ds = params.ds_samples_per_bit
    state = fsk_demod.init_state(params, B, "cpu")
    front = state.front
    acc = torch.from_numpy(rng.standard_normal((2, B)).astype(np.float32))
    ring0 = torch.from_numpy(
        (rng.random((ds, B)) < 0.5).astype(np.float32)).to(torch.bfloat16)
    ds_phase = 0
    for T in pieces:
        x = sig[:, start:start + T].t().contiguous()
        assert x.shape[0] == T
        args = (params, ds_phase, front, acc,
                ring0 if flags["emit_rsum"] else None, x)
        k = fsk_seq.seq(*args, **flags)
        p = fsk_seq.seq_plain(*args, **flags)
        label = f"T={T} ds_phase={ds_phase}"
        p_softs = p[4] if not flags["emit_csum"] else None
        for name, got, want in zip(("front", "ds_acc", "bits", "amps",
                                    "softs", "rsum"), k, p):
            if name == "rsum":
                continue
            _close(f"{label} {name}", got, want, p_softs)
        if flags["emit_rsum"] and ds <= 256 and k[2] is not None:
            ext = torch.cat([ring0.float(), k[2].float()])
            cs = torch.cumsum(ext, 0)
            assert torch.equal(cs[ds:] - cs[:-ds], k[5].float()), label
        front, acc = k[0], k[1]
        if k[2] is not None:
            ring0 = torch.cat([ring0, k[2]])[-ds:].contiguous()
        ds_phase = (ds_phase + T) % params.downsample_ratio
        start += T


@pytest.mark.parametrize("mode", range(16))
def test_k1_stream_modes(on_host, mode):
    """Every stream flag combination at B = 33 (a partial block of the
    five-warp pipeline) over pieces opening a group (T = 1), closing it
    (T < the 32-sample tile), empty, and crossing tiles."""
    flags = dict(emit_bits=bool(mode & 1), emit_amps=bool(mode & 2),
                 emit_csum=bool(mode & 4), emit_rsum=bool(mode & 8))
    _k1_run(FSKParams.from_config(FSKConfig()), 33, (1, 17, 0, 70), flags,
            seed=mode)


ALL_STREAMS = dict(emit_bits=True, emit_amps=True, emit_csum=False,
                   emit_rsum=True)


@pytest.mark.parametrize("case", ["B1", "B64_two_blocks", "ratio3", "K7",
                                  "ds480_with_R", "no_agc"])
def test_k1_edges(on_host, case):
    bench = _bench()
    p50 = FSKParams.from_config(FSKConfig(baud_rate=50, mark_frequency=1270,
                                          space_frequency=1070))
    runs = {
        "B1": (bench, 1, (1, 31, 32, 33, 100), ALL_STREAMS),
        "B64_two_blocks": (bench, 64, (129, 3), ALL_STREAMS),
        # the group logic at a ratio the configurations do not use
        "ratio3": (dataclasses.replace(
            FSKParams.from_config(FSKConfig()), downsample_ratio=3), 9,
            (100, 2, 1, 50), ALL_STREAMS),
        "K7": (p50, 7, (60, 101), dict(ALL_STREAMS, emit_rsum=False)),
        "ds480_with_R": (p50, 3, (60, 41), ALL_STREAMS),
        "no_agc": (FSKParams.from_config(FSKConfig(agc_enabled=False)), 9,
                   (100, 33), ALL_STREAMS),
    }
    params, B, pieces, flags = runs[case]
    _k1_run(params, B, pieces, flags, seed=len(case),
            start=5000 if params is p50 else 1000)


@pytest.mark.parametrize("B,T", [(37, 4801), (1, 999)])
def test_k2_k8_exact(on_host, B, T):
    """K2 and K8 equal their plain versions exactly on real planes with
    syncs and bytes, at an odd B, an odd n_ds (a partial 16-step tile),
    and with the bits plane at an odd element offset (rows of its words
    misaligned), the state carried chunk to chunk."""
    params = _bench()
    sig, _ = _signal(params, B, seed=B, n_bytes=2)
    ds = params.ds_samples_per_bit
    state = fsk_demod.init_state(params, B, "cpu")
    fires = n_bytes = ds_phase = 0
    for pos in range(0, sig.shape[1], T):
        x = sig[:, pos:pos + T]
        front, acc, bits, amps, softs, rsum = fsk_seq.seq_plain(
            params, ds_phase, state.front, state.ds_acc,
            state.bit_tail[-ds:], x.t().contiguous())
        ratios = fsk_demod._sync_ratios_from_r(params, state.r_tail, rsum)
        ints, flts = fsk_demod._framing_carry(params, state)
        n = bits.shape[0]
        odd = torch.cat([torch.zeros((1, B), dtype=torch.bfloat16),
                         bits])[1:]
        assert odd.storage_offset() == B
        for plane in (bits, odd):
            args = (params, ints, flts, state.bit_fill, plane, amps, ratios,
                    torch.cat([state.amp_tail, amps]))
            maxb = fsk_demod.max_bytes(params, n)
            k = fsk_framing.stage_d_compact(*args, maxb)
            p = fsk_framing.stage_d_compact_plain(*args, maxb)
            for got, want in zip(k, p):
                assert torch.equal(got, want)
            k8 = fsk_framing.stage_d(*args)
            p8 = fsk_framing.stage_d_plain(*args)
            for got, want in zip(_flat(k8), _flat(p8)):
                assert torch.equal(got, want)
        fires += int(k[5].sum())
        n_bytes += int(k[3].sum())
        state, _ = fsk_demod.sync_and_frame(params, state, bits, amps, softs,
                                            rsum, plain=True, front=front,
                                            ds_acc=acc)
        ds_phase = (ds_phase + x.shape[1]) % params.downsample_ratio
    assert fires == B and n_bytes == 2 * B


@pytest.mark.parametrize("case", [c[0] for c in cs.FRAMING_EDGE_CASES])
def test_k2_k8_edges(on_host, case):
    """K2 and K8 (the two output modes of fsk_framing.cu) equal their
    plain versions exactly at ``chip_smoke.FRAMING_EDGE_CASES``, which
    the card holds too: B = 1001 and 1 with the bits plane one element
    past alignment, n_ds = 0, 1 and 17, a fire in a partial last tile, a
    counter a few steps below its wrap (the carried quarter phase), sil
    at 2^24 - 3 on a silent stream and an EOD after 559.3 steps (the
    integer EOD compare against its ceiling); compact(K8)
    equals K2 and two halves chained through the carry equal one call.
    Each wrapper launches once a call."""
    params, args = cs._framing_case(case, torch.device("cpu"))
    need = next(c[5] for c in cs.FRAMING_EDGE_CASES if c[0] == case)
    before = (fsk_framing.launches, fsk_framing.stage_d_launches)
    err, events = cs._framing_check(params, args, case)
    halves = 2 if args[3].shape[0] > 1 else 0
    assert (fsk_framing.launches, fsk_framing.stage_d_launches) == (
        before[0] + 1, before[1] + 1 + halves)
    assert err == 0.0
    assert all(events[k] for k in need), events


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


K6_CASES = {
    # name: (config overrides, B, pieces, emit_rsum, first ds_phase)
    "B33": ({}, 33, (63, 40), True, 0),
    "B1": ({}, 1, (63, 40), True, 0),
    "T0_1_17": ({}, 33, (1, 17, 0, 63), True, 0),
    "ds_phase1": ({}, 9, (40, 33), True, 1),
    # D = 5: the delayed sample lies in the same G tile
    "D5_below_a_G_tile": ({"baud_rate": 4800}, 33, (70, 3, 40), True, 0),
    "D480_no_R": ({"baud_rate": 50}, 9, (60, 41), False, 0),
    # D = 960 > SHARED_RING_MAX_D: the rings in the ring_out plane, with
    # lanes past B that must not touch lane B - 1's ring
    "D960_device_rings": ({"baud_rate": 50, "sample_rate": 96000}, 3,
                          (60, 41), False, 0),
}


@pytest.mark.parametrize("case", list(K6_CASES))
def test_k6_shared_front_end(on_host, case):
    """K6 (seq_pipe.cuh's warps 0 and 1, then its ring and atan2f warps):
    bits, rings and R exactly, floats within ATOL, state carried over the
    pieces (a ds_phase prefix after an odd piece), at partial blocks,
    empty and one-sample pieces, a delay shorter than a G tile, and both
    ring placements."""
    overrides, B, pieces, emit_rsum, ds_phase = K6_CASES[case]
    params = psk_model.params_from_config(psk_model.PSKConfig(**overrides))
    D = params.ds_samples_per_bit
    if case == "D960_device_rings":
        assert D > psk_seq.SHARED_RING_MAX_D
    sig, rng = _signal(params, B, seed=6, modulate=psk)
    state = psk.init_state(params, B, "cpu")
    front = state.front
    acc = torch.from_numpy(rng.standard_normal((2, B)).astype(np.float32))
    ring = torch.from_numpy(rng.standard_normal((2 * D, B)).astype(
        np.float32))
    # inside the messages, away from the lead silence
    start = min(1000 if D <= 20 else 5000, sig.shape[1] - sum(pieces))
    for T in pieces:
        x = sig[:, start:start + T].t().contiguous()
        assert x.shape[0] == T
        ring0 = torch.from_numpy(
            (rng.random((D, B)) < 0.5).astype(np.float32)).to(torch.bfloat16)
        args = (params, ds_phase, front, acc, ring,
                ring0 if emit_rsum else None, x)
        k = psk_seq.seq(*args, emit_rsum=emit_rsum)
        p = psk_seq.seq_plain(*args, emit_rsum=emit_rsum)
        label = f"T={T} ds_phase={ds_phase}"
        for name, got, want in zip(("front", "ds_acc", "ring", "bits",
                                    "amps", "softs", "rsum"), k, p):
            if name in ("ring", "bits", "rsum"):
                assert (got is None and want is None) or \
                    torch.equal(got, want), f"{label} {name}"
            else:
                _close(f"{label} {name}", got, want)
        front, acc, ring = k[0], k[1], k[2]
        ds_phase = (ds_phase + T) % params.downsample_ratio
        start += T


def _np_csum0(x):
    out = np.zeros((x.shape[0] + 1, x.shape[1]), np.float32)
    np.cumsum(x, axis=0, out=out[1:])
    return out


K5_CASES = {
    # name: (ring rows, B, window start, window rows, base offset in floats)
    "n0": (0, 5, 0, 0, 0),
    "n1_B1": (1, 1, 0, 1, 0),
    "n37_B3": (37, 3, 0, 37, 0),
    # 300 rows: two whole 128-row stages and a partial one; B = 33: a
    # partial block, rows misaligned for 16-byte copies
    "n300_B33": (300, 33, 0, 300, 0),
    "long_B3": (2000, 3, 0, 2000, 0),
    "n37_B4097": (37, 4097, 0, 37, 0),
    # a base pointer that is only 4-byte aligned
    "unaligned_base_B64": (200, 64, 0, 200, 1),
    # a window that wraps past the ring's last row, at an odd B
    "ring_wrap_B7": (600, 7, 500, 300, 0),
    "ring_wrap_B32": (640, 32, 384, 512, 0),
    "ring_view_B33": (700, 33, 123, 400, 3),
}


@pytest.mark.parametrize("case", list(K5_CASES))
def test_k5_exact(on_host, case):
    """K5 (producer warp copying stages ahead, consumer warp adding in row
    order) equals its plain version and np.cumsum of the window exactly,
    at empty, one-row, partial-stage and long windows, partial blocks,
    misaligned rows and bases, and windows that wrap the ring."""
    rows, B, start, n, offset = K5_CASES[case]
    rng = np.random.default_rng(rows + B)
    flat = rng.standard_normal(offset + rows * B).astype(np.float32)
    ring = torch.from_numpy(flat)[offset:].view(rows, B)
    assert ring.data_ptr() % 16 == 4 * offset % 16
    got = cumsum0.csum0(ring, start, n)
    want = cumsum0.csum0_plain(ring, start, n)
    assert got.shape == (n + 1, B)
    assert torch.equal(got, want)
    window = np.concatenate([flat[offset:].reshape(rows, B)[start:],
                             flat[offset:].reshape(rows, B)])[:n]
    np.testing.assert_array_equal(got.numpy(), _np_csum0(window))


def test_host_warp_pipe_mirrors_the_card_header():
    """The emulated hand-over primitives are the card header's, name for
    name: a primitive added or removed in one copy fails here."""
    prim = re.compile(r"\bvoid\s+(\w+)\s*\(")
    card = prim.findall((_build.CSRC_DIR / "warp_pipe.cuh").read_text())
    host = prim.findall((HOST / "warp_pipe.cuh").read_text())
    assert card and sorted(card) == sorted(host)


def test_host_shim_emulates_every_cuda_call_of_csrc():
    """Every CUDA call of a kernel source (``__shfl_sync``,
    ``__ballot_sync``, ``cudaFuncSetAttribute``, ...) is one that
    ``cuda_shim.h`` emulates: a primitive a kernel starts to use fails
    here until the emulation has it.  ``warp_pipe.cuh`` has a host copy
    of its own (the test above)."""
    call = re.compile(r"\b(__\w+|cuda[A-Z]\w*)\s*\(")
    shim = (HOST / "cuda_shim.h").read_text()
    emulated = set(re.findall(r"\b(__\w+|cuda[A-Z]\w*)\b", shim))
    used = {}
    for src in _build.CSRC_DIR.iterdir():
        if src.suffix not in (".cu", ".cuh") or src.name == "warp_pipe.cuh":
            continue
        code = re.sub(r"//[^\n]*|/\*.*?\*/", "", src.read_text(), flags=re.S)
        for name in call.findall(code):
            used.setdefault(name, src.name)
    assert {"__shfl_sync", "__ballot_sync"} <= set(used)
    missing = {n: f for n, f in used.items() if n not in emulated}
    assert not missing, f"not emulated in cuda_shim.h: {missing}"


# -- K3 ----------------------------------------------------------------------
# The edge cases and their inputs are chip_smoke.py's, which holds the
# same cases on the card.

def _k3_case(case, threads):
    """K3 edge case ``case`` at ``threads`` threads a trellis, reached
    through ``pick`` by L and T, against the plain version bit for bit;
    returns whether its records were in shared memory."""
    L, T, layout, ties = cs._k3_edge(case, threads)
    shared = T <= viterbi.shared_max_steps(threads)
    assert viterbi.pick(L, T) == (threads, shared)
    rng = np.random.default_rng(T * 64 + threads)
    soft = cs._k3_soft(rng, L, T, layout, ties, torch.device("cpu"))
    if layout == "body":                      # a view of [2T, L], no copy
        assert soft.stride() == (1, 2 * L, L)
    n_bits = max(T - fec.K + 1, 0)
    want = viterbi.decode_plain(*viterbi.branch_sums(soft), n_bits)
    before = viterbi.launches
    got = viterbi.decode(soft, n_bits)
    assert viterbi.launches == before + 1
    assert got.shape == want.shape == (L, n_bits)
    assert torch.equal(got, want)
    return shared


@pytest.mark.parametrize("threads", viterbi.GROUPS)
@pytest.mark.parametrize("case", [c[0] for c in cs.K3_EDGE_CASES
                                  if isinstance(c[1], int)])
def test_k3_edges(on_host, case, threads):
    """K3 at every width its wrapper picks equals the plain version bit
    for bit, reached through ``pick`` by L and T: T = 1, 15, 16, 17
    (around one normalization period), 38 (the header) and 40 with
    near-ties; L from the first lane count of the width, partial blocks
    and one short of a block, both soft-view layouts; records where the
    wrapper puts them (past the switch of the emulation's small budget,
    device memory)."""
    _k3_case(case, threads)


@pytest.mark.parametrize("threads", viterbi.GROUPS)
def test_k3_record_placements(on_host, threads):
    """Both placements of the decision records at the switch, as ``pick``
    chooses them: the longest trellis that fits the emulation's shared
    budget, then one step more (device memory)."""
    assert _k3_case("shared_switch", threads)
    assert not _k3_case("past_the_switch", threads)


@pytest.mark.parametrize("L,T,threads,shared", [
    (32768, 38, 1, True),        # the header candidates at B = 4096
    (8192, 113, 1, False),
    (8191, 38, 8, True),         # one lane below G = 1
    (4096, 150, 8, True),        # the bodies
    (2048, 822, 8, True),        # payload-100 bodies
    (768, 897, 8, False),
    (767, 150, 32, True),        # one lane below G = 8
    (8, 38, 32, True),           # a few lanes
    (61, 38, 32, True),          # SoftFrameDecoder's header candidates
    (1, 150, 32, True),          # its 16-byte body
    (4, 2062, 32, True),         # the blind receiver's longest body
    (1, 3585, 32, False)])
def test_k3_pick(L, T, threads, shared):
    """The wrapper's choice: one thread a trellis for many lanes, 8 below,
    32 for a few; records in shared memory while they fit."""
    assert viterbi.pick(L, T) == (threads, shared)
    assert shared == (T <= viterbi.shared_max_steps(threads))


def test_k3_through_viterbi_core(on_host):
    """``fec._viterbi_core`` hands the kernel a batch of soft views in
    place, with the batch shape kept."""
    rng = np.random.default_rng(9)
    soft = torch.from_numpy(rng.standard_normal((2, 3, 38, 2)).astype(
        np.float32))
    got = fec._viterbi_core(soft, 32)
    a, d = viterbi.branch_sums(soft)
    want = viterbi.decode_plain(a, d, 32).reshape(2, 3, 32)
    assert torch.equal(got, want)


# -- K4 ----------------------------------------------------------------------

@pytest.mark.parametrize("case", list(cs.K4_EDGE_CASES))
def test_k4_exact(on_host, case):
    """K4 equals its plain version exactly: stride 1 and ds (chains) and a
    stride that does not divide ds, ``virt0`` on and off, ``pad_lo`` > 0,
    bases inside, at both plane edges and past them, n_wsum <= 0, B = 1,
    odd B and two blocks of channels."""
    n_rows, B = cs.K4_EDGE_CASES[case][:2]
    rng = np.random.default_rng(n_rows + B)
    csum, kw, bases = cs._k4_case(rng, case, torch.device("cpu"))
    for base in bases:
        want = align.aligned_wsum_plain(csum, base, **kw)
        before = align.launches
        got = align.aligned_wsum(csum, base, **kw)
        assert align.launches == before + 1
        assert torch.equal(got, want), (case, base[:4])
