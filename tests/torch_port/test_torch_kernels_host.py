"""The CUDA sources of K1 / K7, K2, K8 and K6 built for the CPU with g++
over a host emulation of CUDA (``host_cuda/``), against their plain
versions, through the port's own wrappers.

The card is the only place a kernel is timed or held exactly to its
plain version (``chip_smoke.py``).  Here the emulation runs each block's
threads as threads of the host, so the warp-specialised pipelines' hand
over (named barriers, cp.async copies that land only at their wait) and
their edges (partial blocks, partial tiles, T = 0, odd B, a misaligned
bits plane) are exercised by the CPU suite: a barrier that never
completes fails the launch instead of hanging.

Tolerances: K2 and K8 exactly (integer state machine and IEEE f32
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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_helpers import random_messages, signals
from webaudio_modem_tpu_torch.models import psk as psk_model
from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams
from webaudio_modem_tpu_torch.ops import fsk_demod, psk
from webaudio_modem_tpu_torch.ops.kernels import (_build, fsk_framing,
                                                  fsk_seq, psk_seq)

HOST = Path(__file__).resolve().parent / "host_cuda"
NAMES = ("fsk_seq", "fsk_framing", "fsk_stage_d", "psk_seq")
LAUNCH = re.compile(r"(\w+(?:<[^<>]*>)?(?:\[[^\]]+\])?)\s*<<<(.*?)>>>\s*\(",
                    re.S)
SHARED = re.compile(r"extern __shared__ ([\w ]+?)\s+(\w+)\[\];")
ATOL = 1e-4
FLIP_SOFT = 1e-5


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


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def test_k6_shared_front_end(on_host):
    """K6 through the split front end of seq_front.cuh: bits, rings and R
    exactly, floats within ATOL, state carried over a ds_phase prefix."""
    params = psk_model.params_from_config(psk_model.PSKConfig())
    B, D = 33, params.ds_samples_per_bit
    sig, rng = _signal(params, B, seed=6, modulate=psk)
    state = psk.init_state(params, B, "cpu")
    front, acc = state.front, state.ds_acc
    ring = torch.from_numpy(rng.standard_normal((2 * D, B)).astype(
        np.float32))
    ds_phase, start = 0, 1000
    for T in (63, 40):
        x = sig[:, start:start + T].t().contiguous()
        ring0 = torch.from_numpy(
            (rng.random((D, B)) < 0.5).astype(np.float32)).to(torch.bfloat16)
        args = (params, ds_phase, front, acc, ring, ring0, x)
        k = psk_seq.seq(*args)
        p = psk_seq.seq_plain(*args)
        for name, got, want in zip(("front", "ds_acc", "ring", "bits",
                                    "amps", "softs", "rsum"), k, p):
            if name in ("ring", "bits", "rsum"):
                assert torch.equal(got, want), name
            else:
                _close(name, got, want)
        front, acc, ring = k[0], k[1], k[2]
        ds_phase = (ds_phase + T) % params.downsample_ratio
        start += T


def test_host_warp_pipe_mirrors_the_card_header():
    """The emulated hand-over primitives are the card header's, name for
    name: a primitive added or removed in one copy fails here."""
    prim = re.compile(r"\bvoid\s+(\w+)\s*\(")
    card = prim.findall((_build.CSRC_DIR / "warp_pipe.cuh").read_text())
    host = prim.findall((HOST / "warp_pipe.cuh").read_text())
    assert card and sorted(card) == sorted(host)
