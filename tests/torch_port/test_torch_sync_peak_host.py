"""The sync-peak kernel (``csrc/sync_peak.cu``) built for the CPU with g++
over the host emulation of CUDA (``host_cuda/``, built as
``test_torch_kernels_host.py`` builds the other kernels), against
``sync_peak_plain`` through the port's own wrapper, exactly: t_peak and
the gate bit for bit, ties included.

R planes here are what K1 emits, integers in [0, ds]: random, with
planted patterns, with peaks tied on purpose (the first t wins, across
phases, steps and time segments), at the gate's exact threshold, at
every edge of the kernel's split (segments and their halos, ring and
sub-chunk boundaries, a partial last block of ds steps), in both lanes
(the reference's pattern by its recurrence, two channels in fp16; any
pattern summed directly, one channel in f32).
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from test_torch_kernels_host import build_host_libs
from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams
from webaudio_modem_tpu_torch.ops.kernels import _build, sync_peak

PARAMS = FSKParams.from_config(FSKConfig())     # the frames cell's PHY
DS = PARAMS.ds_samples_per_bit                  # 20
SIGNS, N_ZERO = sync_peak._signs(PARAMS)         # 29 taps, 12 of -1
THRESHOLD = float(np.float32(PARAMS.config.sync_threshold))


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return build_host_libs(tmp_path_factory.mktemp("host_sync_peak"),
                           ("sync_peak",))["sync_peak"]


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """The wrapper launches the emulated kernel on CPU tensors."""
    monkeypatch.setattr(_build, "use_kernel", lambda *tensors: True)
    monkeypatch.setattr(_build, "library", lambda name: host_lib)
    monkeypatch.setattr(_build, "stream", lambda: ctypes.c_void_p(None))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())


def _plane(r):
    return torch.from_numpy(np.ascontiguousarray(r, np.float32)).bfloat16()


def _frames(rng, n_ds, B, flip=0.05):
    """R of random bits with the pattern planted once a channel at a
    random t (every fourth channel none), ``flip`` of the bits flipped:
    peaks on both sides of the gate."""
    n_pat = len(PARAMS.pattern_bits)
    bits = rng.integers(0, 2, (n_ds + DS, B))
    for b in range(B):
        if b % 4 == 3 or n_ds < n_pat * DS:
            continue
        at = int(rng.integers(0, n_ds - n_pat * DS + 1))
        bits[DS + at:DS + at + n_pat * DS, b] = np.repeat(
            PARAMS.pattern_bits, DS)
    bits ^= rng.random(bits.shape) < flip
    csum = np.concatenate([np.zeros((1, B)), np.cumsum(bits, 0)])
    return csum[DS + 1:] - csum[1:-DS]               # ds-wide sums


def _check(R, fast=None, segments=None):
    """One launch equals the plain version, bit for bit."""
    before = sync_peak.launches
    t, ok = sync_peak._launch(PARAMS, R, fast, segments)
    assert sync_peak.launches == before + 1
    t_plain, ok_plain = sync_peak.sync_peak_plain(PARAMS, R)
    assert t.dtype == torch.int64 and ok.dtype == torch.bool
    assert torch.equal(t, t_plain)
    assert torch.equal(ok, ok_plain)
    return t, ok


@pytest.mark.parametrize("B", [1, 2, 33, 34])
def test_the_cells_pattern_at_small_batches(on_host, B):
    """Planted frames at 5 % flipped bits: both lanes where B is even,
    the f32 lane alone where it is odd."""
    rng = np.random.default_rng(B)
    R = _plane(_frames(rng, 1500, B))
    lanes = (False, True) if B % 2 == 0 else (None,)
    assert sync_peak._fast(PARAMS, R) == (B % 2 == 0)
    for fast in lanes:
        _, ok = _check(R, fast)
    if B >= 33:
        assert 0 < int(ok.sum()) < B           # both sides of the gate


@pytest.mark.parametrize("n_ds", [1, 7, 19, 20, 21, 579, 601, 1013])
def test_short_and_ragged_planes(on_host, n_ds):
    """n_ds shorter than one ds-block, than W - ds, and not a multiple of
    ds: the last block of steps is partial in some phases."""
    rng = np.random.default_rng(n_ds)
    R = _plane(_frames(rng, n_ds, 6, flip=0.0))
    for fast in (False, True):
        _check(R, fast)


def test_all_zero_R_ties_everywhere(on_host):
    """Every ratio ties at n_zero ds / W: t_peak is 0 for every channel,
    under the gate."""
    R = _plane(np.zeros((997, 34)))
    for fast, segments in ((True, None), (False, 3)):
        t, ok = _check(R, fast, segments)
        assert not t.any() and not ok.any()


@pytest.mark.parametrize("period", [647, 660])
def test_equal_peaks_the_first_wins(on_host, period):
    """Each channel's bits repeat with ``period`` (the pattern, then
    random bits), so every peak has equals one, two, three periods
    later: in another phase (647) or the same (660), in another time
    segment where there are several."""
    rng = np.random.default_rng(period)
    n_pat = len(PARAMS.pattern_bits)
    B = 4
    block = rng.integers(0, 2, (period, B))
    block[DS:DS + n_pat * DS] = np.repeat(PARAMS.pattern_bits, DS)[:, None]
    bits = np.concatenate([np.zeros((DS, B), np.int64),
                           np.tile(block, (4, 1))])
    csum = np.concatenate([np.zeros((1, B)), np.cumsum(bits, 0)])
    R = _plane(csum[DS:] - csum[:-DS])
    for fast, segments in ((True, 1), (True, 5), (False, 5)):
        t, ok = _check(R, fast, segments)
        assert ok.all()
        assert (t < DS + period + n_pat * DS).all()


def _one_peak(n_ds, B, peaks):
    """R zero but for one phase of each channel: at t_b, the positive
    taps sum to ``peaks[b]`` (matched = that + n_zero ds), a unique
    maximum."""
    R = np.zeros((n_ds, B))
    plus = [j for j, s in enumerate(SIGNS, 1) if s > 0]
    where = []
    for b, total in enumerate(peaks):
        t = n_ds - 1 - 37 * b
        left = total
        for j in plus:
            R[t - j * DS, b] = min(DS, left)
            left -= R[t - j * DS, b]
        assert left == 0
        where.append(t)
    return R, where


def test_the_gate_at_its_exact_threshold(on_host):
    """matched 510 reads 510 / 600 = 0.85 = the threshold in f32: not
    over it; 511 is; and a peak far below and far above."""
    assert N_ZERO * DS == 240 and PARAMS.sync_window == 600
    R, where = _one_peak(1200, 4, [270, 271, 100, 340])
    for fast in (False, True):
        t, ok = _check(_plane(R), fast)
        assert t.tolist() == where
        assert ok.tolist() == [False, True, False, True]


def test_the_cards_plain_gate_agrees():
    """On the card the plain version divides by W as a multiply by the
    f32 reciprocal (PyTorch's CUDA `div` by a scalar), which rounds 350
    of the 1201 counts 0..1200 apart from the IEEE division the kernel
    and the CPU take: none of them crosses the cell's threshold, so the
    card test's equality holds for every count a peak can have."""
    m = torch.arange(0, 2 * PARAMS.sync_window + 1, dtype=torch.float32)
    div = m / PARAMS.sync_window
    recip = m * torch.tensor(1.0 / np.float32(PARAMS.sync_window),
                             dtype=torch.float32)
    assert (div != recip).any()
    assert torch.equal(div > THRESHOLD, recip > THRESHOLD)


@pytest.mark.parametrize("segments", [2, 7])
def test_segment_and_halo_edges(on_host, segments):
    """Peaks at the first and the last step of a time segment (the
    first read whole from the halo) and at the plane's last step, and
    random frames, at forced
    segment counts; and the wrapper's own split over a plane long enough
    to take several segments."""
    n_ds = 2 * sync_peak.MIN_SEGMENT * DS + 333
    n_tau = -(-n_ds // DS)
    seg = -(-n_tau // segments)
    rng = np.random.default_rng(segments)
    R = _frames(rng, n_ds, 8)
    R[:, :4] = 0
    taus = (seg, seg - 1, n_tau - 1, seg + 31)
    for b, tau in enumerate(taus):
        R[:, b] = 0
        for j, s in enumerate(SIGNS, 1):
            if s > 0:
                R[(tau - j) * DS + b, b] = DS
    R = _plane(R)
    for fast in (False, True):
        t, _ = _check(R, fast, segments)
        assert t[:4].tolist() == [tau * DS + b for b, tau in
                                  enumerate(taus)]
    assert sync_peak._segments(n_tau, 20)[1] == 2
    _check(R)


def test_other_patterns_and_phases_take_the_f32_lane(on_host,
                                                    monkeypatch):
    """A 32-tap pattern (even parity) and ds = 80 (300 baud): past the
    fast lane (another pattern; sums past fp16's exact integers), the f32
    lane (63 taps) at an even B; and the kernel refuses its fast lane to
    another pattern even where the host would ask for it."""
    for cfg in (FSKConfig(parity="even"),
                FSKConfig(baud_rate=300, mark_frequency=1270,
                          space_frequency=1070)):
        params = FSKParams.from_config(cfg)
        ds = params.ds_samples_per_bit
        rng = np.random.default_rng(ds)
        R = _plane(rng.integers(0, ds + 1, (40 * ds + 3, 6)))
        assert not sync_peak._fast(params, R)
        before = sync_peak.launches
        t, ok = sync_peak.sync_peak(params, R)
        assert sync_peak.launches == before + 1
        t_plain, ok_plain = sync_peak.sync_peak_plain(params, R)
        assert torch.equal(t, t_plain) and torch.equal(ok, ok_plain)
    parity = FSKParams.from_config(FSKConfig(parity="even"))
    monkeypatch.setattr(sync_peak, "_fast", lambda params, rsum: True)
    with pytest.raises(RuntimeError, match="sync_peak"):
        sync_peak.sync_peak(parity, R)


def test_the_fast_lanes_pattern_is_the_kernels():
    """The host's reference pattern (``FSKConfig``'s) is the one the
    fast lane is compiled for (``kRefPlus``, ``kRefTaps``), and its
    recurrence keeps 11 of 30 terms at sigma -1, summing within 980 at
    the cell's ds = 20."""
    src = (_build.CSRC_DIR / "sync_peak.cu").read_text()
    plus = sum(1 << j for j, s in enumerate(SIGNS, 1) if s > 0)
    assert f"kRefPlus = {plus:#x}ull;" in src
    assert f"kRefTaps = {len(SIGNS)};" in src
    sigma, coefs = sync_peak._recurrence(SIGNS)
    assert sigma == -1 and sum(c != 0 for c in coefs) == 11
    assert (len(SIGNS) + sum(map(abs, coefs))) * DS == 980


def test_what_the_kernel_cannot_take_raises(on_host):
    """No R plane, R not bf16, not contiguous, no rows, the fast lane at
    an odd B, a pattern of more than 63 taps."""
    R = _plane(np.zeros((100, 6)))
    before = sync_peak.launches
    with pytest.raises(ValueError, match="no R plane"):
        sync_peak.sync_peak(PARAMS, None)
    with pytest.raises(TypeError):
        sync_peak.sync_peak(PARAMS, R.float())
    with pytest.raises(ValueError, match="contiguous"):
        sync_peak.sync_peak(PARAMS, R[:, ::2])
    with pytest.raises(ValueError, match="no rows"):
        sync_peak.sync_peak(PARAMS, R[:0])
    with pytest.raises(ValueError, match="fast lane"):
        sync_peak._launch(PARAMS, R[:, :5].contiguous(), fast=True)
    long = FSKParams.from_config(FSKConfig(preamble_pattern=(0x55,) * 6))
    with pytest.raises(ValueError, match="63"):
        sync_peak.sync_peak(long, R)
    assert sync_peak.launches == before


def test_cpu_tensors_run_the_plain_version():
    """Without the emulation a CPU tensor takes the plain version, and
    no launch is counted."""
    R = _plane(_frames(np.random.default_rng(0), 800, 3))
    before = sync_peak.launches
    t, ok = sync_peak.sync_peak(PARAMS, R)
    t_plain, ok_plain = sync_peak.sync_peak_plain(PARAMS, R)
    assert torch.equal(t, t_plain) and torch.equal(ok, ok_plain)
    assert sync_peak.launches == before
