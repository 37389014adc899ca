"""Sync-threshold and reconfiguration behaviour, through stage D: the
reference's ``tests/modems/test_fsk_sync_config.py`` in both packages on
the same inputs, with the reference's assertions and the port's decodes
and sync counts equal to the JAX package's.

Each sample of audio costs ~0.3 ms on the CPU here (K1's plain version,
whatever B), so cases whose channels are independent share one batch:
the 300-baud transmissions at the default threshold are the channels of
one farm call, and the threshold sweep runs K1 once (it does not read
the sync threshold) and stages C and D (``fsk_demod.sync_and_frame``)
once per threshold, as ``demod_chunk`` composes them.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import configs
from webaudio_modem_tpu.models.farm import ModemFarm as JaxFarm
from webaudio_modem_tpu.models.fsk import FSKCore as JaxCore
from webaudio_modem_tpu_torch.models.config import FSKConfig
from webaudio_modem_tpu_torch.models.farm import ModemFarm
from webaudio_modem_tpu_torch.models.fsk import FSKCore
from webaudio_modem_tpu_torch.ops import fsk_demod
from webaudio_modem_tpu_torch.ops.kernels import fsk_seq

SYNC300 = dict(baud_rate=300, mark_frequency=1650, space_frequency=1850,
               sync_threshold=0.85)
THRESHOLDS = (0.7, 0.75, 0.8, 0.85, 0.9)
# the farm's channels at SYNC300: the pattern alone, then data full of
# 0x55 (the preamble's byte)
FARM_DATA = (b"\x48", bytes([0x55, 0x55, 0x48]))


def _stack(signals):
    """[B, T] f32, each row a signal padded with silence to the longest."""
    T = max(len(s) for s in signals)
    return np.stack([np.pad(np.asarray(s, np.float32), (0, T - len(s)))
                     for s in signals])


@pytest.fixture(scope="module")
def sync300_farm():
    """FARM_DATA through ModemFarm at SYNC300 in both packages: (port
    bytes, port sync counts, reference bytes, reference sync counts)."""
    pc, jc, _, _ = configs(**SYNC300)
    core = FSKCore(pc, device="cpu")
    x = _stack([core.modulate_data(d) for d in FARM_DATA])
    farm, ref = ModemFarm(pc, len(x), device="cpu"), \
        JaxFarm(jc, len(x), donate=False)
    got, want = farm.demodulate(x), ref.demodulate(x)
    return (got, farm.get_status()["sync_detections"].tolist(), want,
            np.asarray(ref.get_status()["sync_detections"]).tolist())


def test_detects_pattern_in_clean_signal_300baud(sync300_farm):
    got, syncs, want, ref_syncs = sync300_farm
    assert got[0] == want[0] == FARM_DATA[0]
    assert syncs[0] == ref_syncs[0] == 1


def test_preamble_like_data_bytes(sync300_farm):
    """Data full of 0x55 must not confuse sync."""
    got, syncs, want, ref_syncs = sync300_farm
    assert got[1] == want[1] == FARM_DATA[1]
    assert syncs[1] == ref_syncs[1] == 1


def _port_per_threshold(overrides, thresholds, x):
    """Decoded bytes and sync counts of [B, T] samples ``x`` at each sync
    threshold: one plain K1 pass, then stages C and D per threshold, each
    threshold with its own state (the arithmetic of one whole-signal
    ``demod_chunk`` per threshold)."""
    params = [configs(**dict(overrides, sync_threshold=s))[2]
              for s in thresholds]
    B = x.shape[0]
    state = fsk_demod.init_state(params[0], B, "cpu")
    ds = params[0].ds_samples_per_bit
    front, acc, bits, amps, softs, rsum = fsk_seq.seq_plain(
        params[0], 0, state.front, state.ds_acc, state.bit_tail[-ds:],
        torch.from_numpy(x).t().contiguous())
    out = []
    for p in params:
        st, o = fsk_demod.sync_and_frame(p, state, bits, amps, softs, rsum,
                                         front=front, ds_acc=acc)
        counts = o.byte_count.tolist()
        out.append(([bytes(o.bytes_out[b, :counts[b]].numpy())
                     for b in range(B)], st.sync_count.tolist()))
    return out


@pytest.fixture(scope="module")
def sweep():
    """b"\\x48" at every threshold of THRESHOLDS and b"\\x42" at 0.99 (an
    unreachable threshold: the reference's j == 0 quirk caps the ratio
    at (n - 1) / n), in both packages, by threshold: (port bytes, port
    syncs, reference bytes, reference syncs) of each channel."""
    pc, _, _, _ = configs(**SYNC300)
    core = FSKCore(pc, device="cpu")
    x = _stack([core.modulate_data(b"\x48"), core.modulate_data(b"\x42")])
    thresholds = THRESHOLDS + (0.99,)
    port = _port_per_threshold(SYNC300, thresholds, x)
    out = {}
    for s, (got, syncs) in zip(thresholds, port):
        jc = configs(**dict(SYNC300, sync_threshold=s))[1]
        ref = JaxFarm(jc, len(x), donate=False)
        want = ref.demodulate(x)
        out[s] = (got, syncs, want,
                  np.asarray(ref.get_status()["sync_detections"]).tolist())
    return out


@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_threshold_sweep(sweep, threshold):
    """If anything decodes it must be correct; 0.9 legitimately fails to
    sync (the j == 0 quirk caps the reachable ratio), the reference's
    default region (<= 0.85) must decode."""
    got, syncs, want, ref_syncs = sweep[threshold]
    assert got[0] == want[0] and syncs[0] == ref_syncs[0]
    if got[0]:
        assert got[0][0:1] == b"\x48"
    if threshold <= 0.85:
        assert got[0] == b"\x48"


def test_impossible_threshold_never_syncs(sweep):
    got, syncs, want, ref_syncs = sweep[0.99]
    assert got[1] == want[1] == b""
    assert syncs[1] == ref_syncs[1] == 0


def test_sweep_composition_equals_the_farm(sweep, sync300_farm):
    """The sweep's composed path at 0.85 decodes as ModemFarm does."""
    got, syncs, _, _ = sweep[0.85]
    farm_got, farm_syncs, _, _ = sync300_farm
    assert got[0] == farm_got[0] and syncs[0] == farm_syncs[0]


def test_structure_300baud():
    pc, _, pp, jp = configs(**SYNC300)
    assert (pp.samples_per_bit, pp.ds_samples_per_bit, pp.quarter_bit) == \
        (jp.samples_per_bit, jp.ds_samples_per_bit, jp.quarter_bit) == \
        (160, 80, 20)
    assert FSKCore(pc, device="cpu").params == pp


# -- reconfiguration ----------------------------------------------------------

def test_reset_then_reconfigure():
    pc, jc, _, _ = configs()
    core, ref = FSKCore(pc, device="cpu"), JaxCore(jc)
    data = b"\x48"
    sig = core.modulate_data(data)
    assert core.demodulate_data(sig) == ref.demodulate_data(sig)
    for c, config in ((core, pc), (ref, jc)):
        c.reset()
        c.configure(config)
    assert core.demodulate_data(sig) == ref.demodulate_data(sig) == data
    assert core.get_status()["sync_detections"] == \
        ref.get_status()["sync_detections"] == 1


def test_reconfigure_changes_rate():
    pc, jc, _, _ = configs()
    core, ref = FSKCore(pc, device="cpu"), JaxCore(jc)
    sig1200 = core.modulate_data(b"\x42")
    core.configure(FSKConfig(baud_rate=300))
    ref.configure(configs(baud_rate=300)[1])
    sig300 = core.modulate_data(b"\x42")
    assert len(sig300) == 4 * len(sig1200)  # 4x slower baud
    assert core.demodulate_data(sig300) == ref.demodulate_data(sig300) \
        == b"\x42"


def test_unconfigured_raises():
    core = FSKCore(device="cpu")
    with pytest.raises(RuntimeError):
        core.modulate_data(b"\x00")
    with pytest.raises(RuntimeError):
        core.demodulate_data(np.zeros(128, np.float32))


def test_get_config_returns_config():
    pc, _, _, _ = configs()
    assert FSKCore(pc, device="cpu").get_config() == pc


def test_configure_from_reference_style_dict():
    as_dict = {"sampleRate": 48000, "baudRate": 1200,
               "markFrequency": 1650, "spaceFrequency": 1850}
    core, ref = FSKCore(device="cpu"), JaxCore()
    core.configure(as_dict)
    ref.configure(as_dict)
    assert core.is_ready() and ref.is_ready()
    data = b"\x31"
    sig = core.modulate_data(data)
    assert core.demodulate_data(sig) == ref.demodulate_data(sig) == data
