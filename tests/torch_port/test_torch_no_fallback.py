"""Guards against hidden fallbacks in the port.

The port and chip_smoke.py must import neither JAX (the card's machine
has none) nor anything of the JAX package ``webaudio_modem_tpu`` (the
port keeps its own copies); the entry points run on the card unless the
caller asks for the CPU, and a CUDA request without a card raises; a
kernel wrapper given a tensor that is not on the CPU launches its kernel
or raises, never runs the plain version; and chip_smoke.py fails,
printing no result, where there is no CUDA device.
"""

import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from webaudio_modem_tpu_torch.models import checkpoint
from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams
from webaudio_modem_tpu_torch.models.farm import ModemFarm
from webaudio_modem_tpu_torch.models.fsk import FSKCore
from webaudio_modem_tpu_torch.models.psk import PSKConfig, PSKCore
from webaudio_modem_tpu_torch.models.soft_modem import SoftModemCore
from webaudio_modem_tpu_torch.models.v21 import V21Duplex, V21Station
from webaudio_modem_tpu_torch.ops import (fec, filters, fsk_demod, fsk_mod,
                                          psk, soft_fsk)
from webaudio_modem_tpu_torch.ops.kernels import (_build, align, cumsum0,
                                                  fsk_framing, fsk_seq,
                                                  psk_seq, viterbi)
from webaudio_modem_tpu_torch.ops.soft_blind import BlindSoftBatchReceiver
from webaudio_modem_tpu_torch.runtime import (BlindSoftFarmHub,
                                              DeviceFarmHub, FSKProcessor,
                                              FarmLoopbackHub, SoftFarmHub)
from webaudio_modem_tpu_torch.sim import ber, impairments
from webaudio_modem_tpu_torch.transports.fec_frame import FrameDecoder

REPO = Path(__file__).resolve().parents[2]


def _run(code_or_args, timeout):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    args = code_or_args if isinstance(code_or_args, list) else \
        ["-c", code_or_args]
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


# every module of the port, then chip_smoke, with a finder in front of
# sys.meta_path that refuses JAX and the JAX package outright
_BLOCKED_IMPORTS = """
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "webaudio_modem_tpu")


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"the port imported {name}")
        return None


loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
sys.meta_path.insert(0, Refuse())
import webaudio_modem_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(len(names), "modules clean")
"""


def test_port_and_smoke_import_nothing_of_jax_or_the_jax_package():
    proc = _run(_BLOCKED_IMPORTS, timeout=120)
    assert proc.returncode == 0, proc.stderr
    n, rest = proc.stdout.strip().split(" ", 1)
    assert rest == "modules clean"
    # the soft and acquisition slices' modules are among those walked
    assert int(n) >= 25, proc.stdout


@pytest.mark.parametrize("module", [
    "webaudio_modem_tpu_torch.ops.soft_blind",
    "webaudio_modem_tpu_torch.ops.kernels.cumsum0",
    "webaudio_modem_tpu_torch.models.soft_modem",
    "webaudio_modem_tpu_torch.sim", "webaudio_modem_tpu_torch.sim.channels",
    "webaudio_modem_tpu_torch.sim.ber",
    "webaudio_modem_tpu_torch.sim.impairments",
    "webaudio_modem_tpu_torch.golden",
    "webaudio_modem_tpu_torch.golden.fsk_golden",
    "webaudio_modem_tpu_torch.models.v21",
    "webaudio_modem_tpu_torch.models.checkpoint",
    "webaudio_modem_tpu_torch.ops.filters",
    "webaudio_modem_tpu_torch.utils.abort",
    "webaudio_modem_tpu_torch.utils.ring_buffer",
    "webaudio_modem_tpu_torch.utils.audio_io",
    "webaudio_modem_tpu_torch.runtime",
    "webaudio_modem_tpu_torch.runtime.processor",
    "webaudio_modem_tpu_torch.runtime.audio_graph",
    "webaudio_modem_tpu_torch.runtime.chunked_modulator",
    "webaudio_modem_tpu_torch.runtime.data_channel",
    "webaudio_modem_tpu_torch.transports",
    "webaudio_modem_tpu_torch.transports.xmodem",
    "webaudio_modem_tpu_torch.transports.xmodem.types",
    "webaudio_modem_tpu_torch.transports.xmodem.packet",
    "webaudio_modem_tpu_torch.transports.xmodem.xmodem",
    "webaudio_modem_tpu_torch.native",
    "webaudio_modem_tpu_torch.native.deframer",
    "webaudio_modem_tpu_torch.native.crc16_native",
    "webaudio_modem_tpu_torch.runtime.farm_channel",
    "webaudio_modem_tpu_torch.runtime.device_hub",
    "webaudio_modem_tpu_torch.examples",
    "webaudio_modem_tpu_torch.examples.farm_transport_demo",
    "webaudio_modem_tpu_torch.examples.farm_endurance",
    "webaudio_modem_tpu_torch.examples.latency_probe",
    "webaudio_modem_tpu_torch.runtime.soft_hub",
    "webaudio_modem_tpu_torch.transports.fec_frame",
    "webaudio_modem_tpu_torch.examples.farm_host_cost",
    "webaudio_modem_tpu_torch.examples.blind_host_cost",
    "webaudio_modem_tpu_torch.examples.demo"])
def test_new_modules_are_walked_behind_the_blocker(module):
    code = _BLOCKED_IMPORTS.replace(
        'print(len(names), "modules clean")',
        f'assert {module!r} in names or {module!r} == pkg.__name__, names\n'
        'print(len(names), "modules clean")')
    proc = _run(code, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("fn", [
    ModemFarm.__init__, FSKCore.__init__, PSKCore.__init__,
    fsk_mod.modulate_bits,
    fec.viterbi_decode_soft, fec.viterbi_decode_bits, fec.decode_bytes,
    soft_fsk.encode_frame_signal, soft_fsk.encode_frames_batch,
    soft_fsk.decode_frames_batch, soft_fsk.decode_frames_batch_async,
    soft_fsk.decode_frame_signal, soft_fsk.decode_frame_chunks,
    soft_fsk.SoftFrameDecoder.__init__, fsk_demod.soft_stream,
    BlindSoftBatchReceiver.__init__, SoftModemCore.__init__,
    ber.ber_sweep, ber.ber_parity_report, impairments.carrier_offset_sweep,
    impairments.clock_skew_sweep, V21Station.__init__, V21Duplex.__init__,
    checkpoint.load_state, checkpoint.loads_state, ModemFarm.restore,
    filters.biquad_init_state, FSKProcessor.__init__,
    fsk_mod.modulate, fsk_mod.modulate_batch, psk.modulate,
    psk.modulate_batch, fsk_demod.init_state, psk.init_state,
    FarmLoopbackHub.__init__, DeviceFarmHub.__init__,
    SoftFarmHub.__init__, BlindSoftFarmHub.__init__, FrameDecoder.__init__,
    soft_fsk.frames_synth_device_fn(FSKParams.from_config(FSKConfig()), 4),
], ids=lambda f: f.__qualname__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_cuda_request_without_a_card_raises(monkeypatch):
    """The default device is the card; where there is none, the entry
    points refuse instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = FSKParams.from_config(FSKConfig())
    calls = [
        lambda: ModemFarm(FSKConfig(), 2),
        lambda: FSKCore(FSKConfig()),
        lambda: PSKCore(PSKConfig()),
        lambda: ModemFarm(PSKConfig(), 2),
        lambda: soft_fsk.decode_frames_batch(
            params, torch.zeros((1, 64)), 4),
        lambda: soft_fsk.encode_frames_batch(params, [b"abcd"]),
        lambda: fec.viterbi_decode_bits(np.zeros(12, np.uint8), 0),
        lambda: BlindSoftBatchReceiver(params, 2, 4800),
        lambda: soft_fsk.SoftFrameDecoder(params),
        lambda: soft_fsk.decode_frame_signal(params, np.zeros(64)),
        lambda: fsk_demod.soft_stream(params, np.zeros(64)),
        lambda: SoftModemCore(FSKConfig()),
        lambda: ber.ber_sweep(FSKConfig(), [30.0], messages_per_point=1),
        lambda: impairments.carrier_offset_sweep(FSKConfig(), [0.0]),
        lambda: impairments.clock_skew_sweep(FSKConfig(), [0.0],
                                             soft=True),
        lambda: V21Duplex(),
        lambda: checkpoint.loads_state(checkpoint.dumps_state(
            fsk_demod.init_state(params, 1, "cpu"), FSKConfig())),
        lambda: filters.biquad_init_state((2,)),
        lambda: FSKProcessor(),
        lambda: fsk_mod.modulate(params, b"x"),
        lambda: fsk_mod.modulate_batch(params, [b"x"]),
        lambda: psk.modulate(params, b"x"),
        lambda: psk.modulate_batch(params, [b"x"]),
        lambda: fsk_demod.init_state(params),
        lambda: psk.init_state(params, batch=1),
        lambda: FarmLoopbackHub(FSKConfig(), 2),
        lambda: DeviceFarmHub(FSKConfig(), 2),
        lambda: SoftFarmHub(FSKConfig(), 2),
        lambda: BlindSoftFarmHub(FSKConfig(), 2),
        lambda: FrameDecoder(),
        lambda: soft_fsk.frames_synth_device_fn(params, 4)(
            np.zeros((1, 4), np.uint8)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="is_available"):
            call()


def test_framed_xmodem_path_names_nothing_of_the_jax_package():
    """XModem's frame path reaches the port's own native deframer: its
    source and the deframer's name no module of the JAX package, and a
    channel that advertises ``supports_frames`` takes the frame path."""
    import re

    from webaudio_modem_tpu_torch.native import deframer
    from webaudio_modem_tpu_torch.runtime.data_channel import (
        QueueDataChannel)
    from webaudio_modem_tpu_torch.transports.xmodem import xmodem

    for mod in (xmodem, deframer):
        source = Path(mod.__file__).read_text()
        assert not re.search(r"webaudio_modem_tpu\.", source)
    assert "webaudio_modem_tpu_torch.native import deframer" in \
        Path(xmodem.__file__).read_text()
    channel = QueueDataChannel()
    channel.supports_frames = True
    transport = xmodem.XModemTransport(channel)
    assert transport._frames_supported()
    hub = FarmLoopbackHub(FSKConfig(), 2, device="cpu")
    assert xmodem.XModemTransport(hub.channel("a", 0))._frames_supported()
    assert not xmodem.XModemTransport(QueueDataChannel())._frames_supported()
    assert transport.is_ready()


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no fallback"):
        _build.check_cuda(torch.device("cuda", 0))
    assert _build.use_kernel(torch.zeros(2)) is False


def _launches():
    return (fsk_seq.launches, fsk_framing.launches,
            fsk_framing.stage_d_launches, viterbi.launches, align.launches,
            psk_seq.launches, cumsum0.launches)


@pytest.mark.parametrize("kernel", ["fsk_seq", "fsk_framing", "fsk_stage_d",
                                    "viterbi", "align", "psk_seq",
                                    "cumsum0"])
def test_wrappers_raise_off_cpu(kernel):
    """Tensors on a device that is neither the CPU nor CUDA are refused,
    not handed to the plain version."""
    params = FSKParams.from_config(FSKConfig())
    state = fsk_demod.init_state(params, 4, "meta")
    ds = params.ds_samples_per_bit
    z = torch.zeros((8, 4), device="meta")
    before = _launches()
    with pytest.raises(ValueError, match="CPU tensors"):
        if kernel == "fsk_seq":
            fsk_seq.seq(params, 0, state.front, state.ds_acc,
                        state.bit_tail[-ds:], z)
        elif kernel == "fsk_framing":
            ints, flts = fsk_demod._framing_carry(params, state)
            fsk_framing.stage_d_compact(
                params, ints, flts, state.bit_fill, z.bfloat16(), z, z, z, 4)
        elif kernel == "fsk_stage_d":
            fsk_demod.stage_d(params, state, z.bfloat16(), z, z, z)
        elif kernel == "viterbi":
            viterbi.decode(z.reshape(4, 4, 2), 2)
        elif kernel == "cumsum0":
            cumsum0.csum0(z)
        elif kernel == "psk_seq":
            st = psk.init_state(params, 4, "meta")
            psk_seq.seq(params, 0, st.front, st.ds_acc, st.ring,
                        st.bit_tail[-ds:], z)
        else:
            align.aligned_wsum(z, torch.zeros(4, dtype=torch.int32,
                                              device="meta"), 3, 2)
    assert _launches() == before


def test_wrappers_refuse_mixed_devices():
    params = FSKParams.from_config(FSKConfig())
    state = fsk_demod.init_state(params, 4, "cpu")
    ds = params.ds_samples_per_bit
    with pytest.raises(ValueError, match="several devices"):
        fsk_seq.seq(params, 0, state.front, state.ds_acc,
                    state.bit_tail[-ds:],
                    torch.zeros((8, 4), device="meta"))


def test_k5_refuses_cuda_without_a_card_and_mixed_devices(monkeypatch):
    """K5's wrapper launches its kernel or raises: a CUDA tensor without a
    usable card raises (no plain fallback); so do tensors on two devices
    at its check."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fake_cuda = torch.zeros((8, 4), device="meta")
    before = cumsum0.launches
    with pytest.raises(ValueError, match="CPU tensors"):
        cumsum0.csum0(fake_cuda)
    with pytest.raises(ValueError, match="several devices"):
        _build.use_kernel(torch.zeros((8, 4)), fake_cuda)
    with pytest.raises(RuntimeError, match="no fallback"):
        _build.check_cuda(torch.device("cuda", 0))
    assert cumsum0.launches == before


def test_chip_smoke_fails_without_cuda():
    proc = _run([str(REPO / "chip_smoke.py")], timeout=60)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr
