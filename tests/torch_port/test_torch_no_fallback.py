"""Guards against hidden fallbacks in the port.

The port and chip_smoke.py must not import JAX (the card's machine has
none); a kernel wrapper given a tensor that is not on the CPU launches
its kernel or raises, never runs the plain version; and chip_smoke.py
fails, printing no result, where there is no CUDA device.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams
from webaudio_modem_tpu_torch.ops import fsk_demod
from webaudio_modem_tpu_torch.ops.kernels import _build, fsk_framing, fsk_seq

REPO = Path(__file__).resolve().parents[2]


def _run(code_or_args, timeout):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    args = code_or_args if isinstance(code_or_args, list) else \
        ["-c", code_or_args]
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_and_smoke_import_no_jax():
    proc = _run(
        "import sys\n"
        "import webaudio_modem_tpu_torch\n"
        "import webaudio_modem_tpu_torch.models.config\n"
        "import webaudio_modem_tpu_torch.models.fsk\n"
        "import webaudio_modem_tpu_torch.models.farm\n"
        "import webaudio_modem_tpu_torch.ops.fsk_mod\n"
        "import webaudio_modem_tpu_torch.ops.fsk_demod\n"
        "import webaudio_modem_tpu_torch.ops.kernels._build\n"
        "import webaudio_modem_tpu_torch.ops.kernels.fsk_seq\n"
        "import webaudio_modem_tpu_torch.ops.kernels.fsk_framing\n"
        "import webaudio_modem_tpu_torch.utils.device\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print('clean')\n", timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no fallback"):
        _build.check_cuda(torch.device("cuda", 0))
    assert _build.use_kernel(torch.zeros(2)) is False


@pytest.mark.parametrize("kernel", ["fsk_seq", "fsk_framing"])
def test_wrappers_raise_off_cpu(kernel):
    """Tensors on a device that is neither the CPU nor CUDA are refused,
    not handed to the plain version."""
    params = FSKParams.from_config(FSKConfig())
    state = fsk_demod.init_state(params, 4, "meta")
    ds = params.ds_samples_per_bit
    before = (fsk_seq.launches, fsk_framing.launches)
    with pytest.raises(ValueError, match="CPU tensors"):
        if kernel == "fsk_seq":
            fsk_seq.seq(params, 0, state.front, state.ds_acc,
                        state.bit_tail[-ds:],
                        torch.zeros((8, 4), device="meta"))
        else:
            ints, flts = fsk_demod._framing_carry(params, state)
            z = torch.zeros((8, 4), device="meta")
            fsk_framing.stage_d_compact(
                params, ints, flts, state.bit_fill, z.bfloat16(), z, z, z, 4)
    assert (fsk_seq.launches, fsk_framing.launches) == before


def test_wrappers_refuse_mixed_devices():
    params = FSKParams.from_config(FSKConfig())
    state = fsk_demod.init_state(params, 4, "cpu")
    ds = params.ds_samples_per_bit
    with pytest.raises(ValueError, match="several devices"):
        fsk_seq.seq(params, 0, state.front, state.ds_acc,
                    state.bit_tail[-ds:],
                    torch.zeros((8, 4), device="meta"))


def test_chip_smoke_fails_without_cuda():
    proc = _run([str(REPO / "chip_smoke.py")], timeout=60)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr
