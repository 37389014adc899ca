"""ModemFarm.demodulate_stream's ``group=`` and the farm's ``donate=``
against the reference's, on the CPU: the guards of
``TestDemodulateStreamGuards`` (tests/modems/test_fsk_demodulation.py),
and the grouped decode equal to the per-chunk loop and to the JAX
package's ``demodulate_stream`` on the same numpy signal, with a trailing
partial group and chunk sizes aligned and not aligned to the downsample
ratio, for FSK and DBPSK."""

import numpy as np
import pytest
import torch

from torch_port_helpers import configs
from webaudio_modem_tpu.models.farm import ModemFarm as JaxFarm
from webaudio_modem_tpu.models.psk import PSKConfig as JaxPSKConfig
from webaudio_modem_tpu_torch.models.farm import ModemFarm
from webaudio_modem_tpu_torch.models.psk import PSKConfig

B = 4
MSGS = [bytes([65 + b, 48 + b]) for b in range(B)]


@pytest.fixture(scope="module", params=["fsk", "psk"])
def family(request):
    """(port config, reference config, signal with an odd tail, the
    per-chunk loop's bytes at chunk 512)."""
    if request.param == "fsk":
        pc, jc, _, _ = configs()
    else:
        pc, jc = PSKConfig(), JaxPSKConfig()
    farm = ModemFarm(pc, B, device="cpu", donate=False)
    sig = farm.modulate(MSGS).numpy()
    sig = np.concatenate([sig, np.zeros((B, 777), np.float32)], axis=1)
    loop = farm.demodulate(sig, chunk_size=512)
    assert loop == MSGS
    return pc, jc, sig, loop


@pytest.mark.parametrize("group,chunk", [(2, 512), (3, 512), (3, 511)])
def test_grouped_equals_loop_and_reference(family, group, chunk):
    pc, jc, sig, loop = family
    ratio = ModemFarm(pc, B, device="cpu").params.downsample_ratio
    # 512 runs full groups and a trailing partial one; 511 is not a
    # multiple of the ratio, so the chunks carry a downsample phase
    assert (chunk % ratio == 0) == (chunk == 512)
    assert sig.shape[1] % (chunk * group) != 0
    farm = ModemFarm(pc, B, device="cpu", donate=False)
    grouped = farm.demodulate_stream(sig, chunk_size=chunk, group=group)
    ref = JaxFarm(jc, B, donate=False).demodulate_stream(
        sig, chunk_size=chunk, group=group)
    assert grouped == ref == loop == MSGS


@pytest.mark.parametrize("bad", [0, -1])
def test_group_below_one_rejected(bad):
    pc, _, _, _ = configs()
    farm = ModemFarm(pc, 2, device="cpu", donate=False)
    with pytest.raises(ValueError, match="group"):
        farm.demodulate_stream(np.zeros((2, 1024), np.float32),
                               chunk_size=512, group=bad)


def test_group_one_equals_loop():
    pc, _, _, _ = configs()
    msgs = [b"G1", b"g1"]
    farm = ModemFarm(pc, 2, device="cpu", donate=False)
    sig = farm.modulate(msgs)
    assert farm.demodulate_stream(sig, chunk_size=512, group=1) == msgs


@pytest.mark.parametrize("donate", [False, True])
def test_held_state_stays_readable(donate):
    """The chunk step returns new state tensors for either value of
    ``donate``: state a caller held before a grouped decode keeps its
    values."""
    pc, _, _, _ = configs()
    msgs = [b"DS", b"ds"]
    farm = ModemFarm(pc, 2, device="cpu", donate=donate)
    held = farm.state
    before = {k: v.clone() for k, v in vars(held).items()}
    sig = farm.modulate(msgs)
    assert farm.demodulate_stream(sig, chunk_size=512, group=2) == msgs
    assert held.front.shape == (20, 2)
    for name, value in before.items():
        assert torch.equal(getattr(held, name), value), name
    assert not torch.equal(farm.state.front, before["front"])


def test_restore_takes_donate(tmp_path):
    pc, _, _, _ = configs()
    farm = ModemFarm(pc, 2, device="cpu")
    farm.save(tmp_path / "farm.npz")
    for donate in (False, True):
        again = ModemFarm.restore(tmp_path / "farm.npz", device="cpu",
                                  donate=donate)
        assert again.batch == 2
