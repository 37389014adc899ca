"""Checkpoints of the port (``models/checkpoint.py``, ``ModemFarm.save`` /
``restore``): ``tests/modems/test_checkpoint.py`` mirrored on the CPU,
and snapshots carried across packages in the reference's file format —
a snapshot the JAX package wrote continues in the port with the decodes
of an uninterrupted run, and the reverse, for FSK and DBPSK, also from
an old snapshot without ``r_tail``.
"""

import io
import json

import numpy as np
import pytest
import torch

import jax

from webaudio_modem_tpu.models import checkpoint as jax_checkpoint
from webaudio_modem_tpu.models.config import FSKConfig as JaxFSKConfig
from webaudio_modem_tpu.models.farm import ModemFarm as JaxModemFarm
from webaudio_modem_tpu.models.psk import PSKConfig as JaxPSKConfig
from webaudio_modem_tpu_torch.models import checkpoint
from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams
from webaudio_modem_tpu_torch.models.farm import ModemFarm
from webaudio_modem_tpu_torch.models.psk import PSKConfig
from webaudio_modem_tpu_torch.ops import fsk_demod, psk

B = 4


def _state_equal(a, b):
    for name, x in vars(a).items():
        y = getattr(b, name)
        assert x.dtype == y.dtype and torch.equal(x, y), name


def _without_r_tail(blob, names):
    """The snapshot rewritten in the layout that predates r_tail: its
    leaf dropped, the rest renumbered (tests/modems/test_checkpoint.py)."""
    r_idx = names.index(("r_tail", -1))
    with np.load(io.BytesIO(blob)) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        leaves = [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    old_bf16 = set(meta["bf16_leaves"])
    del leaves[r_idx]
    arrays, new_bf16 = {}, []
    for i, a in enumerate(leaves):
        if f"leaf_{i if i < r_idx else i + 1}" in old_bf16:
            new_bf16.append(f"leaf_{i}")
        arrays[f"leaf_{i}"] = a
    meta["n_leaves"] = len(leaves)
    meta["bf16_leaves"] = new_bf16
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(json.dumps(meta).encode(),
                                         dtype=np.uint8), **arrays)
    return buf.getvalue()


def _leaf_names(config, state):
    family = checkpoint._family_of(config)
    fields, ops = checkpoint._FAMILIES[family]
    return checkpoint._leaf_names(fields, ops.state_to_reference(state))


# ---------------------------------------------------------------------------
# The reference suite, mirrored
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["fsk", "psk"])
def test_mid_stream_checkpoint_resume_bit_identical(tmp_path, family):
    config = FSKConfig() if family == "fsk" else PSKConfig()
    base = 0x00 if family == "fsk" else 0x30
    msgs = [bytes([base + i]) * 3 for i in range(B)]
    farm = ModemFarm(config, B, device="cpu")
    sig = farm.modulate(msgs).numpy()
    cut = (sig.shape[1] // 2) | 1    # odd cut: the ds_phase carry
    expected = ModemFarm(config, B, device="cpu").demodulate(sig)

    part1 = farm.demodulate(sig[:, :cut])
    path = tmp_path / "farm.npz"
    farm.save(path)
    restored = ModemFarm.restore(path, device="cpu")
    assert type(restored.config) is type(config)
    assert restored._ds_phase == cut % 2
    _state_equal(restored.state, farm.state)
    part2 = restored.demodulate(sig[:, cut:])
    assert [a + b for a, b in zip(part1, part2)] == expected == msgs


def test_dumps_loads_roundtrip():
    config = FSKConfig(baud_rate=300)
    params = FSKParams.from_config(config)
    state = fsk_demod.init_state(params, 2, "cpu")
    state.framing[1] = torch.tensor([5, 9], dtype=torch.int32)
    state.bit_tail[3] = 1.0
    blob = checkpoint.dumps_state(state, config, ds_phase=1)
    state2, config2, ds_phase = checkpoint.loads_state(blob, device="cpu")
    assert config2 == config
    assert ds_phase == 1
    _state_equal(state2, state)


def test_psk_dumps_loads_roundtrip():
    cfg = PSKConfig(baud_rate=300)
    params = psk.psk_params(carrier_frequency=cfg.carrier_frequency,
                            baud_rate=cfg.baud_rate,
                            sample_rate=cfg.sample_rate)
    state = psk.init_state(params, 2, "cpu")
    state.ring.copy_(torch.arange(state.ring.numel(),
                                  dtype=torch.float32).view_as(state.ring))
    blob = checkpoint.dumps_state(state, cfg, ds_phase=1)
    state2, cfg2, ds_phase = checkpoint.loads_state(blob, device="cpu")
    assert cfg2 == cfg
    assert ds_phase == 1
    assert type(state2) is psk.PSKDemodState
    _state_equal(state2, state)


def test_shape_mismatch_rejected():
    config = FSKConfig(baud_rate=300)
    state = fsk_demod.init_state(FSKParams.from_config(config), 2, "cpu")
    # config says 1200 baud but windows were sized for 300 baud
    blob = checkpoint.dumps_state(state, config.replace(baud_rate=1200))
    with pytest.raises(ValueError, match="mismatch"):
        checkpoint.loads_state(blob, device="cpu")


def test_unknown_family_rejected():
    config = FSKConfig(baud_rate=300)
    state = fsk_demod.init_state(FSKParams.from_config(config), 1, "cpu")
    blob = checkpoint.dumps_state(state, config)
    with np.load(io.BytesIO(blob)) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        meta["family"] = "qam"
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    with pytest.raises(ValueError, match="family"):
        checkpoint.loads_state(buf.getvalue(), device="cpu")


def test_dtype_migration_cast_on_load():
    """A snapshot whose bit plane was stored as float32 (before the bf16
    planes) restores with the current dtypes."""
    config = FSKConfig(baud_rate=1200)
    state = fsk_demod.init_state(FSKParams.from_config(config), 2, "cpu")
    jstate = jax_checkpoint.loads_state(checkpoint.dumps_state(
        state, config))[0]
    old = jstate._replace(bit_tail=jstate.bit_tail.astype(np.float32) + 1)
    restored, _, _ = checkpoint.loads_state(
        jax_checkpoint.dumps_state(old, JaxFSKConfig(baud_rate=1200)),
        device="cpu")
    assert restored.bit_tail.dtype == torch.bfloat16
    assert torch.equal(restored.bit_tail, torch.ones_like(state.bit_tail))


@pytest.mark.parametrize("family", ["fsk", "psk"])
def test_pre_r_tail_checkpoint_migrates(family):
    """r_tail derived from the saved bit_tail, exactly."""
    config = FSKConfig() if family == "fsk" else PSKConfig()
    params = checkpoint._params(config)
    ops = fsk_demod if family == "fsk" else psk
    state = ops.init_state(params, 3, "cpu")
    rng = np.random.RandomState(5)
    state.bit_tail.copy_(torch.from_numpy(
        rng.randint(0, 2, tuple(state.bit_tail.shape)).astype(np.float32)))
    ds = params.ds_samples_per_bit
    cs = torch.cumsum(state.bit_tail.float(), 0)
    state.r_tail.copy_(cs[ds:] - cs[:-ds])
    blob = _without_r_tail(checkpoint.dumps_state(state, config),
                           _leaf_names(config, state))
    restored, _, _ = checkpoint.loads_state(blob, device="cpu")
    _state_equal(restored, state)


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------

def _jax_config(config):
    if isinstance(config, PSKConfig):
        return JaxPSKConfig(**vars(config))
    return JaxFSKConfig(**vars(config))


@pytest.fixture(scope="module", params=["fsk", "psk"])
def stream(request):
    """A B=4 stream of distinct 3-byte messages in both packages: the
    signal, the cut (odd, mid-frame) and the JAX farm's uninterrupted
    decode."""
    config = FSKConfig() if request.param == "fsk" else PSKConfig()
    msgs = [bytes([0x41 + i, 0x10 * i, 0x7F - i]) for i in range(B)]
    jconfig = _jax_config(config)
    sig = np.asarray(JaxModemFarm(jconfig, B, donate=False).modulate(msgs))
    cut = (sig.shape[1] // 2) | 1
    expected = JaxModemFarm(jconfig, B, donate=False).demodulate(sig)
    assert expected == msgs
    return config, jconfig, msgs, sig, cut


def test_jax_snapshot_continues_in_the_port(stream):
    config, jconfig, msgs, sig, cut = stream
    jfarm = JaxModemFarm(jconfig, B, donate=False)
    part1 = jfarm.demodulate(sig[:, :cut])
    buf = io.BytesIO()
    jfarm.save(buf)
    buf.seek(0)
    farm = ModemFarm.restore(buf, device="cpu")
    assert farm.config == config and farm._ds_phase == cut % 2
    # the state equals the one the field maps build from the JAX state
    ops = fsk_demod if isinstance(config, FSKConfig) else psk
    from torch_port_helpers import reference_fields

    _state_equal(farm.state, ops.state_from_reference(
        reference_fields(jfarm.state), "cpu"))
    part2 = farm.demodulate(sig[:, cut:])
    assert part2 == jfarm.demodulate(sig[:, cut:])
    assert [a + b for a, b in zip(part1, part2)] == msgs


def test_port_snapshot_continues_in_the_jax_package(stream, tmp_path):
    config, jconfig, msgs, sig, cut = stream
    farm = ModemFarm(config, B, device="cpu")
    part1 = farm.demodulate(sig[:, :cut])
    path = tmp_path / "port.npz"
    farm.save(path)
    jfarm = JaxModemFarm.restore(path, donate=False)
    assert jfarm.config == jconfig and jfarm._ds_phase == cut % 2
    # every leaf in the reference's dtype and shape
    template = jax.tree.leaves(type(jfarm)(jconfig, B, donate=False).state)
    for want, got in zip(template, jax.tree.leaves(jfarm.state)):
        assert (want.dtype, want.shape) == (got.dtype, got.shape)
    part2 = jfarm.demodulate(sig[:, cut:])
    assert part2 == farm.demodulate(sig[:, cut:])
    assert [a + b for a, b in zip(part1, part2)] == msgs


def test_old_jax_snapshot_without_r_tail_continues_in_the_port(stream):
    config, jconfig, msgs, sig, cut = stream
    jfarm = JaxModemFarm(jconfig, B, donate=False)
    part1 = jfarm.demodulate(sig[:, :cut])
    blob = jax_checkpoint.dumps_state(jfarm.state, jconfig, jfarm._ds_phase)
    state, _, ds_phase = checkpoint.loads_state(
        _without_r_tail(blob, _leaf_names(
            config, ModemFarm(config, B, device="cpu").state)),
        device="cpu")
    np.testing.assert_array_equal(state.r_tail.float().numpy(),
                                  np.asarray(jfarm.state.r_tail, np.float32))
    farm = ModemFarm(config, B, device="cpu")
    farm.state, farm._ds_phase = state, ds_phase
    part2 = farm.demodulate(sig[:, cut:])
    assert [a + b for a, b in zip(part1, part2)] == msgs
