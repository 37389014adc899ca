"""Checkpoint / resume for streaming demodulator state — both families.

Counterpart of ``webaudio_modem_tpu/models/checkpoint.py``, in its file
format exactly, so a snapshot carries a stream across packages: one the
JAX package wrote continues in the port with the same decodes, and the
reverse.

The format is a plain ``.npz``:

* ``leaf_i``: the leaves of the reference's state pytree
  (``DemodState`` for FSK, ``PSKDemodState`` for DBPSK) in the order
  ``jax.tree.flatten`` walks it, tuple fields expanded one [B] row per
  leaf (``_FSK_FIELDS`` / ``_PSK_FIELDS`` below keep that order);
* bf16 leaves (``bit_tail``, ``r_tail``) stored as uint16 bit patterns
  and listed in ``bf16_leaves``;
* ``__meta__``: JSON bytes with the family tag, the config dataclass,
  ``ds_phase``, ``n_leaves`` and ``bf16_leaves``.

The port's states map to and from the reference's fields through
``fsk_demod.state_to_reference`` / ``state_from_reference`` (and
``psk``'s).  A snapshot that predates the carried ``r_tail`` plane is
migrated as the reference migrates it: r_tail derived from the saved
bit_tail, which restores bit-identical streams.
"""

from __future__ import annotations

import dataclasses
import io
import json
from typing import List, Tuple

import numpy as np

from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams
from webaudio_modem_tpu_torch.models.psk import PSKConfig, params_from_config
from webaudio_modem_tpu_torch.ops import fsk_demod, psk
from webaudio_modem_tpu_torch.utils.device import resolve_device

_TAIL_FIELDS = (
    "bit_tail", "r_tail", "amp_tail", "bit_fill", "amp_fill", "started",
    "counter", "sil", "threshold", "accum", "count", "bsc", "next_idx",
    "byte_cur", "pos", "sync_count", "eod_count", "last_sync_ratio",
    "q_win_sum", "q_win_sumsq", "q_win_cnt")
# the reference NamedTuples' fields, in order
_FSK_FIELDS = ("agc_gain", "pre", "phi", "iq_i", "iq_q", "ds_iacc",
               "ds_qacc", "last_phase", "post") + _TAIL_FIELDS
_PSK_FIELDS = ("agc_gain", "pre", "phi", "iq_i", "iq_q", "ds_iacc",
               "ds_qacc", "zbuf_i", "zbuf_q", "zidx") + _TAIL_FIELDS
_BF16_FIELDS = ("bit_tail", "r_tail")

# family tag -> (fields, ops module)
_FAMILIES = {"fsk": (_FSK_FIELDS, fsk_demod), "psk": (_PSK_FIELDS, psk)}


def _family_of(config) -> str:
    return "psk" if isinstance(config, PSKConfig) else "fsk"


def _config_from_meta(family: str, d: dict):
    if family == "psk":
        d = dict(d)
        for k in ("preamble_pattern", "sfd_pattern"):
            if k in d:
                d[k] = tuple(d[k])
        return PSKConfig(**d)
    if family != "fsk":
        raise ValueError(f"unknown checkpoint family: {family!r}")
    return FSKConfig.from_dict(d)


def _params(config) -> FSKParams:
    if isinstance(config, PSKConfig):
        return params_from_config(config)
    return FSKParams.from_config(config)


def _leaf_names(fields, ref: dict) -> List[Tuple[str, int]]:
    """(field, row) per leaf in flatten order; row -1 for a plain leaf."""
    out = []
    for name in fields:
        value = ref[name]
        if isinstance(value, tuple):
            out += [(name, k) for k in range(len(value))]
        else:
            out.append((name, -1))
    return out


def _bf16_bits(values: np.ndarray) -> np.ndarray:
    """float32 values exact in bf16 -> their uint16 bit patterns."""
    return (np.ascontiguousarray(values, np.float32).view(np.uint32)
            >> 16).astype(np.uint16)


def _bf16_values(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def save_state(path_or_file, state, config, ds_phase: int = 0) -> None:
    """Snapshot (state, config, ds_phase) of either family in the
    reference's format."""
    family = _family_of(config)
    fields, ops = _FAMILIES[family]
    ref = ops.state_to_reference(state)
    arrays, bf16_leaves = {}, []
    for i, (name, row) in enumerate(_leaf_names(fields, ref)):
        value = np.asarray(ref[name] if row < 0 else ref[name][row])
        key = f"leaf_{i}"
        if name in _BF16_FIELDS:
            value = _bf16_bits(value)
            bf16_leaves.append(key)
        arrays[key] = value
    meta = {
        "family": family,
        "config": dataclasses.asdict(config),
        "ds_phase": ds_phase,
        "n_leaves": len(arrays),
        "bf16_leaves": bf16_leaves,
    }
    np.savez(path_or_file, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **arrays)


def load_state(path_or_file, device="cuda"):
    """Returns (state, config, ds_phase), the state on ``device``.

    The leaf layout (shapes, dtypes) is rebuilt from the family's own
    ``init_state``, so a snapshot whose config or batch no longer
    matches its arrays is rejected loudly."""
    device = resolve_device(device)
    with np.load(path_or_file) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        family = meta.get("family", "fsk")
        config = _config_from_meta(family, meta["config"])
        fields, ops = _FAMILIES[family]
        params = _params(config)
        batch = int(data["leaf_0"].shape[0])  # agc_gain [B], both families
        template = ops.state_to_reference(ops.init_state(params, batch, "cpu"))
        names = _leaf_names(fields, template)
        bf16 = set(meta.get("bf16_leaves", ()))
        restored = [
            _bf16_values(data[f"leaf_{i}"]) if f"leaf_{i}" in bf16
            else data[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    if meta["n_leaves"] == len(names) - 1:
        # snapshots predating the carried sliding block-sum plane: derive
        # r_tail[k] = R(ds + k) = sum of bit_tail[k+1 .. k+ds] (exact
        # integer counts), as the reference does
        r_idx = names.index(("r_tail", -1))
        b_idx = names.index(("bit_tail", -1))
        ds = params.ds_samples_per_bit
        cs = np.cumsum(np.asarray(restored[b_idx], np.float32), axis=0)
        restored.insert(r_idx, cs[ds:] - cs[:-ds])
    if len(restored) != len(names):
        raise ValueError(
            f"checkpoint leaf-count mismatch: {meta['n_leaves']} vs "
            f"{len(names)} — family/state layout changed?")
    fields_np = {}
    for (name, row), got in zip(names, restored):
        want = np.asarray(template[name] if row < 0 else template[name][row])
        if want.shape != got.shape:
            raise ValueError(
                f"checkpoint shape mismatch: {got.shape} vs {want.shape} "
                "— config/batch changed?")
        # cast to the template's dtype (bit planes as their float32
        # values: 0/1 and integer counts, exact)
        got = np.asarray(got).astype(want.dtype)
        if row < 0:
            fields_np[name] = got
        else:
            fields_np.setdefault(name, []).append(got)
    fields_np = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in fields_np.items()}
    state = ops.state_from_reference(fields_np, device)
    return state, config, int(meta["ds_phase"])


def dumps_state(state, config, ds_phase: int = 0) -> bytes:
    buf = io.BytesIO()
    save_state(buf, state, config, ds_phase)
    return buf.getvalue()


def loads_state(blob: bytes, device="cuda"):
    return load_state(io.BytesIO(blob), device=device)
