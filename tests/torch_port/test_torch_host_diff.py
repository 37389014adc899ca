"""The port's host layers against the JAX package's on the same seeded
inputs: ``RingBuffer`` after every operation of a seeded sequence, WAV
files written by either package read back by the other, and the core
contracts (the abstract methods of the ABCs, ``TransportStatistics``'
fields and defaults, ``AUDIO_CHUNK_SIZE``).  All of it is numpy or plain
Python on both sides, so every comparison is exact."""

import dataclasses

import numpy as np
import pytest

from webaudio_modem_tpu import core as jax_core
from webaudio_modem_tpu.utils import audio_io as jax_audio_io
from webaudio_modem_tpu.utils.ring_buffer import RingBuffer as JaxRing
from webaudio_modem_tpu_torch import core as port_core
from webaudio_modem_tpu_torch.utils import audio_io as port_audio_io
from webaudio_modem_tpu_torch.utils.ring_buffer import RingBuffer as PortRing


def _outcome(fn):
    """(result, error type) of ``fn()``, results as plain lists."""
    try:
        value = fn()
    except (IndexError, ValueError) as exc:
        return None, type(exc).__name__
    if isinstance(value, np.ndarray):
        value = value.tolist()
    elif isinstance(value, np.generic):
        value = value.item()
    return value, None


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("seed", range(3))
def test_ring_buffer_sequences_alike(seed, dtype):
    rng = np.random.default_rng(seed)
    capacity = int(rng.integers(3, 40))
    rings = (JaxRing(dtype, capacity), PortRing(dtype, capacity))

    def values(n):
        return rng.integers(0, 200, n).astype(dtype)

    for step in range(400):
        op = rng.choice(["put", "write_array", "read_array", "remove",
                         "read", "get", "remove_array", "clear"],
                        p=[.2, .2, .15, .1, .1, .12, .1, .03])
        n = int(rng.integers(0, 2 * capacity + 2))
        arg = values(n)
        idx = int(rng.integers(-capacity - 2, capacity + 2))
        outs = []
        for ring in rings:
            if op == "put":
                call = lambda r=ring: r.put(*arg[:3])      # noqa: E731
            elif op == "write_array":
                call = lambda r=ring: r.write_array(arg)   # noqa: E731
            elif op == "read_array":
                def call(r=ring):
                    out = np.full(n, 7, dtype)
                    r.read_array(out)
                    return out
            elif op == "get":
                call = lambda r=ring: r.get(idx)           # noqa: E731
            elif op == "remove_array":
                call = lambda r=ring: r.remove_array(n)    # noqa: E731
            else:
                call = getattr(ring, op)
            outs.append(_outcome(call))
        assert outs[1] == outs[0], (step, op)
        for probe in ("__len__", "to_array", "available_write"):
            assert _outcome(getattr(rings[1], probe)) == \
                _outcome(getattr(rings[0], probe)), (step, op, probe)
        assert rings[1].has_space(n % capacity) == \
            rings[0].has_space(n % capacity)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("fmt", ["pcm16", "float32"])
def test_wav_files_cross_read(tmp_path, fmt, writer):
    rng = np.random.default_rng(5)
    x = np.clip(rng.standard_normal(4001) * 0.4, -1, 1).astype(np.float32)
    paths = {}
    for name, mod in (("jax", jax_audio_io), ("port", port_audio_io)):
        paths[name] = tmp_path / f"{name}.wav"
        mod.write_wav(paths[name], x, sample_rate=44100, fmt=fmt)
    # byte for byte the same file
    assert paths["port"].read_bytes() == paths["jax"].read_bytes()
    reader = port_audio_io if writer == "jax" else jax_audio_io
    other = jax_audio_io if writer == "jax" else port_audio_io
    got, rate = reader.read_wav(paths[writer])
    ref, ref_rate = other.read_wav(paths[writer])
    assert rate == ref_rate == 44100
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    if fmt == "float32":
        np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("name", ["IModulator", "IDataChannel",
                                  "IAudioProcessor", "ITransport"])
def test_core_abcs_alike(name):
    got, ref = getattr(port_core, name), getattr(jax_core, name)
    assert got.__abstractmethods__ == ref.__abstractmethods__
    public = {n for n in dir(ref) if not n.startswith("_")}
    assert public <= {n for n in dir(got) if not n.startswith("_")}


def test_transport_statistics_and_constants_alike():
    got = [(f.name, f.type, f.default)
           for f in dataclasses.fields(port_core.TransportStatistics)]
    ref = [(f.name, f.type, f.default)
           for f in dataclasses.fields(jax_core.TransportStatistics)]
    assert got == ref
    stats = port_core.TransportStatistics(packets_sent=3)
    copy = stats.copy()
    copy.packets_sent += 1
    assert stats.packets_sent == 3
    assert port_core.AUDIO_CHUNK_SIZE == jax_core.AUDIO_CHUNK_SIZE
