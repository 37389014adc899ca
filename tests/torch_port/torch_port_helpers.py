"""Shared inputs for the port's differential tests: configurations in
both packages, seeded signals, and reference states as numpy."""

import dataclasses

import numpy as np

from webaudio_modem_tpu.models import config as jax_config_mod
from webaudio_modem_tpu_torch.models import config as port_config_mod
from webaudio_modem_tpu_torch.ops import fsk_mod as port_mod

BENCH = dict(baud_rate=300, mark_frequency=1270, space_frequency=1070)

CONFIGS = {
    "default": {},
    "bench_300_mark_gt_space": BENCH,
    "even_parity": dict(parity="even"),
    "2400_baud": dict(baud_rate=2400, mark_frequency=1200,
                      space_frequency=2400),
    "ds_over_256": dict(baud_rate=50, mark_frequency=1270,
                        space_frequency=1070),
}


def configs(**overrides):
    """(port FSKConfig, reference FSKConfig, port FSKParams, reference
    FSKParams) for the same settings."""
    pc = port_config_mod.FSKConfig(**overrides)
    jc = jax_config_mod.FSKConfig(**dataclasses.asdict(pc))
    return (pc, jc, port_config_mod.FSKParams.from_config(pc),
            jax_config_mod.FSKParams.from_config(jc))


def add_noise(sig, snr_db, rng):
    """Uniform noise at ``snr_db`` below the signal's power, per row."""
    sig = np.asarray(sig, np.float32)
    power = np.mean(sig.astype(np.float64) ** 2, axis=-1, keepdims=True)
    amp = np.sqrt(3 * power / (10 ** (snr_db / 10)))
    noise = amp * (rng.uniform(size=sig.shape) * 2 - 1)
    return (sig + noise).astype(np.float32)


def random_messages(rng, batch, n_bytes):
    return [bytes(rng.integers(0, 256, n_bytes, dtype=np.uint8))
            for _ in range(batch)]


def signals(params, messages, snr_db=None, rng=None):
    """Port-modulated f32 [B, T] numpy signal (noisy when snr_db given)."""
    sig = port_mod.modulate_batch(params, messages, "cpu").numpy()
    return sig if snr_db is None else add_noise(sig, snr_db, rng)


def reference_fields(state):
    """A reference DemodState as numpy arrays by field name (tuple fields
    stacked, bf16 planes as float32)."""
    out = {}
    for name, value in state._asdict().items():
        if isinstance(value, tuple):
            value = np.stack([np.asarray(v, np.float32) for v in value])
        else:
            value = np.asarray(value)
            if value.dtype.name == "bfloat16":
                value = value.astype(np.float32)
        out[name] = value
    return out


# XModem over the simulated audio graph on the CPU.  XModem's timeouts
# are wall-clock while the graph runs as fast as it can: on the CPU each
# processor pays K1's plain version (~0.3-0.5 ms a sample), so a hello's
# ACK round trip takes ~17 s of wall clock on an idle core, close to the
# JAX package's 20 s harness timeout; under several test workers it would
# pass it and retransmit.  The port's stacks wait 120 s instead, and the
# tests hold the transfers to zero retransmissions.
ARQ_TIMEOUT_MS = 120000


def make_arq_stack(channel_fn=None, core_factory=None, config=None,
                   timeout_ms=ARQ_TIMEOUT_MS, max_retries=3, quantum=512):
    """(graph, sender, receiver): the port's copy of
    ``tests/runtime/conftest.py``'s stack, on the CPU: two processors on
    one loopback graph with XModem transports.  ``core_factory`` returns
    a fresh modem core per processor (None = FSKCore on the CPU)."""
    from webaudio_modem_tpu_torch.models.config import DEFAULT_FSK_CONFIG
    from webaudio_modem_tpu_torch.runtime import AudioGraph, FSKProcessor
    from webaudio_modem_tpu_torch.transports.xmodem import XModemTransport

    def proc(name):
        core = None if core_factory is None else core_factory()
        p = FSKProcessor(name=name, core=core, device="cpu")
        p.configure(DEFAULT_FSK_CONFIG if config is None else config)
        return p

    sender_proc, receiver_proc = proc("sender"), proc("receiver")
    graph = AudioGraph(quantum=quantum, channel_fn=channel_fn)
    graph.connect(sender_proc)
    graph.connect(receiver_proc)
    sender = XModemTransport(sender_proc)
    receiver = XModemTransport(receiver_proc)
    for t in (sender, receiver):
        t.configure({"timeout_ms": timeout_ms, "max_retries": max_retries})
    return graph, sender, receiver


async def arq_transfer(graph, sender, receiver, data, timeout=600):
    """Drive the graph while one send_data / receive_data pair runs."""
    import asyncio

    drive = asyncio.ensure_future(graph.run())
    try:
        send_task = asyncio.ensure_future(sender.send_data(data))
        received = await asyncio.wait_for(receiver.receive_data(),
                                          timeout=timeout)
        await asyncio.wait_for(send_task, timeout=60)
        return received
    finally:
        graph.stop()
        await drive
