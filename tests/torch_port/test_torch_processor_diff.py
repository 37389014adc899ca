"""The port's ``FSKProcessor`` (on the CPU: the plain versions of K1
and K2) against the JAX package's, quantum by quantum.

Both processors first play out a short modulation through ``process()``,
which arms the post-TX guard, so the next quanta are split at sample
counts that are not powers of two (512 = guard, then 128 guard + 384
live).  Then the same input quanta, a message modulated by the JAX
package with silence around it, go through both.  The bytes each
quantum delivers must be equal, and so must the integer counters of
``get_status()`` and the integer state of both cores after the stream.

The one float of the status, the adaptive silence threshold, is 0.1 x
the mean amplitude over the sync window at the sync fire.  The
amplitudes agree within 1e-4 between the packages (two atan2 / float32
filter implementations; ``test_torch_demod_chunk.py`` holds them so), so
the threshold agrees within 1e-5.
"""

import asyncio
import dataclasses

import numpy as np
import pytest

from torch_port_helpers import reference_fields
from webaudio_modem_tpu.models.config import DEFAULT_FSK_CONFIG as JAX_CONFIG
from webaudio_modem_tpu.models.fsk import FSKCore as JaxCore
from webaudio_modem_tpu.runtime import FSKProcessor as JaxProcessor
from webaudio_modem_tpu_torch.models.config import FSKConfig
from webaudio_modem_tpu_torch.ops import fsk_demod as port_demod
from webaudio_modem_tpu_torch.runtime import FSKProcessor

QUANTUM = 512
THRESHOLD_ATOL = 1e-5
STATE_INTS = ("started", "counter", "sil", "accum", "count", "bsc",
              "next_idx", "byte_cur", "pos", "bit_fill", "amp_fill",
              "sync_count", "eod_count")


def _input_quanta(rng):
    sig = np.asarray(JaxCore(JAX_CONFIG).modulate_data(b"Hi\x06!"),
                     np.float32)
    sig = sig + rng.normal(0, 0.01, len(sig)).astype(np.float32)
    x = np.concatenate([np.zeros(1500, np.float32), sig,
                        np.zeros(2500, np.float32)])
    x = np.pad(x, (0, -len(x) % QUANTUM))
    return x.reshape(-1, QUANTUM)


async def _run(proc, config, quanta):
    """Play out one modulation, then feed ``quanta``; the bytes each
    quantum delivered."""
    proc.configure(config)
    task = asyncio.ensure_future(proc.modulate(b"\x55"))
    await asyncio.sleep(0)
    while not task.done():
        proc.process(np.zeros(QUANTUM, np.float32),
                     np.zeros(QUANTUM, np.float32))
        await asyncio.sleep(0)
    await task
    assert proc._rx_guard == QUANTUM + 128
    per_quantum = []
    for q in quanta:
        proc.process(q, np.zeros(QUANTUM, np.float32))
        buf = proc.demodulated_buffer
        per_quantum.append(bytes(buf.remove_array(len(buf))))
    return per_quantum


async def test_bytes_per_quantum_equal_the_jax_processor():
    quanta = _input_quanta(np.random.default_rng(7))
    ref = JaxProcessor(name="jax")
    got = FSKProcessor(name="port", device="cpu")
    ref_bytes = await _run(ref, JAX_CONFIG, quanta)
    got_bytes = await _run(got, FSKConfig(**dataclasses.asdict(JAX_CONFIG)),
                           quanta)
    assert b"".join(ref_bytes) == b"Hi\x06!"
    assert got_bytes == ref_bytes

    ref_status, got_status = ref.get_status(), got.get_status()
    assert got_status.keys() == ref_status.keys()
    thr = got_status.pop("silence_threshold")
    assert thr == pytest.approx(ref_status.pop("silence_threshold"),
                                abs=THRESHOLD_ATOL)
    assert got_status == ref_status
    assert got_status["sync_detections"] == 1
    assert got_status["process_call_count"] > len(quanta)

    ref_state = reference_fields(ref.fsk_core._state)
    got_state = port_demod.state_to_reference(got.fsk_core._state)
    for name in STATE_INTS:
        np.testing.assert_array_equal(got_state[name], ref_state[name],
                                      err_msg=name)
    np.testing.assert_allclose(got_state["threshold"],
                               ref_state["threshold"], rtol=0,
                               atol=THRESHOLD_ATOL)
