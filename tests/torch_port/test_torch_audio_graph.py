"""Mirror of ``tests/runtime/test_audio_graph.py`` against the port.

AudioGraph tests: mixing topology, channel effects, pacing."""

import time

import numpy as np

from webaudio_modem_tpu_torch.core import IAudioProcessor
from webaudio_modem_tpu_torch.runtime import AudioGraph


class ToneSource(IAudioProcessor):
    def __init__(self, value):
        self.value = value
        self.heard = []

    def process(self, inputs, outputs):
        self.heard.append(inputs.copy())
        outputs[:] = self.value
        return True


def test_hub_mixes_all_outputs_to_all_inputs():
    a, b = ToneSource(0.25), ToneSource(0.5)
    graph = AudioGraph(quantum=4)
    graph.connect(a)
    graph.connect(b)
    mix = graph.step()
    np.testing.assert_allclose(mix, 0.75)
    graph.step()
    # both processors hear the same mix on the next quantum
    np.testing.assert_allclose(a.heard[1], 0.75)
    np.testing.assert_allclose(b.heard[1], 0.75)


def test_channel_fn_applied():
    a = ToneSource(1.0)
    graph = AudioGraph(quantum=4, channel_fn=lambda x: x * 0.5)
    graph.connect(a)
    mix = graph.step()
    np.testing.assert_allclose(mix, 0.5)


def test_gain():
    a = ToneSource(1.0)
    graph = AudioGraph(quantum=4, gain=0.1)
    graph.connect(a)
    np.testing.assert_allclose(graph.step(), 0.1)


async def test_run_max_steps():
    graph = AudioGraph(quantum=4)
    graph.connect(ToneSource(0.0))
    await graph.run(max_steps=10)
    assert graph.steps == 10


async def test_realtime_pacing():
    # 20 quanta of 480 samples at 48 kHz = 200 ms of audio; the
    # realtime clock must hold rendering to >= ~200 ms wall
    graph = AudioGraph(quantum=480, sample_rate=48000)
    graph.connect(ToneSource(0.0))
    t0 = time.monotonic()
    await graph.run(max_steps=20, realtime=True)
    elapsed = time.monotonic() - t0
    assert elapsed >= 0.18
