"""Driver of the ``stream`` mixes: a closed loop over ``ModemFarm``.

A step is ``ModemFarm.demodulate_chunk`` on the next chunk of every
channel's stream, then ``ModemFarm.collect_bytes``: timed on the host
from the dispatch call until the decoded bytes are host objects.  The
farm carries its state from step to step over the replayed cycle.  When
the window closes the farm plays on, untimed, to the end of the cycle,
so every message sent is due; then each channel's decoded bytes are
held to its messages, message by message.
"""

from __future__ import annotations

import time

import torch

from wam_bench.drivers import common
from wam_bench.reference import compare
from wam_bench.traffic import gen_stream

FAULTS = ("state_unchanged", "half_batch", "altered_answer")
CONTROLS = ("state_reset",)


class Driver:
    def __init__(self, cell, config, mix, seed, device, tracer, fault=None,
                 control=None):
        common.check_choice("fault", fault, FAULTS)
        common.check_choice("control", control, CONTROLS)
        self.config, self.mix, self.seed = config, mix, seed
        self.device, self.tracer = device, tracer
        self.fault, self.control = fault, control
        self.batch = int(config["batch"])
        self.chunk = int(config["chunk"])
        self.rec = {}
        self.pieces = []
        self.k = 0

    def setup(self) -> None:
        from webaudio_modem_tpu_torch.models.farm import ModemFarm

        fsk = common.reference_fsk(self.config)
        self.traffic = gen_stream.make(fsk, self.batch, self.chunk, self.mix,
                                       self.seed, self.device)
        self.farm = ModemFarm(common.program_config(self.config),
                              self.batch, device=self.device)
        common.join_background_warmups()
        # the one shape of the window, twice, then a fresh stream
        for k in range(2):
            self.farm.collect_bytes(self.farm.demodulate_chunk(
                self.traffic.chunk_view(k)))
        self.farm.reset()
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _step(self, spans: common.EventSpans):
        farm = self.farm
        if self.control == "state_reset":
            farm.reset()
        before = farm.state
        with self.tracer.span("wam.demodulate_chunk"):
            e = spans.begin()
            out = farm.demodulate_chunk(self.traffic.chunk_view(self.k))
            spans.end(e)
        if self.fault == "state_unchanged":
            farm.state = before
        if self.fault == "altered_answer":
            out.bytes_out[:, 0] ^= 1
        with self.tracer.span("wam.collect_bytes"):
            c0 = time.perf_counter()
            pieces = farm.collect_bytes(out)
            c1 = time.perf_counter()
        if self.fault == "half_batch":
            pieces[self.batch // 2:] = [b""] * (self.batch - self.batch // 2)
        self.pieces.append(pieces)
        self.k += 1
        return c1 - c0

    def window(self, seconds: float) -> None:
        tr = self.tracer
        latency, collect = [], []
        traced = 0
        tr.start()
        spans = common.EventSpans(tr.active)
        t_start = time.perf_counter()
        deadline = t_start + seconds
        trace_end = t_start + float(self.mix["trace_seconds"])
        t_end = t_start
        while True:
            t0 = time.perf_counter()
            if t0 >= deadline:
                break
            if tr.active and t0 >= trace_end:
                tr.stop()
                spans.on = False
            if tr.active:
                traced += 1
            collect.append(self._step(spans))
            t_end = time.perf_counter()
            latency.append(t_end - t0)
        self.n_window = len(latency)
        n_ds = (self.chunk + 1) // 2
        self.rec.update(
            window_s=t_end - t_start,
            step_latency_s=latency,
            collect_ms=[1e3 * c for c in collect],
            chunk_device_ms=spans.ms(),
            launches={"k1": {f"T{self.chunk}_B{self.batch}": traced},
                      "k2": {f"n{n_ds}_B{self.batch}": traced}}
            if traced else {})

    def finish(self) -> None:
        """Play on to the end of the cycle: every message sent is due."""
        while self.k % self.traffic.n_chunks:
            self._step(common.EventSpans(False))
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def release(self) -> None:
        self.farm = None
        self.traffic.audio = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        cycles = self.k // self.traffic.n_chunks
        due = lost = stray = exact = 0
        for b, got in enumerate(zip(*self.pieces)):
            d, n_lost, n_stray = compare.compare_stream(
                b"".join(got), self.traffic.messages[b], cycles)
            due += d
            lost += n_lost
            stray += n_stray
            exact += n_lost == 0 and n_stray == 0
        audio_s = self.chunk / float(self.config["fsk"]["sample_rate"])
        self.rec.update(
            attempted=due, failed=lost,
            step_channel_audio_s=[exact * audio_s] * self.n_window)
        return [{"name": "lost_messages", "value": lost, "limit": 0},
                {"name": "stray_bytes", "value": stray, "limit": 0}]
