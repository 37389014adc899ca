"""Driver of the ``frames`` mixes: batches of soft-FEC frames through
``soft_fsk.decode_frames_batch_async``, pipelined one batch ahead.

A step is one batch: from the dispatch call of batch t (made before
batch t-1 is resolved) until its finalizer has returned the payloads
as host objects.  Every answer of every batch is held to the payload
that was sent, after the window.
"""

from __future__ import annotations

import time

import torch

from wam_bench.drivers import common
from wam_bench.reference import compare, fec_fsk
from wam_bench.traffic import gen_frames

FAULTS = ("half_batch", "altered_answer")
CONTROLS = ("csum_bf16",)
# distinct frames of a run (6 batches of 4096) the decode may give up
# on at 8 dB (a sync miss, or no header found): between the sound runs'
# largest reading and the csum_bf16 control's smallest (PERF.md, "Cells")
ERASED_LIMIT = 7
HEADER_LANES_PER_FRAME = 8       # the decode's header candidates a frame
HEADER_STEPS = 8 * 4 + fec_fsk.K - 1


class Driver:
    def __init__(self, cell, config, mix, seed, device, tracer, fault=None,
                 control=None):
        common.check_choice("fault", fault, FAULTS)
        common.check_choice("control", control, CONTROLS)
        self.config, self.mix, self.seed = config, mix, seed
        self.device, self.tracer = device, tracer
        self.fault, self.control = fault, control
        self.batch = int(config["batch"])
        self.rec = {}
        self.done = []       # (key, results) of every resolved batch
        self.pending = None  # (key, dispatch time, finalizer)
        self.undo = []       # (module, name, original) of what _plant set

    def setup(self) -> None:
        from webaudio_modem_tpu_torch.models.config import FSKParams
        from webaudio_modem_tpu_torch.ops import soft_fsk

        self.soft_fsk = soft_fsk
        self.params = FSKParams.from_config(
            common.program_config(self.config))
        self.fsk = common.reference_fsk(self.config)
        self.traffic = gen_frames.make(self.fsk, self.batch, self.mix,
                                       self.seed, self.device)
        self._plant()
        # every shape of the window, twice
        for key in sorted(self.traffic.audio):
            if key[1] == 0:
                for _ in range(2):
                    self._dispatch(key)()
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _plant(self) -> None:
        """The control or fault, underneath the program's entry; undone
        by ``release``."""
        if self.control == "csum_bf16":
            # K1's csum plane, the soft path's f32 prefix sums, kept in
            # bfloat16: the nearest precision below the configuration's
            # (half of K1's writes, the step that would tempt)
            seq = self.soft_fsk.fsk_seq.seq

            def lowered(*a, **kw):
                out = list(seq(*a, **kw))
                if kw.get("emit_csum"):
                    out[4] = out[4].to(torch.bfloat16).to(out[4].dtype)
                return tuple(out)
            self._swap(self.soft_fsk.fsk_seq, "seq", lowered)
        if self.fault == "altered_answer":
            pack = self.soft_fsk._pack_bodies

            def altered(*a, **kw):
                packed = pack(*a, **kw)
                packed[:, 0] ^= 1
                return packed
            self._swap(self.soft_fsk, "_pack_bodies", altered)

    def _swap(self, module, name: str, value) -> None:
        self.undo.append((module, name, getattr(module, name)))
        setattr(module, name, value)

    def _dispatch(self, key):
        x = self.traffic.audio[key]
        if self.fault == "half_batch":
            x = x[: self.batch // 2]
        return self.soft_fsk.decode_frames_batch_async(
            self.params, x, key[0], device=self.device)

    def _resolve(self):
        key, t0, fin = self.pending
        self.pending = None
        with self.tracer.span("wam.finalize"):
            results = fin()
        t1 = time.perf_counter()
        self.done.append((key, results))
        return key, t1 - t0, t1

    def window(self, seconds: float) -> None:
        tr = self.tracer
        order = self.traffic.order()
        latency, keys, traced = [], [], []
        tr.start()
        t_start = time.perf_counter()
        deadline = t_start + seconds
        trace_end = t_start + float(self.mix["trace_seconds"])
        t_end = t_start
        while True:
            now = time.perf_counter()
            if now >= deadline:
                break
            if tr.active and now >= trace_end:
                if self.pending is not None:
                    key, lat, t_end = self._resolve()
                    latency.append(lat)
                    keys.append(key)
                tr.stop()
            key = next(order)
            t0 = time.perf_counter()
            with tr.span("wam.dispatch"):
                fin = self._dispatch(key)
            if tr.active:
                traced.append(key[0])
            if self.pending is not None:
                k, lat, t_end = self._resolve()
                latency.append(lat)
                keys.append(k)
            self.pending = (key, t0, fin)
        self.n_window = len(latency)
        self.window_keys = keys
        self.rec.update(window_s=t_end - t_start, step_latency_s=latency,
                        decodes_traced=len(traced),
                        launches=self._launches(traced) if traced else {})

    def _launches(self, lengths) -> dict:
        B = self.batch
        k1, k3 = {}, {}
        for pl in lengths:
            T = fec_fsk.frame_samples(self.fsk, pl)
            body = 8 * (pl + 2) + fec_fsk.K - 1
            for d, key in ((k1, f"T{T}_B{B}"),
                           (k3, f"L{B * HEADER_LANES_PER_FRAME}_T"
                                f"{HEADER_STEPS}"),
                           (k3, f"L{B}_T{body}")):
                d[key] = d.get(key, 0) + 1
        return {"k1csum": k1, "k3": k3}

    def finish(self) -> None:
        if self.pending is not None:
            self._resolve()
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def release(self) -> None:
        for module, name, original in reversed(self.undo):
            setattr(module, name, original)
        self.undo = []
        self.traffic.audio = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> list:
        """Every answer of every batch against its payload.  A frame that
        the decode gives up on (None, its CRC failed) is erased; one that
        passes its CRC with other bytes is wrong.  Both count against the
        frame's step; the compared numbers count distinct frames, since
        a batch is decoded many times over."""
        failed = 0
        erased, wrong = set(), set()
        exact = []
        for key, results in self.done:
            want = self.traffic.payloads[key]
            bad = compare.failed_rows(results, want)
            failed += len(bad)
            exact.append(len(want) - len(bad))
            for i in bad:
                got = results[i] if i < len(results) else None
                (erased if got is None else wrong).add((key, i))
        sr = float(self.config["fsk"]["sample_rate"])
        self.rec.update(
            attempted=sum(len(self.traffic.payloads[k]) for k, _ in
                          self.done),
            failed=failed,
            step_channel_audio_s=[
                exact[i] * fec_fsk.frame_samples(self.fsk, key[0]) / sr
                for i, key in enumerate(self.window_keys)])
        return [{"name": "wrong_payloads", "value": len(wrong), "limit": 0},
                {"name": "erased_frames", "value": len(erased),
                 "limit": ERASED_LIMIT}]
