"""ModemFarm — thousands of independent streaming modem channels on one card.

Counterpart of ``webaudio_modem_tpu/models/farm.py``: B concurrent
48 kHz streams demodulated with carried filter, NCO, sync and framing
state, through the same ``demod_chunk`` as the B=1 facade of the
config's family: an FSKConfig runs the FSK pipeline (FSKCore's), a
PSKConfig DBPSK (PSKCore's).  Channels are a tensor dimension on the
device given at construction (the card unless the caller asks for the
CPU).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import List, Optional, Sequence

import numpy as np
import torch

from webaudio_modem_tpu_torch.core import SignalQuality
from webaudio_modem_tpu_torch.models import checkpoint
from webaudio_modem_tpu_torch.models import psk as psk_model
from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams
from webaudio_modem_tpu_torch.ops import fsk_demod, fsk_mod, psk
from webaudio_modem_tpu_torch.utils.device import resolve_device
from webaudio_modem_tpu_torch.utils.trace import metrics


_FSK_OPS = SimpleNamespace(init_state=fsk_demod.init_state,
                           demod_chunk=fsk_demod.demod_chunk,
                           make_demod_chunk=fsk_demod.make_demod_chunk,
                           modulate_batch=fsk_mod.modulate_batch,
                           quality_from_state=fsk_demod.quality_from_state)
_PSK_OPS = SimpleNamespace(init_state=psk.init_state,
                           demod_chunk=psk.demod_chunk,
                           make_demod_chunk=psk.make_demod_chunk,
                           modulate_batch=psk.modulate_batch,
                           quality_from_state=psk.quality_from_state)


def _resolve_family(config):
    """(ops, params) of a config's model family."""
    if isinstance(config, psk_model.PSKConfig):
        return _PSK_OPS, psk_model.params_from_config(config)
    if isinstance(config, FSKConfig):
        return _FSK_OPS, FSKParams.from_config(config)
    raise NotImplementedError(
        f"{type(config).__name__}: ModemFarm takes an FSKConfig or a "
        "PSKConfig")


class ModemFarm:
    def __init__(self, config, batch: int, *, device="cuda", mesh=None,
                 donate: bool = True):
        """``config`` selects the model family: an FSKConfig runs the FSK
        pipeline, a PSKConfig DBPSK on the same shared stages.

        ``donate`` is the reference's buffer-donation switch, accepted
        for its callers: the chunk step here returns new state tensors
        and donates nothing, so state tensors a caller holds stay valid
        and readable for either value."""
        self._ops, self.params = _resolve_family(config)
        if mesh is not None:
            raise NotImplementedError(
                "mesh=: sharding is not ported; ROADMAP queue 1, slice G "
                "(item 18) decides what replaces it")
        self.config = config
        self.batch = batch
        self.device = resolve_device(device)
        if fsk_demod.AUTO_WARM_QUALITY:
            fsk_demod.warm_quality_calibration(
                self.params, family="psk" if isinstance(
                    config, psk_model.PSKConfig) else "fsk")
        self.state = self._ops.init_state(self.params, batch, self.device)
        self._ds_phase = 0

    # -- modulation ---------------------------------------------------------

    def modulate(self, messages: Sequence[bytes]) -> torch.Tensor:
        """[B] equal-length messages -> f32 [B, T] signal on the device."""
        if len(messages) != self.batch:
            raise ValueError(f"expected {self.batch} messages")
        return self._ops.modulate_batch(self.params, messages, self.device)

    # -- streaming demodulation ---------------------------------------------

    def _as_samples(self, samples) -> torch.Tensor:
        x = torch.as_tensor(samples, dtype=torch.float32, device=self.device)
        if x.dim() != 2 or x.shape[0] != self.batch:
            raise ValueError(f"expected [{self.batch}, T] samples, got "
                             f"{tuple(x.shape)}")
        return x

    def demodulate_chunk(self, samples) -> fsk_demod.DemodOut:
        """Feed one [B, T] frame; returns the DemodOut (device tensors).
        Use ``collect_bytes`` to decode on the host."""
        x = self._as_samples(samples)
        self.state, out = self._ops.demod_chunk(
            self.params, self._ds_phase, self.state, x)
        self._ds_phase = (self._ds_phase + x.shape[-1]) \
            % self.params.downsample_ratio
        return out

    @staticmethod
    def collect_bytes(out: fsk_demod.DemodOut) -> List[bytes]:
        counts = out.byte_count.cpu().numpy()
        vals = out.bytes_out.cpu().numpy()
        return [bytes(vals[b, :counts[b]]) for b in range(len(counts))]

    def demodulate(self, samples, chunk_size: Optional[int] = None
                   ) -> List[bytes]:
        """Demodulate a full [B, T] batch (optionally in chunks),
        returning per-channel decoded bytes; the host collects the bytes
        after every chunk."""
        x = self._as_samples(samples)
        T = x.shape[1]
        chunk = chunk_size or T
        collected = [bytearray() for _ in range(self.batch)]
        for start in range(0, T, chunk):
            with metrics.timer("farm.chunk"):
                out = self.demodulate_chunk(x[:, start:start + chunk])
                pieces = self.collect_bytes(out)
            for b, piece in enumerate(pieces):
                collected[b] += piece
        total = sum(len(c) for c in collected)
        if total:
            metrics.incr("farm.bytes_decoded", total)
        return [bytes(c) for c in collected]

    def demodulate_stream(self, samples, chunk_size: int,
                          group: int = 8) -> List[bytes]:
        """Throughput mode: the same per-chunk computation as
        ``demodulate`` (byte for byte the same decode), but the outputs
        of ``group`` consecutive chunks stay on the device, and the host
        collects them only after the group's last chunk (or the stream's
        last chunk), so it waits for the card once per group."""
        if group < 1:
            raise ValueError(f"group must be >= 1, got {group}")
        x = self._as_samples(samples)
        T = x.shape[1]
        collected = [bytearray() for _ in range(self.batch)]
        pending = []
        for start in range(0, T, chunk_size):
            pending.append(self.demodulate_chunk(
                x[:, start:start + chunk_size]))
            if len(pending) < group and start + chunk_size < T:
                continue
            for out in pending:
                counts = out.byte_count.cpu().numpy()
                vals = out.bytes_out.cpu().numpy()
                for b in np.nonzero(counts)[0]:
                    collected[b] += bytes(vals[b, :counts[b]])
            pending = []
        total = sum(len(c) for c in collected)
        if total:
            metrics.incr("farm.bytes_decoded", total)
        return [bytes(c) for c in collected]

    def reset(self) -> None:
        self.state = self._ops.init_state(self.params, self.batch,
                                          self.device)
        self._ds_phase = 0

    # -- checkpoint / resume ------------------------------------------------

    def save(self, path) -> None:
        """Snapshot the full streaming state mid-stream, in the JAX
        package's checkpoint format (``models/checkpoint.py``)."""
        checkpoint.save_state(path, self.state, self.config, self._ds_phase)

    @classmethod
    def restore(cls, path, *, device="cuda",
                donate: bool = True) -> "ModemFarm":
        """Resume a farm from a checkpoint (written by the port or by the
        JAX package) on ``device``; decoding continues bit-identically
        from where the snapshot was taken.  ``donate`` as in the
        constructor."""
        state, config, ds_phase = checkpoint.load_state(path, device=device)
        farm = cls(config, int(state.bit_fill.shape[0]), device=device,
                   donate=donate)
        farm.state = state
        farm._ds_phase = ds_phase
        return farm

    # -- observability ------------------------------------------------------

    def get_status(self) -> dict:
        return {
            "batch": self.batch,
            "sync_detections": self.state.sync_count.cpu().numpy(),
            "eod_events": self.state.eod_count.cpu().numpy(),
            "frames_started": self.state.started.cpu().numpy(),
        }

    def get_signal_quality(self) -> List[SignalQuality]:
        """Per-channel SignalQuality: snr from the carried amplitude
        window, ber from the sync-correlation mismatch, frequency offset
        and phase jitter from the discriminator window statistics (the
        differential phase over one bit period for DBPSK)."""
        ber, freq, jitter, eye = self._ops.quality_from_state(self.params,
                                                              self.state)
        amps = self.state.amp_tail.cpu().numpy()          # [A, B]
        thr = self.state.threshold.cpu().numpy()          # [B]
        active = amps > thr[None, :]
        cnt = active.sum(0)
        asum = np.where(active, amps, 0.0).sum(0)
        mean = asum / np.maximum(cnt, 1)
        var = np.maximum((np.where(active, amps * amps, 0.0).sum(0)
                          / np.maximum(cnt, 1)) - mean * mean, 0.0)
        have = cnt >= 8
        with np.errstate(divide="ignore", invalid="ignore"):
            snr = np.where(have,
                           10 * np.log10((mean ** 2 + 1e-30)
                                         / (var + 1e-12)), 0.0)
        return [SignalQuality(snr=float(snr[b]), ber=float(ber[b]),
                              eye_opening=float(eye[b]),
                              phase_jitter=float(jitter[b]),
                              frequency_offset=float(freq[b]))
                for b in range(self.batch)]
