"""FSKCore — single-channel host facade over the batched demodulator.

Counterpart of ``webaudio_modem_tpu/models/fsk.py``, with the same
``configure`` / ``modulate_data`` / ``demodulate_data`` / ``reset`` /
``get_status`` / ``get_signal_quality`` semantics.  It is a B=1 view of
the same ``demod_chunk`` that drives ModemFarm, on the device given at
construction (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from webaudio_modem_tpu_torch.core import IModulator, SignalQuality
from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams
from webaudio_modem_tpu_torch.ops import fsk_demod, fsk_mod
from webaudio_modem_tpu_torch.utils.device import resolve_device
from webaudio_modem_tpu_torch.utils.trace import metrics


class FSKCore(IModulator):
    name = "FSK"
    type = "FSK"

    def __init__(self, config: Optional[FSKConfig] = None, *,
                 device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self._config: Optional[FSKConfig] = None
        self.params: Optional[FSKParams] = None
        self._state: Optional[fsk_demod.DemodState] = None
        self._ds_phase = 0
        # the silence threshold persists across configure()
        self._threshold_carry: Optional[float] = None
        # debug counters, zeroed by reset()
        self._demodulation_calls = 0
        self._total_samples = 0
        if config is not None:
            self.configure(config)

    # -- configuration ------------------------------------------------------

    def configure(self, config: FSKConfig) -> None:
        if isinstance(config, dict):
            config = FSKConfig.from_dict(config)
        self._config = config
        self.params = FSKParams.from_config(config)
        self._init_state()
        self._ready = True
        if fsk_demod.AUTO_WARM_QUALITY:
            # build the quality calibration in the background, so the
            # first get_signal_quality does not pay for it
            fsk_demod.warm_quality_calibration(self.params)
        self.emit("configured")

    def _init_state(self) -> None:
        self._state = fsk_demod.init_state(self.params, 1, self.device)
        if self._threshold_carry is not None:
            self._state.threshold.fill_(self._threshold_carry)
        self._ds_phase = 0

    def get_config(self) -> FSKConfig:
        return self._config

    # -- modulation ---------------------------------------------------------

    def modulate_data(self, data) -> np.ndarray:
        if not self._ready:
            raise RuntimeError("FSK modulator not configured")
        return fsk_mod.modulate(self.params, bytes(data), self.device)

    # -- demodulation -------------------------------------------------------

    def demodulate_data(self, samples) -> bytes:
        if not self._ready:
            raise RuntimeError("FSK demodulator not configured")
        samples = np.asarray(samples, dtype=np.float32)
        if samples.ndim != 1:
            raise ValueError("demodulate_data expects a 1-D sample array")
        if len(samples) == 0:
            return b""
        self._demodulation_calls += 1
        self._total_samples += len(samples)
        x = torch.from_numpy(samples).to(self.device)[None]
        result = bytearray()
        syncs = eods = 0
        # Power-of-two pieces, as the reference cuts them: the chunk
        # boundaries, and so the quality windows anchored at them, match
        # the reference call for call.
        offset, n = 0, len(samples)
        while offset < n:
            piece = 1 << ((n - offset).bit_length() - 1)
            self._state, out = fsk_demod.demod_chunk(
                self.params, self._ds_phase, self._state,
                x[:, offset:offset + piece])
            self._ds_phase = (self._ds_phase + piece) \
                % self.params.downsample_ratio
            count = int(out.byte_count[0])
            if count:
                result += bytes(out.bytes_out[0, :count].cpu().numpy())
            syncs += int(out.sync_fired[0])
            for _ in range(int(out.eod_fired[0])):
                eods += 1
                self.emit("eod")
            offset += piece
        self._threshold_carry = float(self._state.threshold[0])
        metrics.incr("fsk.demodulate_calls")
        if result:
            metrics.incr("fsk.bytes_decoded", len(result))
        if syncs:
            metrics.incr("fsk.syncs", syncs)
        if eods:
            metrics.incr("fsk.eods", eods)
        return bytes(result)

    # -- state management ---------------------------------------------------

    def reset(self) -> None:
        """Clear the sync bit window, the framing registers, the NCO, the
        I/Q and post filters, the downsample accumulators and the debug
        counters, but keep the AGC gain, the pre-filter state, the
        amplitude window and the adaptive silence threshold (the
        reference's reset() semantics)."""
        self._demodulation_calls = 0
        self._total_samples = 0
        if self.params is not None and self._state is not None:
            old = self._state
            self._init_state()
            front = self._state.front
            front[0:5] = old.front[0:5]          # AGC gain + pre-filter
            self._state = self._state.replace(
                amp_tail=old.amp_tail, amp_fill=old.amp_fill,
                threshold=old.threshold)
            self._threshold_carry = float(old.threshold[0])
        self.emit("reset")

    # -- observability ------------------------------------------------------

    def get_status(self) -> dict:
        s = self._state
        p = self.params
        return {
            "ready": self._ready,
            "frame_started": bool(s.started[0]) if s is not None else False,
            "global_sample_counter": int(s.counter[0])
            if s is not None else 0,
            "sync_detections": int(s.sync_count[0]) if s is not None else 0,
            "eod_events": int(s.eod_count[0]) if s is not None else 0,
            "silence_threshold": float(s.threshold[0])
            if s is not None else 0.01,
            "demodulation_calls": self._demodulation_calls,
            "total_samples_processed": self._total_samples,
            "received_bits_length": int(min(int(s.bit_fill[0]),
                                            p.sync_window))
            if s is not None and p is not None else 0,
            "byte_buffer_length": 0,
        }

    def get_signal_quality(self) -> SignalQuality:
        if self._state is None:
            return SignalQuality()
        ber, freq, jitter, eye = fsk_demod.quality_from_state(
            self.params, self._state)
        snr = 0.0
        amps = self._state.amp_tail[:, 0].cpu().numpy()
        active = amps[amps > float(self._state.threshold[0])]
        if len(active) >= 8:
            mean = float(active.mean())
            std = float(active.std())
            snr = float(10 * np.log10((mean ** 2) / (std ** 2 + 1e-12)))
        return SignalQuality(snr=snr, ber=float(ber[0]),
                             eye_opening=float(eye[0]),
                             phase_jitter=float(jitter[0]),
                             frequency_offset=float(freq[0]))
