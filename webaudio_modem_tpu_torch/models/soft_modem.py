"""SoftModemCore — the soft-FEC physical layer behind the modem API.

Counterpart of ``webaudio_modem_tpu/models/soft_modem.py``: the same
configure / modulate_data / demodulate_data / reset / get_status /
get_signal_quality surface as ``FSKCore``, so a transport built against a
modem core runs over coded frames unchanged.  Each ``modulate_data``
payload becomes one coded frame (``soft_fsk.encode_frame_signal``); the
receive side is the streaming ``soft_fsk.SoftFrameDecoder``, so frames
decode across any chunk boundaries and ``demodulate_data`` returns the
concatenated payloads.  K1 and the Viterbi (K3) run on the device given
at construction (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from webaudio_modem_tpu_torch.core import EventEmitter, SignalQuality
from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams
from webaudio_modem_tpu_torch.ops import fsk_demod, soft_fsk
from webaudio_modem_tpu_torch.utils.device import resolve_device


class SoftModemCore(EventEmitter):
    """FSKCore-shaped facade over the soft-decision FEC frame path.
    ``rs_parity`` / ``body_code`` (slice E) raise ``NotImplementedError``
    at ``configure``."""

    def __init__(self, config: Optional[FSKConfig] = None,
                 rs_parity: int = 0, body_code=None, *, device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self._rs_parity = rs_parity
        self._body_code = body_code
        self._ready = False
        self.params: Optional[FSKParams] = None
        self._config: Optional[FSKConfig] = None
        self._decoder: Optional[soft_fsk.SoftFrameDecoder] = None
        self._demodulation_calls = 0
        self._total_samples = 0
        if config is not None:
            self.configure(config)

    # -- configuration ----------------------------------------------------

    def configure(self, config) -> None:
        if isinstance(config, dict):
            config = FSKConfig.from_dict(config)
        self._config = config
        self.params = FSKParams.from_config(config)
        self._decoder = soft_fsk.SoftFrameDecoder(
            self.params, rs_parity=self._rs_parity,
            body_code=self._body_code, device=self.device)
        self._ready = True
        if fsk_demod.AUTO_WARM_QUALITY:
            fsk_demod.warm_quality_calibration(self.params)
        self.emit("configured")

    def get_config(self) -> Optional[FSKConfig]:
        return self._config

    def is_ready(self) -> bool:
        return self._ready

    # -- modulation ---------------------------------------------------------

    def modulate_data(self, data) -> np.ndarray:
        if not self._ready:
            raise RuntimeError("Soft modem not configured")
        return soft_fsk.encode_frame_signal(self.params, bytes(data),
                                            device=self.device)

    # -- demodulation ---------------------------------------------------------

    def demodulate_data(self, samples) -> bytes:
        if not self._ready:
            raise RuntimeError("Soft modem not configured")
        samples = np.asarray(samples, np.float32)
        if samples.ndim != 1:
            raise ValueError("demodulate_data expects a 1-D sample "
                             "chunk (FSKCore contract)")
        self._demodulation_calls += 1
        self._total_samples += len(samples)
        if not len(samples):
            return b""
        return b"".join(self._decoder.feed(samples))

    # -- lifecycle / observability ------------------------------------------

    def reset(self) -> None:
        if self._decoder is not None:
            self._decoder.reset()
        self._demodulation_calls = 0
        self._total_samples = 0

    def get_signal_quality(self) -> SignalQuality:
        """FSKCore's five fields.  The decoder records the last decoded
        frame's sync-window statistics itself (the soft stage runs no
        chunk-step quality window); they go into the carried state's
        quality plane before the shared calibrated computation."""
        state = self._decoder._state if self._decoder is not None else None
        if state is None:
            return SignalQuality()
        q = self._decoder.last_sync_quality
        snr = 0.0
        if q is not None:
            ratio, s, ss, n, amp_mean, amp_var = q
            state = state.replace(quality=torch.tensor(
                [[ratio], [s], [ss], [n]], dtype=torch.float32))
            # SNR from the same window's I/Q amplitudes (every sample
            # carries the pattern, so no activity gating is needed)
            if n >= 8:
                snr = float(10 * np.log10((amp_mean ** 2)
                                          / (amp_var + 1e-12)))
        ber, freq, jitter, eye = fsk_demod.quality_from_state(
            self.params, state)
        return SignalQuality(snr=snr, ber=float(ber[0]),
                             eye_opening=float(eye[0]),
                             phase_jitter=float(jitter[0]),
                             frequency_offset=float(freq[0]))

    def get_status(self) -> dict:
        frames = self._decoder.frames_decoded if self._decoder else 0
        return {
            "ready": self._ready,
            "demodulation_calls": self._demodulation_calls,
            "total_samples_processed": self._total_samples,
            # every decoded frame took one sync acquisition
            "sync_detections": frames,
            "frames_decoded": frames,
            "rs_parity": self._rs_parity,
            "body_code": (type(self._body_code).__name__
                          if self._body_code is not None else None),
        }
