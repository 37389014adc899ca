"""PSKConfig and PSKCore — the single-channel DBPSK modem facade.

Counterpart of ``webaudio_modem_tpu/models/psk.py``: the same
``configure`` / ``modulate_data`` / ``demodulate_data`` / ``reset`` /
``get_status`` / ``get_signal_quality`` surface and streaming contract
as FSKCore, over the DBPSK ops (``ops/psk.py``), on the device given at
construction (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from webaudio_modem_tpu_torch.core import IModulator, SignalQuality
from webaudio_modem_tpu_torch.models.config import FSKParams
from webaudio_modem_tpu_torch.ops import psk as psk_ops
from webaudio_modem_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PSKConfig:
    sample_rate: int = 48000
    baud_rate: int = 1200
    carrier_frequency: float = 1800.0
    preamble_pattern: tuple = (0x55, 0x55)
    sfd_pattern: tuple = (0x7E,)
    start_bits: int = 1
    stop_bits: int = 1
    parity: str = "none"
    sync_threshold: float = 0.85
    agc_enabled: bool = True
    pre_filter_bandwidth: float = 800.0

    def replace(self, **kwargs) -> "PSKConfig":
        return dataclasses.replace(self, **kwargs)


DEFAULT_PSK_CONFIG = PSKConfig()


def params_from_config(config: PSKConfig) -> FSKParams:
    """The shared pipeline parameters of a PSKConfig."""
    return psk_ops.psk_params(
        carrier_frequency=config.carrier_frequency,
        baud_rate=config.baud_rate,
        sample_rate=config.sample_rate,
        preamble_pattern=tuple(config.preamble_pattern),
        sfd_pattern=tuple(config.sfd_pattern),
        start_bits=config.start_bits,
        stop_bits=config.stop_bits,
        parity=config.parity,
        sync_threshold=config.sync_threshold,
        agc_enabled=config.agc_enabled,
        pre_filter_bandwidth=config.pre_filter_bandwidth)


class PSKCore(IModulator):
    name = "PSK"
    type = "PSK"

    def __init__(self, config: Optional[PSKConfig] = None, *,
                 device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self._config: Optional[PSKConfig] = None
        self.params: Optional[FSKParams] = None
        self._state: Optional[psk_ops.PSKDemodState] = None
        self._ds_phase = 0
        if config is not None:
            self.configure(config)

    def configure(self, config: PSKConfig) -> None:
        if isinstance(config, dict):
            config = PSKConfig(**config)
        self._config = config
        self.params = params_from_config(config)
        self._state = psk_ops.init_state(self.params, 1, self.device)
        self._ds_phase = 0
        self._ready = True
        self.emit("configured")

    def get_config(self) -> PSKConfig:
        return self._config

    def modulate_data(self, data) -> np.ndarray:
        if not self._ready:
            raise RuntimeError("PSK modulator not configured")
        return psk_ops.modulate(self.params, bytes(data), self.device)

    def demodulate_data(self, samples) -> bytes:
        if not self._ready:
            raise RuntimeError("PSK demodulator not configured")
        samples = np.asarray(samples, dtype=np.float32)
        if len(samples) == 0:
            return b""
        x = torch.from_numpy(samples).to(self.device)[None]
        result = bytearray()
        # power-of-two pieces, as the reference cuts them
        offset, n = 0, len(samples)
        while offset < n:
            piece = 1 << ((n - offset).bit_length() - 1)
            self._state, out = psk_ops.demod_chunk(
                self.params, self._ds_phase, self._state,
                x[:, offset:offset + piece])
            self._ds_phase = (self._ds_phase + piece) \
                % self.params.downsample_ratio
            count = int(out.byte_count[0])
            if count:
                result += bytes(out.bytes_out[0, :count].cpu().numpy())
            for _ in range(int(out.eod_fired[0])):
                self.emit("eod")
            offset += piece
        return bytes(result)

    def reset(self) -> None:
        if self.params is not None:
            self._state = psk_ops.init_state(self.params, 1, self.device)
            self._ds_phase = 0
        self.emit("reset")

    def get_status(self) -> dict:
        s = self._state
        return {
            "ready": self._ready,
            "frame_started": bool(s.started[0]) if s is not None else False,
            "sync_detections": int(s.sync_count[0]) if s is not None else 0,
            "eod_events": int(s.eod_count[0]) if s is not None else 0,
        }

    def get_signal_quality(self) -> SignalQuality:
        if self._state is None:
            return SignalQuality()
        ber, freq, jitter, eye = psk_ops.quality_from_state(self.params,
                                                            self._state)
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
