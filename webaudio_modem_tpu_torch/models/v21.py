"""ITU-T V.21 dual-channel full-duplex modem (BASELINE config 4) — PyTorch
port.

Counterpart of ``webaudio_modem_tpu/models/v21.py``.  V.21 is 300 baud
binary FSK with two frequency-division channels sharing one line:
  channel 1 (calling station TX):   mark 980 Hz, space 1180 Hz
  channel 2 (answering station TX): mark 1650 Hz, space 1850 Hz
Each ``V21Station`` owns a modulator on its own channel and a
demodulator (the port's ``FSKCore``) on the opposite one, fronted by a
streaming windowed-sinc band-pass channel-separation filter
(``ops/filters.sinc_bandpass``, 191 taps, ``fir_apply``) that
suppresses the station's own strong local transmission.  Both run on
``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from webaudio_modem_tpu_torch.models.config import FSKConfig
from webaudio_modem_tpu_torch.models.fsk import FSKCore
from webaudio_modem_tpu_torch.ops import filters
from webaudio_modem_tpu_torch.utils.device import resolve_device

V21_BAUD = 300
V21_CH1 = dict(mark_frequency=980.0, space_frequency=1180.0)
V21_CH2 = dict(mark_frequency=1650.0, space_frequency=1850.0)


def v21_config(channel: int, sample_rate: int = 48000,
               **overrides) -> FSKConfig:
    if channel not in (1, 2):
        raise ValueError("V.21 channel must be 1 or 2")
    freqs = V21_CH1 if channel == 1 else V21_CH2
    return FSKConfig(sample_rate=sample_rate, baud_rate=V21_BAUD,
                     **freqs, **overrides)


class V21Station:
    """One end of a V.21 full-duplex link.

    ``channel`` is the station's OWN transmit channel; it receives on
    the other one.  ``separation_taps`` sizes the FIR channel-separation
    filter (odd-tap windowed sinc; larger = sharper split between the
    670 Hz-apart bands).
    """

    def __init__(self, channel: int, sample_rate: int = 48000,
                 separation_taps: int = 191, *, device="cuda",
                 **config_overrides):
        self.device = resolve_device(device)
        self.tx_channel = channel
        self.rx_channel = 2 if channel == 1 else 1
        self.tx_config = v21_config(channel, sample_rate,
                                    **config_overrides)
        self.rx_config = v21_config(self.rx_channel, sample_rate,
                                    **config_overrides)
        self.modulator = FSKCore(self.tx_config, device=self.device)
        self.demodulator = FSKCore(self.rx_config, device=self.device)

        rx_center = (self.rx_config.mark_frequency
                     + self.rx_config.space_frequency) / 2
        # Carson bandwidth for 300 baud, 100 Hz deviation: 800 Hz
        bandwidth = 2 * (abs(self.rx_config.space_frequency
                             - self.rx_config.mark_frequency) / 2
                         + V21_BAUD)
        self._sep_taps = filters.sinc_bandpass(
            rx_center, bandwidth, sample_rate, separation_taps)
        self._sep_history: Optional[torch.Tensor] = None

    # -- TX -----------------------------------------------------------------

    def modulate(self, data: bytes) -> np.ndarray:
        return self.modulator.modulate_data(data)

    # -- RX -----------------------------------------------------------------

    def demodulate(self, line_samples) -> bytes:
        """Feed line audio (own TX + remote TX mixed); returns decoded
        remote bytes.  Streaming: FIR history and demod state carry."""
        line = torch.as_tensor(np.asarray(line_samples, dtype=np.float32),
                               device=self.device)
        self._sep_history, separated = filters.fir_apply(
            self._sep_taps, line[None, :], self._sep_history)
        return self.demodulator.demodulate_data(separated[0].cpu().numpy())

    def reset(self) -> None:
        self.modulator.reset()
        self.modulator.configure(self.tx_config)
        self.demodulator.reset()
        self.demodulator.configure(self.rx_config)
        self._sep_history = None


class V21Duplex:
    """A complete two-station V.21 link over a shared line."""

    def __init__(self, sample_rate: int = 48000, *, device="cuda",
                 **overrides):
        self.calling = V21Station(1, sample_rate, device=device,
                                  **overrides)
        self.answering = V21Station(2, sample_rate, device=device,
                                    **overrides)

    def exchange(self, calling_data: bytes, answering_data: bytes,
                 noise: Optional[np.ndarray] = None):
        """Simultaneously transmit both directions over one line and
        decode both; returns (decoded_at_answering, decoded_at_calling)."""
        sig1 = self.calling.modulate(calling_data)
        sig2 = self.answering.modulate(answering_data)
        n = max(len(sig1), len(sig2))
        line = np.zeros(n, np.float32)
        line[:len(sig1)] += sig1
        line[:len(sig2)] += sig2
        if noise is not None:
            line = line + np.asarray(noise[:n], np.float32)
        got_ch1 = self.answering.demodulate(line)   # answering hears ch1
        got_ch2 = self.calling.demodulate(line)     # calling hears ch2
        return got_ch1, got_ch2
