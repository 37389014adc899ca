"""Impairment sweeps — carrier frequency offset and sample-clock skew.

Counterpart of ``webaudio_modem_tpu/sim/impairments.py``: the tolerance
envelopes of both physical layers (hard FSK through ``ModemFarm``, the
soft-FEC frames through ``SoftModemCore``), on ``device``.

  * **Carrier offset**: the transmitter's mark/space pair sits df Hz
    off nominal (both tones shifted together — an oscillator error).
    The receiver demodulates with the NOMINAL config.
  * **Sample-clock skew**: the receiver's ADC clock runs (1 + eps)
    fast/slow; modeled by linear-interpolation resampling of the
    transmitted signal onto the skewed time grid.

Decode verdicts are frame-exactness.  The clean signals are modulated on
the CPU and the noise is drawn on the host as the reference draws it,
so a sweep sees the same impaired signals on any device; pass
``demodulate=sim.ber.golden_demodulate(config)`` for the golden scalar
comparator on them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams
from webaudio_modem_tpu_torch.models.farm import ModemFarm
from webaudio_modem_tpu_torch.models.soft_modem import SoftModemCore
from webaudio_modem_tpu_torch.ops import fsk_mod, soft_fsk
from webaudio_modem_tpu_torch.sim.ber import bit_errors
from webaudio_modem_tpu_torch.sim.channels import awgn_snr
from webaudio_modem_tpu_torch.utils.device import resolve_device


def clock_skew(signal: np.ndarray, eps: float) -> np.ndarray:
    """Resample ``signal`` as heard by an ADC whose clock runs
    ``1 + eps`` times the transmitter's: output sample k is the input
    at time k * (1 + eps), linearly interpolated.  eps > 0 = receiver
    clock fast (signal appears stretched/slow)."""
    n_out = int(len(signal) / (1.0 + eps)) if eps > 0 else len(signal)
    t = np.arange(n_out, dtype=np.float64) * (1.0 + eps)
    return np.interp(t, np.arange(len(signal), dtype=np.float64),
                     signal).astype(np.float32)


@dataclasses.dataclass
class ImpairmentPoint:
    value: float                  # df (Hz) or eps (fraction)
    messages: int
    frame_errors: int
    bit_errs: int
    total_bits: int

    @property
    def fer(self) -> float:
        return self.frame_errors / max(self.messages, 1)

    @property
    def ber(self) -> float:
        return self.bit_errs / max(self.total_bits, 1)


def _sweep(clean_for: Callable[[float], np.ndarray],
           values: Sequence[float], message: bytes,
           messages_per_point: int, snr_db: Optional[float], seed: int,
           demodulate: Callable[[np.ndarray], List[bytes]]) \
        -> List[ImpairmentPoint]:
    out = []
    for v in values:
        clean = clean_for(v)
        rng = np.random.RandomState(seed + int(abs(v) * 1e6) % 99991)
        if snr_db is None:
            batch = np.stack([clean] * messages_per_point)
        else:
            batch = np.stack([awgn_snr(clean, snr_db, rng)
                              for _ in range(messages_per_point)])
        decoded = demodulate(batch)
        out.append(ImpairmentPoint(
            value=v, messages=messages_per_point,
            frame_errors=sum(1 for d in decoded if d != message),
            bit_errs=sum(bit_errors(message, d) for d in decoded),
            total_bits=8 * len(message) * messages_per_point))
    return out


def _demodulator(config: FSKConfig, soft: bool, device) -> Callable:
    """The sweep's decoder on ``device``: one ModemFarm over the batch
    (hard), or a fresh SoftModemCore per signal (soft)."""
    device = resolve_device(device)
    if soft:
        return lambda batch: [
            SoftModemCore(config, device=device).demodulate_data(row)
            for row in batch]
    return lambda batch: ModemFarm(config, batch.shape[0],
                                   device=device).demodulate(batch)


def _clean(config: FSKConfig, message: bytes, soft: bool) -> np.ndarray:
    """``message`` modulated on the CPU: a soft-FEC frame signal (the
    signal ``SoftModemCore.modulate_data`` makes) or a hard FSK one."""
    params = FSKParams.from_config(config)
    if soft:
        return soft_fsk.encode_frame_signal(params, message, device="cpu")
    return fsk_mod.modulate(params, message, "cpu")


def carrier_offset_sweep(config: FSKConfig,
                         offsets_hz: Sequence[float],
                         message: bytes = b"\x55\x0f\xa3\xc1",
                         messages_per_point: int = 16,
                         snr_db: Optional[float] = 30.0,
                         seed: int = 7, soft: bool = False,
                         demodulate: Optional[Callable] = None,
                         device="cuda") -> List[ImpairmentPoint]:
    """FER/BER vs carrier offset: TX tones at (mark+df, space+df),
    RX at nominal.  ``demodulate`` overrides the decoder (e.g.
    ``sim.ber.golden_demodulate(config)`` for the comparator curve)."""
    if demodulate is None:
        demodulate = _demodulator(config, soft, device)

    def clean_for(df: float) -> np.ndarray:
        return _clean(dataclasses.replace(
            config, mark_frequency=config.mark_frequency + df,
            space_frequency=config.space_frequency + df), message, soft)

    return _sweep(clean_for, offsets_hz, message, messages_per_point,
                  snr_db, seed, demodulate)


def clock_skew_sweep(config: FSKConfig, skews: Sequence[float],
                     message: bytes = b"\x55\x0f\xa3\xc1",
                     messages_per_point: int = 16,
                     snr_db: Optional[float] = 30.0,
                     seed: int = 11, soft: bool = False,
                     demodulate: Optional[Callable] = None,
                     device="cuda") -> List[ImpairmentPoint]:
    """FER/BER vs receiver sample-clock skew ``eps`` (fractional;
    1e-4 = 100 ppm)."""
    if demodulate is None:
        demodulate = _demodulator(config, soft, device)
    clean = _clean(config, message, soft)
    return _sweep(lambda eps: clock_skew(clean, eps), skews, message,
                  messages_per_point, snr_db, seed, demodulate)
