"""BER evaluation harness (BASELINE config 2) — PyTorch port.

Counterpart of ``webaudio_modem_tpu/sim/ber.py``: decoded byte and bit
error rates of a demodulator over an AWGN channel at given SNRs, a batch
of messages per SNR decoded at once (``ModemFarm.demodulate`` with the
whole signal as one chunk, on ``device``), with the golden scalar model
(``golden/fsk_golden.py``) as the reference comparator.

The noise is the reference's, drawn on the host: one
``np.random.RandomState(seed + int(snr * 1000) % 99991)`` per SNR and the
port's copy of ``awgn_snr`` per message, over the clean signal
modulated on the CPU, so the same seed gives the same noisy signals as
the JAX package (to the modulators' 1e-5) and, on any device, the same
signals as on the CPU.

The error metric is frame-oriented, as the reference's tests judge
decoding (exact byte match): for each message, bit errors = hamming
(decoded, sent) counted over the common length, plus 8 bits per missing
or extra byte.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from webaudio_modem_tpu_torch.golden import GoldenFSK
from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams
from webaudio_modem_tpu_torch.models.farm import ModemFarm
from webaudio_modem_tpu_torch.ops import fsk_mod
from webaudio_modem_tpu_torch.sim.channels import awgn_snr, signal_power
from webaudio_modem_tpu_torch.utils.device import resolve_device

_POPCOUNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                          axis=1).sum(1)
# messages per noise draw in ``noisy_batch``: bounds the f64 draw's size
_ROWS_PER_DRAW = 512


def bit_errors(sent: bytes, decoded: bytes) -> int:
    n = min(len(sent), len(decoded))
    errors = 8 * (max(len(sent), len(decoded)) - n)
    if n:
        a = np.frombuffer(sent[:n], dtype=np.uint8)
        b = np.frombuffer(decoded[:n], dtype=np.uint8)
        errors += int(_POPCOUNT[a ^ b].sum())
    return errors


@dataclasses.dataclass
class BERPoint:
    snr_db: float
    messages: int
    byte_errors: int
    bit_errors: int
    total_bits: int

    @property
    def ber(self) -> float:
        return self.bit_errors / max(self.total_bits, 1)

    @property
    def fer(self) -> float:
        """Frame error rate: fraction of messages not decoded exactly."""
        return self.byte_errors / max(self.messages, 1)


def clean_signal(config: FSKConfig, message: bytes) -> np.ndarray:
    """The sweep's clean signal: ``message`` modulated on the CPU, f32
    numpy [T]."""
    return fsk_mod.modulate(FSKParams.from_config(config), message, "cpu")


def noisy_batch(clean: np.ndarray, snr_db: float, messages: int,
                seed: int = 0) -> np.ndarray:
    """The sweep's noisy signals at ``snr_db``: f32 [messages, T].

    The reference draws one ``awgn_snr(clean, snr_db, rng)`` per message;
    the same draws are taken here ``_ROWS_PER_DRAW`` messages at a time
    (``RandomState`` fills a [rows, T] draw row by row from the same
    stream, and every row's power is the clean signal's), so the result
    is equal, and row k is the same whatever ``messages`` is: a subset is
    the first rows."""
    rng = np.random.RandomState(seed + int(snr_db * 1000) % 99991)
    power = signal_power(clean)
    out = np.empty((messages, len(clean)), np.float32)
    for lo in range(0, messages, _ROWS_PER_DRAW):
        n = min(_ROWS_PER_DRAW, messages - lo)
        out[lo:lo + n] = awgn_snr(np.broadcast_to(clean, (n, len(clean))),
                                  snr_db, rng, reference_power=power)
    return out


def ber_sweep(config: FSKConfig, snrs_db: Sequence[float],
              message: bytes = b"\x55\x0f\xa3\xc1",
              messages_per_point: int = 32,
              seed: int = 0,
              demodulate: Optional[Callable[[np.ndarray], List[bytes]]]
              = None, device="cuda") -> List[BERPoint]:
    """Run a BER-vs-SNR sweep.

    ``demodulate``: [B, T] noisy signals -> list of decoded bytes; the
    default is ``ModemFarm(config, messages_per_point, device=device)
    .demodulate``.  Pass ``golden_demodulate(config)`` for the comparator
    curve on identical noise (same seed => identical noisy signals).
    """
    if demodulate is None:
        device = resolve_device(device)

        def demodulate(batch):
            return ModemFarm(config, messages_per_point,
                             device=device).demodulate(batch)

    clean = clean_signal(config, message)
    results = []
    for snr in snrs_db:
        decoded = demodulate(noisy_batch(clean, snr, messages_per_point,
                                         seed))
        byte_err = sum(1 for d in decoded if d != message)
        bits = sum(bit_errors(message, d) for d in decoded)
        results.append(BERPoint(
            snr_db=snr, messages=messages_per_point,
            byte_errors=byte_err, bit_errors=bits,
            total_bits=8 * len(message) * messages_per_point))
    return results


def golden_demodulate(config: FSKConfig) -> Callable[[np.ndarray],
                                                     List[bytes]]:
    """Comparator: decode each signal with a fresh golden scalar model."""
    def run(batch: np.ndarray) -> List[bytes]:
        return [GoldenFSK(config).demodulate(row) for row in batch]

    return run


def ber_parity_report(config: FSKConfig, snrs_db: Sequence[float],
                      device="cuda", **kwargs) -> Dict[str, List[BERPoint]]:
    """Device curve vs golden comparator curve on identical noise."""
    ours = ber_sweep(config, snrs_db, device=device, **kwargs)
    golden = ber_sweep(config, snrs_db,
                       demodulate=golden_demodulate(config), **kwargs)
    return {"device": ours, "golden": golden}
