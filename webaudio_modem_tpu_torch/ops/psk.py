"""DBPSK modem ops — the farm's second model family, PyTorch port.

Counterpart of ``webaudio_modem_tpu/ops/psk.py``.  The scheme:

  TX  framed bits (the same UART framing, preamble and SFD as FSK) are
      differentially encoded — bit 1 keeps the carrier phase, bit 0 flips
      it by pi — on a single carrier.
  RX  the FSK front end (AGC, band-pass, NCO mix, I/Q low-pass, 2x
      average), then the decision sign(Re(z_k conj(z_{k-D}))) against the
      downsampled sample one bit period (D = ds_samples_per_bit) earlier:
      kernel K6, ``ops/kernels/psk_seq.py``.  Stages C and D (sync
      correlation, framing kernel K2) and the quality window are the FSK
      family's own (``fsk_demod.sync_and_frame``).

Parameters are an ``FSKParams`` with mark == space == the carrier: the
pre-filter is a band-pass around it and the I/Q low-passes cut at the
baud rate, the front end DBPSK needs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Sequence, Tuple

import numpy as np
import torch

from webaudio_modem_tpu_torch.models.config import FSKConfig, FSKParams
from webaudio_modem_tpu_torch.ops import fsk_demod, fsk_mod
from webaudio_modem_tpu_torch.ops.kernels import psk_seq
from webaudio_modem_tpu_torch.utils.device import resolve_device

_TWO_PI = 2.0 * np.pi
# the reference PSKDemodState's front-end fields, in the front plane's order
_FRONT_FIELDS = fsk_demod._FRONT_FIELDS[:5]


def psk_params(carrier_frequency: float = 1800.0, baud_rate: int = 1200,
               sample_rate: int = 48000, **overrides) -> FSKParams:
    """Shared pipeline parameters for a DBPSK carrier: an ``FSKParams``
    with mark == space == ``carrier_frequency``."""
    config = FSKConfig(sample_rate=sample_rate, baud_rate=baud_rate,
                       mark_frequency=carrier_frequency,
                       space_frequency=carrier_frequency, **overrides)
    return FSKParams.from_config(config)


# ---------------------------------------------------------------------------
# Modulation
# ---------------------------------------------------------------------------

def modulate_batch(params: FSKParams, messages: Sequence[bytes],
                   device="cuda") -> torch.Tensor:
    """Differentially encoded BPSK on the carrier for a batch of
    equal-length messages -> f32 [B, T] on ``device``, in FSK's signal
    layout (2 bit-times of lead, one byte-time of trailing silence).  The
    per-bit phase offsets are float64 on the host; the sine expansion
    runs on the device (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    if len({len(m) for m in messages}) != 1:
        raise ValueError("modulate_batch requires equal-length messages")
    bits = fsk_mod.frame_bits_batch(params, [bytes(m) for m in messages])
    # differential encoding: bit 1 keeps the phase, bit 0 flips it
    enc = np.cumsum(bits == 0, axis=-1, dtype=np.int64) % 2
    omega = _TWO_PI * params.center_freq / params.sample_rate
    carrier = (np.arange(bits.shape[-1], dtype=np.float64) * omega
               * params.samples_per_bit)
    offsets = np.mod(carrier[None, :] + np.pi * enc, _TWO_PI)
    lead = params.samples_per_bit * 2
    trail = params.bits_per_byte * params.samples_per_bit
    return fsk_mod._synth(offsets, np.full(bits.shape, omega),
                          params.samples_per_bit, (lead, trail), device)


def modulate(params: FSKParams, data: bytes, device="cuda") -> np.ndarray:
    """Modulate one message on ``device`` -> float32 numpy [T]."""
    return modulate_batch(params, [data], device)[0].cpu().numpy()


# ---------------------------------------------------------------------------
# Carried state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PSKDemodState(fsk_demod.DemodState):
    """The FSK family's carried state (``fsk_demod.DemodState``) with the
    front plane cut to the 15 shared front-end rows ([15, B], the
    reference's ``psk_seq._pack_fr`` order) and the one-bit-period delay
    line of averaged samples:

      ring  f32 [2D, B]  the last D I samples, then the last D Q samples,
                         each oldest first (always so: no ring index)
    """

    ring: torch.Tensor


def init_state(params: FSKParams, batch: int = 1,
               device="cuda") -> PSKDemodState:
    """A fresh carried state of ``batch`` channels on ``device`` (the card
    unless the caller asks for the CPU)."""
    base = fsk_demod.init_state(params, batch, device)
    D = params.ds_samples_per_bit
    return PSKDemodState(
        **{**vars(base), "front": base.front[:psk_seq.N_FRONT].clone()},
        ring=torch.zeros((2 * D, batch), dtype=torch.float32,
                         device=device))


def state_from_reference(fields: Mapping[str, np.ndarray],
                         device) -> PSKDemodState:
    """Build the port's state from a reference ``PSKDemodState`` given as
    numpy arrays by field name (as ``fsk_demod.state_from_reference``
    takes them).  The reference's circular delay lines ``zbuf_i`` /
    ``zbuf_q`` [D, B] are read from their index ``zidx`` (the oldest
    entry) on, so the port's ring is oldest first."""
    zidx = int(np.asarray(fields["zidx"]))
    ring = np.concatenate([
        np.roll(np.asarray(fields[n], np.float32), -zidx, axis=0)
        for n in ("zbuf_i", "zbuf_q")])
    return PSKDemodState(
        **fsk_demod._fields_from_reference(fields, device, _FRONT_FIELDS),
        ring=torch.from_numpy(ring).to(device))


def state_to_reference(state: PSKDemodState) -> dict:
    """The inverse of ``state_from_reference``, with ``zidx`` = 0."""
    out = fsk_demod._fields_to_reference(state, _FRONT_FIELDS)
    ring = state.ring.detach().cpu().numpy()
    D = ring.shape[0] // 2
    out["zbuf_i"], out["zbuf_q"] = ring[:D], ring[D:]
    out["zidx"] = np.int32(0)
    return out


# ---------------------------------------------------------------------------
# Full chunk step
# ---------------------------------------------------------------------------

def demod_chunk(params: FSKParams, ds_phase: int, state: PSKDemodState,
                samples: torch.Tensor, plain: bool = False
                ) -> Tuple[PSKDemodState, fsk_demod.DemodOut]:
    """Process one f32 [B, T] sample frame through the DBPSK pipeline;
    returns (state', outputs).  ``ds_phase`` as for FSK (host-tracked);
    ``plain=True`` runs the plain PyTorch versions of K6 and K2 on
    whatever device the tensors are on."""
    D = params.ds_samples_per_bit
    # R is exact in bf16 only up to D = 256; above it stage C takes the
    # exact cumsum form over the bits
    use_r = D <= 256
    seq = psk_seq.seq_plain if plain else psk_seq.seq
    front, ds_acc, ring, bits, amps, softs, rsum = seq(
        params, ds_phase, state.front, state.ds_acc, state.ring,
        state.bit_tail[-D:] if use_r else None, samples.t().contiguous(),
        emit_rsum=use_r)
    return fsk_demod.sync_and_frame(params, state, bits, amps, softs, rsum,
                                    plain=plain, front=front, ds_acc=ds_acc,
                                    ring=ring)


@functools.lru_cache(maxsize=32)
def _quality_calibration(params: FSKParams):
    """``fsk_demod.quality_calibration`` from K6's plain version (B=1,
    CPU) over a clean DBPSK preamble+SFD+payload signal."""
    x = modulate_batch(params, [b"\x55"], "cpu").t().contiguous()
    state = init_state(params, 1, "cpu")
    _, _, _, bits, amps, softs, _ = psk_seq.seq_plain(
        params, 0, state.front, state.ds_acc, state.ring, None, x,
        emit_rsum=False)
    return fsk_demod.quality_calibration(params, state, bits, amps, softs)


def quality_from_state(params: FSKParams, state: PSKDemodState):
    """SignalQuality estimates [B] (ber, frequency_offset_hz,
    phase_jitter, eye_opening), as ``fsk_demod.quality_from_state`` with
    the DBPSK calibration, the differential delay of one bit period and
    the class separation pi (constellation points at 0 and pi)."""
    return fsk_demod.quality_from_state(
        params, state, delay_ds=params.ds_samples_per_bit, family="psk")


def make_demod_chunk(params: FSKParams, ds_phase: int, donate: bool = True):
    """``demod_chunk`` bound to (params, ds_phase): the counterpart of the
    reference's jitted step, with no compilation.  ``donate`` is the
    reference's buffer-donation switch, accepted for its callers: the
    step returns new state tensors and donates nothing, so the state
    passed in stays valid for either value."""
    return functools.partial(demod_chunk, params, ds_phase)
