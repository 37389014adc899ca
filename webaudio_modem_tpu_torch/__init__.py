"""webaudio_modem_tpu_torch — the PyTorch / CUDA port of webaudio_modem_tpu.

The JAX package ``webaudio_modem_tpu`` is the reference; this package
mirrors its module names so each ported module's counterpart is easy to
find:

  utils.device        require_cuda(): the card, or an error (no CPU fallback)
  models.config       FSKConfig / FSKParams (same fields and derivation)
  models.fsk          FSKCore, the B=1 facade
  models.farm         ModemFarm, B independent streaming channels
  ops.fsk_mod         batched phase-continuous FSK synthesis
  ops.fsk_demod       streaming hard-decision demodulator (demod_chunk)
  ops.kernels         hand-written Hopper kernels (csrc/*.cu) and their
                      plain PyTorch versions

Only the streaming hard-FSK path is ported so far (ROADMAP.md, queue 1).
Importing this package imports torch and numpy only; kernels are built
with nvcc the first time a CUDA tensor reaches them.
"""

__version__ = "0.1.0"
