"""webaudio_modem_tpu_torch — the PyTorch / CUDA port of webaudio_modem_tpu.

The JAX package ``webaudio_modem_tpu`` is the reference; this package
mirrors its module names so each ported module's counterpart is easy to
find:

  core                contracts: SignalQuality, TransportStatistics,
                      Event, EventEmitter, IModulator, IDataChannel,
                      IAudioProcessor, ITransport, AUDIO_CHUNK_SIZE
  utils.device        resolve_device / require_cuda: the card, or an error
                      (no CPU fallback)
  utils.trace         the metrics registry
  utils.crc16         CRC-16-CCITT-FALSE
  utils.abort         AbortController / AbortSignal for asyncio
  utils.ring_buffer   RingBuffer, the host byte queue
  utils.audio_io      WAV read / write (numpy)
  models.config       FSKConfig / FSKParams (same fields and derivation)
  models.fsk          FSKCore, the B=1 facade
  models.psk          PSKConfig / PSKCore, the DBPSK facade
  models.soft_modem   SoftModemCore, the soft-FEC facade (streaming
                      SoftFrameDecoder behind the FSKCore surface)
  models.farm         ModemFarm, B independent streaming channels (FSK
                      or DBPSK, by the config's type); save / restore
  models.checkpoint   save_state / load_state in the JAX package's file
                      format (a snapshot continues across packages)
  models.v21          V21Station / V21Duplex, ITU-T V.21 full duplex
  golden              GoldenFSK, the numpy scalar comparator (a copy)
  ops.filters         Butterworth biquad and windowed-sinc FIR design,
                      fir_apply and biquad_scan
  ops.fsk_mod         batched phase-continuous FSK synthesis
  ops.fsk_demod       streaming hard-decision demodulator (demod_chunk,
                      K1 + K2) and stage_d, stage D's per-step events (K8)
  ops.psk             DBPSK modulator and demodulator (demod_chunk)
  ops.fec             K=7 rate-1/2 convolutional code, batched Viterbi
  ops.soft_fsk        soft-decision FEC frames: encode, farm batch decode,
                      the streaming single-channel decoder
  ops.soft_blind      BlindSoftBatchReceiver, blind batched acquisition
  sim                 channel simulators (numpy, and make_device_awgn),
                      the BER harness (ber_sweep against the golden
                      model) and the impairment sweeps
  ops.kernels         hand-written Hopper kernels (csrc/*.cu) and their
                      plain PyTorch versions
  runtime             the streaming runtime: ChunkedModulator,
                      FSKProcessor (the realtime processor over an
                      FSKCore, PSKCore or SoftModemCore), the in-memory
                      data channels and the simulated AudioGraph
  transports          data-link ARQ: XModem packets and state machine

Ported so far: the streaming hard-FSK path, the farm soft-FEC decode,
DBPSK, soft-frame acquisition (the blind receiver and the streaming
soft decoder), the BER and V.21 configurations with the golden
comparator, the impairment sweeps and checkpoints, and the interactive
path: XModem over the realtime processor and the audio graph (ROADMAP.md,
queue 1); every TPU kernel has its Hopper kernel (K1-K8).  The entry points run on the card
unless the caller passes ``device="cpu"``.  Importing this package
imports torch and numpy only, never the JAX package; kernels are built
with nvcc the first time a CUDA tensor reaches them.
"""

__version__ = "0.1.0"

from webaudio_modem_tpu_torch.core import (  # noqa: F401
    Event,
    EventEmitter,
    IDataChannel,
    IModulator,
    ITransport,
    SignalQuality,
    TransportStatistics,
)
from webaudio_modem_tpu_torch.utils import (  # noqa: F401
    CRC16,
    AbortController,
    AbortError,
    AbortSignal,
    RingBuffer,
)
from webaudio_modem_tpu_torch.runtime import (  # noqa: F401
    AudioGraph,
    ChunkedModulator,
    FSKProcessor,
    QueueDataChannel,
)
from webaudio_modem_tpu_torch.transports import (  # noqa: F401
    ControlType,
    XModemConfig,
    XModemPacket,
    XModemTransport,
)
