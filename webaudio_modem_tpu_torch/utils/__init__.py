"""Host utilities of the port (abort signals, CRC-16, the ring buffer,
WAV I/O, the metrics registry, the device helpers)."""

from webaudio_modem_tpu_torch.utils.abort import (  # noqa: F401
    AbortController,
    AbortError,
    AbortSignal,
)
from webaudio_modem_tpu_torch.utils.crc16 import CRC16  # noqa: F401
from webaudio_modem_tpu_torch.utils.ring_buffer import RingBuffer  # noqa: F401
