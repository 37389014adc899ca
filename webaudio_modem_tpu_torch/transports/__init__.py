"""Data-link transports of the port: XModem ARQ and the FEC frame
layer."""

from webaudio_modem_tpu_torch.transports.fec_frame import (  # noqa: F401
    FrameDecoder,
    FrameEncoder,
)
from webaudio_modem_tpu_torch.transports.xmodem import (  # noqa: F401
    ControlType,
    XModemConfig,
    XModemPacket,
    XModemTransport,
)
