"""Data-link transports of the port: XModem ARQ."""

from webaudio_modem_tpu_torch.transports.xmodem import (  # noqa: F401
    ControlType,
    XModemConfig,
    XModemPacket,
    XModemTransport,
)
