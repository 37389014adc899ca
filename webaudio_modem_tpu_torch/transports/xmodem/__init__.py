from webaudio_modem_tpu_torch.transports.xmodem.types import (  # noqa: F401
    ControlType,
    PacketConstants,
)
from webaudio_modem_tpu_torch.transports.xmodem.packet import (  # noqa: F401
    DataPacket,
    XModemPacket,
)
from webaudio_modem_tpu_torch.transports.xmodem.xmodem import (  # noqa: F401
    State,
    XModemConfig,
    XModemTransport,
)
