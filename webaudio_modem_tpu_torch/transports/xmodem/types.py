"""XModem packet structure constants: the port's copy of
``webaudio_modem_tpu/transports/xmodem/types.py``.

Wire-identical to the JAX package's:
data packet = SOH | SEQ | ~SEQ | LEN | PAYLOAD | CRC-16(BE);
control characters are bare single bytes.
"""

from __future__ import annotations

import enum


class ControlType(enum.IntEnum):
    SOH = 0x01  # Start of Header — data packet follows
    ACK = 0x06  # positive response
    NAK = 0x15  # request (re)transmission
    EOT = 0x04  # end of data stream


class PacketConstants:
    SOH = 0x01
    HEADER_SIZE = 4       # SOH + SEQ + ~SEQ + LEN
    CRC_SIZE = 2
    MIN_PACKET_SIZE = 6
    MAX_PACKET_SIZE = 261
    MAX_PAYLOAD_SIZE = 255
    MAX_SEQUENCE = 255
    MIN_DATA_SEQUENCE = 1
