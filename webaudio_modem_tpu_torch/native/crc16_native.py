"""ctypes facade for the native CRC-16 (``modem_native.cpp``); the
library is built at the first call, not at import, and a failed build
raises."""

from __future__ import annotations

from webaudio_modem_tpu_torch.native import get_lib


def calculate(data: bytes) -> int:
    return int(get_lib().wam_crc16(data, len(data)))
