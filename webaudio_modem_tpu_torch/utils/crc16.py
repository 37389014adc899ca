"""CRC-16-CCITT-FALSE: the port's copy of
``webaudio_modem_tpu/utils/crc16.py`` (``calculate``, ``verify`` and
``calculate_rows``).

Polynomial 0x1021, initial value 0xFFFF, final XOR 0x0000, MSB-first:
"" -> 0xFFFF, "A" -> 0xB915, "123456789" -> 0x29B1, [0x00] -> 0xE1F0,
[0xFF] -> 0xFF00.  ``calculate`` runs in the native library
(``native/modem_native.cpp``), built at its first call (this module
imports without it; a failed build raises); ``calculate_python`` is the
table-driven (256 entries) Python path it is held against.
"""

from __future__ import annotations

import numpy as np

from webaudio_modem_tpu_torch.native import crc16_native

POLYNOMIAL = 0x1021
INITIAL_VALUE = 0xFFFF
FINAL_XOR = 0x0000


def _build_table() -> tuple:
    table = []
    for byte in range(256):
        crc = byte << 8
        for _ in range(8):
            if crc & 0x8000:
                crc = ((crc << 1) ^ POLYNOMIAL) & 0xFFFF
            else:
                crc = (crc << 1) & 0xFFFF
        table.append(crc)
    return tuple(table)


TABLE = _build_table()


class CRC16:
    POLYNOMIAL = POLYNOMIAL
    INITIAL_VALUE = INITIAL_VALUE
    FINAL_XOR = FINAL_XOR

    @staticmethod
    def calculate(data: bytes | bytearray | memoryview) -> int:
        return crc16_native.calculate(bytes(data))

    @staticmethod
    def calculate_python(data: bytes | bytearray | memoryview) -> int:
        crc = INITIAL_VALUE
        for byte in bytes(data):
            crc = ((crc << 8) & 0xFFFF) ^ TABLE[((crc >> 8) ^ byte) & 0xFF]
        return crc ^ FINAL_XOR

    @staticmethod
    def verify(data: bytes, expected_crc: int) -> bool:
        return CRC16.calculate(data) == expected_crc

    @staticmethod
    def calculate_rows(rows) -> np.ndarray:
        """CRC over each row of a [B, n] uint8 byte matrix -> [B]
        uint16: the table recurrence runs once per byte position with
        all B rows at once."""
        rows = np.asarray(rows, np.uint8)
        if rows.ndim != 2:
            raise ValueError("calculate_rows expects [B, n] bytes")
        table = np.asarray(TABLE, np.uint32)
        crc = np.full(rows.shape[0], INITIAL_VALUE, np.uint32)
        for j in range(rows.shape[1]):
            crc = ((crc << 8) & 0xFFFF) ^ table[((crc >> 8)
                                                 ^ rows[:, j]) & 0xFF]
        return (crc ^ FINAL_XOR).astype(np.uint16)
