"""The port's copy of tests/utils/test_crc16.py: CRC-16-CCITT-FALSE.

``CRC16.calculate`` runs in the port's native library, ``calculate_python``
is the table-driven Python path; both are held to the reference's
vectors (crc16.node.test.ts) and to the JAX package's CRC."""

import time

import numpy as np
import pytest

from webaudio_modem_tpu.utils.crc16 import CRC16 as JaxCRC16
from webaudio_modem_tpu_torch.utils import CRC16

PATHS = {"native": CRC16.calculate, "python": CRC16.calculate_python}


@pytest.fixture(params=sorted(PATHS))
def calc(request):
    return PATHS[request.param]


class TestStandardVectors:
    def test_empty(self, calc):
        assert calc(b"") == 0xFFFF

    def test_single_a(self, calc):
        assert calc(b"A") == 0xB915

    def test_123456789(self, calc):
        assert calc(b"123456789") == 0x29B1

    def test_zero_byte(self, calc):
        assert calc(bytes([0x00])) == 0xE1F0

    def test_ff_byte(self, calc):
        assert calc(bytes([0xFF])) == 0xFF00

    def test_hello_world_consistency(self, calc):
        data = b"Hello, World!"
        assert calc(data) == calc(data) == JaxCRC16.calculate(data)

    def test_different_data_different_crc(self, calc):
        assert calc(b"abc") != calc(b"abd")


class TestVerify:
    def test_verify_good(self):
        data = b"test data"
        assert CRC16.verify(data, CRC16.calculate(data))

    def test_verify_bad(self):
        assert not CRC16.verify(b"test data", 0x1234)

    def test_verify_corrupted(self):
        data = bytearray(b"test data")
        crc = CRC16.calculate(bytes(data))
        data[0] ^= 0x01
        assert not CRC16.verify(bytes(data), crc)


class TestPerformance:
    def test_1kb_under_10ms(self, calc):
        data = bytes(range(256)) * 4
        assert len(data) == 1024
        calc(b"")  # the native library is built at its first call
        start = time.perf_counter()
        calc(data)
        elapsed_ms = (time.perf_counter() - start) * 1000
        assert elapsed_ms < 10

    def test_properties(self, calc):
        assert CRC16.POLYNOMIAL == 0x1021
        assert CRC16.INITIAL_VALUE == 0xFFFF
        assert CRC16.FINAL_XOR == 0x0000
        # single-bit difference changes the CRC
        assert calc(bytes([0x00])) != calc(bytes([0x01]))


class TestBatchRows:
    def test_rows_match_scalar(self, calc):
        rng = np.random.RandomState(3)
        rows = rng.randint(0, 256, (37, 19), dtype=np.uint8)
        got = CRC16.calculate_rows(rows)
        assert got.dtype == np.uint16
        for r, g in zip(rows, got):
            assert int(g) == calc(bytes(r))

    def test_reference_vectors_and_empty(self):
        rows = np.frombuffer(b"123456789", np.uint8)[None, :]
        assert int(CRC16.calculate_rows(rows)[0]) == 0x29B1
        empty = np.zeros((3, 0), np.uint8)
        assert (CRC16.calculate_rows(empty) == 0xFFFF).all()

    def test_rejects_non_matrix(self):
        with pytest.raises(ValueError):
            CRC16.calculate_rows(np.zeros(4, np.uint8))


def test_native_matches_python_and_the_jax_package_random():
    rng = np.random.RandomState(0)
    for _ in range(50):
        data = bytes(rng.randint(0, 256, rng.randint(0, 300),
                                 dtype=np.uint8))
        want = JaxCRC16.calculate(data)
        assert CRC16.calculate(data) == CRC16.calculate_python(data) == want
