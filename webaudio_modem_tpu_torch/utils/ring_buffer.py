"""Circular buffer over a numpy array: the port's copy of
``webaudio_modem_tpu/utils/ring_buffer.py``.

Overwrite-oldest on overflow, negative indexing, zero-fill underflow
reads.  Used on the host for demodulated byte queues.
"""

from __future__ import annotations

from typing import Iterable, Union

import numpy as np


class RingBuffer:
    def __init__(self, dtype: Union[type, np.dtype, str], size: int):
        size = int(size)  # JS ToIndex truncates fractional sizes
        if size <= 0:
            raise ValueError("RingBuffer size must be positive")
        self._buffer = np.zeros(size, dtype=dtype)
        self._read_index = 0
        self._write_index = 0
        self._length = 0
        self._max_length = size

    def __len__(self) -> int:
        return self._length

    @property
    def length(self) -> int:
        return self._length

    @property
    def capacity(self) -> int:
        return self._max_length

    def get(self, index: int):
        if index < 0:
            index += self._length
        if index < 0 or index >= self._length:
            raise IndexError("Index out of bounds")
        return self._buffer[(self._read_index + index) % self._max_length]

    def put(self, *values) -> None:
        for value in values:
            self._buffer[self._write_index] = value
            self._write_index = (self._write_index + 1) % self._max_length
            if self._length < self._max_length:
                self._length += 1
            else:  # overwrite oldest
                self._read_index = (self._read_index + 1) % self._max_length

    def remove(self):
        if self._length == 0:
            raise IndexError("Buffer is empty")
        value = self._buffer[self._read_index]
        self._read_index = (self._read_index + 1) % self._max_length
        self._length -= 1
        return value

    def read(self):
        return self.remove() if self._length > 0 else self._buffer.dtype.type(0)

    def write(self, value) -> None:
        self.put(value)

    def write_array(self, samples: Union[np.ndarray, Iterable]) -> None:
        """Bulk put, vectorized (no per-element Python)."""
        arr = np.asarray(samples, dtype=self._buffer.dtype).ravel()
        n = len(arr)
        if n == 0:
            return
        if n >= self._max_length:
            # only the newest max_length survive (overwrite-oldest)
            self._buffer[:] = arr[n - self._max_length:]
            self._read_index = 0
            self._write_index = 0
            self._length = self._max_length
            return
        w = self._write_index
        first = min(n, self._max_length - w)
        self._buffer[w:w + first] = arr[:first]
        if n > first:
            self._buffer[:n - first] = arr[first:]
        overflow = max(0, self._length + n - self._max_length)
        self._write_index = (w + n) % self._max_length
        self._length = min(self._length + n, self._max_length)
        if overflow:
            self._read_index = (self._read_index + overflow) \
                % self._max_length

    def read_array(self, output: np.ndarray) -> None:
        """Bulk read into ``output``, vectorized; zero-fills when the
        buffer underflows."""
        want = len(output)
        n = min(want, self._length)
        r = self._read_index
        first = min(n, self._max_length - r)
        output[:first] = self._buffer[r:r + first]
        if n > first:
            output[first:n] = self._buffer[:n - first]
        if want > n:
            output[n:] = 0
        self._read_index = (r + n) % self._max_length
        self._length -= n

    def remove_array(self, count: int) -> np.ndarray:
        """Remove and return up to ``count`` elements as an array."""
        n = min(int(count), self._length)
        out = np.empty(n, dtype=self._buffer.dtype)
        self.read_array(out)
        return out

    def available_read(self) -> int:
        return self._length

    def available_write(self) -> int:
        return self._max_length - self._length

    def has_space(self, min_space: int) -> bool:
        return self.available_write() > min_space

    def clear(self) -> None:
        self._read_index = 0
        self._write_index = 0
        self._length = 0

    def to_array(self) -> np.ndarray:
        result = np.zeros(self._length, dtype=self._buffer.dtype)
        for i in range(self._length):
            result[i] = self.get(i)
        return result
