"""Bloom filter: rejects absent keys before a lookup touches per-file
metadata. The port of ``opengemini_tpu/utils/bloom.py``, whole.

Double hashing over blake2b: h_i(x) = h1 + i*h2 (Kirsch-Mitzenmacher),
bits in a numpy uint8 array. Sized for a target false-positive rate at
build time; lookups are O(k) with no allocation.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np


def _hash_pair(key: bytes) -> tuple[int, int]:
    d = hashlib.blake2b(key, digest_size=16).digest()
    return int.from_bytes(d[:8], "little"), int.from_bytes(d[8:], "little") | 1


class BloomFilter:
    def __init__(self, capacity: int, fp_rate: float = 0.01):
        capacity = max(1, capacity)
        m = max(8, int(-capacity * math.log(fp_rate) / (math.log(2) ** 2)))
        self.m = (m + 7) // 8 * 8
        self.k = max(1, round(self.m / capacity * math.log(2)))
        self.bits = np.zeros(self.m // 8, dtype=np.uint8)

    @staticmethod
    def _key(item) -> bytes:
        if isinstance(item, bytes):
            return item
        if isinstance(item, str):
            return item.encode("utf-8")
        return int(item).to_bytes(8, "little", signed=True)

    def add(self, item) -> None:
        h1, h2 = _hash_pair(self._key(item))
        for i in range(self.k):
            bit = (h1 + i * h2) % self.m
            self.bits[bit >> 3] |= 1 << (bit & 7)

    def might_contain(self, item) -> bool:
        h1, h2 = _hash_pair(self._key(item))
        for i in range(self.k):
            bit = (h1 + i * h2) % self.m
            if not (self.bits[bit >> 3] >> (bit & 7)) & 1:
                return False
        return True

    def __contains__(self, item) -> bool:
        return self.might_contain(item)
