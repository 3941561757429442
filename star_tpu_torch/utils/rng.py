"""std::mt19937-compatible RNG.

The reference's random choices (multimapper order shuffle, transcriptome
primary-alignment pick) come from std::mt19937 seeded runRNGseed*(chunk+1)
with libstdc++'s uniform_real_distribution<double>(0,1) (= generate_canonical
with 2 32-bit draws).  Bit-identical outputs require replicating both
(reference: ReadAlign.cpp:11-12, ReadAlign_multMapSelect.cpp:71-79,
ReadAlign_quantTranscriptome.cpp:70).
"""
from __future__ import annotations

import math

_N, _M = 624, 397
_MATRIX_A = 0x9908B0DF
_UPPER = 0x80000000
_LOWER = 0x7FFFFFFF
_MASK32 = 0xFFFFFFFF


class MT19937:
    def __init__(self, seed: int):
        self.mt = [0] * _N
        self.mt[0] = seed & _MASK32
        for i in range(1, _N):
            self.mt[i] = (1812433253 * (self.mt[i - 1] ^ (self.mt[i - 1] >> 30)) + i) & _MASK32
        self.index = _N

    def _generate(self):
        mt = self.mt
        for i in range(_N):
            y = (mt[i] & _UPPER) | (mt[(i + 1) % _N] & _LOWER)
            nxt = mt[(i + _M) % _N] ^ (y >> 1)
            if y & 1:
                nxt ^= _MATRIX_A
            mt[i] = nxt
        self.index = 0

    def next_u32(self) -> int:
        if self.index >= _N:
            self._generate()
        y = self.mt[self.index]
        self.index += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & _MASK32

    def uniform01(self) -> float:
        """libstdc++ generate_canonical<double,53,mt19937>: 2 draws, low first"""
        x0 = self.next_u32()
        x1 = self.next_u32()
        ret = (x0 + x1 * 4294967296.0) / 18446744073709551616.0
        if ret >= 1.0:
            ret = math.nextafter(1.0, 0.0)
        return ret
