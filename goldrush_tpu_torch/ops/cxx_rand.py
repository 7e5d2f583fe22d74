"""Bit-exact replica of glibc ``rand()`` (TYPE_3 additive-feedback generator).

The reference designs its spaced seeds with ``srand(123); rand()%2``
(goldrush_path/spaced_seeds.cpp:19,34), so seed-pattern parity requires
reproducing glibc's generator exactly.  Validated against golden vectors
generated with g++ (tests/fixtures/glibc_rand_123.json).

Algorithm (glibc stdlib/random_r.c, TYPE_3: degree 31, separation 3):
  r[0] = seed
  r[i] = (16807 * r[i-1]) % 2147483647      for i in 1..30   (Park-Miller step,
         computed in signed 64-bit, negative results += 2^31-1)
  r[i] = r[i-31]                             for i in 31..33
  r[i] = (r[i-3] + r[i-31]) mod 2^32         for i >= 34
  output_j = r[34+j] >> 1
"""

from __future__ import annotations

MASK32 = 0xFFFFFFFF


class GlibcRand:
    def __init__(self, seed: int = 1):
        self.srand(seed)

    def srand(self, seed: int) -> None:
        seed = seed & MASK32
        if seed == 0:
            seed = 1
        r = [0] * 344
        r[0] = seed
        for i in range(1, 31):
            # hi/lo decomposition identical to glibc to avoid 64-bit overflow
            # differences; equivalently (16807*r[i-1]) % 2147483647 on signed64.
            word = (16807 * r[i - 1]) % 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 3] + r[i - 31]) & MASK32
        self._r = r
        self._i = 344

    def rand(self) -> int:
        r, i = self._r, self._i
        val = (r[i - 3] + r[i - 31]) & MASK32
        r.append(val)
        self._i = i + 1
        # keep the list from growing unboundedly
        if self._i > 4096:
            self._r = r[-31:]
            self._i = 31
        return val >> 1
