"""Spaced-seed pattern design, parity-exact with the reference.

Reimplements the behavior of goldrush_path/spaced_seeds.cpp:8-69:
 - random mode: symmetric base seed of span k / weight w drawn with glibc
   ``srand(123)`` (spaced_seeds.cpp:19-45), left half random until weight/2
   ones (first position forced to 1), right half = mirror;
 - preset mode: user pattern split into left/right halves
   (spaced_seeds.cpp:58-60);
 - multi-length family: seed i = left + i*'0' + right (spaced_seeds.cpp:63-66),
   so the h seeds have spans k, k+1, .., k+h-1.

Validated against fixtures generated from the compiled reference designer
(tests/fixtures/seed_fixtures.jsonl).
"""

from __future__ import annotations

from .cxx_rand import GlibcRand


def make_seed_pattern(seed_preset: str, k: int, weight: int, h: int) -> list[str]:
    if seed_preset == "":
        rng = GlibcRand(123)
        half = k // 2
        left = [0] * half
        left[0] = 1  # leftmost position must be a care position
        weight_count = 0
        while weight_count != weight // 2:
            for i in range(1, half):
                left[i] = rng.rand() % 2
            weight_count = sum(left)
        left_str = "".join(map(str, left))
        right_str = left_str[::-1]
    else:
        half = len(seed_preset) // 2
        left_str = seed_preset[:half]
        right_str = seed_preset[half: 2 * half]

    return [left_str + "0" * i + right_str for i in range(h)]


def seed_spans(seeds: list[str]) -> list[int]:
    return [len(s) for s in seeds]


def care_positions(seed: str) -> list[int]:
    """Indices of '1' (care) positions within the seed span."""
    return [i for i, c in enumerate(seed) if c == "1"]
