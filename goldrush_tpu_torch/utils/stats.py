"""Assembly stats (abyss-fac equivalents): N50/L50 etc.

The reference demo asserts the final assembly's L50
(tests/goldrush_test_demo.sh:12-14 via abyss-fac)."""

from __future__ import annotations


def assembly_stats(lengths: list[int], min_len: int = 500) -> dict:
    ls = sorted((l for l in lengths if l >= min_len), reverse=True)
    total = sum(ls)
    if not ls:
        return {"n": 0, "total": 0, "max": 0, "N50": 0, "L50": 0}
    acc = 0
    n50 = l50 = 0
    for i, l in enumerate(ls, 1):
        acc += l
        if acc * 2 >= total:
            n50, l50 = l, i
            break
    return {"n": len(ls), "total": total, "max": ls[0], "N50": n50,
            "L50": l50}
