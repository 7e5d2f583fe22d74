"""GoldPolish-Target equivalent: polish only gap-filled / joined regions.

The reference runs ``goldpolish --target --k-ntlink 88 --w-ntlink 1000 -l 64``
as the final stage (bin/goldrush:305-308): only the sequence inserted by
ntLink gap filling (plus a 64 bp flank) is re-polished, since the rest of the
assembly was already polished upstream.

Here (as in goldrush_tpu/stages/targeted.py) the filled-region coordinates
flow directly from the ntLink-equivalent stage, each region (+flank) is
excised, polished with the same site-parallel k-mer polisher (K21 on the
card), and spliced back.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import polish as polish_mod
from .ntlink import Scaffold


@dataclass
class TargetParams:
    flank: int = 64          # -l
    k: int = 24
    solid_min: int = 2
    rounds: int = 8
    # gap fills are raw read sequence (~5-10% error): dense clusters need a
    # small-k-first schedule — small k localizes inside clusters where a
    # 24-mer window never goes clean, larger k refines (measured 0.42 ->
    # 0.91 truth 21-mer identity on synthetic 5%-error fills vs 0.66 for
    # single-k; tools/downstream_validate.py)
    schedule: tuple = ((13, 12), (17, 12), (24, 8))


def polish_targets(scaffolds: list[Scaffold], reads: list[bytes],
                   p: TargetParams | None = None,
                   mapper_k: int | None = None, mapper_w: int = 1000,
                   device="cuda") -> tuple[list[tuple[str, bytes]], int]:
    """With mapper_k set, reads are first assigned to their best-mapping
    scaffold (minimizer mapping at mapper_k/mapper_w — the analog of
    goldpolish --target's internal ntLink mapping at --k-ntlink 88
    --w-ntlink 1000, bin/goldrush:305-308) and each scaffold's fill regions
    polish against ITS reads only; without it one global k-mer table serves
    all scaffolds."""
    p = p or TargetParams()
    pp = polish_mod.PolishParams(k=p.k, solid_min=p.solid_min,
                                 rounds=p.rounds, schedule=p.schedule,
                                 site_spacing=2)
    assigned: list[list[bytes]] | None = None
    if mapper_k is not None:
        from . import mapping
        index = mapping.build_index([sc.seq.upper() for sc in scaffolds],
                                    [sc.name for sc in scaffolds],
                                    min(32, mapper_k), mapper_w,
                                    device=device)
        assigned = [[] for _ in scaffolds]
        for read, hits in zip(reads, mapping.map_reads(index, reads,
                                                       device=device)):
            if hits:
                assigned[hits[0].tid].append(read)
    tables: dict = {}
    out = []
    total_edits = 0
    for si, sc in enumerate(scaffolds):
        if not sc.filled:
            out.append((sc.name, sc.seq.upper()))
            continue
        if assigned is None:
            sc_reads, sc_tables = reads, tables
        else:
            sc_reads, sc_tables = assigned[si], {}
            if not sc_reads:           # no mapped evidence: leave as-is
                out.append((sc.name, sc.seq.upper()))
                continue
        seq = sc.seq
        # process regions right-to-left so earlier coordinates stay valid
        regions = sorted(sc.filled, key=lambda r: -r[0])
        for r0, r1 in regions:
            a = max(r0 - p.flank, 0)
            b = min(r1 + p.flank, len(seq))
            window = seq[a:b].upper()
            fixed, ne = polish_mod.polish_seq(window, sc_reads, pp,
                                              sc_tables, device)
            total_edits += ne
            seq = seq[:a] + fixed + seq[b:]
        out.append((sc.name, seq.upper()))
    return out, total_edits
