"""Synthetic genome / long-read simulator (shared by tests and chip_smoke.py)."""

from __future__ import annotations

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = {65: 84, 84: 65, 67: 71, 71: 67}


def random_genome(n: int, seed: int = 1) -> bytes:
    rng = np.random.default_rng(seed)
    return bytes(BASES[rng.integers(0, 4, n)])


def revcomp(seq: bytes) -> bytes:
    return bytes(COMP[b] for b in reversed(seq))


def repeat_genome(n: int, seed: int = 1, tandem_frac: float = 0.08,
                  dispersed_frac: float = 0.12, divergence: float = 0.02
                  ) -> bytes:
    """Repeat-structured genome: unique backbone + tandem arrays + dispersed
    repeat families with per-copy divergence.

    The reference's target organisms are repeat-rich; uniform-random
    genomes (random_genome) never stress the classifier smoothing, tigmint
    cuts or ntLink joins the way repeats do (VERDICT r3 item 5).
      * tandem arrays: unit 100-2000 bp x 3-20 copies, ``divergence``
        substitutions per copy,
      * dispersed families: 8 families of 500-5000 bp units; copies are
        scattered genome-wide on either strand, each diverged.
    """
    rng = np.random.default_rng(seed)
    fam_units = [BASES[rng.integers(0, 4, int(rng.integers(500, 5001)))]
                 for _ in range(8)]

    def diverge(u):
        v = u.copy()
        m = rng.random(len(v)) < divergence
        v[m] = BASES[rng.integers(0, 4, int(m.sum()))]
        return v

    parts = []
    total = 0
    while total < n:
        r = rng.random()
        if r < tandem_frac:
            unit = BASES[rng.integers(0, 4, int(rng.integers(100, 2001)))]
            copies = int(rng.integers(3, 21))
            seg = np.concatenate([diverge(unit) for _ in range(copies)])
        elif r < tandem_frac + dispersed_frac:
            u = diverge(fam_units[int(rng.integers(0, len(fam_units)))])
            seg = u[::-1] if rng.integers(0, 2) else u
        else:
            seg = BASES[rng.integers(0, 4, int(rng.integers(5_000, 20_001)))]
        parts.append(seg)
        total += len(seg)
    return bytes(np.concatenate(parts)[:n])


def _homopolymer_mask(seq: np.ndarray, min_run: int = 3) -> np.ndarray:
    """Bool mask of positions inside homopolymer runs >= min_run."""
    n = len(seq)
    if n < min_run:
        return np.zeros(n, dtype=bool)
    same = np.concatenate([[False], seq[1:] == seq[:-1]])
    # run length ending at each position
    run = np.ones(n, dtype=np.int32)
    for _ in range(min_run - 1):          # bounded unroll is enough
        run = np.where(same, np.concatenate([[0], run[:-1]]) + 1, 1)
    # positions where a run of >= min_run ends; expand backward
    mask = np.zeros(n, dtype=bool)
    ends = np.nonzero(run >= min_run)[0]
    for e in ends:
        mask[e - min_run + 1: e + 1] = True
    return mask


def simulate_reads(genome: bytes, n_reads: int, read_len: int,
                   seed: int = 2, err_rate: float = 0.0,
                   phred: int = 20, phred_jitter: int = 3,
                   both_strands: bool = True,
                   indel_frac: float = 0.0,
                   homopolymer_bias: float = 0.0
                   ) -> list[tuple[str, bytes, bytes]]:
    """Uniformly sampled reads in random order with optional errors.

    ``err_rate`` is the total per-base error rate; ``indel_frac`` of the
    errors are split evenly between 1-bp insertions and deletions (ONT-like
    profile ~0.4), the rest are substitutions.  Quality strings are
    constant-ish around ``phred``.  Read ids encode the true genomic start
    (``read{i}_p{start}``) so tests can score recruits positionally.

    ``homopolymer_bias`` > 0 concentrates that fraction of the indels at
    homopolymer runs (>= 3), the dominant ONT error mode — uniform errors
    understate the burstiness real reads stress the classifier with."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    out = []
    garr = np.frombuffer(genome, dtype=np.uint8)
    for i in range(n_reads):
        L = read_len
        start = int(rng.integers(0, max(G - L, 1)))
        seq = garr[start:start + L].copy()
        if err_rate > 0:
            nerr = rng.binomial(L, err_rate)
            n_ind = int(nerr * indel_frac)
            n_sub = nerr - n_ind
            pos = rng.integers(0, L, n_sub)
            seq[pos] = BASES[rng.integers(0, 4, n_sub)]
            if n_ind:
                parts = []
                if homopolymer_bias > 0:
                    hp = np.nonzero(_homopolymer_mask(seq))[0]
                    n_hp = min(int(n_ind * homopolymer_bias), len(hp))
                    cut = np.concatenate([
                        rng.choice(hp, n_hp, replace=False) if n_hp else
                        np.zeros(0, dtype=np.int64),
                        rng.integers(0, len(seq), n_ind - n_hp)])
                    cut = np.sort(cut)
                else:
                    cut = np.sort(rng.integers(0, len(seq), n_ind))
                is_ins = rng.integers(0, 2, n_ind).astype(bool)
                prev = 0
                for p, ins in zip(cut, is_ins):
                    parts.append(seq[prev:p])
                    if ins:
                        parts.append(BASES[rng.integers(0, 4, 1)])
                        prev = p
                    else:
                        prev = p + 1          # drop one base
                parts.append(seq[prev:])
                seq = np.concatenate(parts)
        s = bytes(seq)
        if both_strands and rng.integers(0, 2):
            s = revcomp(s)
        q = np.clip(phred + rng.integers(-phred_jitter, phred_jitter + 1,
                                         len(s)),
                    2, 40).astype(np.uint8) + 33
        out.append((f"read{i}_p{start}", s, bytes(q)))
    return out


def write_fastq(path: str, reads) -> None:
    with open(path, "wb") as f:
        for rid, seq, qual in reads:
            f.write(b"@" + rid.encode() + b"\n" + seq + b"\n+\n" + qual + b"\n")
