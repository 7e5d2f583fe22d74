"""GoldPolish equivalent: alignment-free k-mer polishing of goldtigs.

The reference invokes the external bcgsc/goldpolish (ntEdit/Sealer-style
under the hood) via ``goldpolish --minimap2 -m /dev/shm`` (bin/goldrush:
266-268).  Reformulation (goldrush_tpu/stages/polish.py, here on PyTorch):

 1. all read k-mers are hashed on the card and scatter-counted into a flat
    table; "solid" k-mers (count >= solid_min) are the evidence set;
 2. every contig k-mer is presence-checked in one batched device query;
    absent runs localize candidate error bases (a lone error base b makes
    exactly the k-mers [b-k+1, b] absent);
 3. each error site generates 8 candidate edits (3 substitutions, 4
    insertions, 1 deletion); every candidate's edited window is re-hashed
    and scored in one big device batch — sites are processed in parallel,
    not by a sequential walk, because sites >= k apart are independent;
 4. winning edits are applied right-to-left; clustered sites resolve over
    multiple rounds.

This is the polishing analog of the survey's "batched, not sequential"
design rule (SURVEY.md section 7).

The count and the query are K21: on a CUDA table they launch the
hand-written kernels of csrc/kmer_count.cu, on a CPU table they run the
plain PyTorch versions.  Both launch on the batch's own shape; the JAX
package pads rows and columns to powers of two (to bound its compiles) and
sends every invalid position, padding included, to the table's sentinel
slot ``size``, which nothing reads.  The port skips invalid positions, so
its sentinel stays 0 and the table equals the JAX one on ``[:size]``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..io import fastq
from ..mibf.mibf import fastrange
from ..ops.nthash import hash_positions, unspaced_family
from ..path.engine import resolve_device

BASES = b"ACGT"


@dataclass
class PolishParams:
    k: int = 24
    solid_min: int = 2
    rounds: int = 6
    occupancy_factor: int = 8   # table slots per expected distinct k-mer
    min_score: float = 0.3      # absolute floor; acceptance is relative to
                                # the unedited window's score
    min_gain: int = 3           # an edit must make >= this many additional
                                # window k-mers solid (a true single-base fix
                                # gains ~k; guards truncated end windows
                                # where 1 accidental k-mer beats an empty
                                # noop)
    batch: int = 64
    # multi-k schedule ((k, rounds), ...): smaller k first resolves dense
    # error clusters (absent runs merge when errors are < k apart and a
    # large-k window never beats its noop), larger k refines.  Empty ->
    # single (k, rounds) stage.
    schedule: tuple = ()
    # site density controls (ONT error spacing ~ 1/err_rate is COMPARABLE to
    # k, so merged absent regions hide most error sites from the one-edit-
    # per-region-per-round walk — measured on homopolymer-indel reads the
    # default-spacing polisher fixes only ~28% of errors, tools/
    # polish_probe.py).  site_spacing < k emits a candidate at EVERY absent
    # sub-run end at least this far from the previous site; edits still
    # apply right-to-left so coordinate shifts compose, and each round
    # re-scores against the edited sequence, so overlapping-window score
    # error self-corrects over rounds.
    site_spacing: int = 0           # 0 -> p.k (the conservative default)

    def spacing(self, k: int) -> int:
        return self.site_spacing if self.site_spacing > 0 else k

    def stages(self) -> tuple:
        return self.schedule or ((self.k, self.rounds),)


def _slots_plain(codes: torch.Tensor, k: int, size: int) -> torch.Tensor:
    """int64 [B, L - k + 1]: the table slot of every k-mer of the codes."""
    P = codes.shape[1] - k + 1
    h = hash_positions(codes, unspaced_family(k), P)[:, 0]
    return fastrange(h, size)


def _valid(lengths: torch.Tensor, k: int, P: int) -> torch.Tensor:
    pos = torch.arange(P, dtype=torch.int64, device=lengths.device)
    return pos[None, :] < (lengths.to(torch.int64) - k + 1)[:, None]


def _check_kmer_args(counts, codes, lengths, k: int, size: int) -> None:
    if not 0 < size < 1 << 32 or counts.shape != (size + 1,):
        raise ValueError(f"k-mer table: size {size} must be in (0, 2^32) "
                         f"and counts [size + 1], got {tuple(counts.shape)}")
    if k < 1 or codes.dim() != 2 or lengths.shape != codes.shape[:1]:
        raise ValueError(f"k-mer batch: codes {tuple(codes.shape)}, lengths "
                         f"{tuple(lengths.shape)}, k {k}")
    if not counts.device == codes.device == lengths.device:
        raise ValueError(f"k-mer table on {counts.device}, batch on "
                         f"{codes.device} and {lengths.device}")


def count_kmers(counts: torch.Tensor, codes: torch.Tensor,
                lengths: torch.Tensor, k: int, size: int) -> None:
    """K21 count, in place: counts[fastrange(h, size)] += 1 for the
    canonical ntHash h of every valid k-mer (position < length - k + 1) of
    each row.  counts: int32 [size + 1] holding uint32 bits (the add wraps
    as the JAX uint32 add does); codes: uint8 [B, L]; lengths: int64 [B]."""
    _check_kmer_args(counts, codes, lengths, k, size)
    if counts.is_cuda:
        _count_kmers_cuda(counts, codes, lengths, k, size)
    else:
        _count_kmers_plain(counts, codes, lengths, k, size)


def _count_kmers_plain(counts, codes, lengths, k, size):
    P = codes.shape[1] - k + 1
    if P <= 0:
        return
    slots = _slots_plain(codes, k, size)[_valid(lengths, k, P)]
    counts.index_add_(0, slots, torch.ones_like(slots, dtype=torch.int32))


def _count_kmers_cuda(counts, codes, lengths, k, size):
    dev = counts.device
    kernels.check(counts, "counts", torch.int32, device=dev)
    kernels.check(codes, "codes", torch.uint8, device=dev)
    kernels.check(lengths, "lengths", torch.int64, device=dev)
    B, L = codes.shape
    kernels.KMER_COUNT(dev, kernels.ptr(codes), B, L, kernels.ptr(lengths),
                       k, size, kernels.ptr(counts))


def query_kmers(counts: torch.Tensor, codes: torch.Tensor,
                lengths: torch.Tensor, k: int, size: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """K21 query: (counts of the codes' k-mers, int32 [B, P] holding uint32
    bits, and the valid mask bool [B, P]), P = L - k + 1; invalid positions
    hold the count of their padding k-mer's slot, as in the JAX
    function."""
    _check_kmer_args(counts, codes, lengths, k, size)
    P = codes.shape[1] - k + 1
    if P <= 0:
        raise ValueError(f"k-mer query: width {codes.shape[1]} < k = {k}")
    if counts.is_cuda:
        cnt = _query_kmers_cuda(counts, codes, k, size)
    else:
        cnt = _query_kmers_plain(counts, codes, k, size)
    return cnt, _valid(lengths, k, P)


def _query_kmers_plain(counts, codes, k, size):
    return counts[_slots_plain(codes, k, size)]


def _query_kmers_cuda(counts, codes, k, size):
    dev = counts.device
    kernels.check(counts, "counts", torch.int32, device=dev)
    kernels.check(codes, "codes", torch.uint8, device=dev)
    B, L = codes.shape
    out = torch.empty((B, L - k + 1), dtype=torch.int32, device=dev)
    kernels.KMER_QUERY(dev, kernels.ptr(codes), B, L, k, size,
                       kernels.ptr(counts), kernels.ptr(out))
    return out


class KmerTable:
    """Flat count table of canonical k-mer hashes: an int32 tensor of
    uint32 bits on ``device``, filled and read by K21."""

    def __init__(self, expected_kmers: int, factor: int, device="cuda"):
        self.device = resolve_device(device)
        self.size = max(1 << 16, int(expected_kmers * factor)) | 1
        self.counts = torch.zeros(self.size + 1, dtype=torch.int32,
                                  device=self.device)

    def _batch(self, codes: np.ndarray, lengths: np.ndarray):
        return (torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(
                    self.device),
                torch.from_numpy(np.asarray(lengths, np.int64)).to(
                    self.device))

    def add_batch(self, codes: np.ndarray, lengths: np.ndarray, k: int):
        count_kmers(self.counts, *self._batch(codes, lengths), k, self.size)

    def query_batch(self, codes: np.ndarray, lengths: np.ndarray, k: int):
        """(counts uint32 [B, P], valid bool [B, P]) of a batch, P = L - k +
        1, on the host."""
        cnt, valid = query_kmers(self.counts, *self._batch(codes, lengths),
                                 k, self.size)
        return cnt.cpu().numpy().view(np.uint32), valid.cpu().numpy()


def build_read_table(reads: list[bytes], p: PolishParams, device="cuda"
                     ) -> KmerTable:
    total = sum(len(r) for r in reads)
    table = KmerTable(total, p.occupancy_factor, device)
    order = sorted(range(len(reads)), key=lambda i: len(reads[i]))
    i = 0
    while i < len(order):
        grp = order[i: i + p.batch]
        i += p.batch
        L = max(max(len(reads[j]) for j in grp), p.k + 1)
        codes = np.zeros((len(grp), L), dtype=np.uint8)
        lens = np.zeros(len(grp), dtype=np.int64)
        for row, j in enumerate(grp):
            c = fastq.encode(reads[j])
            c = np.where(c > 3, 0, c)
            codes[row, : len(c)] = c
            lens[row] = len(c)
        table.add_batch(codes, lens, p.k)
    return table


def _contig_solidity(table: KmerTable, codes: np.ndarray, p: PolishParams
                     ) -> np.ndarray:
    """bool[P] solid flags of one contig's k-mers (single query batch)."""
    n = len(codes) - p.k + 1
    if n <= 0:
        return np.zeros(0, dtype=bool)
    cnt, _ = table.query_batch(codes[None, :],
                               np.array([len(codes)], dtype=np.int64), p.k)
    return cnt[0] >= p.solid_min


def _candidate_edits(seq: np.ndarray, b: int, k: int):
    """8 edited windows around error base b: list of (tag, window_codes).
    Window spans [b-k+1, b+k) of the edited sequence, so every k-mer touching
    base b is covered."""
    lo = max(b - k + 1, 0)
    hi = min(b + k, len(seq))
    left, mid, right = seq[lo:b], seq[b:b + 1], seq[b + 1:hi]
    out = []
    cur = int(mid[0]) if len(mid) else 0
    for alt in range(4):
        if alt != cur:
            out.append((("sub", alt),
                        np.concatenate([left, [alt], right])))
    out.append((("del", 0), np.concatenate([left, right])))
    for ins in range(4):
        # insert before b (contig missing a base ending the absent run) and
        # after b (run end localizes the junction one base earlier for
        # deletion-type errors)
        out.append((("ins", ins),
                    np.concatenate([left, [ins], mid, right])))
        out.append((("ins2", ins),
                    np.concatenate([left, mid, [ins], right])))
    # 2-bp homopolymer run adjustments: two same-run indels land in one
    # absent region on ONT homopolymer-biased reads, and no single edit's
    # window clears the noop gate (ntEdit's indel ladder plays the same
    # card — VERDICT r4 item 3)
    out.append((("del2", 0), np.concatenate([left, right[1:]])))
    out.append((("ins_hp2", cur),
                np.concatenate([left, [cur, cur], mid, right])))
    return out


def polish_contig(seq: bytes, table: KmerTable, p: PolishParams
                  ) -> tuple[bytes, int]:
    """Polish one contig; returns (new_seq, n_edits)."""
    arr = fastq.encode(seq)
    arr = np.where(arr > 3, 0, arr).astype(np.uint8)
    total_edits = 0
    for _ in range(p.rounds):
        solid = _contig_solidity(table, arr, p)
        n = len(solid)
        if n == 0 or solid.all():
            break
        absent = ~solid
        # error sites: last index of each absent run (b = run_end), spaced
        # >= k apart so their candidate windows don't interact
        d = np.diff(absent.astype(np.int8))
        # absent runs separated by < k chance-solid k-mers belong to one
        # error region; the region's end localizes the bad base (a bad base
        # b makes exactly k-mers [b-k+1, b] absent); a region reaching the
        # final k-mer only bounds the bad base below
        r_starts = list(np.nonzero(d == 1)[0] + 1)
        r_ends = list(np.nonzero(d == -1)[0])
        if absent[0]:
            r_starts = [0] + r_starts
        if absent[-1]:
            r_ends = r_ends + [n - 1]
        spacing = p.spacing(p.k)
        cand_b = []
        for s_, e_ in zip(r_starts, r_ends):
            if cand_b and s_ - cand_b[-1] < spacing:
                cand_b[-1] = e_        # merge into previous region
            else:
                cand_b.append(e_)
        if cand_b and cand_b[-1] == n - 1:
            cand_b[-1] = min(n - 1 + p.k - 1, len(arr) - 1)
        sites = []
        last = -10 ** 9
        for b in cand_b:
            b = min(int(b), len(arr) - 1)
            if b - last >= spacing:
                sites.append(b)
                last = b
        if not sites:
            break
        # batch-score all candidates of all sites; the UNEDITED window is
        # scored too ("noop") so acceptance is relative — with clustered
        # errors an edited window still contains absent k-mers from the
        # neighbor error, and an absolute gate would reject the true fix
        cands = []           # (site_idx, b, tag, window)
        for si, b in enumerate(sites):
            lo = max(b - p.k + 1, 0)
            hi = min(b + p.k, len(arr))
            cands.append((si, b, ("noop", 0), arr[lo:hi]))
            # run-end localization jitters by one for indel-type errors:
            # also try the neighbors
            for bb in (b - 1, b, b + 1):
                if 0 <= bb < len(arr):
                    for tag, win in _candidate_edits(arr, bb, p.k):
                        cands.append((si, bb, tag, win))
        W = max(len(c[3]) for c in cands)
        wins = np.zeros((len(cands), max(W, p.k + 1)), dtype=np.uint8)
        lens = np.zeros(len(cands), dtype=np.int64)
        for i, (_, _, _, win) in enumerate(cands):
            wins[i, : len(win)] = win
            lens[i] = len(win)
        cnt, valid = table.query_batch(wins, lens, p.k)
        solid_w = (cnt >= p.solid_min) & valid
        nsolid = solid_w.sum(1)
        scores = nsolid / np.maximum(valid.sum(1), 1)
        # pick best candidate per site; accept only if it beats the
        # unedited window by >= min_gain solid k-mers AND clears the floor
        best: dict[int, tuple[float, int, tuple, int]] = {}
        noop: dict[int, tuple[float, int]] = {}
        for i, (si, b, tag, _) in enumerate(cands):
            s = float(scores[i])
            if tag[0] == "noop":
                noop[si] = (s, int(nsolid[i]))
                continue
            if si not in best or s > best[si][0]:
                best[si] = (s, b, tag, int(nsolid[i]))
        # apply accepted edits right-to-left
        edits = sorted(
            ((s, b, tag) for si, (s, b, tag, ns) in best.items()
             if s > noop.get(si, (0.0, 0))[0] and s >= p.min_score
             and ns - noop.get(si, (0.0, 0))[1] >= p.min_gain),
            key=lambda v: -v[1])
        if not edits:
            break
        pieces = arr.copy()
        for score, b, (kind, alt) in edits:
            if kind == "sub":
                pieces[b] = alt
            elif kind == "del":
                pieces = np.concatenate([pieces[:b], pieces[b + 1:]])
            elif kind == "del2":
                pieces = np.concatenate([pieces[:b], pieces[b + 2:]])
            elif kind == "ins_hp2":
                pieces = np.concatenate([pieces[:b],
                                         np.array([alt, alt], np.uint8),
                                         pieces[b:]])
            elif kind == "ins":
                pieces = np.concatenate([pieces[:b],
                                         np.array([alt], np.uint8),
                                         pieces[b:]])
            else:  # ins2: insert after b
                pieces = np.concatenate([pieces[:b + 1],
                                         np.array([alt], np.uint8),
                                         pieces[b + 1:]])
            total_edits += 1
        arr = pieces
    return np.frombuffer(BASES, np.uint8)[arr].tobytes(), total_edits


def polish_seq(seq: bytes, reads: list[bytes], p: PolishParams,
               tables: dict | None = None, device="cuda"
               ) -> tuple[bytes, int]:
    """Polish one sequence through the (k, rounds) schedule; per-k read
    tables are built lazily and may be shared via ``tables``."""
    import dataclasses
    total = 0
    for k, rounds in p.stages():
        pp = dataclasses.replace(p, k=k, rounds=rounds, schedule=())
        if tables is not None:
            if k not in tables:
                tables[k] = build_read_table(reads, pp, device)
            table = tables[k]
        else:
            table = build_read_table(reads, pp, device)
        seq, ne = polish_contig(seq, table, pp)
        total += ne
    return seq, total


def run_polish_streaming(contigs: list[tuple[str, bytes]], reads_path: str,
                         p: PolishParams | None = None,
                         mapper_k: int = 15, mapper_w: int = 10,
                         chunk: int = 512, spill_dir: str | None = None,
                         device="cuda"
                         ) -> tuple[list[tuple[str, bytes]], int]:
    """Bounded-memory run_polish: reads STREAM from disk in fixed-size
    chunks through the batched mapper and spill to one temp file per
    goldtig; each goldtig then polishes against its own spilled reads.

    Peak memory is O(contigs + minimizer index + chunk + largest
    per-goldtig read set) instead of O(all reads) — the reference's
    memory envelope at scale (67x human ~ 200 GB of reads vs its 51.9 GB
    peak, /root/reference/README.md:121) cannot be met by whole-file
    lists.  Output is IDENTICAL to run_polish(mapper_k=...): read->contig
    assignment is per-read (chunking cannot change it) and per-contig
    polishing is independent.
    """
    import shutil as _shutil
    import tempfile as _tempfile
    from ..io import fastq as _fq
    from . import mapping
    p = p or PolishParams()
    index = mapping.build_index([s for _, s in contigs],
                                [n for n, _ in contigs], mapper_k, mapper_w,
                                device=device)
    own = spill_dir is None
    if own:
        spill_dir = _tempfile.mkdtemp(prefix="polish_spill_")
    files = [open(os.path.join(spill_dir, f"c{i}.reads"), "wb")
             for i in range(len(contigs))]
    try:
        def spill(batch: list[bytes]):
            for read, hits in zip(batch, mapping.map_reads(
                    index, batch, device=device)):
                if hits:
                    files[hits[0].tid].write(read + b"\n")

        batch: list[bytes] = []
        for rec in _fq.read_records(reads_path):
            batch.append(rec.seq)
            if len(batch) >= chunk:
                spill(batch)
                batch = []
        if batch:
            spill(batch)
        for f in files:
            f.close()
        out, edits = [], 0
        for i, (name, seq) in enumerate(contigs):
            with open(os.path.join(spill_dir, f"c{i}.reads"), "rb") as f:
                rds = [ln for ln in f.read().splitlines() if ln]
            if rds:
                ns, ne = polish_seq(seq, rds, p, device=device)
            else:
                ns, ne = seq, 0        # no evidence -> leave unpolished
            out.append((name, ns))
            edits += ne
        return out, edits
    finally:
        for f in files:
            if not f.closed:
                f.close()
        if own:
            _shutil.rmtree(spill_dir, ignore_errors=True)


def run_polish(contigs: list[tuple[str, bytes]], reads: list[bytes],
               p: PolishParams | None = None,
               mapper_k: int | None = None, mapper_w: int = 10,
               device="cuda") -> tuple[list[tuple[str, bytes]], int]:
    """Polish contigs against read k-mer evidence.

    With mapper_k set, reads are first assigned to their best-mapping goldtig
    and each goldtig is polished against ITS reads' k-mers only — goldpolish's
    targeted architecture (reads mapped with --minimap2 or --ntlink,
    bin/goldrush:35-41), which keeps cross-contig k-mers from vetoing true
    edits.  Without it, one global table serves all contigs (alignment-free
    fallback)."""
    p = p or PolishParams()
    out = []
    edits = 0
    if mapper_k is None:
        tables: dict = {}
        for name, seq in contigs:
            ns, ne = polish_seq(seq, reads, p, tables, device)
            out.append((name, ns))
            edits += ne
        return out, edits
    from . import mapping
    index = mapping.build_index([s for _, s in contigs],
                                [n for n, _ in contigs], mapper_k, mapper_w,
                                device=device)
    assigned: list[list[bytes]] = [[] for _ in contigs]
    for read, hits in zip(reads, mapping.map_reads(index, reads,
                                                   device=device)):
        if hits:
            assigned[hits[0].tid].append(read)
    for (name, seq), rds in zip(contigs, assigned):
        if rds:
            ns, ne = polish_seq(seq, rds, p, device=device)
        else:
            ns, ne = seq, 0            # no evidence -> leave unpolished
        out.append((name, ns))
        edits += ne
    return out, edits
