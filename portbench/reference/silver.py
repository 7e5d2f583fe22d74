"""A goldrush-path silver job in the exact sequential semantics, over a
sparse filter, rank-compressed or direct.

The two passes of goldrush_tpu/path/oracle_engine.py:58-199 at commit
93d720b (``calc_phred_threshold``, ``fill``, ``run_paths``: the phred
gate, the presence fill, then read by read the vote, the decision, the
blockwise reservoir insert, the silver rotation) with the filter of
goldrush_tpu/mibf/mibf_np.py:50-131, its reservoir keyed on ranks in the
compressed filter, as the reference keys them (``key_mode="rank"``), and
on slots in the direct one (``key_mode="slot"``).  The sizing is
goldrush_tpu/config.py:206-230.  Nothing of either package is imported.

The filter is kept sparse: the sorted present slots (a slot's rank is its
index there), and an id and a counter a rank, whichever the layout.  A
human-size filter of 6e10 slots is never held densely; only the slots the
job's reads touch exist.
Every tensor lives on ``device`` (the card, to keep the check short).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from . import nthash, votes
from .phred import (MEDIAN_SAMPLES_NEEDED, MINIMUM_PHRED_THRESHOLD,
                    calc_median_phred, phred_stats)

_MASK32 = 0xFFFFFFFF
# the reads hashed at once in the fill
FILL_CHUNK_BASES = 1 << 24


def filter_size(cfg: dict) -> int:
    """min(4^w, 2 G) * 0.5 * h slots at occupancy o, rounded up to 64 as
    the reference rounds (adds 64 - size % 64)."""
    universe = int(min(4 ** cfg["weight"], 2 * cfg["genome_size"]) * 0.5
                   * cfg["hash_num"])
    approx = int(-float(universe) / math.log(1.0 - cfg["occupancy"]))
    return approx + (64 - approx % 64)


def fill_slots(reads: list, seeds: list, size: int, slot_map: str,
               device) -> torch.Tensor:
    """The sorted distinct slots of every valid hash of ``reads`` (codes
    uint8 arrays): pass 1's presence."""
    found, chunk, n = [], [], 0

    def flush():
        flat = torch.from_numpy(np.concatenate(chunk)).to(device)
        lens = torch.tensor([len(c) for c in chunk], device=device)
        start = torch.cumsum(lens, 0) - lens
        read = torch.repeat_interleave(torch.arange(len(chunk),
                                                    device=device), lens)
        pos = torch.arange(flat.shape[0], device=device) - start[read]
        for s in seeds:
            h = nthash.canonical(flat, s)
            ok = pos[: h.shape[0]] < (lens - len(s) + 1)[read[: h.shape[0]]]
            found.append(torch.unique(nthash.slot_of(h[ok], size, slot_map)))
        chunk.clear()

    for c in reads:
        chunk.append(c)
        n += len(c)
        if n >= FILL_CHUNK_BASES:
            flush()
            n = 0
    if chunk:
        flush()
    return torch.unique(torch.cat(found))


class SilverJob:
    """One job: ``run(reads)`` with reads as (id, codes uint8 array, qual
    bytes), in file order."""

    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.device = device
        self.seeds = nthash.seed_family(cfg["seed_preset"], cfg["hash_num"])
        self.size = filter_size(cfg)
        self.slot_keys = cfg["mibf_mode"] == "direct"
        self.gates = dict(threshold=cfg["threshold"],
                          unassigned_min=cfg["unassigned_min"],
                          assigned_max=cfg["assigned_max"],
                          vote_min=2, vote_topk=cfg["vote_topk"])
        # per recruit: (window grid entries, distinct keys a block, summed,
        # accepted writes): what the insert must move
        self.inserts: list = []

    # ---- pass 1 --------------------------------------------------------
    def phred_gate(self, reads) -> None:
        cfg = self.cfg
        self.phred_min = cfg["phred_min"]
        quals = [np.frombuffer(q, dtype=np.uint8) for _, c, q in reads]
        stats = [phred_stats(q) for q in quals]
        if self.phred_min == 0:
            long = [s[0] for (_, c, _), s in zip(reads, stats)
                    if len(c) >= cfg["min_length"]][:MEDIAN_SAMPLES_NEEDED]
            scores = np.zeros(MEDIAN_SAMPLES_NEEDED, dtype=np.uint32)
            scores[: len(long)] = long
            self.phred_min = max(MINIMUM_PHRED_THRESHOLD,
                                 calc_median_phred(scores, len(long)))
        self.filter_out = set()
        passing = []
        for (rid, c, _), (avg, delta) in zip(reads, stats):
            if len(c) < cfg["min_length"]:
                continue
            if avg < self.phred_min or delta >= cfg["phred_delta"] or \
                    (c > 3).any():
                self.filter_out.add(rid)
                continue
            passing.append(c)
        if not passing:
            raise RuntimeError("no reads passed the phred and length gates")
        self.present = fill_slots(passing, self.seeds, self.size,
                                  cfg["slot_map"], self.device)

    def ranks(self, slots: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(rank, present) of each slot."""
        S = self.present
        r = torch.searchsorted(S, slots)
        hit = S[torch.clamp(r, max=S.shape[0] - 1)] == slots
        return r, hit & (r < S.shape[0])

    # ---- pass 2 --------------------------------------------------------
    def read_grid(self, codes: np.ndarray):
        """A read's tile frames as ranks: (rank int64 [frames, h], present
        bool [frames, h], valid bool [frames], tiles)."""
        TL = self.cfg["tile_length"]
        c = torch.from_numpy(codes).to(self.device)
        L = len(codes)
        T = L // TL
        k = len(self.seeds[0])
        pos, valid = nthash.tile_frames(
            torch.tensor([L], device=self.device), T, TL, k, len(self.seeds))
        pos = pos[0]
        hs = [nthash.canonical(c, s) for s in self.seeds]
        slots = torch.stack([
            nthash.slot_of(hs[s][torch.clamp(pos[:, s], max=hs[s].shape[0] - 1)],
                           self.size, self.cfg["slot_map"])
            for s in range(len(self.seeds))], 1)
        rank, hit = self.ranks(slots)
        return rank, hit, valid[0], T

    def insert(self, rank, hit, valid, lo: int, hi: int, base: int,
               trimmed: bool) -> None:
        """Tiles lo..hi in blocks of block_size, block m under id base + m
        (trimmed: base + (m * bs + 1) // bs), one after another: every
        distinct present rank of a block bumps its counter and takes the
        id iff (u32(key) ^ id) % count == count - 1, the key the rank, or
        in the direct filter the slot."""
        TL, bs = self.cfg["tile_length"], self.cfg["block_size"]
        tile = torch.arange(rank.shape[0], device=rank.device) // TL
        entries = distinct = accepted = 0
        m = 0
        for lo_b in range(lo, hi + 1, bs):
            hi_b = min(lo_b + bs - 1, hi)
            bid = base + ((m * bs + 1) // bs if trimmed else m)
            sel = (tile >= lo_b) & (tile <= hi_b)
            entries += int(sel.sum()) * rank.shape[1]
            r = torch.unique(rank[(sel & valid)[:, None] & hit])
            self.counts[r] += 1
            cnt = self.counts[r]
            key = self.present[r] if self.slot_keys else r
            acc = ((key & _MASK32) ^ bid) % cnt == cnt - 1
            self.ids[r[acc]] = bid
            distinct += r.shape[0]
            accepted += int(acc.sum())
            m += 1
        self.inserts.append((entries, distinct, accepted))

    def run(self, reads: list, stale: int = 1) -> dict:
        """The job's rows and path digests.  ``stale`` > 1 is the cell's
        control: each run of that many eligible reads is voted against the
        filter as the run found it (the staleness the exact policy rules
        out), then its recruits inserted in order."""
        cfg = self.cfg
        if not hasattr(self, "present"):
            self.phred_gate(reads)
        n = self.present.shape[0]
        self.ids = torch.zeros(n, dtype=torch.int64, device=self.device)
        self.counts = torch.zeros_like(self.ids)
        self.rows, self.paths = [], [[]]
        self.ids_inserted = self.inserted_bases = 0
        self.curr_path = 1
        group = []
        for rec in reads:
            if len(rec[1]) < cfg["min_length"] or rec[0] in self.filter_out:
                continue
            group.append(rec)
            if len(group) == stale:
                if self._decide(group):
                    break
                group = []
        else:
            if group:
                self._decide(group)
        return dict(rows=np.asarray(self.rows, dtype=np.int64).reshape(-1, 8),
                    path_digests=[hashlib.sha256(b"".join(p)).hexdigest()
                                  for p in self.paths],
                    phred_min=self.phred_min)

    def _decide(self, group: list) -> bool:
        """Vote and decide every read of ``group`` against the filter as it
        stands, then insert the recruits in order and write their records;
        True once the last silver path is complete."""
        cfg = self.cfg
        TL, bs = cfg["tile_length"], cfg["block_size"]
        n = self.present.shape[0]
        decided = []
        for rid, codes, qual in group:
            rank, hit, valid, T = self.read_grid(codes)
            ids = torch.where(hit, self.ids[torch.clamp(rank, max=n - 1)], 0)
            row = votes.read_rows(ids, hit.all(1), valid, [T], T * TL, TL,
                                  self.gates)[0]
            decided.append((rid, codes, qual, rank, hit, valid, T, row))
        target = int(cfg["ratio"] * cfg["genome_size"])
        for rid, codes, qual, rank, hit, valid, T, row in decided:
            self.rows.append(row)
            dec, ts, te = row[:3]
            if dec == 0:
                continue
            self.ids_inserted += 1
            if dec == 1:
                self.insert(rank, hit, valid, 0, T - 1, self.ids_inserted,
                            False)
                self.ids_inserted += len(codes) // (TL * bs)
                seq, q, tag = codes, qual, "_untrimmed"
            else:
                self.insert(rank, hit, valid, ts, te, self.ids_inserted, True)
                self.ids_inserted += (te - ts) // bs
                end = len(codes) if te == T - 1 else \
                    ts * TL + (te - ts + 1) * TL
                seq, q, tag = (codes[ts * TL: end], qual[ts * TL: end],
                               "_trimmed")
            self.paths[-1].append(b"@" + rid.encode() + tag.encode() + b"\n"
                                  + _bases(seq) + b"\n+\n" + q + b"\n")
            self.inserted_bases += len(seq)
            if cfg["silver_path"] and target < self.inserted_bases:
                self.curr_path += 1
                if cfg["max_paths"] < self.curr_path:
                    return True
                self.inserted_bases = self.ids_inserted = 0
                self.ids.zero_()
                self.counts.zero_()
                self.paths.append([])
        return False


_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _bases(codes: np.ndarray) -> bytes:
    return _ACGT[codes].tobytes()
