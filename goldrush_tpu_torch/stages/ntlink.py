"""ntLink equivalent: minimizer-based long-read scaffolding + gap filling.

The reference runs the external ntLink for 5 rounds:
``ntLink_rounds run_rounds_gaps target=.. k=40 w=250 z=1000 soft_mask=True
rounds=5 reads=.. G=-1 a=1`` (bin/goldrush:292-296, defaults :88-92).

Reformulation per round (goldrush_tpu/stages/ntlink.py):
 1. minimizer index of the current scaffolds (K20 on the card); map every
    read;
 2. consecutive hits of one read to the *ends* of two different scaffolds
    vote for an oriented join with a gap estimate;
 3. mutual-best joins with support >= a become scaffold edges; simple paths
    are walked deterministically;
 4. merged scaffolds fill each junction with the supporting read's actual
    subsequence (soft-masked lowercase like ntLink's soft_mask=True);
    negative gaps trim the entering contig.

Filled-region coordinates are returned for GoldPolish-Target.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import mapping

COMP = bytes.maketrans(b"ACGTacgt", b"TGCAtgca")


def revcomp(s: bytes) -> bytes:
    return s.translate(COMP)[::-1]


@dataclass
class NtLinkParams:
    k: int = 40
    w: int = 250
    z: int = 1000            # min scaffold size to join
    a: int = 1               # min supporting reads per join
    rounds: int = 5
    end_margin: int = 2000   # hit must reach this close to a contig end
    min_anchors: int = 3
    soft_mask: bool = True
    gap_tol: int = 500       # evidence reads must agree with the median
                             # gap estimate within this tolerance to count
                             # toward support (multi-read distance
                             # consensus; ntLink estimates gaps from
                             # minimizer-pair evidence across supporting
                             # reads — a single outlier read must not set
                             # the distance or force a chimeric join)


@dataclass
class Scaffold:
    name: str
    seq: bytes
    filled: list = field(default_factory=list)   # [(start, end)] gap fills


def _end_of(hit: mapping.Hit, length: int, margin: int) -> str | None:
    """Which end of the target this hit can extend past: the read leaves the
    target's tail (strand +) / head (strand -) after q_end."""
    if hit.strand == 1:
        if hit.t_end >= length - margin:
            return "tail"
        if hit.t_start <= margin:
            return "head"
    else:
        if hit.t_start <= margin:
            return "head"
        if hit.t_end >= length - margin:
            return "tail"
    return None


def _collect_joins(scaffolds, reads, p: NtLinkParams, device="cuda"):
    names = [s.name for s in scaffolds]
    seqs = [s.seq for s in scaffolds]
    idx = mapping.build_index(seqs, names, k=p.k, w=p.w, device=device)
    joins: dict = {}    # key (endA, endB) normalized -> list of evidence
    all_hits = mapping.map_reads(idx, reads, min_anchors=p.min_anchors,
                                 diag_bin=1000, device=device)
    for ridx, hits in enumerate(all_hits):
        # one best hit per target
        best: dict[int, mapping.Hit] = {}
        for h in hits:
            if len(seqs[h.tid]) < p.z:
                continue
            if h.tid not in best or h.n_anchors > best[h.tid].n_anchors:
                best[h.tid] = h
        hs = sorted(best.values(), key=lambda h: h.q_start)
        for h1, h2 in zip(hs, hs[1:]):
            if h1.tid == h2.tid:
                continue
            # read leaves h1 after its segment and enters h2
            leave = "tail" if h1.strand == 1 else "head"
            enter = "head" if h2.strand == 1 else "tail"
            L1, L2 = len(seqs[h1.tid]), len(seqs[h2.tid])
            m = p.end_margin
            ok1 = (h1.t_end >= L1 - m) if leave == "tail" else (h1.t_start <= m)
            ok2 = (h2.t_start <= m) if enter == "head" else (h2.t_end >= L2 - m)
            if not (ok1 and ok2):
                continue
            # distance from mapped segment to the contig end it leaves/enters
            tail1 = (L1 - h1.t_end) if leave == "tail" else h1.t_start
            tail2 = h2.t_start if enter == "head" else (L2 - h2.t_end)
            gap = (h2.q_start - h1.q_end) - tail1 - tail2
            endA = (h1.tid, leave)
            endB = (h2.tid, enter)
            key = (endA, endB) if endA <= endB else (endB, endA)
            flip = key != (endA, endB)
            joins.setdefault(key, []).append(
                (ridx, h1, h2, gap, flip))
    return joins


def _consensus(joins, p: NtLinkParams):
    """Per-junction gap-distance consensus: the gap estimate is the MEDIAN
    over supporting reads, and only evidence within ``gap_tol`` of that
    median counts as consistent support.  Returns
    {key: (gap_median, consistent_evidence)} — junctions whose evidence
    disagrees collapse to their largest consistent cluster, so one
    repeat-confused read cannot chimera-join two scaffolds or distort the
    inserted gap length (VERDICT r3 item 6; the external ntLink's
    abundance/distance-consensus behavior, bin/goldrush:292-296)."""
    out = {}
    for key, ev in joins.items():
        gaps = sorted(e[3] for e in ev)
        med = gaps[len(gaps) // 2]
        consistent = [e for e in ev if abs(e[3] - med) <= p.gap_tol]
        if not consistent:
            continue
        cg = sorted(e[3] for e in consistent)
        out[key] = (cg[len(cg) // 2], consistent)
    return out


def _mutual_best(joins, p: NtLinkParams):
    """support-filtered, per-end mutual-best join selection (deterministic).
    ``joins`` holds CONSISTENT evidence only (see _consensus); non-chosen
    junction alternatives are naturally revisited by the next round's fresh
    mapping over the merged scaffolds."""
    support = {k: len(v) for k, v in joins.items()}
    best_for_end: dict = {}
    for (ea, eb), s in support.items():
        if s < p.a:
            continue
        for e, other in ((ea, eb), (eb, ea)):
            cur = best_for_end.get(e)
            cand = (s, other)
            if cur is None or cand[0] > cur[0] or \
                    (cand[0] == cur[0] and cand[1] < cur[1]):
                best_for_end[e] = cand
    chosen = []
    for (ea, eb), s in sorted(support.items()):
        if s < p.a:
            continue
        if best_for_end.get(ea, (0, None))[1] == eb and \
                best_for_end.get(eb, (0, None))[1] == ea:
            chosen.append((ea, eb))
    return chosen


def _walk_paths(n: int, edges):
    """Order/orient contigs into simple paths.  Returns list of
    [(cid, forward?), ...]."""
    adj: dict = {}
    for ea, eb in edges:
        if ea in adj or eb in adj:
            continue            # degree cap 1 per end
        adj[ea] = eb
        adj[eb] = ea
    def other(e):
        return (e[0], "head" if e[1] == "tail" else "tail")

    visited = set()
    paths = []
    for cid in range(n):
        if cid in visited:
            continue
        # walk backwards from (cid, head) to a terminal (unlinked) entry end
        entry = (cid, "head")
        guard = set()
        while entry in adj:
            if entry in guard:
                break            # cycle: break arbitrarily here
            guard.add(entry)
            entry = other(adj[entry])
        # traverse forward building the path
        path = []
        cur_entry = entry
        while True:
            c, side = cur_entry
            if c in visited:
                break
            visited.add(c)
            path.append((c, side == "head"))   # entering at head = forward
            exit_end = other(cur_entry)
            if exit_end not in adj:
                break
            cur_entry = adj[exit_end]   # partner end = next contig's entry
        if path:
            paths.append(path)
    return paths


def _merge_path(scaffolds, path, joins, chosen_keys, reads, p: NtLinkParams,
                name: str) -> Scaffold:
    pieces: list[bytes] = []
    filled: list[tuple[int, int]] = []
    carried = []
    pos = 0
    for i, (cid, fwd) in enumerate(path):
        s = scaffolds[cid]
        seq = s.seq if fwd else revcomp(s.seq)
        regions = [( (r0, r1) if fwd else (len(s.seq) - r1, len(s.seq) - r0))
                   for r0, r1 in s.filled]
        if i > 0:
            prev_cid, prev_fwd = path[i - 1]
            endA = (prev_cid, "tail" if prev_fwd else "head")
            endB = (cid, "head" if fwd else "tail")
            key = (endA, endB) if endA <= endB else (endB, endA)
            gap_med, ev = joins.get(key, (100, []))
            fill = b""
            gap = gap_med
            if ev:
                # fill from the read whose own gap estimate is closest to
                # the consensus median (anchor count breaks ties) — the
                # median read's sequence is the best single representative
                # of the junction the evidence agrees on
                ridx, h1, h2, _, _ = min(
                    ev, key=lambda e: (abs(e[3] - gap_med),
                                       -(e[1].n_anchors + e[2].n_anchors)))
                seg = reads[ridx][h1.q_end: h2.q_start]
                # the read span between the mapped segments covers the
                # unmapped contig-end stubs too; trim them so only the true
                # gap sequence is inserted
                L1 = len(scaffolds[h1.tid].seq)
                leave = "tail" if h1.strand == 1 else "head"
                tail1 = (L1 - h1.t_end) if leave == "tail" else h1.t_start
                L2 = len(scaffolds[h2.tid].seq)
                enter = "head" if h2.strand == 1 else "tail"
                tail2 = h2.t_start if enter == "head" else (L2 - h2.t_end)
                seg = seg[max(tail1, 0): max(len(seg) - max(tail2, 0),
                                             max(tail1, 0))]
                # a read consistent with this junction encounters prev first
                # iff it runs in the scaffold direction; otherwise it crossed
                # cur -> prev and the fill segment reverses
                fill = seg if h1.tid == prev_cid else revcomp(seg)
            if gap >= 0:
                fill_used = fill if fill else b"N" * min(max(gap, 1), 100)
                if p.soft_mask:
                    fill_used = fill_used.lower()
                pieces.append(fill_used)
                filled.append((pos, pos + len(fill_used)))
                pos += len(fill_used)
            else:
                trim = min(-gap, len(seq) - 1)
                seq = seq[trim:]
        pieces.append(seq)
        for r0, r1 in regions:
            filled.append((pos + r0, pos + r1))
        pos += len(seq)
    return Scaffold(name=name, seq=b"".join(pieces), filled=filled)


def run_ntlink_round(scaffolds: list[Scaffold], reads: list[bytes],
                     p: NtLinkParams, round_no: int, device="cuda"
                     ) -> list[Scaffold]:
    joins = _collect_joins(scaffolds, reads, p, device)
    cons = _consensus(joins, p)
    chosen = _mutual_best({k: ev for k, (_, ev) in cons.items()}, p)
    if not chosen:
        return scaffolds
    paths = _walk_paths(len(scaffolds), chosen)
    out = []
    for i, path in enumerate(paths):
        if len(path) == 1:
            out.append(scaffolds[path[0][0]])
        else:
            nm = f"ntl{round_no}_{i}"
            out.append(_merge_path(scaffolds, path, cons, chosen, reads, p,
                                   nm))
    return out


def run_ntlink(contigs: list[tuple[str, bytes]], reads: list[bytes],
               p: NtLinkParams | None = None, device="cuda"
               ) -> list[Scaffold]:
    p = p or NtLinkParams()
    scaffolds = [Scaffold(name=n, seq=s) for n, s in contigs]
    for r in range(p.rounds):
        before = len(scaffolds)
        scaffolds = run_ntlink_round(scaffolds, reads, p, r + 1, device)
        if len(scaffolds) == before:
            break
    return scaffolds
