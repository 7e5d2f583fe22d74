"""The wavefront kernels' designs (csrc/wavefront.cu) as numpy models of
their arithmetic, held bit for bit to the port's plain versions and to a
NumPy transcription of the JAX adjacency.

wave_adjacency: each CTA of the count keys `units` tiles of the window
(read u // T, tile u % T) and counts its valid frames' keys per partition
(group_part of the (conflict key, fingerprint) group); the (partition, CTA)
offset scan gives each CTA its place inside every partition's slice, where
the scatter writes its keys in any order (shared-memory atomics: a random
order here); each partition then groups its keys in shared memory when
they are at most `cap`, else its distinct keys when they are at most cap /
2, else sorts its slice (in global memory): a table of the groups, each
claimed by one of its keys, holds each group's least and greatest read
orders, the first order found between them and whether another is; a
group of two orders counts its pair once, one of three its two pairs,
the keys of a group of four or more are sorted and each adjacent pair of
distinct orders counts.  Run on the windows of
tests/test_torch_wavefront.py::test_adjacency_matches_numpy (overlapping
reads, padding rows, the compressed filter at insert stride 2, repeats),
a window of homopolymer reads, at the kernel's capacity and at small ones
that push partitions onto the distinct-key and the sorted paths.

wave_rounds: the flattened insert index of a commit pass (read of the list,
seed, entry; the list's window sizes as a prefix; 32-bit arithmetic) held
to ``_insert_rows`` at insert strides 1 and 2 with trimmed and whole
recruits; the warp-sized probe's vote table and top-K held to
``_classify_rows``'s votes on the windows' query grids.  The kernels
themselves run only on a card (tests/test_torch_kernels.py)."""

import functools

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401

from goldrush_tpu_torch.config import PathConfig
from goldrush_tpu_torch.mibf import mibf as tdm
from goldrush_tpu_torch.ops.nthash import fingerprints
from goldrush_tpu_torch.path import engine as teng
from goldrush_tpu_torch.path import wavefront as wave
from tests.test_torch_wavefront import np_adjacency
from tests.test_torch_wavefront_engine import (  # noqa: F401
    CFG, two_torch_threads, wave_reads)

U64 = np.uint64


def group_part(group, parts):
    """csrc/wavefront.cu's group_part: the high word of the group times the
    golden ratio, scaled to [0, parts) by a multiply-high."""
    hi = (group * U64(0x9E3779B97F4A7C15)) >> U64(32)
    return ((hi * U64(parts)) >> U64(32)).astype(np.int64)


def runs_of(first, second, rng):
    """Each key's place when keys go to runs ordered by (first, second),
    in any order inside a run: a shared-memory cursor per run."""
    perm = rng.permutation(first.size)
    key = first[perm] * (int(second.max(initial=0)) + 1) + second[perm]
    order = perm[np.argsort(key, kind="stable")]
    f, s = first[order], second[order]
    starts = np.r_[True, (f[1:] != f[:-1]) | (s[1:] != s[:-1])]
    run = np.zeros(first.size, np.int64)
    head = np.maximum.accumulate(np.where(starts, np.arange(first.size), 0))
    run[order] = np.arange(first.size) - head
    return run


def adjacency_model(grid, fp, limit, ranked, T, units, parts, cap, seed=0):
    """wave_adjacency as the kernels compute it; returns (counts [B, B],
    the partitions that took each path: shared memory, distinct keys,
    sorted slice)."""
    rng = np.random.default_rng(seed)
    B, H, TF = grid.shape
    F = TF // T
    ob = wave.ord_bits(B)
    omask = U64((1 << ob) - 1)
    nb = min(parts, wave.ADJ_BUCKETS)
    shift = (parts // nb).bit_length() - 1
    conf = grid if ranked else grid & ((1 << wave.DIRECT_CONFLICT_BITS) - 1)
    group = (conf.astype(U64) << U64(wave.FP_BITS)) | fp.astype(U64)
    key = (group << U64(ob)) | np.arange(B, dtype=U64)[:, None, None]
    valid = grid < limit
    part = group_part(group, parts)
    unit = (np.arange(B)[:, None, None] * T
            + np.arange(TF)[None, None, :] // F)
    cta = np.broadcast_to(unit // units, grid.shape)
    C = -(-(B * T) // units)
    k, p, c = key[valid], part[valid], cta[valid]
    bk = p >> shift
    # the count: one row of counts per CTA, over the buckets
    pcount = np.zeros((C, nb), np.int64)
    np.add.at(pcount, (c, bk), 1)
    # the scan: each CTA's offset inside each bucket, the buckets' offsets
    within = np.cumsum(pcount, axis=0) - pcount
    boff = np.concatenate([[0], np.cumsum(pcount.sum(axis=0))])
    # the scatter: a CTA's keys of one bucket land in its run in any order
    at = boff[bk] + within[c, bk] + runs_of(bk, c, rng)
    assert np.array_equal(np.sort(at), np.arange(k.size))
    keys = np.empty(k.size, U64)
    keys[at] = k
    # the split: each bucket's keys counted by partition, then placed
    kp = group_part(keys >> U64(ob), parts)
    counts = np.bincount(kp, minlength=parts)
    part_off = np.concatenate([[0], np.cumsum(counts)])
    at = part_off[kp] + runs_of(kp, np.zeros_like(kp), rng)
    assert np.array_equal(np.sort(at), np.arange(k.size))
    assert np.array_equal(part_off[::1 << shift], boff)
    buckets = np.empty(k.size, U64)
    buckets[at] = keys
    cnt = np.zeros(B * B, np.int64)
    paths = [0, 0, 0]

    def pairs(a):
        s = np.sort(a)
        same = (s[1:] >> U64(ob)) == (s[:-1] >> U64(ob))
        o1 = (s[1:] & omask).astype(np.int64)
        o0 = (s[:-1] & omask).astype(np.int64)
        hit = same & (o1 != o0)
        np.add.at(cnt, (np.maximum(o1, o0) * B + np.minimum(o1, o0))[hit], 1)

    sizes = np.diff(part_off)
    paths[0] = int(((sizes >= 2) & (sizes <= cap)).sum())
    # a partition of at most `cap` keys groups them all (groups never span
    # partitions, so all such partitions at once); a larger one its
    # distinct keys, or sorts
    small = np.repeat(sizes <= cap, sizes)
    grouped = [buckets[small]]
    for q in np.flatnonzero(sizes > cap):
        sl = buckets[part_off[q]:part_off[q + 1]]
        a = np.unique(sl)
        if a.size > cap // 2:
            paths[2] += 1
            pairs(sl)
        else:
            paths[1] += 1
            grouped.append(a)
    a = np.concatenate(grouped)
    if a.size:
        # the group table: each group's claimer is one of its keys, its
        # least and greatest orders, the orders between them
        grp = a >> U64(ob)
        o = (a & omask).astype(np.int64)
        _, inv = np.unique(grp, return_inverse=True)
        claim = np.full(inv.max() + 1, -1)
        pick = rng.permutation(a.size)
        claim[inv[pick]] = pick
        lo = np.full(claim.size, 0xFFFF)
        hi = np.zeros(claim.size, np.int64)
        np.minimum.at(lo, inv, o)
        np.maximum.at(hi, inv, o)
        # the orders strictly between: the first one found, and whether
        # another is
        between = (lo[inv] < o) & (o < hi[inv])
        mid = np.full(claim.size, -1)
        first = pick[np.isin(pick, np.flatnonzero(between))]
        mid[inv[first[::-1]]] = o[first[::-1]]
        many = np.zeros(claim.size, bool)
        np.logical_or.at(many, inv, between & (o != mid[inv]))
        # a group of two orders counts one pair from its claimer, one of
        # three two pairs; the keys of a group of four or more are sorted
        two = (lo != hi) & (mid < 0)
        three = (mid >= 0) & ~many
        np.add.at(cnt, (hi * B + lo)[two], 1)
        np.add.at(cnt, (mid * B + lo)[three], 1)
        np.add.at(cnt, (hi * B + mid)[three], 1)
        pairs(a[many[inv]])
    return cnt.reshape(B, B).astype(np.int32), paths


@functools.lru_cache(maxsize=None)
def port_engine(d, path, mode, stride):
    over = dict(mibf_mode=mode, insert_stride=stride, wave_window=64,
                silver_path=True)
    te = teng.GoldenPathEngine(PathConfig(prefix_file=str(d / f"m{mode}"),
                                          input=path, **dict(CFG, **over)),
                               device="cpu")
    te.calc_phred_threshold(path)
    te.fill(path)
    return te


def window(wave_reads, mode, stride, which):
    """A window of 64 reads of the test dataset as the engine builds it:
    (engine, inputs of _window_inputs, limit, ranked)."""
    d, path = wave_reads
    te = port_engine(d, path, mode, stride)
    recs = list(te._eligible(path))
    wins = [te._pack_batch(recs[i: i + 64]) for i in range(0, len(recs), 64)]
    codes, lengths, full, T = wins[1 if which == 1 else 0]
    codes = codes.copy()
    if which == "repeats":
        codes[1] = 0                          # a homopolymer read
        codes[2:6] = codes[6]                 # four copies of read 6
        codes[7, 1000:3000] = codes[8, 2000:4000]
    elif which == "homopolymer":
        codes[:] = (np.arange(codes.shape[0]) % 4)[:, None]
    state = te.cstate if te.compressed else te.state
    _, _, ranked, limit, _ = wave._filter_view(state, te.size)
    return te, te._window_inputs(codes, lengths, full, T), limit, ranked, T


ADJ_WINDOWS = [("direct", 1, 0), ("compressed", 1, 0), ("direct", 1, 1),
               ("compressed", 2, 0), ("direct", 1, "repeats"),
               ("direct", 1, "homopolymer")]


@pytest.mark.parametrize("mode,stride,which", ADJ_WINDOWS)
def test_adjacency_model_matches_numpy(wave_reads, mode, stride, which):
    te, inputs, limit, ranked, T = window(wave_reads, mode, stride, which)
    codes_t, _, _, gi, _, _, _ = inputs
    fp = fingerprints(codes_t, te.fam_ins, T * te.params.tile_length,
                      te.params_ins.frame_stride, wave.FP_BITS)
    want = np_adjacency(gi.numpy(), fp.numpy(), limit, ranked)
    assert np.array_equal(
        wave.wave_adjacency_plain(gi, fp, limit, ranked).numpy(), want)
    B, H, TF = gi.shape
    n = B * H * TF
    parts = wave.adjacency_parts(n)
    seen = [0, 0, 0]
    # the kernel's shape on an H100; and partitions of ~300 keys (two a
    # bucket) at a capacity of 64, past which a partition takes its
    # distinct keys or sorts its slice
    for units, cap, parts in ((wave.adjacency_units(B * T, 132),
                               wave.ADJ_CAP, parts), (1, 64, 2 * parts)):
        got, paths = adjacency_model(gi.numpy(), fp.numpy(), limit, ranked,
                                     T, units, parts, cap)
        np.testing.assert_array_equal(got, want)
        seen = [a + b for a, b in zip(seen, paths)]
    if which in ("repeats", "homopolymer"):
        # a heavy group's repeats collapse to its distinct keys
        assert seen[1] > 0
    if which != "homopolymer":
        assert seen[0] > 0 and seen[2] > 0
    if which == "homopolymer":
        # consecutive reads of a strand class pair once per seed
        assert want.max() == te.fam_ins.h


def insert_model(table, side, grid, order, rows, n_tiles, ceil, bs, limit,
                 or_bits, T):
    """csrc/wavefront.cu's insert_rows on numpy tables: the list's windows
    (each seed's tiles lo..hi of the insert grid) as one range of uint32
    indices from the prefix of their sizes, each index's read by the
    first end above it, its seed and entry by a division by its window."""
    B, H, TF = grid.shape
    F = TF // T
    u32 = np.uint32
    dec, ts, te = rows[:, 0], rows[:, 1], rows[:, 2]
    lo = np.where(dec == 1, 0, ts)
    last = np.minimum(np.where(dec == 1, n_tiles - 1, te), T - 1)
    win = np.where(last < lo, 0, (last - lo + 1) * F).astype(u32)[order]
    ends = np.cumsum(win * u32(H), dtype=u32)
    e = np.arange(ends[-1] if len(ends) else 0, dtype=u32)
    j = np.searchsorted(ends, e, side="right")
    rem = e - np.where(j > 0, ends[np.maximum(j - 1, 0)], u32(0))
    s = rem // win[j]
    col = rem - s * win[j]
    r = order[j]
    key = grid[r, s, lo[r].astype(u32) * u32(F) + col]
    m = col // u32(F) // u32(bs)
    ids = (ceil[r].astype(u32) + u32(1)
           + np.where(dec[r] == 2, (m * u32(bs) + u32(1)) // u32(bs), m))
    ok = (key >= 0) & (key < limit)
    np.maximum.at(table, key[ok], (or_bits | ids[ok]).astype(np.int32))
    np.maximum.at(side, key[ok], (wave.INV_BASE - ids[ok]).astype(np.int32))


def warp_probe_model(ws, ok, T, K, vote_min, threshold):
    """probe_vote_warp on the words ``ws`` of each seed (int32 [B, TF]):
    per tile, 32 frames a round, the gate and dedupe of each frame's ids,
    the lanes' equal ids counted once into a table of 2^bits entries
    (linear probing from the id's multiplicative hash), every entry keyed
    (H*F + 1 - count) << 32 | id, the candidates (count > vote_min)
    compacted by ballots in table order and each ranked by the smaller
    keys.  Returns the VoteResult fields as numpy arrays."""
    H = len(ws)
    B, TF = ok.shape
    F = TF // T
    FH = H * F
    bits = max(1, (FH - 1).bit_length())
    w = np.stack([x.numpy().view(np.uint32) for x in ws], 1)   # [B, H, TF]
    okn = ok.numpy()
    out = dict(curr_id=np.zeros((B, T), np.int32),
               top_count=np.zeros((B, T), np.int32),
               cand_ids=np.zeros((B, T, K), np.int32),
               cand_counts=np.zeros((B, T, K), np.int32),
               bool_init=np.zeros((B, T), bool),
               overflow=np.zeros((B, T), np.int32),
               queries=np.zeros(B, np.int64), hits=np.zeros(B, np.int64),
               misses=np.zeros(B, np.int64))
    for b in range(B):
        for t in range(T):
            tab = {}
            for f0 in range(0, F, 32):
                lanes = []
                for fr in range(f0, min(F, f0 + 32)):
                    col = t * F + fr
                    ids = [int(w[b, s, col]) if okn[b, col] else 0
                           for s in range(H)]
                    allp = 0x40000000 if okn[b, col] else 0
                    for x in ids:
                        allp &= x
                    ids = [x & 0x3FFFFFFF for x in ids]
                    out["queries"][b] += int(okn[b, col])
                    if not allp:
                        ids = [0] * H
                    else:
                        out["hits"][b] += sum(x != 0 for x in ids)
                        out["misses"][b] += sum(x == 0 for x in ids)
                    ids = [0 if x in ids[:i] else x for i, x in enumerate(ids)]
                    lanes.append(ids)
                for s in range(H):
                    for x in dict.fromkeys(v[s] for v in lanes):
                        if x == 0:
                            continue
                        n = sum(v[s] == x for v in lanes)
                        h = ((x * 0x9E3779B1) & 0xFFFFFFFF) >> (32 - bits)
                        while h in tab and tab[h][0] != x:
                            h = (h + 1) & ((1 << bits) - 1)
                        tab[h] = (x, tab.get(h, (x, 0))[1] + n)
            keys = {h: ((FH + 1 - c) << 32) | x for h, (x, c) in tab.items()}
            cand = [keys[h] for h in sorted(keys)
                    if FH + 1 - (keys[h] >> 32) > vote_min]
            for key in cand:
                rank = sum(k < key for k in cand)
                if rank < K:
                    out["cand_ids"][b, t, rank] = key & 0xFFFFFFFF
                    out["cand_counts"][b, t, rank] = FH + 1 - (key >> 32)
            best = min(keys.values(), default=None)
            c = 0 if best is None else FH + 1 - (best >> 32)
            out["curr_id"][b, t] = best & 0xFFFFFFFF if c > 0 else 0
            out["top_count"][b, t] = c
            out["bool_init"][b, t] = c > vote_min and c > threshold
            out["overflow"][b, t] = max(len(cand) - K, 0)
    return out


@pytest.mark.parametrize("mode,stride", [("direct", 1), ("compressed", 1),
                                         ("direct", 2)])
def test_round_model_matches_plain(wave_reads, mode, stride):
    """The flattened insert of a commit pass (whole and trimmed recruits,
    ids from random ceilings) against _insert_rows, then the warp-sized
    probe of the window's query tier through the bracket view of the
    tables it wrote against _vote_from_words and _classify_rows."""
    from goldrush_tpu_torch.path.classify import _classify_plain
    from goldrush_tpu_torch.path.engine_util import tile_min_count
    te, inputs, limit, ranked, T = window(wave_reads, mode, stride, 0)
    _, grid, ok, gi, _, n_t, _ = inputs
    state = te.cstate if te.compressed else te.state
    table = (state.ids if te.compressed else state.words).clone()
    side = torch.zeros_like(table)
    B = gi.shape[0]
    rng = np.random.default_rng(stride)
    nt = n_t.numpy().astype(np.int64)
    rows = np.zeros((B, 8), np.int64)
    rows[:, 0] = rng.choice([1, 2], B)
    rows[:, 1] = rng.integers(0, np.maximum(nt, 1))
    rows[:, 2] = rows[:, 1] + rng.integers(0, np.maximum(nt - rows[:, 1], 1))
    order = np.sort(rng.choice(B, B // 2, replace=False))
    ceil = rng.integers(0, 1_000, B)
    _, _, _, _, or_bits = wave._filter_view(state, te.size)
    bs = te.params.block_size
    tab_m, side_m = table.numpy().copy(), side.numpy().copy()
    insert_model(tab_m, side_m, gi.numpy(), order, rows, nt, ceil, bs, limit,
                 or_bits, T)
    rows_t = torch.from_numpy(rows)
    lo = torch.where(rows_t[:, 0] == 1, 0, rows_t[:, 1])
    hi = torch.where(rows_t[:, 0] == 1, n_t.long() - 1, rows_t[:, 2])
    wave._insert_rows(table, side, gi, torch.from_numpy(order), lo, hi,
                      torch.from_numpy(ceil) + 1, rows_t[:, 0] == 2, bs,
                      limit, or_bits, T)
    assert np.array_equal(tab_m, table.numpy())
    assert np.array_equal(side_m, side.numpy())
    assert (rows[order, 0] == 2).any() and (rows[order, 0] == 1).any()
    assert (side_m != 0).any()
    # the warp-sized probe of the query tier, under ceilings that see some
    # of those ids and not others
    p = te.params
    ceil_q = torch.from_numpy(rng.integers(0, 1_500, B))
    ws = tdm.bracket_words(table, side, grid, ceil_q, limit, ranked)
    assert (1 << wave_probe_bits(grid, T)) <= 256
    got = warp_probe_model(ws, ok, T, p.vote_topk, p.vote_min, p.threshold)
    want = tdm._vote_from_words(ws, ok, p, T)
    for name, v in got.items():
        np.testing.assert_array_equal(v, getattr(want, name).numpy(), name)
    assert (got["cand_ids"] != 0).any()
    r = _classify_plain(*(torch.from_numpy(got[k]) for k in
                          ("curr_id", "cand_ids", "cand_counts")), n_t,
                        p.threshold, te.spec.unassigned_min,
                        te.spec.assigned_max, False)
    rows_m = torch.stack([r.decision.long(), r.trim_start.long(),
                          r.trim_end.long(), r.num_assigned.long(),
                          torch.from_numpy(got["queries"]),
                          torch.from_numpy(got["hits"]),
                          torch.from_numpy(got["misses"]),
                          torch.from_numpy(got["overflow"]).long().sum(1)],
                         dim=1)
    rows_w, tmin_w = wave._classify_rows(te.spec, table, side, ranked, limit,
                                         grid, ok, n_t, ceil_q, p, T)
    assert torch.equal(rows_m, rows_w)
    assert torch.equal(tile_min_count(torch.from_numpy(got["top_count"]),
                                      n_t), tmin_w)


def wave_probe_bits(grid, T):
    """The query tier's vote table bits (probe_vote.cuh table_bits)."""
    n = grid.shape[1] * grid.shape[2] // T
    return max(1, (n - 1).bit_length())
