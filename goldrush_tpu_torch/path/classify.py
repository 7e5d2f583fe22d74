"""Tile classifier: the 8 smoothing passes, longest-stretch search, flank
evaluation and recruit decision (goldrush_path.cpp:628-888, :195-233,
:341-527, :943-1081).

``classify_batch`` launches kernel C (csrc/classify.cu) for CUDA tensors:
one warp per read runs the reference's sequential loops as transcribed in
``goldrush_tpu/path/oracle.py``, with their inner loops (candidate
lookups, the gap-bridge sort, flank counts) across its lanes and the rows
in shared memory.  For CPU tensors it runs the plain PyTorch
version below, a transcription of the JAX package's batched formulation
(goldrush_tpu/path/classify.py:75-429: per-tile loops with [B]-wide carries,
cummax interval painting), so the kernel and its plain version are two
independent formulations held to the same outputs.

Candidate lookups use the [B, T, K] top-K table of ``probe_and_vote``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as tnf

from .. import kernels


class ClassifyResult(NamedTuple):
    decision: torch.Tensor      # int32 [B]: 0 drop, 1 whole, 2 trimmed
    trim_start: torch.Tensor    # int32 [B] (valid when decision==2)
    trim_end: torch.Tensor      # int32 [B]
    num_assigned: torch.Tensor  # int32 [B]
    ids: torch.Tensor           # int32 [B, T] smoothed id vector
    bools: torch.Tensor         # int32 [B, T] smoothed assignment vector


# per-pass debug snapshot labels, matching the reference's 9
# log_tile_states sites (goldrush_path.cpp:637,664,685,737,769,796,824,
# 853,880)
DEBUG_PASSES = ("initial", "recon_fwd", "recon_bwd", "neighbor_fill",
                "hole_fill", "lone_suppress", "gap_bridge",
                "endfix_noncontig", "short_run")
MAXID = (1 << 30) - 1


def classify_batch(curr_id, top_count, cand_ids, cand_counts, n_tiles,
                   threshold: int, unassigned_min: int, assigned_max: int,
                   debug: bool = False):
    """Full per-read classification from vote tables.

    curr_id: int32 [B, T]; top_count: [B, T] (unused by the decision, kept
    for the JAX signature); cand_ids/cand_counts: int32 [B, T, K];
    n_tiles: int32 [B].  With ``debug=True`` returns (result, ids_trace
    [B, 9, T], bools_trace [B, 9, T]), one snapshot per DEBUG_PASSES site."""
    if curr_id.is_cuda:
        return _classify_cuda(curr_id, cand_ids, cand_counts, n_tiles,
                              threshold, unassigned_min, assigned_max, debug)
    return _classify_plain(curr_id, cand_ids, cand_counts, n_tiles,
                           threshold, unassigned_min, assigned_max, debug)


def _classify_cuda(curr_id, cand_ids, cand_counts, n_tiles, threshold,
                   u_min, a_max, debug):
    B, T = curr_id.shape
    K = cand_ids.shape[2]
    dev = curr_id.device
    kernels.check(curr_id, "curr_id", torch.int32, (B, T), dev)
    kernels.check(cand_ids, "cand_ids", torch.int32, (B, T, K), dev)
    kernels.check(cand_counts, "cand_counts", torch.int32, (B, T, K), dev)
    kernels.check(n_tiles, "n_tiles", torch.int32, (B,), dev)
    i32 = dict(dtype=torch.int32, device=dev)
    res = ClassifyResult(
        decision=torch.empty(B, **i32), trim_start=torch.empty(B, **i32),
        trim_end=torch.empty(B, **i32), num_assigned=torch.empty(B, **i32),
        ids=torch.empty((B, T), **i32), bools=torch.empty((B, T), **i32))
    ids_tr = torch.empty((B, 9, T), **i32) if debug else None
    bools_tr = torch.empty((B, 9, T), **i32) if debug else None
    kernels.CLASSIFY(
        dev, kernels.ptr(curr_id), kernels.ptr(cand_ids),
        kernels.ptr(cand_counts), kernels.ptr(n_tiles), B, T, K,
        int(threshold), int(u_min), int(a_max),
        *(kernels.ptr(t) for t in res),
        kernels.ptr(ids_tr), kernels.ptr(bools_tr))
    if debug:
        return res, ids_tr, bools_tr
    return res


def row_cummax(x: torch.Tensor) -> torch.Tensor:
    """Running max along each row of an int32 [R, T] tensor.  For CUDA
    tensors this launches, on its own, the warp cummax from which kernel
    C's passes 5 and 10 take their run starts (csrc/classify.cu), so that
    it can be held against torch.cummax; for CPU tensors it is
    torch.cummax."""
    if not x.is_cuda:
        return torch.cummax(x, dim=1).values
    R, T = x.shape
    kernels.check(x, "x", torch.int32, (R, T))
    out = torch.empty_like(x)
    kernels.ROW_CUMMAX(x.device, kernels.ptr(x), R, T, kernels.ptr(out))
    return out


def _adj(a, b):
    """id adjacency a==b, a==b+1, a==b-1 under the reference's unsigned
    arithmetic (b==0 makes b-1 unreachable)."""
    return (a == b) | (a == b + 1) | ((b > 0) & (a == b - 1))


def _ffill_value(seed_mask, seed_vals, T):
    """Per-row forward fill of seed_vals (< 2^30) from seeded positions."""
    idx = torch.arange(T, dtype=torch.int64, device=seed_mask.device)[None]
    combo = torch.where(seed_mask, ((idx + 1) << 30) | seed_vals.long(), 0)
    return (torch.cummax(combo, dim=1).values & MAXID).int()


def _scatter_max(B, T, ok, pos, vals, dtype):
    """out[b, pos] = max over ok entries of vals (0 elsewhere)."""
    out = torch.zeros((B, T), dtype=dtype, device=ok.device)
    return out.scatter_reduce(1, torch.where(ok, pos, 0).long(),
                              torch.where(ok, vals, 0).to(dtype), "amax")


def _shift_prev(x, fill=0):
    """x[:, t-1] at t (fill at t=0)."""
    return tnf.pad(x[:, :-1], (1, 0), value=fill)


def _shift_next(x, fill=0):
    return tnf.pad(x[:, 1:], (0, 1), value=fill)


def _classify_plain(curr_id, cand_ids, cand_counts, n_tiles, threshold,
                    u_min, a_max, debug):
    B, T = curr_id.shape
    dev = curr_id.device
    trace = []
    ci = cand_ids.int()
    cc = cand_counts.int()
    n = n_tiles.int()
    t_idx = torch.arange(T, dtype=torch.int32, device=dev)[None, :]
    in_read = t_idx < n[:, None]
    ids = torch.where(in_read, curr_id.int(), 0)
    bools = (in_read & (cc[:, :, 0] > 0)
             & (cc[:, :, 0] > threshold)).int()
    smooth = n >= 3
    if debug:
        trace.append((ids, bools))          # 637: initial assignment

    # ---- pass 1/2: ID reconciliation, forward then backward -------------
    def recon(ids, bools, reverse):
        ids, bools = ids.clone(), bools.clone()
        prev = torch.zeros(B, dtype=torch.int32, device=dev)
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            if reverse:
                active = smooth & (t <= n - 2)
            else:
                active = smooth & (t >= 1) & (t < n)
            m = (ci[:, t] == prev[:, None]) & (cc[:, t] > 0)
            cnt = torch.where(m, cc[:, t], 0).sum(-1)
            hit = active & (ids[:, t] != prev) & m.any(-1)
            ids[:, t] = torch.where(hit, prev, ids[:, t])
            bools[:, t] = torch.where(hit, (cnt > threshold).int(),
                                      bools[:, t])
            prev = ids[:, t]
        return ids, bools

    ids, bools = recon(ids, bools, False)
    if debug:
        trace.append((ids, bools))          # 664: forward reconciliation
    ids, bools = recon(ids, bools, True)
    if debug:
        trace.append((ids, bools))          # 685: backward reconciliation

    # ---- pass 3/4: neighbor fill, forward then backward -----------------
    def nfill(ids, bools, reverse):
        # the not-yet-visited neighbour is read from the pre-pass snapshot,
        # the visited one from the running carry
        snap_i, snap_b = ids, bools
        ids, bools = ids.clone(), bools.clone()
        z = torch.zeros(B, dtype=torch.int32, device=dev)
        carry_i, carry_b = z, z
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            i, b = ids[:, t], bools[:, t]
            far = t + 1 if not reverse else t - 1
            if 0 <= far < T:
                far_i, far_b = snap_i[:, far], snap_b[:, far]
            else:
                far_i, far_b = z, z
            if reverse:
                prev_i, prev_b, nxt_i, nxt_b = far_i, far_b, carry_i, carry_b
            else:
                prev_i, prev_b, nxt_i, nxt_b = carry_i, carry_b, far_i, far_b
            active = smooth & (t >= 1) & (t <= n - 2) & (b == 0)
            c1 = ((i == prev_i) & (prev_b == 1)) | ((i == nxt_i)
                                                    & (nxt_b == 1))
            c2 = ((i == prev_i + 1) & (prev_b == 1)) | \
                 ((i == nxt_i + 1) & (nxt_b == 1))
            c3 = ((prev_i > 0) & (i == prev_i - 1) & (prev_b == 1)) | \
                 ((nxt_i > 0) & (i == nxt_i - 1) & (nxt_b == 1))
            c4 = (prev_i == nxt_i) & (prev_b == 1) & (nxt_b == 1)
            new_b = torch.where(active & (c1 | c2 | c3 | c4), 1, b)
            new_i = torch.where(active & ~c1 & ~c2 & ~c3 & c4, prev_i, i)
            ids[:, t], bools[:, t] = new_i, new_b
            carry_i, carry_b = new_i, new_b
        return ids, bools

    ids, bools = nfill(ids, bools, False)
    ids, bools = nfill(ids, bools, True)
    if debug:
        trace.append((ids, bools))          # 737: neighbor fill

    # ---- pass 5: hole fill between compatible flank ids ------------------
    nn = n[:, None]
    interior = (t_idx >= 1) & (t_idx <= nn - 2) & smooth[:, None]
    pb = _shift_prev(bools)
    start_f = interior & (bools == 0) & (pb == 1)          # run starts
    close_f = interior & (bools == 1) & (pb == 0)          # run closes at i
    a_of = torch.cummax(torch.where(start_f, t_idx, 0), dim=1).values
    left = torch.gather(ids, 1, torch.clamp(a_of - 1, 0, T - 1).long())
    ok = close_f & (a_of > 0) & _adj(left, ids)
    starts = _scatter_max(B, T, ok, a_of, ok, torch.int32) > 0
    fill = torch.cumsum(starts.int() - ok.int(), dim=1) > 0
    fill_val = _ffill_value(
        starts, _scatter_max(B, T, ok, a_of, left, torch.int32), T)
    ids = torch.where(fill, fill_val, ids)
    bools = torch.where(fill, 1, bools)
    if debug:
        trace.append((ids, bools))          # 769: hole fill

    # ---- pass 6: lone-tile suppression fwd/bwd ---------------------------
    def lone(bools, reverse):
        snap = bools
        bools = bools.clone()
        carry = torch.zeros(B, dtype=torch.int32, device=dev)
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            far = t + 1 if not reverse else t - 1
            far_b = snap[:, far] if 0 <= far < T else torch.zeros_like(carry)
            active = smooth & (t >= 2) & (t <= n - 3)
            b = bools[:, t]
            new_b = torch.where(active & (b == 1) & (carry == 0)
                                & (far_b == 0), 0, b)
            bools[:, t] = new_b
            carry = new_b
        return bools

    bools = lone(lone(bools, False), True)
    if debug:
        trace.append((ids, bools))          # 796: lone-tile suppression

    # ---- pass 7: gap bridging by ID --------------------------------------
    member0 = (bools == 1) & smooth[:, None] & in_read   # membership snapshot
    ids0 = ids
    uid_sorted = torch.sort(torch.where(member0, ids0, MAXID), dim=1).values
    first = tnf.pad(uid_sorted[:, 1:] != uid_sorted[:, :-1], (1, 0),
                    value=True)
    uniq = torch.sort(torch.where(first & (uid_sorted < MAXID), uid_sorted,
                                  MAXID), dim=1).values
    cur = ids
    for g_i in range(T):
        g = uniq[:, g_i]
        if bool((g == MAXID).all()):      # ascending: only padding remains
            break
        mask = member0 & (ids0 == g[:, None])
        prev_m = torch.cummax(torch.where(mask, t_idx, -T), dim=1).values
        prev_ex = _shift_prev(prev_m, -T)
        has_prev = prev_ex >= 0
        gap = mask & has_prev & (t_idx > prev_ex + 1)
        # members re-read the current ids when first or adjacent to the
        # previous member; gap members inherit the preceding fill's value
        head = mask & (~has_prev | (t_idx == prev_ex + 1))
        v = _ffill_value(head, torch.where(head, cur, 0), T)
        v_prev = torch.gather(v, 1, torch.clamp(prev_ex, 0, T - 1).long())
        pos = torch.clamp(prev_ex + 1, 0, T - 1)
        fill_start = _scatter_max(B, T, gap, pos, gap, torch.int32) > 0
        seed_vals = _scatter_max(B, T, gap, prev_ex + 1, v_prev, torch.int32)
        infill = torch.cumsum(fill_start.int() - _shift_prev(gap.int()),
                              dim=1) > 0
        cur = torch.where(infill, _ffill_value(fill_start, seed_vals, T), cur)
    ids = torch.where(smooth[:, None], cur, ids)
    if debug:
        trace.append((ids, bools))          # 824: gap bridging

    # ---- pass 8: end-tile fix --------------------------------------------
    def gat(arr, pos):
        return torch.gather(arr, 1, torch.clamp(pos, 0, T - 1).long()[:, None]
                            )[:, 0]
    last, second_last = gat(ids, n - 1), gat(ids, n - 2)
    start0 = ids[:, 0]
    second0 = ids[:, 1] if T > 1 else ids[:, 0]
    fix_last = smooth & _adj(last, second_last)
    fix_first = smooth & _adj(start0, second0)
    bools = bools.clone()
    rows = torch.arange(B, device=dev)
    lp = torch.clamp(n - 1, 0, T - 1).long()
    bools[rows, lp] = torch.where(fix_last, 1, bools[rows, lp])
    bools[:, 0] = torch.where(fix_first, 1, bools[:, 0])

    # ---- pass 9: non-contiguous-ID suppression ---------------------------
    iso = interior & ~_adj(ids, _shift_next(ids)) & ~_adj(ids, _shift_prev(ids))
    bools = torch.where(iso, 0, bools)
    if debug:
        trace.append((ids, bools))          # 853: end fix + non-contiguous

    # ---- pass 10: short-run suppression (<=5) ----------------------------
    pb = _shift_prev(bools)
    rstart = interior & (bools == 1) & (pb == 0)
    rclose = interior & (bools == 0) & (pb == 1)           # run ended at i-1
    a_of = torch.cummax(torch.where(rstart, t_idx, 0), dim=1).values
    short = rclose & ((t_idx - 1) - a_of + 1 <= 5)
    starts = _scatter_max(B, T, short, torch.clamp(a_of, 0, T - 1), short,
                          torch.int32) > 0
    suppress = torch.cumsum(starts.int() - short.int(), dim=1) > 0
    bools = torch.where(suppress & smooth[:, None], 0, bools)
    bools = torch.where(in_read, bools, 0)
    if debug:
        trace.append((ids, bools))          # 880: short-run suppression
    num_assigned = bools.sum(dim=1).int()

    # ---- find_longest_stretch (goldrush_path.cpp:195-233) ----------------
    z = torch.zeros(B, dtype=torch.int32, device=dev)
    start, end, cur_len, longest, ls, le = z, z, z, z, z, z
    pb_full = _shift_prev(bools)
    for t in range(T):
        b, p = bools[:, t], pb_full[:, t]
        active = (t >= 1) & (t <= n - 2)
        c1 = (b == 0) & (p == 1)
        c2 = (b == 0) & (b == p) & (t + 1 != n - 1)
        c3 = (b == 1) & (b != p)
        c4 = (t + 1 == n - 1) & (end < start)
        sel1 = active & c1
        sel2 = active & ~c1 & c2
        sel3 = active & ~c1 & ~c2 & c3
        sel4 = active & ~c1 & ~c2 & ~c3 & c4
        start = torch.where(sel1, t, start)
        cur_len = torch.where(sel1, 1, torch.where(sel2 | sel4, cur_len + 1,
                                                   cur_len))
        end = torch.where(sel3, t - 1, torch.where(sel4, t, end))
        upd = (sel3 | sel4) & (longest < cur_len)
        longest = torch.where(upd, cur_len, longest)
        ls = torch.where(upd, start, ls)
        le = torch.where(upd, end, le)

    # ---- eval_flanks (goldrush_path.cpp:341-527) -------------------------
    def flank_top2(lo, hi):
        """top-2 (count, id) over lo <= t < hi, count desc then id asc."""
        rng = (t_idx >= lo[:, None]) & (t_idx < hi[:, None])
        eq = ids[:, :, None] == ids[:, None, :]
        cnt = (eq & rng[:, :, None] & rng[:, None, :]).sum(dim=2)
        cnt = torch.where(rng, cnt, 0)
        key = cnt.long() * (1 << 31) + (MAXID - ids)
        k1 = torch.where(rng, key, 0).max(dim=1).values
        c1 = (k1 >> 31).int()
        i1 = torch.where(c1 > 0, MAXID - (k1 & ((1 << 31) - 1)).int(), 0)
        k2 = torch.where(rng & (ids != i1[:, None]), key, 0).max(dim=1).values
        c2 = (k2 >> 31).int()
        i2 = torch.where(c2 > 0, MAXID - (k2 & ((1 << 31) - 1)).int(), 0)
        return c1, i1, c2, i2, hi > lo

    def good(c1, i1, c2, i2, need_second):
        pair = (c1 + c2 > 3) & ((i1 == i2 + 1) | (i2 == i1 + 1))
        if need_second:
            pair = pair & (c2 > 0)
        return (c1 >= 2) | pair                 # MIN_IDS_IN_FLANK = 2

    trim_start0 = torch.where(ls != 0, ls - 1, ls)
    trim_end0 = le + 1
    # small-read branch (n < 15)
    lc1, li1, lc2, li2, lne = flank_top2(z, ls)
    good_left = (lne & good(lc1, li1, lc2, li2, True)) | (trim_start0 == 0)
    rc1, ri1, rc2, ri2, rne = flank_top2(le + 1, n)
    good_right = (rne & good(rc1, ri1, rc2, ri2, True)) | (trim_end0 == n - 1)
    good_small = good_left & good_right
    # large-read branch (n >= 15): window of 5 tiles each side
    has_lwin = ls - 5 >= 1
    Lc1, Li1, Lc2, Li2, _ = flank_top2(torch.clamp(ls - 5, min=0), ls)
    good_l = has_lwin & good(Lc1, Li1, Lc2, Li2, False)
    has_rwin = le + 5 < n - 1
    Rc1, Ri1, Rc2, Ri2, _ = flank_top2(le + 1, torch.minimum(le + 6, n))
    good_r = has_rwin & good(Rc1, Ri1, Rc2, Ri2, False)
    good_large = good_l | good_r | ~has_lwin | ~has_rwin
    trim_start_large = torch.where(~has_lwin, 0, trim_start0)
    trim_end_large = torch.where(~has_rwin, n - 1, trim_end0)
    small = n < 15
    good_flank = torch.where(small, good_small, good_large)
    trim_start = torch.where(small, trim_start0, trim_start_large)
    trim_end = torch.where(small, trim_end0, trim_end_large)

    # ---- decision (process_read :968-1081) -------------------------------
    whole = ((n - num_assigned) >= u_min) & (num_assigned <= a_max)
    fully = num_assigned == n
    trimmed = ~whole & ~fully & good_flank
    decision = torch.where(whole, 1, torch.where(trimmed, 2, 0)).int()
    result = ClassifyResult(decision=decision, trim_start=trim_start.int(),
                            trim_end=trim_end.int(),
                            num_assigned=num_assigned, ids=ids.int(),
                            bools=bools.int())
    if debug:
        return (result, torch.stack([t[0] for t in trace], dim=1),
                torch.stack([t[1] for t in trace], dim=1))
    return result
