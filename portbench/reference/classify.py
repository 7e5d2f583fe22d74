"""The tile classifier and recruit decision of goldrush-path, in plain
Python.

Frozen copy of goldrush_tpu/path/oracle.py:1-279 at commit 93d720b (its
own provenance follows), with no import of that package.  Only this
header differs.


Pure-Python/NumPy transcription of the golden-path per-read pipeline
(goldrush_path.cpp): the eight order-sensitive smoothing passes of
calc_num_assigned_tiles (:628-888), find_longest_stretch (:195-233),
eval_flanks (:341-527), and the process_read decision logic (:892-1094).

This module is the executable specification the batched JAX classifier is
held to; it is itself validated against 1200 golden input->output vectors
generated by compiling the reference's own logic (tests/fixtures/
classify_fixtures.json).  Quirks preserved deliberately:

 - all ID adjacency tests are on unsigned values but IDs stay < 2^30, so
   plain integer arithmetic is equivalent;
 - the flank maps iterate in ascending-ID order and the descending-count
   sort is effectively stable at these sizes, so ties order by ascending ID;
 - find_longest_stretch's unreachable-stretch corner cases (a stretch of
   length 1 at position n-2 is never recorded; a stretch starting at 0
   inherits start_idx=0 only via the default) are kept as-is;
 - the large-read flank branch ORs left/right goodness into one flag while
   the small-read branch ANDs separate flags (reference asymmetry);
 - gap-bridging re-reads id_vec[prev_idx] (which earlier IDs' fills may have
   rewritten) rather than using the map key.
"""

from __future__ import annotations

SMALL_READ_THRESHOLD = 15
MAX_TILES_TO_CHECK = 5
MIN_IDS_IN_FLANK = 2


def smooth_tiles(all_id: list[list[tuple[int, int]]], id_vec: list[int],
                 bool_vec: list[int], threshold: int) -> int:
    """Apply initial thresholding + the 8 smoothing passes in place.

    all_id[i]: per-tile candidate (id, count) pairs with count > 2, sorted by
    count descending (ties by ascending id).  id_vec[i]: max-count id over
    *all* ids.  Returns the number of assigned tiles.
    """
    n = len(id_vec)
    for i in range(n):
        if all_id[i] and all_id[i][0][1] > threshold:
            bool_vec[i] = 1

    if n >= 3:
        # pass 1: forward ID reconciliation (:646-661)
        for i in range(1, n):
            prev_id = id_vec[i - 1]
            if id_vec[i] != prev_id:
                for pid, c in all_id[i]:
                    if pid == prev_id:
                        id_vec[i] = prev_id
                        bool_vec[i] = 1 if c > threshold else 0
        # pass 2: backward (:667-682)
        for i in range(n - 2, -1, -1):
            prev_id = id_vec[i + 1]
            if id_vec[i] != prev_id:
                for pid, c in all_id[i]:
                    if pid == prev_id:
                        id_vec[i] = prev_id
                        bool_vec[i] = 1 if c > threshold else 0
        # pass 3: forward neighbor fill (:688-710)
        for i in range(1, n - 1):
            if not bool_vec[i]:
                ci, pi, ni = id_vec[i], id_vec[i - 1], id_vec[i + 1]
                pa, na = bool_vec[i - 1], bool_vec[i + 1]
                if (ci == pi and pa) or (ci == ni and na):
                    bool_vec[i] = 1
                elif (ci == pi + 1 and pa) or (ci == ni + 1 and na):
                    bool_vec[i] = 1
                elif (pi and ci == pi - 1 and pa) or (ni and ci == ni - 1 and na):
                    bool_vec[i] = 1
                elif pi == ni and pa and na:
                    bool_vec[i] = pa
                    id_vec[i] = pi
        # pass 4: backward neighbor fill (:712-734)
        for i in range(n - 2, 0, -1):
            if not bool_vec[i]:
                ci, pi, ni = id_vec[i], id_vec[i - 1], id_vec[i + 1]
                pa, na = bool_vec[i - 1], bool_vec[i + 1]
                if (ci == pi and pa) or (ci == ni and na):
                    bool_vec[i] = 1
                elif (ci == pi + 1 and pa) or (ci == ni + 1 and na):
                    bool_vec[i] = 1
                elif (pi and ci == pi - 1 and pa) or (ni and ci == ni - 1 and na):
                    bool_vec[i] = 1
                elif pi == ni and pa and na:
                    bool_vec[i] = pa
                    id_vec[i] = pi
        # pass 5: hole fill between compatible flanks (:739-766)
        coord_vec = []
        start_idx = 0
        for i in range(1, n - 1):
            if not bool_vec[i] and bool_vec[i - 1]:
                start_idx = i
            elif bool_vec[i] and not bool_vec[i - 1]:
                coord_vec.append((start_idx, i - 1))
        for a, b in coord_vec:
            if a == 0 or b == n - 1:
                continue
            left, right = id_vec[a - 1], id_vec[b + 1]
            if left == right or left == right + 1 or (right and left == right - 1):
                for i in range(a, b + 1):
                    bool_vec[i] = 1
                    id_vec[i] = left
        # pass 6: lone-tile suppression, forward then backward (:771-792)
        for i in range(2, n - 2):
            if bool_vec[i] and not bool_vec[i - 1] and not bool_vec[i + 1]:
                bool_vec[i] = 0
        for i in range(n - 3, 1, -1):
            if bool_vec[i] and not bool_vec[i - 1] and not bool_vec[i + 1]:
                bool_vec[i] = 0
        # pass 7: gap bridging by ID, ascending-ID map order (:799-822)
        id_to_idx: dict[int, list[int]] = {}
        for i in range(n):
            if bool_vec[i]:
                id_to_idx.setdefault(id_vec[i], []).append(i)
        for _id in sorted(id_to_idx):
            idx_vec = sorted(id_to_idx[_id])
            for i in range(1, len(idx_vec)):
                prev_idx, curr_idx = idx_vec[i - 1], idx_vec[i]
                if curr_idx > prev_idx + 1:
                    pid = id_vec[prev_idx]
                    for j in range(prev_idx + 1, curr_idx + 1):
                        id_vec[j] = pid
        # pass 8: end-tile fix (:827-838)
        last, second_last = id_vec[n - 1], id_vec[n - 2]
        start, second = id_vec[0], id_vec[1]
        if last == second_last or last == second_last + 1 or \
                (second_last and last == second_last - 1):
            bool_vec[n - 1] = 1
        if start == second or start == second + 1 or \
                (second and start == second - 1):
            bool_vec[0] = 1
        # pass 9: non-contiguous-ID suppression (:840-850)
        ids_snapshot = list(id_vec)
        for i in range(1, n - 1):
            ci, pi, ni = ids_snapshot[i], ids_snapshot[i - 1], ids_snapshot[i + 1]
            if ci != ni and ci != ni + 1 and not (ni and ci == ni - 1) and \
                    ci != pi and ci != pi + 1 and not (pi and ci == pi - 1):
                bool_vec[i] = 0
        # pass 10: short-run suppression <=5 (:856-877)
        coord_vec = []
        start_idx = 0
        for i in range(1, n - 1):
            if bool_vec[i] and not bool_vec[i - 1]:
                start_idx = i
            elif not bool_vec[i] and bool_vec[i - 1]:
                coord_vec.append((start_idx, i - 1))
        for a, b in coord_vec:
            if b - a + 1 <= 5:
                for i in range(a, b + 1):
                    bool_vec[i] = 0

    return sum(1 for b in bool_vec if b)


def find_longest_stretch(bool_vec: list[int]) -> tuple[int, int]:
    """Longest unassigned interior stretch (goldrush_path.cpp:195-233)."""
    n = len(bool_vec)
    start_idx = end_idx = 0
    longest_start = longest_end = 0
    curr = longest = 0
    for i in range(1, n - 1):
        if not bool_vec[i] and bool_vec[i - 1]:
            start_idx = i
            curr = 1
        elif (not bool_vec[i] and bool_vec[i] == bool_vec[i - 1]) and \
                (i + 1 != n - 1):
            curr += 1
        elif bool_vec[i] and bool_vec[i] != bool_vec[i - 1]:
            end_idx = i - 1
            if longest < curr:
                longest, longest_start, longest_end = curr, start_idx, end_idx
        elif i + 1 == n - 1 and end_idx < start_idx:
            end_idx = i
            curr += 1
            if longest < curr:
                longest, longest_start, longest_end = curr, start_idx, end_idx
    return longest_start, longest_end


def _flank_counts(ids) -> list[tuple[int, int]]:
    """(id, count) pairs sorted by count desc, ties ascending id (the
    effective order of map iteration + small-array stable sort)."""
    counts: dict[int, int] = {}
    for v in ids:
        counts[v] = counts.get(v, 0) + 1
    return sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))


def eval_flanks(longest_start: int, longest_end: int, id_vec: list[int]
                ) -> tuple[bool, int, int]:
    """(good_flank, trim_start, trim_end) — goldrush_path.cpp:341-527."""
    n = len(id_vec)
    trim_start = longest_start - 1 if longest_start != 0 else longest_start
    trim_end = longest_end + 1

    def adjacent(a, b):
        return a == b + 1 or b == a + 1

    if n < SMALL_READ_THRESHOLD:
        good_left = good_right = False
        left = _flank_counts(id_vec[i] for i in range(longest_start - 1, -1, -1))
        if left:
            if left[0][1] >= MIN_IDS_IN_FLANK:
                good_left = True
            elif len(left) >= 2 and \
                    left[0][1] + left[1][1] > MIN_IDS_IN_FLANK + 1 and \
                    adjacent(left[0][0], left[1][0]):
                good_left = True
        if trim_start == 0:
            good_left = True
        right = _flank_counts(id_vec[i] for i in range(longest_end + 1, n))
        if right:
            if right[0][1] >= MIN_IDS_IN_FLANK:
                good_right = True
            elif len(right) >= 2 and \
                    right[0][1] + right[1][1] > MIN_IDS_IN_FLANK + 1 and \
                    adjacent(right[0][0], right[1][0]):
                good_right = True
        if trim_end == n - 1:
            good_right = True
        return good_left and good_right, trim_start, trim_end

    good = False
    if longest_start - MAX_TILES_TO_CHECK >= 1:
        left = _flank_counts(
            id_vec[i] for i in range(longest_start - MAX_TILES_TO_CHECK,
                                     longest_start))
        if left[0][1] >= MIN_IDS_IN_FLANK:
            good = True
        elif left[0][1] + left[1][1] > MIN_IDS_IN_FLANK + 1 and \
                adjacent(left[0][0], left[1][0]):
            good = True
    else:
        good = True
        trim_start = 0
    if longest_end + MAX_TILES_TO_CHECK < n - 1:
        right = _flank_counts(
            id_vec[i] for i in range(longest_end + MAX_TILES_TO_CHECK,
                                     longest_end, -1))
        if right[0][1] >= MIN_IDS_IN_FLANK:
            good = True
            trim_end = longest_end + 1
        elif right[0][1] + right[1][1] > MIN_IDS_IN_FLANK + 1 and \
                adjacent(right[0][0], right[1][0]):
            good = True
            trim_end = longest_end + 1
    else:
        good = True
        trim_end = n - 1
    return good, trim_start, trim_end


def classify_read(all_id, id_vec, bool_vec, threshold, unassigned_min,
                  assigned_max):
    """Full per-read decision (process_read, goldrush_path.cpp:943-1081).

    Returns dict with keys: decision ('whole' | 'trimmed' | 'drop'),
    num_assigned, trim (for 'trimmed'), and the smoothed vectors.
    """
    n = len(id_vec)
    num_assigned = smooth_tiles(all_id, id_vec, bool_vec, threshold)
    num_unassigned = n - num_assigned
    if num_unassigned >= unassigned_min and num_assigned <= assigned_max:
        return {"decision": "whole", "num_assigned": num_assigned,
                "id_vec": id_vec, "bool_vec": bool_vec}
    if num_assigned == n:
        return {"decision": "drop", "num_assigned": num_assigned,
                "id_vec": id_vec, "bool_vec": bool_vec}
    ls, le = find_longest_stretch(bool_vec)
    good, ts, te = eval_flanks(ls, le, id_vec)
    if good:
        return {"decision": "trimmed", "num_assigned": num_assigned,
                "trim": (ts, te), "id_vec": id_vec, "bool_vec": bool_vec}
    return {"decision": "drop", "num_assigned": num_assigned,
            "id_vec": id_vec, "bool_vec": bool_vec}
