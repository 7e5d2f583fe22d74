"""Inputs on which kernels A (build_slot_grid), B (probe_and_vote) and C
(classify_batch) branch, and the shapes the minimizer kernel (K20) and the
k-mer table (K21) meet, made with numpy from a seed.  The CPU tests hold
the plain versions against the JAX package on them; the `gpu` tests and
chip_smoke.py hold the kernels against the plain versions on them.  Numpy
only."""

from __future__ import annotations

import numpy as np

PRESENT, SAT, ID_MASK = 1 << 30, 1 << 31, (1 << 30) - 1

# word indices of the vote table below: an absent slot (its frame fails the
# all-seeds gate), a present slot without an id (a miss), the largest id
# saturated and plain; id x >= 1 sits at index x + 3
ABSENT, MISS, SAT_MAX, ID_MAX = 0, 1, 2, 3
N_IDS = 65_536

VOTE_KINDS = ("distinct", "ties_at_k", "at_gates", "overflow", "id_mask",
              "no_votes")


def grid_lengths(TL: int, k: int) -> dict:
    """Read lengths on which kernel A's grid branches (tiles and the
    stale-tail clamp), as name -> (lengths, T): shorter than k, one tile,
    TL + k - 2 (the last length before a tile's frames are all whole), a
    multiple of TL, reads that fill the bucket of T tiles and pass it, and
    a bucket of one tile."""
    return {
        "shorter_than_k": ([k - 1, 5, 0], 2),
        "one_tile": ([TL, TL - 1, TL + 1], 2),
        "tl_plus_k_minus_2": ([TL + k - 2, TL + k - 1, TL + k - 3], 2),
        "multiple_of_tl": ([3 * TL, 2 * TL, TL], 4),
        "fills_bucket": ([4 * TL + TL // 2, 4 * TL + k - 1, 4 * TL], 4),
        "one_tile_bucket": ([TL + 7, TL, 3], 1),
    }


def read_batch(lengths, width: int, seed: int) -> tuple:
    """uint8 codes [B, width] (random bases, zero past each length) and
    int32 lengths [B]."""
    rng = np.random.default_rng(seed)
    codes = np.zeros((len(lengths), width), np.uint8)
    for i, n in enumerate(lengths):
        codes[i, :n] = rng.integers(0, 4, n)
    return codes, np.asarray(lengths, np.int32)


def vote_words() -> np.ndarray:
    """uint32 [N_IDS + 4] words: index ABSENT 0, MISS PRESENT, SAT_MAX
    PRESENT|SAT|ID_MASK, ID_MAX PRESENT|ID_MASK, x + 3 PRESENT|x."""
    w = np.zeros(N_IDS + 4, np.uint32)
    w[MISS] = PRESENT
    w[SAT_MAX] = PRESENT | SAT | ID_MASK
    w[ID_MAX] = PRESENT | ID_MASK
    w[4:] = PRESENT | np.arange(1, N_IDS + 1, dtype=np.uint32)
    return w


def _tile(kind, rng, F, H, K, vote_min, threshold):
    """[H, F] word indices and frame_ok [F] of one tile of `kind`."""
    ok = np.ones(F, bool)
    V = np.full(H * F, MISS, np.int64)      # seed-major: position s*F + f
    ids = rng.permutation(N_IDS)[: H * F] + 1

    def put(pairs):
        """id x at c consecutive positions: c <= F keeps them in distinct
        frames, so the count survives the per-frame dedupe."""
        p = 0
        for x, c in pairs:
            V[p:p + c] = x + 3
            p += c
        assert p <= H * F

    if kind == "distinct":                  # every vote its own id
        V[:] = ids + 3
    elif kind == "ties_at_k":               # equal counts straddle rank K
        c = vote_min + 2
        put([(ids[0], c + 3)] + [(x, c) for x in ids[1:K + 6]])
    elif kind == "at_gates":                # counts at vote_min, threshold
        top = threshold + int(rng.integers(0, 2))   # bool_init off / on
        put([(ids[0], top)] + [(x, c) for x, c in zip(
            ids[1:8], [threshold, vote_min, vote_min + 1, vote_min,
                       vote_min + 1, 1, 1])])
    elif kind == "overflow":                # more than K candidates
        put([(x, vote_min + 1 + int(rng.integers(0, 6)))
             for x in ids[: 2 * K + 5]])
    elif kind == "id_mask":                 # saturated and plain ID_MASK
        V[:] = rng.choice([MISS, SAT_MAX, ID_MAX, ids[0] + 3], H * F)
        V[rng.random(H * F) < 0.1] = ABSENT      # some frames fail the gate
        dup = rng.random(F) < 0.3                # one word on every seed
        for s in range(1, H):
            V[s * F:(s + 1) * F][dup] = V[:F][dup]
    elif kind == "no_votes":                # gate fails, frame_ok off
        V[:] = np.where(rng.random(H * F) < 0.5, ABSENT, MISS)
        ok[rng.random(F) < 0.5] = False
    else:
        raise ValueError(kind)
    V = V.reshape(H, F)[:, rng.permutation(F)]   # same frames for all seeds
    return V, ok


def vote_case(kind: str | None, B: int, T: int, F: int, H: int, K: int,
              vote_min: int, threshold: int, seed: int
              ) -> tuple[np.ndarray, np.ndarray]:
    """A [B, H, T*F] int64 grid of indices into ``vote_words()`` and
    frame_ok bool [B, T*F]; every tile is of ``kind``, or of each kind in
    turn when ``kind`` is None.  The last tile of every read has frame_ok
    off throughout (a read shorter than the bucket)."""
    rng = np.random.default_rng(seed)
    grid = np.empty((B, H, T * F), np.int64)
    ok = np.empty((B, T * F), bool)
    for b in range(B):
        for t in range(T):
            k = kind or VOTE_KINDS[(b * T + t) % len(VOTE_KINDS)]
            V, o = _tile(k, rng, F, H, K, vote_min, threshold)
            grid[b, :, t * F:(t + 1) * F] = V
            ok[b, t * F:(t + 1) * F] = o
        if T > 1:
            ok[b, (T - 1) * F:] = False
    return grid, ok


def classify_case(n_tiles, T: int, K: int, seed: int, n_ids: int = 8
                  ) -> tuple[np.ndarray, ...]:
    """Vote tables shaped like probe_and_vote's for reads of the given
    tile counts in a bucket of T tiles: candidates with count > 2 sorted by
    (count desc, id asc), zero padding, curr_id the top id (or a random id
    of a tile without candidates).  Ids come from 1..n_ids so that
    neighbouring tiles agree often enough for every smoothing pass to act.
    Returns (curr_id, top_count, cand_ids, cand_counts, n_tiles)."""
    rng = np.random.default_rng(seed)
    B = len(n_tiles)
    curr_id = np.zeros((B, T), np.int32)
    ci = np.zeros((B, T, K), np.int32)
    cc = np.zeros((B, T, K), np.int32)
    for b in range(B):
        run_id = int(rng.integers(1, n_ids + 1))
        for t in range(T):
            if rng.random() < 0.3:              # runs of one id, then a step
                run_id = int(np.clip(run_id + rng.integers(-1, 2), 1, n_ids))
            m = int(rng.integers(0, min(K, n_ids) + 1))
            ids = rng.choice(np.arange(1, n_ids + 1), m, replace=False)
            if m and run_id not in ids and rng.random() < 0.6:
                ids[0] = run_id
            counts = rng.integers(3, 25, m)
            order = np.lexsort((ids, -counts))
            ci[b, t, :m] = ids[order]
            cc[b, t, :m] = counts[order]
            curr_id[b, t] = ci[b, t, 0] if m else rng.integers(0, n_ids + 1)
    n = np.minimum(np.asarray(n_tiles, np.int32), T)
    return curr_id, np.zeros_like(curr_id), ci, cc, n


def stage_codes(lengths, width: int, seed: int, n_frac: float = 0.0
                ) -> tuple:
    """uint8 codes [B, width] of random bases with a share `n_frac` of N
    (code 4), zero past each length, and int64 lengths [B]: a batch of the
    minimizer mapper or the k-mer polisher."""
    rng = np.random.default_rng(seed)
    codes = np.zeros((len(lengths), width), np.uint8)
    for i, n in enumerate(lengths):
        c = rng.integers(0, 4, n).astype(np.uint8)
        c[rng.random(n) < n_frac] = 4
        codes[i, :n] = c
    return codes, np.asarray(lengths, np.int64)


def minimizer_lengths(k: int, w: int, width: int, rows: int) -> list:
    """`rows` sequence lengths up to `width` for K20, the first of them the
    edges its windows branch on: shorter than k, shorter than k + w - 1,
    exactly k + w - 1 (one window), one tile of 2,048 windows and one more,
    and the full width."""
    edges = [k - 1, k + w - 2, k + w - 1, 2048 + k + w - 2, 2049 + k + w - 2,
             width]
    rng = np.random.default_rng(k * 1000 + w)
    rest = rng.integers(width // 2, width + 1, max(rows - len(edges), 0))
    return [min(n, width) for n in edges][:rows] + rest.tolist()


def candidate_windows(contig: np.ndarray, n: int, k: int, seed: int
                      ) -> tuple:
    """The polisher's candidate batch (stages/polish.py): `n` windows of
    at most 2k + 2 bases cut from `contig` around random sites, each with
    one edit, zero-padded to 2k + 2; and int64 lengths."""
    rng = np.random.default_rng(seed)
    W = 2 * k + 2
    codes = np.zeros((n, W), np.uint8)
    lengths = rng.integers(k + 1, W + 1, n)
    starts = rng.integers(0, len(contig) - W, n)
    for i in range(n):
        win = contig[starts[i]: starts[i] + lengths[i]].copy()
        win[rng.integers(0, lengths[i])] = rng.integers(0, 4)
        codes[i, :lengths[i]] = win
    return codes, lengths.astype(np.int64)
