"""A Python model of kernel D's batch entry (train_step's insert,
csrc/insert_sorted.cu insert_batch, code in csrc/insert.cuh), held to the
per-recruit plain insert in batch order (``mibf._insert_plain``, which
``mibf.insert_read`` runs on the CPU): each read's tiles and ids worked
out from C's verdicts (``batch_read``), the window's entries over the
whole batch with their read and tile by multiply-highs (``BatchWindow``,
``Div32``), the order field key << (tile_bits + read_bits) | read <<
tile_bits | tile and its chunks of reads (``mibf.batch_layout``), the
owners (``part_of`` over ``mibf.batch_parts`` buckets, several a CTA),
each owner's entries grouped by key with only the repeated keys sorted
(``owner_group_batch``), or past its bucket or its list of repeated keys
the whole bucket sorted (``owner_sort``, ``owner_apply_batch``), and the
reservoir rule over each key's entries (``apply_key``).
``model_batch`` is also held to JAX's per-recruit insert in
tests/test_torch_train.py."""

import numpy as np
import pytest
import torch

from goldrush_tpu_torch.mibf import mibf as tdm

MASK32 = 0xFFFFFFFF


def div32(n, d):
    """Div32 (csrc/insert.cuh): n // d from the multiply-high of n by
    floor((2^32 - 1) / d) and one correction."""
    q = (n * (MASK32 // d)) >> 32
    return q + int(n - q * d >= d)


def batch_read(dec, ts, te, length, tile_length, max_blocks, bs, T):
    """(lo, last) of a read: whole tiles 0..n_t-1, trimmed ts..te, a drop
    nothing; its first max_blocks blocks below T."""
    lo, hi = 1, 0
    if dec == 1:
        lo, hi = 0, length // tile_length - 1
    elif dec == 2:
        lo, hi = ts, te
    return lo, min(hi, lo + max_blocks * bs - 1, T - 1)


def part_of(key, parts):
    """insert.cuh part_of: a multiplicative hash of the key's low 32 bits
    scaled to [0, parts)."""
    return (((key * 0x9E3779B1) & MASK32) * parts) >> 32


def apply_key(words, counts, key, ords, reads, base, trimmed, tile_bits, bs,
              or_bits, keep):
    """apply_key: the reservoir rule over one key's order fields, in
    ascending order."""
    cnt, word, won, prev = counts(key), None, False, None
    for o in ords:
        i, t = o >> tile_bits, o & ((1 << tile_bits) - 1)
        m = (t - reads[i][0]) // bs
        if (i, m) == prev:
            continue
        prev = (i, m)
        bid = (base[i] + ((m * bs + 1) // bs if trimmed[i] else m)) & MASK32
        cnt = (cnt + 1) & MASK32
        if ((key & MASK32) ^ bid) % max(cnt, 1) == (cnt - 1) & MASK32:
            if not won:
                word = words(key) if keep else 0
            word = (word & keep) | or_bits | bid
            won = True
    counts.set(key, cnt)
    if won:
        words.set(key, word)


def model_launch(words, counts, slots, reads, base, trimmed, T, limit,
                 or_bits, keep, bs, tile_bits, read_bits, parts, cap):
    """One launch over the reads of `slots` [n, H, T*F] (numpy int64):
    every CTA's scatter of the window's real entries to their owners'
    buckets of `cap` entries, then each owner's keys: grouped, only the
    keys of several entries sorted, or, past the bucket or the list of
    repeated keys (cap / 2), the whole bucket sorted.  ``words`` and
    ``counts`` read and write the tables by key.  Returns the owners that
    took each path."""
    n, H, TF = slots.shape
    F = TF // T
    shift = tile_bits + read_bits
    assert (T - 1) >> tile_bits == 0 and (n - 1) >> read_bits == 0
    assert (limit - 1).bit_length() + shift <= 63 and shift <= 32
    HTF, W = H * TF, n * H * TF
    buckets = [[] for _ in range(parts)]
    flat = slots.reshape(-1)
    for e in range(W):
        i = div32(e, HTF)
        r = e - i * HTF
        t = div32(r - div32(r, TF) * TF, F)
        lo, last = reads[i]
        if t < lo or t > last:
            continue
        key = int(flat[e])
        if not 0 <= key < limit:
            continue
        entry = key << shift | i << tile_bits | t
        assert entry < (1 << 64) - 1          # below the sort's sentinel
        buckets[part_of(key, parts)].append(entry)
    order_mask = (1 << shift) - 1
    rule = (reads, base, trimmed, tile_bits, bs, or_bits, keep)
    paths = {"grouped": 0, "sorted": 0}
    for p, bucket in enumerate(buckets):
        if len(bucket) <= cap:
            groups = {}
            for entry in bucket:
                groups.setdefault(entry >> shift, []).append(
                    entry & order_mask)
            if sum(len(g) for g in groups.values() if len(g) > 1) \
                    <= cap // 2:
                for key, ords in groups.items():
                    apply_key(words, counts, key, sorted(ords), *rule)
                paths["grouped"] += 1
                continue
        run = sorted(bucket)
        for j, entry in enumerate(run):
            key = entry >> shift
            if j and run[j - 1] >> shift == key:
                continue
            assert part_of(key, parts) == p
            ords = [e2 & order_mask for e2 in run[j:] if e2 >> shift == key]
            apply_key(words, counts, key, ords, *rule)
        paths["sorted"] += 1
    return paths


class Table:
    """A uint32 array read and written by key, as the kernel reaches it."""

    def __init__(self, a):
        self.a = a

    def __call__(self, key):
        return int(self.a[key])

    def set(self, key, v):
        self.a[key] = v


def model_batch(words, counts, slots, dec, ts, te, lengths, base, T,
                tile_length, max_blocks, bs, limit, or_bits, keep,
                window=tdm.BATCH_WINDOW, ctas=tdm.INSERT_PARTS,
                cap=tdm.INSERT_CAP, paths=None):
    """The batch entry as the wrapper launches it: consecutive chunks of
    reads (``batch_layout``), each a launch of ``batch_parts`` owners, on
    numpy uint32 ``words``/``counts`` in place; each owner's path counted
    into ``paths``.  Returns the launches."""
    B, H, TF = slots.shape
    F = TF // T
    tile_bits, read_bits, per = tdm.batch_layout(B, H, T, F, limit, window)
    launches = 0
    for r0 in range(0, B, per):
        r1 = min(B, r0 + per)
        reads = [batch_read(int(dec[i]), int(ts[i]), int(te[i]),
                            int(lengths[i]), tile_length, max_blocks, bs, T)
                 for i in range(r0, r1)]
        took = model_launch(Table(words), Table(counts), slots[r0:r1], reads,
                            [int(b) & MASK32 for b in base[r0:r1]],
                            [int(d) == 2 for d in dec[r0:r1]], T, limit,
                            or_bits, keep, bs, tile_bits, read_bits,
                            tdm.batch_parts((r1 - r0) * H * TF, ctas, cap),
                            cap)
        for k, v in took.items():
            if paths is not None:
                paths[k] = paths.get(k, 0) + v
        launches += 1
    return launches


def per_recruit_plain(words, counts, slots, dec, ts, te, lengths, base, T,
                      params, max_blocks, limit, or_bits, keep):
    """``_insert_plain`` a recruit at a time, in batch order (the CPU's
    ``insert_read`` loop), on torch int32 tables in place."""
    bs = params.block_size
    for i in range(slots.shape[0]):
        d = int(dec[i])
        if d == 0:
            continue
        lo, hi = ((0, int(lengths[i]) // params.tile_length - 1) if d == 1
                  else (int(ts[i]), int(te[i])))
        tdm._insert_plain(words, counts, torch.from_numpy(slots[i]), lo,
                          min(hi, lo + max_blocks * bs - 1),
                          int(base[i]) & MASK32, d == 2, params, T, limit,
                          or_bits, keep)


def shared_batch(rng, B, T, F, limit):
    """B reads of [3, T*F] slot grids over few keys (collisions within and
    across reads), read 1 repeating read 0 and read 3 read 2, sentinel
    tails; verdicts with drops between recruits, read 3 a trimmed copy of
    read 2; lengths of tile length F."""
    slots = rng.integers(0, limit + limit // 4, (B, 3, T * F))
    slots = np.where(slots >= limit, limit, slots).astype(np.int64)
    slots[:, :, -3:] = limit
    slots[1] = slots[0]
    slots[3] = slots[2]
    dec = rng.integers(0, 3, B).astype(np.int32)
    dec[:4] = (1, 1, 1, 2)
    dec[4::5] = 0
    ts = rng.integers(0, T, B).astype(np.int32)
    te = (ts + rng.integers(-1, T, B)).astype(np.int32)
    ts[3], te[3] = 1, T - 2
    lengths = rng.integers(F * (T - 2), F * (T + 2), B).astype(np.int32)
    return slots, dec, ts, te, lengths


@pytest.mark.parametrize("limit,T,room", [
    (10_007, 8, 32 - 3), (142_368_384, 20, 32 - 5),
    ((1 << 32) + 5, 24, 63 - 33 - 5), ((1 << 47) + 1, 1 << 15, 0)])
def test_batch_layout(limit, T, room):
    """The order field beside the keys: tile bits for tiles 0..T-1, read
    bits for the chunk's reads, both at most 32, keys' bits + both at most
    63; chunks of at
    most 2^room reads, BATCH_READS, the window (at least one read) and
    fewer than 2^31 entries; too little room raises."""
    H, F = 3, 50
    tile_bits, read_bits, per = tdm.batch_layout(4_000, H, T, F, limit)
    assert (T - 1) >> tile_bits == 0 and tile_bits == (T - 1).bit_length()
    assert (limit - 1).bit_length() + tile_bits + read_bits <= 63
    assert tile_bits + read_bits <= 32
    assert (per - 1) >> read_bits == 0
    assert per == max(1, min(4_000, tdm.BATCH_READS, 1 << room,
                             tdm.BATCH_WINDOW // (H * T * F)))
    assert tdm.batch_layout(5, H, T, F, limit)[2] == min(5, per)
    assert tdm.batch_layout(5, H, T, F, limit, window=1)[2] == 1
    with pytest.raises(ValueError, match="order field"):
        tdm.batch_layout(4, H, 1 << 16, F, 1 << 48)


def test_batch_parts():
    """A multiple of the CTAs whose buckets expect at most 3/4 of
    INSERT_CAP, at most BATCH_PARTS."""
    cap, ctas = tdm.INSERT_CAP, tdm.INSERT_PARTS
    for entries in (1, 60_000, 3_840_000, tdm.BATCH_WINDOW, 1 << 30):
        p = tdm.batch_parts(entries)
        assert p % ctas == 0 and ctas <= p <= tdm.BATCH_PARTS
        assert entries * 4 <= 3 * cap * p or p + ctas > tdm.BATCH_PARTS
    assert tdm.batch_parts(64 * 60_000) == 5 * ctas     # the bench batch


@pytest.mark.parametrize("bs,max_blocks", [(1, 1), (1, 3), (2, 2), (3, 1),
                                           (3, 50)])
@pytest.mark.parametrize("chunk", [None, 1, 3])
@pytest.mark.parametrize("keep", ["sat_present", "or_present"])
@pytest.mark.parametrize("cap", [tdm.INSERT_CAP, 8])
def test_model_matches_per_recruit(bs, max_blocks, chunk, keep, cap,
                                   monkeypatch):
    """The model, in one launch or chunks of 1 and 3 reads, against the
    plain insert a recruit at a time: words and counters bit for bit, on
    batches whose reads share slots, with both id rules (whole and
    trimmed reads), ids that cross bit 30 (so each accepting block's
    (word & keep) | id matters), and both of the kernel's uses: keep =
    SAT | PRESENT with no or_bits (insert_read), and keep = 0 with
    or_bits = PRESENT; buckets of INSERT_CAP (every owner grouped) and,
    with at most 300 owners, of 8 entries (owners past their bucket or
    their list of repeated keys sort the whole bucket: over the
    parametrisation both paths run)."""
    if cap != tdm.INSERT_CAP:
        monkeypatch.setattr(tdm, "BATCH_PARTS", 300)
    rng = np.random.default_rng([bs, max_blocks, chunk or 0, len(keep)])
    B, T, F, limit = 10, 6, 12, 997
    slots, dec, ts, te, lengths = shared_batch(rng, B, T, F, limit)
    base = (1 << 30) - 4 + 3 * np.arange(B)
    or_bits, keep_bits = ((0, tdm.SAT_BIT | tdm.PRESENT_BIT)
                          if keep == "sat_present" else (tdm.PRESENT_BIT, 0))
    params = tdm.MibfParams(size=limit, h=3, k=22, spans=(22, 23, 24),
                            tile_length=F, block_size=bs)
    w0 = rng.integers(0, 1 << 32, limit + 1, dtype=np.uint32)
    c0 = rng.integers(0, 4, limit + 1).astype(np.uint32)
    c0[:5] = MASK32                              # counters that wrap to 0
    w, c = w0.copy(), c0.copy()
    window = None if chunk is None else chunk * 3 * T * F
    paths = {}
    launches = model_batch(w, c, slots, dec, ts, te, lengths, base, T, F,
                           max_blocks, bs, limit, or_bits, keep_bits,
                           **({} if window is None else {"window": window}),
                           ctas=3, cap=cap, paths=paths)
    assert launches == (1 if chunk is None else -(-B // chunk))
    assert paths["grouped"] > 0
    if cap == tdm.INSERT_CAP:
        assert paths["sorted"] == 0
    tw = torch.from_numpy(w0.view(np.int32).copy())
    tc = torch.from_numpy(c0.view(np.int32).copy())
    per_recruit_plain(tw, tc, slots, dec, ts, te, lengths, base, T, params,
                      max_blocks, limit, or_bits, keep_bits)
    np.testing.assert_array_equal(w, tw.numpy().view(np.uint32))
    np.testing.assert_array_equal(c, tc.numpy().view(np.uint32))
    assert (c != c0).sum() > 50


def test_plain_batch_is_per_recruit():
    """mibf.insert_batch on the CPU (the plain version train_step runs
    there) against the per-recruit loop, base ids as a sequence."""
    rng = np.random.default_rng(5)
    B, T, F, limit = 9, 7, 10, 1_009
    slots, dec, ts, te, lengths = shared_batch(rng, B, T, F, limit)
    params = tdm.MibfParams(size=limit, h=3, k=22, spans=(22, 23, 24),
                            tile_length=F, block_size=2)
    w0 = rng.integers(0, 1 << 32, params.alloc, dtype=np.uint32)
    c0 = rng.integers(0, 4, params.alloc).astype(np.uint32)
    base = list(range(100, 100 + 7 * B, 7))
    st = tdm.state_from_numpy(w0, c0, device="cpu")
    tdm.insert_batch(st, torch.from_numpy(slots), *(
        torch.from_numpy(a) for a in (dec, ts, te, lengths)), base, params,
        2, T)
    tw = torch.from_numpy(w0.view(np.int32).copy())
    tc = torch.from_numpy(c0.view(np.int32).copy())
    per_recruit_plain(tw, tc, slots, dec, ts, te, lengths, base, T, params,
                      2, limit, 0, tdm.SAT_BIT | tdm.PRESENT_BIT)
    assert torch.equal(st.words, tw) and torch.equal(st.counts, tc)
