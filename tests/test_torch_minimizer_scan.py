"""K20's kernel design (csrc/minimizers.cu) as a numpy model of its
arithmetic, held bit for bit to the JAX `minimizer_keys`: CTAs of
`minimizer_tile(k, w)` threads over tiles of its windows of a row, each
tile's codes from a 16-byte-aligned start (the codes' address modulo 16
moves it) in runs of 16 per thread, zero outside the row; the shared
prefix-XOR scan (nthash_scan.cuh) with runs of 16: each entry's XOR within
its run rotated by a byte permutation of 2 (t mod 4) bytes, the runs'
carries from the warp scan by __shfl_up_sync steps and the warps' totals,
both in tables transposed by runs; each thread's 16 hashes from two reads
of the run XORs and the carries of the runs they fall in; the van
Herk/Gil-Werman window minimum over blocks of w from the tile's first
position: the block starts and ends and the valid positions as masks, each
run's (segment seen, min) pair towards each end taken as it hashes, the
warp's segmented scans by shuffle steps, the carries between warps, the
prefix and suffix through their transposed 8-byte tables; the hashes a
tile owns and its windows' keys.  The kernel itself runs only on a card
(tests/test_torch_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

import tests.conftest  # noqa: F401
from goldrush_tpu.ops import minimizers as jmin
from tests.test_torch_kmer_scan import perm64, rol, ror

from goldrush_tpu_torch.hard_cases import minimizer_tile
from goldrush_tpu_torch.ops.minimizers import MAX_K_PLUS_W
from goldrush_tpu_torch.ops.nthash import NT_TAB

RUN = 16
U64 = np.uint64
NO_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)
POS_MASK = np.uint64((1 << 20) - 1)


def min_tile(T, k, w):
    """csrc/minimizers.cu's min_tile at T threads."""
    tw = (RUN * T - k - w - 13) // 16 * 16
    return tw if tw >= 16 else 0


def idx(e):
    """Where entry e of a tile's tables lives: padded by runs, e + e // 16
    (the pad after each run holds its carry)."""
    return e + e // RUN


def warp_shift(x, d, up):
    """__shfl_up_sync / __shfl_down_sync by d over [warps, 32, ...]: the
    lanes without a source keep their own value (the kernel masks them)."""
    out = x.copy()
    if up:
        out[:, d:] = x[:, :-d]
    else:
        out[:, :-d] = x[:, d:]
    return out


def scan16(codes):
    """The scan of a tile's 16 * T codes as the kernel stores it: each
    entry's XOR within its run, rotated into place, at idx(e) (entry 16 T,
    S and R of the whole tile, holds zero), and each run's carry, the XOR
    of the runs before it (carry[T]: the whole tile's)."""
    T = codes.size // RUN
    c = (codes.astype(np.int64) & 3).reshape(T, RUN)
    q = np.arange(RUN)[None, :]
    terms = np.stack([ror(NT_TAB[c], q), rol(NT_TAB[c ^ 3], q)], -1)
    inc = np.bitwise_xor.accumulate(terms, axis=1)        # [T, 16, 2]
    exc = np.concatenate([np.zeros((T, 1, 2), U64), inc[:, :-1]], 1)
    m8 = ((np.arange(T) * 2) & 7) * 0x1111
    sel = [((0x3210 + m8) & 0x7777, (0x7654 + m8) & 0x7777),    # ror 16m
           ((0xBA98 - m8) & 0x7777, (0xFEDC - m8) & 0x7777)]    # rol 16m
    tot = np.zeros((T, 2), U64)
    for strand, (lo, hi) in enumerate(sel):
        tot[:, strand] = perm64(inc[:, -1, strand], lo, hi)
        for r in range(RUN):
            exc[:, r, strand] = perm64(exc[:, r, strand], lo, hi)
    w = tot.reshape(T // 32, 32, 2).copy()
    lane = np.arange(32)[None, :, None]
    for d in (1, 2, 4, 8, 16):
        w = np.where(lane >= d, w ^ warp_shift(w, d, True), w)
    carry_w = np.zeros_like(w[:, -1])
    carry_w[1:] = np.bitwise_xor.accumulate(w[:, -1], axis=0)[:-1]
    carry = np.zeros((T + 1, 2), U64)
    carry[:T] = ((w ^ tot.reshape(T // 32, 32, 2)) ^ carry_w[:, None]
                 ).reshape(T, 2)
    carry[T] = carry[T - 1] ^ tot[-1]
    loc = np.full(((RUN + 1) * (T + 1), 2), U64(0xA5A5A5A5A5A5A5A5))
    e = np.arange(RUN * T).reshape(T, RUN)
    loc[idx(e)] = exc
    loc[idx(RUN * T)] = 0
    loc[(RUN + 1) * np.arange(T + 1) + RUN] = carry   # the pads
    return loc, carry


def seg_scan(v, seg, up):
    """warp_seg_min over [warps, 32]: inclusive segmented min towards
    higher lanes (up) or lower ones."""
    lane = np.arange(32)[None, :]
    for d in (1, 2, 4, 8, 16):
        ov, os_ = warp_shift(v, d, up), warp_shift(seg, d, up)
        inside = lane >= d if up else lane + d < 32
        v = np.where(inside & ~seg, np.minimum(v, ov), v)
        seg = np.where(inside, seg | os_, seg)
    return v, seg


def tile_model(codes, b, t0, k, w, T, TW, P, addr):
    """One CTA: (its hashes from t0, its windows' keys from t0)."""
    B, L = codes.shape
    nw = P - w + 1
    n_win = min(TW, nw - t0)
    n_pos = n_win + w - 1
    n_own = n_pos if t0 + TW >= nw else n_win
    off = (addr + b * L + t0) % 16
    r0 = t0 - off
    cap = RUN * T
    place = r0 + np.arange(cap)
    inside = (place >= 0) & (place < L)
    tile = np.where(inside, codes[b, np.clip(place, 0, max(L - 1, 0))]
                    if L else 0, 0)
    loc, carry = scan16(tile)
    e0 = RUN * np.arange(T)
    j0 = e0 - off
    # the masks of valid positions, block starts and block ends
    lo = np.maximum(0, -j0)
    hi = np.minimum(RUN, n_pos - j0)
    valid = np.where(hi > lo, ((1 << np.maximum(hi, 0)) - 1)
                     & ~((1 << lo) - 1), 0)
    period = sum(1 << i for i in range(0, 32, w))
    r = j0 % w
    s = np.where(r > 0, w - r, 0)                   # each run's first start
    pat = np.array([period << int(x) if x <= RUN else 0 for x in s])
    starts = pat & ((1 << RUN) - 1)
    ends = (starts >> 1) | ((pat >> RUN & 1) << (RUN - 1))
    # the hashes, and each run's pairs as they come
    dt, kq = divmod(k, RUN)
    c0 = carry[np.arange(T)]
    x1 = c0 ^ carry[np.minimum(np.arange(T) + dt, T)]
    x2 = c0 ^ carry[np.minimum(np.arange(T) + dt + 1, T)]
    h = np.zeros((T, RUN), U64)
    key = np.full((T, RUN), NO_KEY)
    pv = np.full(T, NO_KEY)
    sv = np.full(T, NO_KEY)
    ended = np.zeros(T, bool)
    for q in range(RUN):
        ok = (valid >> q & 1).astype(bool)
        qk = q + kq
        x = loc[idx(e0 + q)]
        # entry q + kq of run t + dt, or q + kq - 16 of the next, from a
        # base clamped to the tile's total (positions past the tile)
        t = np.arange(T)
        y1 = np.minimum((RUN + 1) * (t + dt) + kq, idx(RUN * T))
        y2 = np.minimum((RUN + 1) * (t + dt + 1) + kq - RUN, idx(RUN * T))
        y = loc[(y1 if qk < RUN else y2) + q]
        cs = x1 if qk < RUN else x2
        d = x ^ y ^ cs
        fwd = rol(d[:, 0], (e0 + q + k - 1) & 63)
        rev = ror(d[:, 1], (e0 + q) & 63)
        h[:, q] = np.where(ok, np.minimum(fwd, rev), U64(0))
        key[:, q] = np.where(ok, (h[:, q] & ~POS_MASK)
                             | (t0 + j0 + q).astype(U64), NO_KEY)
        pv = np.where(starts >> q & 1, key[:, q], np.minimum(pv, key[:, q]))
        sv = np.where(ended, sv, np.minimum(sv, key[:, q]))
        ended |= (ends >> q & 1).astype(bool)
    nw_ = T // 32
    pv, ps = seg_scan(pv.reshape(nw_, 32), (starts != 0).reshape(nw_, 32),
                      True)
    sv, ss = seg_scan(sv.reshape(nw_, 32), (ends != 0).reshape(nw_, 32),
                      False)
    pc, pcs = warp_shift(pv, 1, True), warp_shift(ps, 1, True)
    sc, scs = warp_shift(sv, 1, False), warp_shift(ss, 1, False)
    pc[:, 0], pcs[:, 0] = NO_KEY, False
    sc[:, -1], scs[:, -1] = NO_KEY, False
    for wi in range(nw_):
        for lane in range(32):
            if not pcs[wi, lane]:
                for u in range(wi - 1, -1, -1):
                    pc[wi, lane] = min(pc[wi, lane], pv[u, 31])
                    if ps[u, 31]:
                        break
            if not scs[wi, lane]:
                for u in range(wi + 1, nw_):
                    sc[wi, lane] = min(sc[wi, lane], sv[u, 0])
                    if ss[u, 0]:
                        break
    pc, sc = pc.reshape(T), sc.reshape(T)
    e = e0[:, None] + np.arange(RUN)[None, :]
    hashes = np.zeros((RUN + 1) * (T + 1), U64)
    hashes[idx(e)] = h
    pre = np.zeros((RUN + 1) * (T + 1), U64)
    suf = np.zeros((RUN + 1) * (T + 1), U64)
    for q in range(RUN):
        qs = RUN - 1 - q
        pc = np.where(starts >> q & 1, key[:, q], np.minimum(pc, key[:, q]))
        sc = np.where(ends >> qs & 1, key[:, qs], np.minimum(sc, key[:, qs]))
        pre[idx(e[:, q])] = pc
        suf[idx(e[:, qs])] = sc
    own = hashes[idx(np.arange(n_own) + off)]
    i = np.arange(n_win) + off
    keys = np.minimum(suf[idx(i)], pre[idx(i + w - 1)])
    return own, keys


def model(codes, k, w, P, addr):
    """minimizer_keys as the kernel computes it for codes at address `addr`
    (mod 16): (keys [B, P - w + 1], hashes [B, P])."""
    B, _ = codes.shape
    T, TW = minimizer_tile(k, w)
    nw = P - w + 1
    keys = np.zeros((B, nw), U64)
    hashes = np.zeros((B, P), U64)
    for b in range(B):
        for t0 in range(0, nw, TW):
            own, kk = tile_model(codes, b, t0, k, w, T, TW, P, addr)
            hashes[b, t0: t0 + len(own)] = own
            keys[b, t0: t0 + len(kk)] = kk
    return keys, hashes


def batch(rng, lengths, width):
    """Random codes with a share of N (code 4) bases, zero past each row's
    length."""
    codes = np.zeros((len(lengths), width), np.uint8)
    for i, n in enumerate(lengths):
        c = rng.integers(0, 4, n).astype(np.uint8)
        c[rng.random(n) < 0.02] = 4
        codes[i, :n] = c
    return codes


@pytest.mark.parametrize("w", [1, 2, 3, 10, 250, 1000])
@pytest.mark.parametrize("k", [15, 24, 32, 40])
def test_tile_model_matches_jax(k, w):
    """Two batches: one of rows narrower than k + w - 1 (P = w, a single
    window that reads past the codes) and rows of exactly one window; one
    whose 2 * TW + 1 windows fill two tiles to their last window and leave
    one window to a third, with rows that end inside each tile."""
    rng = np.random.default_rng(k * 1000 + w)
    T, TW = minimizer_tile(k, w)
    assert TW > 0 and k + w <= MAX_K_PLUS_W
    n_edge = 2 * TW + 1
    wide = n_edge + w - 1 + k - 1                  # P = L - k + 1
    cases = [
        ([k - 1, k + w - 2, 0, (k + w) // 2], k + w - 2, w),
        ([k + w - 1, k + w - 1, k], k + w - 1, w),
        ([wide, wide - 1, TW + k + w - 2, TW + 7, k + w - 1, 3], wide,
         wide - k + 1),
    ]
    for lengths, L, P in cases:
        codes = batch(rng, lengths, L)
        jk, jh = jmin.minimizer_keys(jnp.asarray(codes), k, w, P)
        jk, jh = np.asarray(jk), np.asarray(jh)
        for addr in (0, 5):
            mk, mh = model(codes, k, w, P, addr)
            np.testing.assert_array_equal(mh, jh)
            np.testing.assert_array_equal(mk, jk)


@pytest.mark.parametrize("k,w", [(15, 10), (40, 250), (32, 1000),
                                 (1, 4066), (40, 4027)])
def test_tile_geometry(k, w):
    """A tile's positions fit its CTA's codes from any 16-byte offset, its
    windows are a multiple of 16, and its overlap is a small share where
    the stages run (w = 10 for tigmint, 250 and 1,000 for the mapper)."""
    T, TW = minimizer_tile(k, w)
    assert TW == min_tile(T, k, w) >= 16 and TW % 16 == 0
    assert 15 + TW + w - 1 - 1 + k <= RUN * T
    assert min_tile(256, k, MAX_K_PLUS_W - k) >= 16
    assert min_tile(256, k, MAX_K_PLUS_W - k + 1) == 0
    if w <= 1000:
        assert (w - 1) / (TW + w - 1) < 0.26


def test_masked_terms():
    """The kernel's four-way choice of a code's rotated constant by masks,
    v0 ^ (m1 & (v0 ^ v1)) ^ (m2 & (v0 ^ v2)) ^ (m3 & (v0 ^ v1 ^ v2 ^ v3)),
    picks v_c for every code, high bits above the two low ones ignored."""
    v = [int(x) for x in NT_TAB]
    for c in range(256):
        m1 = -(c & 1) & (2**64 - 1)
        m2 = -(c >> 1 & 1) & (2**64 - 1)
        m3 = m1 & m2
        got = v[0] ^ (m1 & (v[0] ^ v[1])) ^ (m2 & (v[0] ^ v[2])) ^ (
            m3 & (v[0] ^ v[1] ^ v[2] ^ v[3]))
        assert got == v[c & 3]


def test_padded_tables_spread_a_warp():
    """The tables padded by runs: every entry of a tile, entry 16 T (S and
    R of the whole tile) and the runs' carries have places of their own in
    (17 (T + 1)) entries; the 16-byte accesses of one q of a quarter warp's
    8 runs hit 8 bank groups; the 8-byte stores of one q of a warp's runs
    put at most two lanes on a bank pair (the fewest 256 bytes allow), and
    the 8-byte reads of 32 consecutive entries (a warp's outputs, over a
    pad or two) at most three, two where they start a run."""
    for T in (128, 256):
        cap = RUN * T
        places = np.concatenate([idx(np.arange(cap + 1)),
                                 (RUN + 1) * np.arange(T + 1) + RUN])
        assert len(set(places.tolist())) == cap + T + 2
        assert places.max() < (RUN + 1) * (T + 1)
        for q in range(RUN):
            for t0 in range(0, 32, 8):
                groups = idx(RUN * np.arange(t0, t0 + 8) + q) % 8
                assert len(set(groups.tolist())) == 8
            banks = (2 * idx(RUN * np.arange(32) + q)) % 32
            assert np.bincount(banks, minlength=32).max() <= 2
        for c in range(0, 200, 7):
            banks = (2 * idx(c + np.arange(32))) % 32
            assert np.bincount(banks, minlength=32).max() <= (
                2 if c % RUN == 0 else 3)
