"""K21's kernel design (csrc/kmer_count.cu) as a numpy model of its
arithmetic, held bit for bit to the JAX `_count_kmers` / `_query_kmers`
and to the port's plain versions: CTAs over the compact output index o =
b * P + p (`kmer_tile`'s width, or a narrower one that puts more tile
edges in the batch), each tile's first row from a double reciprocal of P,
its codes from a 16-byte-aligned start t0 (the codes' address modulo 16
moves it) in runs of 8 codes per thread,
the warp scan by __shfl_up_sync steps and the carry between warps, the
prefix-XOR identity of the hash, the row from the reciprocal of P, and
the count's __match_any_sync groups with a leader's (slot, count) held
across its outputs.  The kernel itself runs only on a card
(tests/test_torch_kernels.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from goldrush_tpu.stages import polish as jpol

from goldrush_tpu_torch.ops.nthash import NT_TAB
from goldrush_tpu_torch.stages import polish as tpol

THREADS, PER, RUN = 128, 8, 8
TILE, CAP = THREADS * PER, THREADS * RUN
M64 = (1 << 64) - 1
U64 = np.uint64


def rol(x, r):
    """Rotate uint64 values left by r (scalar or array), mod 64."""
    x = np.asarray(x, U64)
    r = np.asarray(r, np.int64) % 64
    with np.errstate(over="ignore"):
        left = x << r.astype(U64)
        right = x >> (64 - r).astype(U64)
    return np.where(r == 0, x, left | right).astype(U64)


def ror(x, r):
    return rol(x, -np.asarray(r, np.int64))


def swz(i):
    """The kernel's swizzled place of entry i of a 16-byte table."""
    return i ^ ((i >> 3) & 7)


def kmer_tile(P, k):
    lo, hi = 0, TILE
    while lo < hi:
        W = (lo + hi + 1) // 2
        if W + 15 + ((W + P - 2) // P + 1) * (k - 1) <= CAP:
            lo = W
        else:
            hi = W - 1
    return lo


def mulhi_u32(x, m):
    """floor(x * m / 2^64) for m < 2^32, as the kernel computes it."""
    return ((x >> 32) * m + (((x & 0xFFFFFFFF) * m) >> 32)) >> 32


def perm64(x, lo, hi):
    """__byte_perm of each uint64's halves by the selectors lo and hi (one
    per value): byte i of the result is byte sel_i of x."""
    b = np.ascontiguousarray(x, U64).view(np.uint8).reshape(-1, 8)
    sel = np.stack([(lo >> (4 * i)) & 7 for i in range(4)]
                   + [(hi >> (4 * i)) & 7 for i in range(4)], 1)
    return np.take_along_axis(b, sel, 1).copy().view(U64)[:, 0]


def scan_tile(codes):
    """The CTA's S and R tables (CAP + 1 entries at their swizzled places)
    from the CAP codes its threads load: each run's constants rotated by q
    < 8 and XORed, then rotated by 8m (m = thread mod 8) as a byte
    permutation, the warp scan by __shfl_up_sync steps, the warp totals'
    carry."""
    c = (codes.astype(np.int64) & 3).reshape(THREADS, RUN)
    q = np.arange(RUN)[None, :]
    inc = np.bitwise_xor.accumulate(
        np.stack([ror(NT_TAB[c], q), rol(NT_TAB[c ^ 3], q)], -1), axis=1)
    m8 = (np.arange(THREADS) & 7) * 0x1111
    sel = [((0x3210 + m8) & 0x7777, (0x7654 + m8) & 0x7777),    # ror 8m
           ((0xBA98 - m8) & 0x7777, (0xFEDC - m8) & 0x7777)]    # rol 8m
    for strand, (lo, hi) in enumerate(sel):
        for r in range(RUN):
            inc[:, r, strand] = perm64(inc[:, r, strand], lo, hi)
    tot = inc[:, -1].reshape(THREADS // 32, 32, 2)
    w = tot.copy()
    lane = np.arange(32)[None, :, None]
    for d in (1, 2, 4, 8, 16):                              # __shfl_up_sync
        up = np.zeros_like(w)
        up[:, d:] = w[:, :-d]
        w = np.where(lane >= d, w ^ up, w)
    warp_tot = w[:, -1]
    carry_w = np.zeros_like(warp_tot)
    carry_w[1:] = np.bitwise_xor.accumulate(warp_tot, axis=0)[:-1]
    carry = ((w ^ tot) ^ carry_w[:, None]).reshape(THREADS, 2)
    exc = np.concatenate([np.zeros((THREADS, 1, 2), U64), inc[:, :-1]], 1)
    sr = np.zeros((CAP + 1, 2), U64)
    sr[swz(np.arange(CAP))] = (exc ^ carry[:, None]).reshape(CAP, 2)
    sr[swz(CAP)] = carry[-1] ^ inc[-1, -1]
    return sr


def model(codes, lengths, k, size, table, addr, W=None):
    """(the query's outputs [B, P], the count's table after adding the
    batch to `table`), computed as the kernel does for codes at address
    `addr` (mod 16)."""
    B, L = codes.shape
    P = L - k + 1
    flat = codes.reshape(-1)
    total, W = B * P, W or kmer_tile(P, k)
    assert 0 < W <= TILE
    recip = M64 // P + 1 if 2 <= P < 1 << 31 else 0
    out = np.zeros(total, np.uint32)
    counts = table.copy()
    for o0 in range(0, total, W):
        n_out = min(W, total - o0)
        b0 = int(float(o0) * (1.0 / P))        # a double, one correction
        p0 = o0 - b0 * P
        b0, p0 = (b0 - 1, p0 + P) if p0 < 0 else (
            (b0 + 1, p0 - P) if p0 >= P else (b0, p0))
        assert (b0, p0) == divmod(o0, P)
        last = p0 + n_out - 1
        first = b0 * L + p0
        end = (b0 + last // P) * L + last % P + k
        t0 = first - (addr + first) % 16
        assert end - t0 <= CAP
        # the threads' runs of codes, zero outside the batch
        g = t0 + np.arange(CAP)
        inside = (g >= 0) & (g < B * L)
        sr = scan_tile(np.where(inside, flat[np.clip(g, 0, B * L - 1)], 0))
        base = first - t0
        slots = np.full((THREADS, PER), M64, dtype=object)
        valid = np.zeros((THREADS, PER), bool)
        for q in range(PER):
            for tid in range(THREADS):
                i = tid + q * THREADS
                if i >= n_out:
                    continue
                u = p0 + i
                row = mulhi_u32(recip, u) if recip else u // P
                j = base + i + row * (k - 1)
                x, y = sr[swz(j)], sr[swz(j + k)]
                fwd = int(rol(x[0] ^ y[0], (j + k - 1) & 63))
                rev = int(ror(x[1] ^ y[1], j & 63))
                slot = mulhi_u32(min(fwd, rev), size)
                out[o0 + i] = table[slot]
                slots[tid, q] = slot
                valid[tid, q] = u - row * P < lengths[b0 + row] - k + 1
        count_tile(counts, slots, valid)
    return out.reshape(B, P), counts


def count_tile(counts, slots, valid):
    """The count's atomics of one CTA: per warp and step, one add of the
    group's size by its first lane (groups of one unless two neighbouring
    lanes share a slot), held while the leader's slot repeats."""
    with np.errstate(over="ignore"):
        for w in range(THREADS // 32):
            held = [None] * 32
            for q in range(PER):
                ok = valid[32 * w: 32 * w + 32, q]
                keys = [slots[32 * w + ln, q] if ok[ln] else -1
                        for ln in range(32)]
                repeat = any(ok[ln] and keys[ln] == keys[ln - 1]
                             for ln in range(1, 32))
                for ln in range(32):
                    if not ok[ln] or (repeat and keys.index(keys[ln]) != ln):
                        continue
                    n = keys.count(keys[ln]) if repeat else 1
                    if held[ln] and held[ln][0] == keys[ln]:
                        held[ln][1] += n
                    else:
                        if held[ln]:
                            counts[held[ln][0]] += np.uint32(held[ln][1])
                        held[ln] = [keys[ln], n]
            for h in held:
                if h:
                    counts[h[0]] += np.uint32(h[1])


def jax_padded(codes, lengths):
    B, L = codes.shape
    Bp, Lp = jpol._pow2(B, 8), jpol._pow2(L)
    cp = np.zeros((Bp, Lp), np.uint8)
    cp[:B, :L] = codes
    lp = np.zeros(Bp, np.int64)
    lp[:B] = lengths
    return jnp.asarray(cp), jnp.asarray(lp), Lp


def windows(rng, B, k):
    """The polisher's candidate windows: width 2k + 2, lengths k + 1 to
    2k + 2, zero past each length."""
    W = 2 * k + 2
    codes = rng.integers(0, 4, (B, W)).astype(np.uint8)
    lengths = rng.integers(k + 1, W + 1, B).astype(np.int64)
    for b, n in enumerate(lengths):
        codes[b, n:] = 0
    return codes, lengths


# (name, k, B, L or None for windows, the codes' high bits, narrow tiles)
CASES = {
    "windows_k13": (13, 70, None, False, 37),
    "windows_k16": (16, 66, None, False, 64),
    "windows_k24": (24, 50, None, False, 100),
    "windows_k32": (32, 60, None, False, 41),
    "windows_k40": (40, 48, None, True, 129),
    "long_rows_k32": (32, 3, 2_100, False, 333),   # P = 2,069
    "p1_k24": (24, 120, 24, False, 7),             # one k-mer a row
    "high_codes_k16": (16, 9, 700, True, 96),
    "homopolymer_k13": (13, 40, 301, False, 31),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scan_model_matches_jax(case):
    k, B, L, high, narrow = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    if L is None:
        codes, lengths = windows(rng, B, k)
    else:
        codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
        lengths = rng.integers(0, L + 1, B).astype(np.int64)
        lengths[0] = L
    if case.startswith("homopolymer"):
        codes[:] = 2
        lengths[:] = L
    if high:                                  # only the low two bits count
        codes = (codes | (rng.integers(0, 64, codes.shape) << 2)).astype(
            np.uint8)
    size = 1_000_003 if codes.size > 5_000 else 65_537
    start = rng.integers(0, 1 << 32, size + 1, dtype=np.uint64).astype(
        np.uint32)
    start[rng.random(size + 1) < 0.5] = 0
    start[::997] = 0xFFFFFFFF                 # uint32 adds wrap
    P = codes.shape[1] - k + 1
    cp, lp, Lp = jax_padded(codes, lengths)
    jcounts = np.asarray(jpol._count_kmers(jnp.asarray(start), cp, lp, k,
                                           Lp - k + 1, size))
    jquery = np.asarray(jpol._query_kmers(jnp.asarray(start), cp, lp, k,
                                          Lp - k + 1, size)[0])[:, :P]
    tcounts = torch.from_numpy(start.view(np.int32).copy())
    tc, tl = torch.from_numpy(codes), torch.from_numpy(lengths)
    tquery = tpol._query_kmers_plain(tcounts, tc, k, size).numpy().view(
        np.uint32)
    tpol._count_kmers_plain(tcounts, tc, tl, k, size)
    tcounts = tcounts.numpy().view(np.uint32)
    # the kernel's width, then a narrower one; codes at several addresses
    for W, addr in ((None, 0), (narrow, k % 16), (narrow, 15)):
        out, counts = model(codes, lengths, k, size, start, addr, W)
        np.testing.assert_array_equal(out, jquery[: len(codes)])
        np.testing.assert_array_equal(out, tquery)
        np.testing.assert_array_equal(counts[:size], jcounts[:size])
        np.testing.assert_array_equal(counts, tcounts)
        assert counts[size] == start[size]      # the sentinel is untouched


@pytest.mark.parametrize("k", [13, 16, 24, 32, 40, 63, 64, 65])
def test_prefix_xor_identity(k):
    """The identity alone, at every origin t0 of a 300-code row and every
    position, against the port's hash of the unspaced family."""
    from goldrush_tpu_torch.ops.nthash import hash_positions, unspaced_family
    rng = np.random.default_rng(k)
    row = rng.integers(0, 4, 300).astype(np.uint8)
    P = 300 - k + 1
    want = hash_positions(torch.from_numpy(row[None]), unspaced_family(k),
                          P)[0, 0].numpy().view(np.uint64)
    for t0 in (0, 7, 63, 64, 200):
        i = np.arange(300 - t0)
        zero = np.zeros(1, U64)
        s = np.concatenate([zero, np.bitwise_xor.accumulate(
            ror(NT_TAB[row[t0:]], i))])
        r = np.concatenate([zero, np.bitwise_xor.accumulate(
            rol(NT_TAB[row[t0:] ^ 3], i))])
        p = np.arange(t0, P)
        fwd = rol(s[p - t0 + k] ^ s[p - t0], p + k - 1 - t0)
        rev = ror(r[p - t0 + k] ^ r[p - t0], p - t0)
        np.testing.assert_array_equal(np.minimum(fwd, rev), want[t0:])


@pytest.mark.parametrize("P", [1, 2, 3, 35, 64, 1_000, 999_969,
                               (1 << 31) - 1])
def test_row_reciprocal(P):
    """The row of a position from the reciprocal of P is exact for every
    position a tile can reach (p0 + i < P + 1,024 < 2^32)."""
    recip = M64 // P + 1 if P >= 2 else 0
    rng = np.random.default_rng(P)
    us = np.concatenate([np.arange(0, min(P + TILE, 5_000)),
                         rng.integers(0, P + TILE, 5_000),
                         [P - 1, P, P + TILE - 1]])
    for u in us.tolist():
        assert (mulhi_u32(recip, u) if recip else u) == u // P
