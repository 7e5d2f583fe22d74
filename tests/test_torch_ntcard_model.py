"""ntCard's counter kernel (K22, csrc/ntcard.cu) as a numpy model on the
CPU: the block tables (``SeedFamily.block_table``), each warp unit's
packed words, every lane's sliding 32-code windows and right-partial ring,
the bank test on the high word, the pending bits cut to each seed's own
frames and the sampled hashes built again from the words, as the kernel
computes them.  Its hash
of every seed at every own frame must equal the per-care-offset XOR of
ops/nthash.py's definition, the port's ``hash_positions`` and the JAX
``hash_positions``; its counters must equal the plain version's
(``_ntcard_count_plain``), which tests/test_torch_ntcard.py holds to the
JAX function.  The card runs the kernel itself in tests/test_torch_kernels.py
and chip_smoke.py phase 8(a)."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from goldrush_tpu.ops.nthash import build_seed_family as jfamily
from goldrush_tpu.ops.nthash import hash_positions as jhash

from goldrush_tpu_torch.ops.nthash import (NT_TAB, NT_TABC, _rol64_np,
                                           build_seed_family, hash_positions,
                                           unspaced_family)
from goldrush_tpu_torch.ops.seeds import make_seed_pattern
from goldrush_tpu_torch.utils import ntcard as tnt

RUN, UNIT, UNIT_WORDS, LANES = 16, 512, 40, 32   # csrc/ntcard.cu
COPIES = {3: 8, 4: 4, 8: 2}     # copies of the tables a CTA, by blocks a half
M32 = np.uint64(0xFFFFFFFF)
PRESET = "1011011110110111101101"
FAMILIES = {
    "chip": lambda: build_seed_family(make_seed_pattern(PRESET, 22, 16, 3)),
    "unspaced15": lambda: unspaced_family(15),
    "unspaced32": lambda: unspaced_family(32),
    # a half of 13 positions: neither half a multiple of 4, the right
    # window 26 bits into a packed word; h = 4 fills the ring of 4
    "half13": lambda: build_seed_family(make_seed_pattern("", 26, 14, 4)),
    # care offsets on both sides of every block edge (3|4, 7|8, 11)
    "edges": lambda: build_seed_family(make_seed_pattern(
        "100110011001" * 2, 24, 12, 3)),
    # h = 5: the ring of 8; a half of 20 (5 blocks: 8 a half, 2 copies)
    "h5_half20": lambda: build_seed_family(make_seed_pattern("", 40, 20, 5)),
}


def fsr(lo, hi, s):
    """__funnelshift_r on uint64 arrays holding 32-bit words."""
    return (((hi << np.uint64(32)) | lo) >> np.uint64(s & 31)) & M32


def rol64(x, r):
    return _rol64_np(x, r)


def rol_hi(x, s):
    return (rol64(x, s) >> np.uint64(32)) & M32


def umin(a, b):
    return np.where(a < b, a, b)


def model_count(codes, offsets, fam, rbits, sbits, counters):
    """The kernel's work on one batch, in numpy: adds into ``counters``
    (int64 [h, 2 * 2^rbits]) and returns {(read, seed): hashes of the
    seed's own frames, in order}."""
    nb = tnt.kernel_blocks(fam, sbits)
    rep = COPIES[nb]
    table = fam.block_table(nb)
    # the CTA's copies: entry e of copy c at e * rep + c, lane l reads
    # copy l % rep (values only: the copies are equal)
    smem = np.repeat(table.reshape(-1, 2), rep, axis=0)
    batch = tnt.pack_batch(codes, offsets, fam.k, "cpu")
    item_read, item_p0 = batch.item_read.numpy(), batch.item_p0.numpy()
    lens = np.diff(offsets)
    units = np.arange(2 * len(item_read))
    r_of = item_read[units >> 1]
    q0 = item_p0[units >> 1] + (units & 1) * UNIT
    n_frames = lens[r_of] - fam.k + 1
    keep = q0 < n_frames
    units, r_of, q0, n_frames = units[keep], r_of[keep], q0[keep], \
        n_frames[keep]
    # each unit's packed words: codes q0 + 16 w + t at bits 2t of word w
    q = q0[:, None] + np.arange(UNIT_WORDS * RUN)[None, :]
    L = lens[r_of][:, None]
    c = np.where(q < L, codes[offsets[r_of][:, None]
                              + np.minimum(q, L - 1)] & 3, 0)
    c = c.reshape(len(units), UNIT_WORDS, RUN).astype(np.uint64)
    words = (c << (2 * np.arange(RUN, dtype=np.uint64))).sum(axis=2)
    lane = np.arange(LANES)
    copy = lane % rep
    qa = q0[:, None] + RUN * lane[None, :]
    active = qa < n_frames[:, None]
    maxh = 4 if fam.h <= 4 else 8
    own = [np.clip(np.maximum(n_frames - s, 1)[:, None] - qa, 0, RUN + 1)
           for s in range(maxh)]
    l0, l1, l2 = (words[:, lane + i] for i in range(3))
    wr, rs = lane + fam.half // 16, 2 * (fam.half % 16)
    r0, r1, r2, r3 = (fsr(words[:, wr + i], words[:, wr + i + 1], rs)
                      for i in range(4))

    def block_xor(lo, hi, side):
        fw = np.zeros(lo.shape, np.uint64)
        rv = np.zeros(lo.shape, np.uint64)
        for b in range(nb):
            idx = ((lo if b < 4 else hi) >> np.uint64(8 * (b & 3))) & 0xFF
            e = ((side * nb + b) * 256 + idx.astype(np.int64)) * rep + copy
            fw ^= smem[e, 0]
            rv ^= smem[e, 1]
        return fw, rv

    def window_at(o):
        """The 32 codes from code o (per lane) of the unit's words."""
        w, sh = o // 16, 2 * (o % 16)
        at = np.arange(len(units))[:, None]
        return (fsr(words[at, w], words[at, w + 1], sh),
                fsr(words[at, w + 1], words[at, w + 2], sh))

    sh0, sh1 = 31 - sbits, 32 - sbits
    smask = (1 << (sbits - 1)) - 1
    rmask = np.uint64((1 << rbits) - 1)
    got = np.zeros((fam.h,) + qa.shape + (RUN,), np.uint64)
    pend = np.zeros((fam.h,) + qa.shape, np.int64)
    ring = [None] * maxh
    for t in range(maxh - 1):
        ring[t] = block_xor(r0, r1, 1)
        r0, r1, r2, r3 = fsr(r0, r1, 2), fsr(r1, r2, 2), fsr(r2, r3, 2), \
            r3 >> np.uint64(2)
    for j0 in range(0, RUN, maxh):
        for jj in range(maxh):
            j = j0 + jj
            ring[(jj + maxh - 1) % maxh] = block_xor(r0, r1, 1)
            r0, r1, r2, r3 = fsr(r0, r1, 2), fsr(r1, r2, 2), \
                fsr(r2, r3, 2), r3 >> np.uint64(2)
            lf, lr = block_xor(l0, l1, 0)
            l0, l1, l2 = fsr(l0, l1, 2), fsr(l1, l2, 2), l2 >> np.uint64(2)
            for s in range(fam.h):
                rf, rr = ring[(jj + s) % maxh]
                m = umin(rol_hi(lf, s) ^ (rf >> np.uint64(32)),
                         (lr >> np.uint64(32)) ^ rol_hi(rr, s))
                sampled = ((m >> np.uint64(sh0)) == 1) | (
                    (m >> np.uint64(sh1)) == smask)
                pend[s] |= np.where(active & sampled & (j < n_frames[:, None]
                                                        - qa), 1 << j, 0)
                hv = umin(rol64(lf, s) ^ rf, lr ^ rol64(rr, s))
                # the high-word test is the full hash's
                valid = active & (j < own[s])
                full = tnt.bank_index(torch.from_numpy(hv.view(np.int64)),
                                      rbits, sbits).numpy()
                assert np.array_equal(sampled[valid],
                                      full[valid] < 2 << rbits)
                got[s, :, :, j] = np.where(valid, hv, 0)
    # the own frames' bits, then each pending hash again from the words
    for s in range(fam.h):
        pend[s] &= (1 << np.minimum(own[s], RUN)) - 1
        for j in range(RUN):
            sel = (pend[s] >> j) & 1 == 1
            lf, lr = block_xor(*window_at(RUN * lane + j), 0)
            rf, rr = block_xor(*window_at(RUN * lane + fam.half + j + s), 1)
            hv = umin(rol64(lf, s) ^ rf, lr ^ rol64(rr, s))
            assert np.array_equal(hv[sel], got[s, :, :, j][sel])
            bank = (hv >> np.uint64(63 - sbits)) != 1
            w = np.where(qa + j == np.maximum(n_frames - s, 1)[:, None] - 1,
                         n_frames[:, None] - np.maximum(n_frames - s, 1)[
                             :, None] + 1, 1)
            idx = (bank.astype(np.int64) << rbits) + (hv & rmask).astype(
                np.int64)
            np.add.at(counters[s], idx[sel], w[sel])
    hashes = {}
    for r in np.unique(r_of):
        at = r_of == r
        for s in range(fam.h):
            own_s = max(lens[r] - fam.k + 1 - s, 1)
            pos = qa[at][:, :, None] + np.arange(RUN)
            order = np.argsort(pos.reshape(-1), kind="stable")
            flat = got[s][at].reshape(-1)[order]
            hashes[(r, s)] = flat[np.sort(pos.reshape(-1)) < own_s]
    return hashes


def per_care_xor(c, fam, s, n):
    """Seed s's canonical hashes at positions 0 .. n - 1 of the zero-padded
    codes c, by the definition: the XOR over its care offsets j of
    rol64(TAB[c], span - 1 - j) and rol64(TABC[c], j)."""
    span = fam.spans[s]
    fwd = np.zeros(n, np.uint64)
    rev = np.zeros(n, np.uint64)
    for j in fam.care(s):
        cj = c[j: j + n]
        fwd ^= _rol64_np(NT_TAB, span - 1 - j)[cj]
        rev ^= _rol64_np(NT_TABC, j)[cj]
    return umin(fwd, rev)


def batch_reads(fam, rng):
    """Reads shorter than k, of exactly k, between k and the longest span
    (their stale tails), one homopolymer, around a work item's and a
    unit's size, one of 5 items, and 16 short reads after which the next
    read's first base falls at every offset of a 16-code packed word."""
    k, top = fam.k, fam.spans[-1]
    lens = [k - 1, k, k + 1, top - 1, top, top + 1, 200,
            tnt.CHUNK + k - 1, tnt.CHUNK + k, UNIT + k - 1, UNIT + k,
            5 * tnt.CHUNK + 37, 3_000]
    lens += list(16 * (k // 16 + 1 + rng.integers(0, 3, 16)) + 1)
    codes = [rng.integers(0, 4, n).astype(np.uint8) for n in lens]
    codes[6][:] = 2                       # a homopolymer
    offsets = np.concatenate([[0], np.cumsum(lens)])
    return np.concatenate(codes), offsets


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_model_hashes_and_counters(name):
    """Every own frame's hash of the model equals the definition, the
    port's and the JAX hash_positions; its counters equal the plain
    version's at sbits 7 and at sbits 3 (~19% sampled)."""
    fam = FAMILIES[name]()
    rng = np.random.default_rng(sum(map(ord, name)))
    codes, offsets = batch_reads(fam, rng)
    assert set(offsets[-17:] % RUN) == set(range(RUN))
    lens = np.diff(offsets)
    B, Lmax = len(lens), int(lens.max())
    block = np.zeros((B, Lmax), np.uint8)
    for b in range(B):
        block[b, :lens[b]] = codes[offsets[b]:offsets[b + 1]]
    P = Lmax - fam.k + 1
    port = hash_positions(torch.from_numpy(block), fam, P).numpy().view(
        np.uint64)
    jax = np.asarray(jhash(block, jfamily(list(fam.seeds)), P))
    np.testing.assert_array_equal(port, jax)
    for rbits, sbits in ((10, 7), (12, 3)):
        counters = np.zeros((fam.h, 2 << rbits), np.int64)
        hashes = model_count(codes, offsets, fam, rbits, sbits, counters)
        checked = 0
        for b in range(B):
            n_frames = lens[b] - fam.k + 1
            if n_frames <= 0:
                assert not any(key[0] == b for key in hashes)
                continue
            padded = np.zeros(lens[b] + fam.pad_needed + 64, np.int64)
            padded[:lens[b]] = block[b, :lens[b]]
            for s in range(fam.h):
                own = max(n_frames - s, 1)
                got = hashes[(b, s)]
                assert got.shape == (own,)
                np.testing.assert_array_equal(got, per_care_xor(padded, fam,
                                                                s, own))
                np.testing.assert_array_equal(got, port[b, s, :own])
                checked += own
        assert checked > 10_000
        plain = torch.zeros((fam.h, 2 << rbits), dtype=torch.int32)
        tnt._ntcard_count_plain(plain, torch.from_numpy(codes),
                                torch.from_numpy(offsets), fam, rbits, sbits)
        np.testing.assert_array_equal(counters, plain.numpy())
        assert counters.sum() > 100


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_block_table_partials(name):
    """A half's partials at a random window are the XOR of its blocks'
    entries indexed by the window's bytes, equal to the per-care-offset
    XOR of kernel A's table (SeedFamily.kernel_table)."""
    fam = FAMILIES[name]()
    rng = np.random.default_rng(7)
    nb = tnt.kernel_blocks(fam, 7)
    tab = fam.block_table(nb).reshape(2, nb, 256, 2)
    kt = fam.kernel_table()
    nl, nc = len(fam.care_left), len(fam.care_left) + len(fam.care_right)
    care, pairs = kt[:nc].astype(np.int64), kt[nc:].reshape(nc, 4, 2)
    for _ in range(200):
        win = rng.integers(0, 4, 4 * nb)
        for side, rows in ((0, range(nl)), (1, range(nl, nc))):
            want = np.zeros(2, np.uint64)
            for r in rows:
                want ^= pairs[r, win[care[r]]]
            got = np.zeros(2, np.uint64)
            for b in range(nb):
                x = sum(int(win[4 * b + t]) << (2 * t) for t in range(4))
                got ^= tab[side, b, x]
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fam,sbits,match", [
    (lambda: unspaced_family(66), 7, "left half"),
    (lambda: build_seed_family(make_seed_pattern(PRESET, 22, 16, 9)), 7,
     "h <= 8"),
    (lambda: build_seed_family(make_seed_pattern(PRESET, 22, 16, 3)), 32,
     "sbits"),
    # a right half of 33 positions: 9 blocks
    (lambda: build_seed_family(["1" * 32 + "0" * 32 + "1"]), 7, "blocks"),
])
def test_kernel_limits_raise(fam, sbits, match):
    """The families and sbits that the kernel does not take raise
    ValueError in the wrapper, before any launch; the plain version takes
    them (tests/test_torch_ntcard.py)."""
    with pytest.raises(ValueError, match=match):
        tnt.kernel_blocks(fam(), sbits)


def test_engine_families_fit_the_kernel():
    """The engine's families (the defaults, the gate dataset's, random
    seeds at its k and w) and the unspaced ones of the stages take the
    kernel at the engine's sbits."""
    fams = [build_seed_family(make_seed_pattern(PRESET, 22, 16, 3)),
            build_seed_family(make_seed_pattern("", 22, 16, 3)),
            build_seed_family(make_seed_pattern("", 32, 16, 4)),
            unspaced_family(15), unspaced_family(32), unspaced_family(64)]
    assert [tnt.kernel_blocks(f, 7) for f in fams] == [3, 3, 4, 3, 4, 8]
