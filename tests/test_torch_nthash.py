"""PyTorch port, hashing and slot map: the port's hash_positions and slot_of
equal goldrush_tpu's JAX kernels and the NumPy oracle bit for bit (kernel
A itself is held to them on a card by test_torch_kernels.py)."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from goldrush_tpu.mibf import mibf as jdm
from goldrush_tpu.ops import nthash_np as oracle
from goldrush_tpu.ops.nthash import build_seed_family as jfamily
from goldrush_tpu.ops.nthash import hash_positions as jhash

from goldrush_tpu_torch.mibf import mibf as tdm
from goldrush_tpu_torch.ops.nthash import build_seed_family, hash_positions
from goldrush_tpu_torch.ops.seeds import make_seed_pattern

RNG = np.random.default_rng(17)


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


@pytest.mark.parametrize("preset,k,w,h", [
    ("1011011110110111101101", 22, 16, 3),
    ("", 22, 16, 3),
    ("", 20, 14, 4),
    ("", 18, 12, 1),
])
def test_hash_positions_matches_jax_and_oracle(preset, k, w, h):
    seeds = make_seed_pattern(preset, k, w, h)
    fam = build_seed_family(seeds)
    # lengths below pad_needed, around a 64-position rotation period, long
    lengths = [k + h, fam.pad_needed - 1, 64, 257, 1100]
    Lmax = max(lengths)
    P = Lmax - k + 1
    codes = np.zeros((len(lengths), Lmax), dtype=np.uint8)
    for i, L in enumerate(lengths):
        codes[i, :L] = RNG.integers(0, 4, L)
    got = _u64(hash_positions(torch.from_numpy(codes), fam, P))
    want = np.asarray(jhash(codes, jfamily(seeds), P))
    np.testing.assert_array_equal(got, want)          # every frame, padding too
    for i, L in enumerate(lengths):
        for s in range(h):
            n = L - len(seeds[s]) + 1
            if n <= 0:
                continue
            fwd, rev = oracle.seed_hashes(codes[i, :L], seeds[s])
            np.testing.assert_array_equal(got[i, s, :n], np.minimum(fwd, rev))


def _rol(x: np.ndarray, r: int) -> np.ndarray:
    r %= 64
    return x if r == 0 else (x << np.uint64(r)) | (x >> np.uint64(64 - r))


@pytest.mark.parametrize("preset,k,w,h", [
    ("1011011110110111101101", 22, 16, 3),
    ("", 22, 16, 3),
    ("", 20, 14, 4),
    ("", 18, 12, 1),
])
def test_kernel_table_factorises_the_jax_hash(preset, k, w, h):
    """Kernel A's arithmetic on SeedFamily.kernel_table, in numpy: per
    position the left-half partials (FL, RL) and the right-half ones
    (FR, RR), then seed s = min(rol(FL, s) ^ FR[+half+s], RL ^ rol(RR[+half
    +s], s)), equals goldrush_tpu's hash_positions at every frame."""
    seeds = make_seed_pattern(preset, k, w, h)
    fam = build_seed_family(seeds)
    nl, nr = len(fam.care_left), len(fam.care_right)
    table = fam.kernel_table()
    care = table[: nl + nr].astype(np.int64)
    const = table[nl + nr:].reshape(nl + nr, 4, 2)     # [offset, base, strand]
    codes = RNG.integers(0, 4, (3, 300)).astype(np.uint8)
    P = 250
    c = np.pad(codes.astype(np.int64), ((0, 0), (0, P + fam.pad_needed)))
    part = np.zeros((2, 2, 3, P + h), np.uint64)       # [half, strand]
    for r, off in enumerate(care):
        start = off if r < nl else fam.half + off
        part[int(r >= nl)] ^= np.moveaxis(
            const[r][c[:, start: start + P + h]], -1, 0)
    want = np.asarray(jhash(codes, jfamily(seeds), P))
    with np.errstate(over="ignore"):
        for s in range(h):
            fwd = _rol(part[0, 0, :, :P], s) ^ part[1, 0, :, s: s + P]
            rev = part[0, 1, :, :P] ^ _rol(part[1, 1, :, s: s + P], s)
            np.testing.assert_array_equal(np.minimum(fwd, rev), want[:, s])


def test_hash_positions_short_codes_pad_with_zero():
    fam = build_seed_family(make_seed_pattern("1011011110110111101101",
                                              22, 16, 3))
    codes = RNG.integers(0, 4, (2, 30)).astype(np.uint8)
    got = _u64(hash_positions(torch.from_numpy(codes), fam, 40))
    want = np.asarray(jhash(codes, jfamily(list(fam.seeds)), 40))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["fastrange", "mod"])
@pytest.mark.parametrize("size", [100_003, 142_368_384, (1 << 32) - 5])
def test_slot_of_matches_jax(mode, size):
    h = RNG.integers(0, 1 << 63, 4000, dtype=np.int64).astype(np.uint64)
    h[:2000] |= np.uint64(1 << 63)                    # top bit set
    h[0], h[1] = np.uint64(0), np.uint64((1 << 64) - 1)
    got = tdm.slot_of(torch.from_numpy(h.view(np.int64)), size, mode)
    want = np.asarray(jdm.slot_of(h, size, mode))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert int(got.max()) < size
