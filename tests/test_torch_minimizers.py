"""PyTorch port, K20 and the minimizer mapper: minimizer_keys (the plain
version the CPU runs), batch_minimizers, _seq_minimizers, build_index and
map_reads against goldrush_tpu, bit for bit (keys, hashes, positions and
hits are integers)."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from goldrush_tpu.ops import minimizers as jmin
from goldrush_tpu.stages import mapping as jmap
from goldrush_tpu.utils import synth

from goldrush_tpu_torch.ops import minimizers as tmin
from goldrush_tpu_torch.stages import mapping as tmap


@pytest.fixture(autouse=True)
def two_torch_threads():
    """The tier-1 run shares the host's cores among parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def row_lengths(k: int, w: int) -> list[int]:
    """Rows shorter than k, shorter than k + w - 1, exactly k + w - 1, one
    base longer, and two of no power-of-two width."""
    return [k - 1, k + w - 2, k + w - 1, k + w, 3 * k + w + 17,
            2 * (k + w) + 101]


def batch(lengths, width, seed, n_frac=0.02):
    """Random codes with a share of N (code 4) bases, zero-padded."""
    rng = np.random.default_rng(seed)
    codes = np.zeros((len(lengths), width), np.uint8)
    for i, L in enumerate(lengths):
        c = rng.integers(0, 4, L).astype(np.uint8)
        c[rng.random(L) < n_frac] = 4
        codes[i, :L] = c
    return codes, np.array(lengths, np.int64)


@pytest.mark.parametrize("w", [10, 100, 1000])
@pytest.mark.parametrize("k", [15, 24, 32, 40])
def test_minimizer_keys_match_jax(k, w):
    lengths = row_lengths(k, w)
    codes, _ = batch(lengths, max(lengths), seed=k * w)
    P = max(codes.shape[1] - k + 1, w)
    jk, jh = jmin.minimizer_keys(codes, k, w, P)
    tk, th = tmin.minimizer_keys(torch.from_numpy(codes), k, w, P)
    np.testing.assert_array_equal(tk.numpy().view(np.uint64), np.asarray(jk))
    np.testing.assert_array_equal(th.numpy().view(np.uint64), np.asarray(jh))


@pytest.mark.parametrize("w", [10, 100, 1000])
@pytest.mark.parametrize("k", [15, 24, 32, 40])
def test_batch_minimizers_independent_of_padding(k, w):
    """The port on the batch's own shape against the JAX function given the
    JAX mapper's padding: width to a power of two >= 1024, 32 rows."""
    lengths = row_lengths(k, w)
    codes, lens = batch(lengths, max(lengths) + 3, seed=k + w)
    L = 1 << max(10, (max(codes.shape[1], k + w) - 1).bit_length())
    padded = np.zeros((32, L), np.uint8)
    padded[:len(lengths), :codes.shape[1]] = codes
    plens = np.zeros(32, np.int64)
    plens[:len(lengths)] = lens
    want = jmin.batch_minimizers(padded, plens, k, w)[:len(lengths)]
    got = tmin.batch_minimizers(codes, lens, k, w, device="cpu")
    assert len(got) == len(want)
    for (gp, gh), (wp, wh), n in zip(got, want, lengths):
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gh, wh)
        assert gh.dtype == np.uint64 and gp.dtype == np.int64
        if n >= k + w - 1:
            assert len(gp) > 0
        else:
            assert len(gp) == 0


def test_minimizer_keys_checks_positions():
    codes = torch.zeros((1, 100), dtype=torch.uint8)
    with pytest.raises(ValueError, match="2\\^20"):
        tmin.minimizer_keys(codes, 15, 10, (1 << 20) + 1)
    with pytest.raises(ValueError):
        tmin.minimizer_keys(codes, 15, 120, 100)


@pytest.mark.parametrize("max_seq", [None, 2_500])
def test_seq_minimizers_match_jax(monkeypatch, max_seq):
    """Whole sequences through both mappers' chunking; with MAX_SEQ cut to
    2,500 in both packages, sequences run past it and are hashed in chunks
    at offsets (the packing limit's logic at a test's size)."""
    if max_seq:
        monkeypatch.setattr(jmap, "MAX_SEQ", max_seq)
        monkeypatch.setattr(tmap, "MAX_SEQ", max_seq)
    g = synth.random_genome(20_000, seed=3)
    seqs = [g[:7_777], g[100:140], g[5_000:5_001 + 2_480], b"",
            g[2_000:14_001], g[9_000:9_300] + b"NNNN" + g[9_300:9_900]]
    for k, w in ((15, 10), (24, 100)):
        want = jmap._seq_minimizers(seqs, k, w)
        got = tmap._seq_minimizers(seqs, k, w, device="cpu")
        for (gp, gh), (wp, wh) in zip(got, want, strict=True):
            np.testing.assert_array_equal(gp, wp)
            np.testing.assert_array_equal(gh, wh)


def assert_same_hits(got, want):
    assert len(got) == len(want)
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            assert (g.tid, g.strand, g.q_start, g.q_end, g.t_start,
                    g.t_end, g.n_anchors, g.offset) == \
                   (w.tid, w.strand, w.q_start, w.q_end, w.t_start,
                    w.t_end, w.n_anchors, w.offset)
            if w.t_anchors is None:
                assert g.t_anchors is None
            else:
                np.testing.assert_array_equal(g.t_anchors, w.t_anchors)


def assert_same_index(t, j):
    assert (t.k, t.w, t.names) == (j.k, j.w, j.names)
    for f in ("hashes", "tid", "pos", "lengths"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b)


def mapping_cases():
    """tests/test_minimizers_mapping.py's inputs: (contigs, k, w, reads)."""
    g9 = synth.random_genome(40_000, seed=9)
    g10 = synth.random_genome(30_000, seed=10)
    g20 = synth.random_genome(60_000, seed=20)
    return {
        "locates": ([g9[:15_000], g9[15_000:28_000], g9[28_000:]], 16, 32,
                    [g9[18_000:21_000], synth.revcomp(g9[30_000:33_500]),
                     g9[13_000:17_500]]),
        "noisy": ([g10], 16, 16,
                  [s for _, s, _ in synth.simulate_reads(
                      g10, 5, 4000, seed=11, err_rate=0.05,
                      both_strands=True)]),
        "batched": ([g20[:20_000], g20[18_000:40_000], g20[38_000:]], 16,
                    24, [s for _, s, _ in synth.simulate_reads(
                        g20, 40, 3_000, seed=21, err_rate=0.04,
                        both_strands=True)]),
    }


@pytest.mark.parametrize("keep_anchors", [False, True])
@pytest.mark.parametrize("case", ["locates", "noisy", "batched"])
def test_build_index_and_map_reads_match_jax(case, keep_anchors):
    contigs, k, w, reads = mapping_cases()[case]
    names = [f"c{i}" for i in range(len(contigs))]
    jidx = jmap.build_index(contigs, names, k=k, w=w)
    tidx = tmap.build_index(contigs, names, k=k, w=w, device="cpu")
    assert_same_index(tidx, jidx)
    want = jmap.map_reads(jidx, reads, keep_anchors=keep_anchors)
    got = tmap.map_reads(tidx, reads, keep_anchors=keep_anchors,
                         device="cpu")
    assert_same_hits(got, want)
    assert any(got)
    # the per-read path over the port's minimizers
    mins = tmap._seq_minimizers(reads, k, w, device="cpu")
    per_read = [tmap.map_sequence(tidx, p, h, keep_anchors=keep_anchors)
                for p, h in mins]
    assert_same_hits(per_read, want)
