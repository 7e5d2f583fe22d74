"""PyTorch port, K21 and the k-mer polisher: the count table (on [:size];
the JAX function also counts its padding's and the invalid positions'
k-mers into the sentinel slot `size`, which the port leaves at 0) and the
query against goldrush_tpu given its own power-of-two padded inputs, and
polish_contig, run_polish (with and without a mapper) and
run_polish_streaming on tests/test_stages.py's and
tests/test_polish_streaming.py's inputs, bit for bit."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from goldrush_tpu.stages import polish as jpol
from goldrush_tpu.utils import synth

from goldrush_tpu_torch.stages import polish as tpol


@pytest.fixture(autouse=True)
def two_torch_threads():
    """The tier-1 run shares the host's cores among parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def kmer_batch(rng, B, L, k):
    """Codes of B rows of width L, lengths from 0 to L (one row of each
    extreme and one shorter than k)."""
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, B).astype(np.int64)
    lengths[0], lengths[-1] = L, min(k - 1, L)
    for b, n in enumerate(lengths):
        codes[b, n:] = 0
    return codes, lengths


def jax_padded(codes, lengths):
    """The JAX KmerTable's padding: rows to _pow2(B, 8), columns to
    _pow2(L) (stages/polish.py:116-137)."""
    B, L = codes.shape
    Bp, Lp = jpol._pow2(B, 8), jpol._pow2(L)
    cp = np.zeros((Bp, Lp), np.uint8)
    cp[:B, :L] = codes
    lp = np.zeros(Bp, np.int64)
    lp[:B] = lengths
    return jnp.asarray(cp), jnp.asarray(lp), Lp


@pytest.mark.parametrize("size", [65_537, 1_000_003])
@pytest.mark.parametrize("k", [13, 16, 24, 32])
def test_count_and_query_match_jax(k, size):
    rng = np.random.default_rng(k * 7 + size % 97)
    # a table of uint32 values, some near 2^32, so the adds wrap as uint32
    start = rng.integers(0, 1 << 32, size + 1, dtype=np.uint64).astype(
        np.uint32)
    start[rng.random(size + 1) < 0.5] = 0
    start[:: 997] = 0xFFFFFFFF
    jcounts = jnp.asarray(start)
    tcounts = torch.from_numpy(start.view(np.int32).copy())
    for B, L in ((5, 301), (3, 77), (9, 1_500)):
        codes, lengths = kmer_batch(rng, B, L, k)
        cp, lp, Lp = jax_padded(codes, lengths)
        jcounts = jpol._count_kmers(jcounts, cp, lp, k, Lp - k + 1, size)
        tpol.count_kmers(tcounts, torch.from_numpy(codes),
                         torch.from_numpy(lengths), k, size)
        got = tcounts.numpy().view(np.uint32)
        np.testing.assert_array_equal(got[:size], np.asarray(jcounts)[:size])
        assert got[size] == start[size]          # the sentinel is untouched
        jc, jv = jpol._query_kmers(jcounts, cp, lp, k, Lp - k + 1, size)
        tc, tv = tpol.query_kmers(tcounts, torch.from_numpy(codes),
                                  torch.from_numpy(lengths), k, size)
        P = L - k + 1
        np.testing.assert_array_equal(tc.numpy().view(np.uint32),
                                      np.asarray(jc)[:B, :P])
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv)[:B, :P])


@pytest.mark.parametrize("k", [13, 24])
def test_kmer_table_batches_match_jax(k):
    """KmerTable's host entry points (numpy in, numpy out) at odd widths
    and batch sizes; the homopolymer row adds every position to one slot."""
    rng = np.random.default_rng(k)
    jt, tt = jpol.KmerTable(3_000, 8), tpol.KmerTable(3_000, 8, "cpu")
    assert jt.size == tt.size and tt.counts.shape == (tt.size + 1,)
    for B, L in ((1, 999), (7, 123), (33, 60)):
        codes, lengths = kmer_batch(rng, B, L, k)
        codes[0, :] = 2
        jt.add_batch(codes, lengths, k)
        tt.add_batch(codes, lengths, k)
        np.testing.assert_array_equal(
            tt.counts.numpy().view(np.uint32)[:tt.size],
            np.asarray(jt.counts)[:jt.size])
        for got, want in zip(tt.query_batch(codes, lengths, k),
                             jt.query_batch(codes, lengths, k)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_count_checks_its_table():
    counts = torch.zeros(101, dtype=torch.int32)
    codes = torch.zeros((1, 50), dtype=torch.uint8)
    n = torch.tensor([50])
    with pytest.raises(ValueError, match="size"):
        tpol.count_kmers(counts, codes, n, 13, 200)
    with pytest.raises(ValueError, match="2\\^32"):
        tpol.count_kmers(torch.zeros(1, dtype=torch.int32), codes, n, 13,
                         1 << 32)
    with pytest.raises(ValueError, match="width"):
        tpol.query_kmers(counts, codes, n, 51, 100)
    with pytest.raises(ValueError, match="batch on"):   # never a mixed call
        tpol.count_kmers(counts, codes.to("meta"), n, 13, 100)


def corrupted_contig():
    """tests/test_stages.py::test_polish_fixes_errors' contig and reads."""
    g = synth.random_genome(8_000, seed=46)
    reads = [g[i:i + 3000] for i in range(0, 5001, 250)]
    reads += [synth.revcomp(r) for r in reads]
    arr = bytearray(g)
    arr[1000] = ord("A") if arr[1000] != ord("A") else ord("C")
    arr[2000] = ord("G") if arr[2000] != ord("G") else ord("T")
    arr.insert(3000, ord("T"))
    del arr[4000]
    return g, bytes(arr), reads


@pytest.mark.parametrize("k", [16, 24])
def test_polish_contig_matches_jax(k):
    g, contig, reads = corrupted_contig()
    jp = jpol.PolishParams(k=k, solid_min=2, rounds=4)
    tp = tpol.PolishParams(k=k, solid_min=2, rounds=4)
    jt = jpol.build_read_table(reads, jp)
    tt = tpol.build_read_table(reads, tp, "cpu")
    np.testing.assert_array_equal(
        tt.counts.numpy().view(np.uint32)[:tt.size],
        np.asarray(jt.counts)[:jt.size])
    want = jpol.polish_contig(contig, jt, jp)
    assert tpol.polish_contig(contig, tt, tp) == want and want[1] >= 4


def polish_cases():
    """(contigs, reads, params, mapper_k) of tests/test_stages.py."""
    g, contig, reads = corrupted_contig()
    clean = synth.random_genome(6_000, seed=47)
    a = synth.random_genome(8_000, seed=51)
    b = synth.random_genome(8_000, seed=52)
    arr = bytearray(a)
    arr[1500] = ord("G") if arr[1500] != ord("G") else ord("T")
    return {
        "fixes_errors": ([("c", contig)], reads,
                         dict(k=24, solid_min=2, rounds=4), None),
        "clean": ([("c", clean)],
                  [clean[i:i + 2500] for i in range(0, 3501, 250)],
                  dict(k=24, solid_min=2, rounds=2), None),
        "mapper": ([("a", bytes(arr)), ("b", b)],
                   [a[i:i + 3000] for i in range(0, 5001, 250)]
                   + [b[i:i + 3000] for i in range(0, 5001, 250)],
                   dict(k=24, solid_min=2, rounds=3), 15),
    }


@pytest.mark.parametrize("case", ["fixes_errors", "clean", "mapper"])
def test_run_polish_matches_jax(case):
    contigs, reads, kw, mk = polish_cases()[case]
    want = jpol.run_polish(contigs, reads, jpol.PolishParams(**kw),
                           mapper_k=mk)
    got = tpol.run_polish(contigs, reads, tpol.PolishParams(**kw),
                          mapper_k=mk, device="cpu")
    assert got == want


def test_run_polish_streaming_matches_jax(tmp_path):
    """tests/test_polish_streaming.py's inputs through both packages'
    streaming polisher, and the port's in-memory one."""
    truth = synth.random_genome(60_000, seed=5)
    recs = synth.simulate_reads(truth, 80, 3_000, seed=6, err_rate=0.04,
                                indel_frac=0.4, homopolymer_bias=0.5)
    reads = [s for _, s, _ in recs]
    contigs = [(f"g{i}", reads[i]) for i in range(3)]
    kw = dict(k=24, schedule=((24, 3), (16, 3)), site_spacing=2)
    path = os.path.join(tmp_path, "reads.fq")
    synth.write_fastq(path, recs)
    want = jpol.run_polish_streaming(contigs, path, jpol.PolishParams(**kw),
                                     mapper_k=15, mapper_w=10, chunk=16)
    got = tpol.run_polish_streaming(contigs, path, tpol.PolishParams(**kw),
                                    mapper_k=15, mapper_w=10, chunk=16,
                                    device="cpu")
    assert got == want and want[1] > 0
    assert tpol.run_polish(contigs, reads, tpol.PolishParams(**kw),
                           mapper_k=15, mapper_w=10, device="cpu") == want
