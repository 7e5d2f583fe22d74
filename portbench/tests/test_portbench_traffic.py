"""The frozen generators: the same seed gives the same reads, and every
seed the same multiset of sizes."""

import os

import pytest
import torch

from portbench.traffic import reads as tr

SMALL = dict(genome=50_000, reads=40, median=2_000, sigma=0.5, min_clip=100,
             max_clip=20_000, cut_below=0, error_rate=0.05, phred=20,
             phred_jitter=3)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_same_seed_same_reads(seed):
    a = tr.make_reads(SMALL, seed, "cpu")
    b = tr.make_reads(SMALL, seed, "cpu")
    assert torch.equal(a.codes, b.codes)
    assert torch.equal(a.offsets, b.offsets)
    assert torch.equal(a.quals, b.quals)
    c = tr.make_reads(SMALL, seed + 1, "cpu")
    assert not torch.equal(a.codes[:1000], c.codes[:1000])


def test_fixed_sizes_in_another_order():
    law = tr.length_law(SMALL)
    assert len(law) == SMALL["reads"]
    assert (law >= SMALL["min_clip"]).all() and (law <= SMALL["max_clip"]).all()
    cut = dict(SMALL, cut_below=2_000)
    assert (tr.length_law(cut) >= 2_000).all()
    # errors are balanced: lengths stay within a few percent of the law
    r = tr.make_reads(SMALL, 3, "cpu")
    assert abs(int(r.offsets[-1]) / law.sum() - 1) < 0.02


def test_codes_and_quals_in_range():
    r = tr.make_reads(SMALL, 5, "cpu")
    assert int(r.codes.max()) <= 3
    q = r.quals.to(torch.int64) - 33
    assert int(q.min()) >= 17 and int(q.max()) <= 23


def test_reverse_strand_reads_are_reverse_complements():
    t = dict(SMALL, error_rate=0.0)
    g = torch.Generator().manual_seed(9)
    r = tr.make_reads(t, 9, "cpu")
    genome = torch.randint(0, 4, (t["genome"],), dtype=torch.uint8,
                           generator=g)
    gs = genome.numpy().tobytes()
    found = 0
    for i in range(len(r)):
        s = r.codes[r.offsets[i]: r.offsets[i + 1]].numpy()
        fwd, rev = s.tobytes(), (3 - s[::-1]).tobytes()
        found += (fwd in gs) or (rev in gs)
    assert found == len(r)


def test_fastq_deterministic(tmp_path):
    paths = []
    for k in range(2):
        p = os.path.join(tmp_path, f"{k}.fq")
        tr.write_fastq(p, tr.host_reads(tr.make_reads(SMALL, 21, "cpu")))
        paths.append(open(p, "rb").read())
    assert paths[0] == paths[1]
    assert paths[0].count(b"\n") == 4 * SMALL["reads"]

