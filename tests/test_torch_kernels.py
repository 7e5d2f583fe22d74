"""The hand-written CUDA kernels of goldrush_tpu_torch against their plain
PyTorch versions, bit for bit, on a card.

Every test here needs a CUDA card and skips without one.  The file imports
neither JAX nor tests/conftest.py, so it also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

import os

import numpy as np
import pytest
import torch

from goldrush_tpu_torch import kernels
from goldrush_tpu_torch.config import PathConfig
from goldrush_tpu_torch.mibf import compressed as tcz
from goldrush_tpu_torch.mibf import mibf as tdm
from goldrush_tpu_torch.ops.nthash import build_seed_family
from goldrush_tpu_torch.ops.seeds import make_seed_pattern
from goldrush_tpu_torch.path.classify import classify_batch
from goldrush_tpu_torch.path.engine import GoldenPathEngine
from goldrush_tpu_torch.utils import synth

pytestmark = pytest.mark.gpu
FAM = build_seed_family(make_seed_pattern("1011011110110111101101", 22, 16, 3))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def reads_batch(rng, lengths, width):
    codes = np.zeros((len(lengths), width), np.uint8)
    for i, L in enumerate(lengths):
        codes[i, :L] = rng.integers(0, 4, L)
    return torch.from_numpy(codes), torch.tensor(lengths, dtype=torch.int32)


def assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x.cpu(), y.cpu())


@pytest.mark.parametrize("mode", ["fastrange", "mod"])
def test_seed_hash_grid_and_fill(cuda, mode):
    rng = np.random.default_rng(1)
    params = tdm.MibfParams(size=142_368_384, h=3, k=22, spans=FAM.spans,
                            tile_length=1000, slot_map=mode)
    T = 20
    codes, lens = reads_batch(rng, [20_000, 19_999, 5_432, 999, 0, 20_500],
                              T * 1000 + 1000)
    got = tdm.build_slot_grid(codes.to(cuda), lens.to(cuda), FAM, params, T)
    assert_same(got, tdm.build_slot_grid(codes, lens, FAM, params, T))
    words = torch.zeros(params.alloc, dtype=torch.int32)
    wk = tdm.fill_presence(words.to(cuda), codes.to(cuda), lens.to(cuda),
                           FAM, params.size, mode)
    wp = tdm.fill_presence(words, codes, lens, FAM, params.size, mode)
    assert torch.equal(wk.cpu(), wp) and int((wp != 0).sum()) > 100_000


@pytest.mark.parametrize("bs,T", [(3, 6), (20, 24)])
def test_probe_vote_and_insert(cuda, bs, T):
    """bs=20 at T=24 makes one block's slot list 60,000 keys, past shared
    memory: the insert kernel then sorts in its global scratch buffer."""
    rng = np.random.default_rng(bs)
    size = 1_000_003
    params = tdm.MibfParams(size=size, h=3, k=22, spans=FAM.spans,
                            tile_length=1000, threshold=4, block_size=bs,
                            vote_topk=8)
    codes, lens = reads_batch(rng, [T * 1000, T * 1000 - 300, 2500, 0],
                              T * 1000 + 1000)
    slots, ok = tdm.build_slot_grid(codes, lens, FAM, params, T)
    w = rng.integers(0, 9, params.alloc).astype(np.uint32)
    w |= np.uint32(tdm.PRESENT_BIT)
    c = rng.integers(0, 3, params.alloc).astype(np.uint32)
    host, dev = tdm.state_from_numpy(w, c), tdm.state_from_numpy(w, c, cuda)
    for i, (lo, hi, base, tr) in enumerate([(0, T - 1, 3, False),
                                            (1, T - 2, 9, True),
                                            (0, 1, 40, False)]):
        tdm.insert_read_sorted(host, slots[i], lo, hi, base, tr, params, T)
        tdm.insert_read_sorted(dev, slots[i].to(cuda), lo, hi, base, tr,
                               params, T)
        assert_same(dev, host)
    for rows in (slice(0, 4), slice(1, 2)):
        s, o = slots[rows].contiguous(), ok[rows].contiguous()
        assert_same(tdm.probe_and_vote(dev.words, s.to(cuda), o.to(cuda),
                                       params, T),
                    tdm.probe_and_vote(host.words, s, o, params, T))


def random_tables(rng, B, T, K, n_ids):
    curr_id = np.zeros((B, T), np.int32)
    ci = np.zeros((B, T, K), np.int32)
    cc = np.zeros((B, T, K), np.int32)
    for b in range(B):
        for t in range(T):
            ids = rng.choice(np.arange(1, n_ids + 1), replace=False,
                             size=min(int(rng.integers(0, K + 1)), n_ids))
            counts = rng.integers(3, 40, len(ids))
            order = np.lexsort((ids, -counts))
            ci[b, t, :len(ids)] = ids[order]
            cc[b, t, :len(ids)] = counts[order]
            curr_id[b, t] = ci[b, t, 0] if len(ids) else n_ids // 2
    n = rng.integers(0, T + 1, B).astype(np.int32)
    n[:8] = [0, 1, 2, 3, 14, 15, 16, T]
    return [torch.from_numpy(a) for a in
            (curr_id, np.zeros_like(curr_id), ci, cc, n)]


@pytest.mark.parametrize("n_ids,K,T", [(6, 8, 20), (40, 32, 20),
                                       (12, 8, 160)])
def test_classify(cuda, n_ids, K, T):
    args = random_tables(np.random.default_rng(n_ids), 64, T, K, n_ids)
    got = classify_batch(*(a.to(cuda) for a in args), 10, 5, 1, debug=True)
    want = classify_batch(*args, 10, 5, 1, debug=True)
    assert_same(got[0], want[0])
    assert_same(got[1:], want[1:])


def test_wrappers_check_their_inputs(cuda):
    params = tdm.MibfParams(size=1000, h=3, k=22, spans=FAM.spans,
                            tile_length=100)
    codes = torch.zeros((2, 600), dtype=torch.uint8, device=cuda)
    lens = torch.full((2,), 500, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        tdm.build_slot_grid(codes, lens.long(), FAM, params, 5)
    with pytest.raises(ValueError):
        tdm.build_slot_grid(codes[:, ::2], lens, FAM, params, 5)
    words = torch.zeros(params.alloc, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tdm.fill_presence(words, codes.cpu(), lens, FAM, params.size)
    before = kernels.SEED_HASH_GRID.launches
    tdm.build_slot_grid(codes, lens, FAM, params, 5)
    assert kernels.SEED_HASH_GRID.launches == before + 1
    # an empty tile range launches nothing and is not counted
    state = tdm.init_state(params, cuda)
    slots = torch.zeros((3, 500), dtype=torch.int64, device=cuda)
    before = kernels.INSERT_SORTED.launches
    tdm.insert_read_sorted(state, slots, 3, 2, 1, False, params, 5)
    assert kernels.INSERT_SORTED.launches == before
    tdm.insert_read_sorted(state, slots, 0, 2, 1, False, params, 5)
    assert kernels.INSERT_SORTED.launches == before + 1


@pytest.mark.parametrize("size", [31, 1_000_003, 65_536 * 40])
def test_rank_kernels(cuda, size):
    """rank_pack + rank_carry (the freeze), rank_lookup, and kernels B and
    D on the rank-indexed tables, against the plain versions."""
    rng = np.random.default_rng(size)
    alloc = -(-(size + 1) // 1024) * 1024
    w = rng.integers(0, 1 << 30, alloc).astype(np.uint32)
    w |= np.where(rng.random(alloc) < 0.3, np.uint32(tdm.PRESENT_BIT),
                  np.uint32(0))
    words = torch.from_numpy(w.view(np.int32).copy())
    host, dev = tcz.freeze(words, size), tcz.freeze(words.to(cuda), size)
    assert_same(dev, host)
    assert int(host.bitrank[-2] >> 32) > 0 or size < 64
    if size < 1000:
        return
    T = 6
    params = tdm.MibfParams(size=size, h=3, k=22, spans=FAM.spans,
                            tile_length=1000, threshold=4, block_size=2,
                            vote_topk=8)
    codes, lens = reads_batch(rng, [6000, 5300, 999, 0], T * 1000 + 1000)
    slots, ok = tdm.build_slot_grid(codes, lens, FAM, params, T)
    slots[0, 0, :2000] = torch.from_numpy(rng.integers(0, size, 2000))
    ranks = tcz.rank_grid(host, slots, size)
    assert torch.equal(tcz.rank_grid(dev, slots.to(cuda), size).cpu(), ranks)
    ids = torch.from_numpy(rng.integers(0, 6, host.ids.shape[0],
                                        dtype=np.int32))
    ids[-1] = 0
    host = host._replace(ids=ids)
    dev = dev._replace(ids=ids.to(cuda))
    for lo, hi, base, tr in [(0, T - 1, 3, False), (1, T - 2, 9, True)]:
        tcz.insert_read_sorted(host, ranks[0], lo, hi, base, tr, params, T)
        tcz.insert_read_sorted(dev, ranks[0].to(cuda), lo, hi, base, tr,
                               params, T)
        assert_same(dev, host)
    assert_same(tcz.probe_and_vote(dev, ranks.to(cuda), ok.to(cuda),
                                   params, T),
                tcz.probe_and_vote(host, ranks, ok, params, T))


def test_engine_on_card_matches_cpu(cuda, tmp_path):
    genome = synth.random_genome(60_000, seed=3)
    reads = synth.simulate_reads(genome, n_reads=120, read_len=3000, seed=4,
                                 err_rate=0.0, phred=20)
    path = str(tmp_path / "reads.fq")
    synth.write_fastq(path, reads)
    cfg = dict(genome_size=60_000, kmer_size=22, weight=16, hash_num=3,
               seed_preset="1011011110110111101101", tile_length=250,
               min_length=1000, block_size=4, phred_min=15,
               silver_path=True, max_paths=2, ratio=0.5, batch_reads=32)
    for mode in ("direct", "compressed"):
        runs = {}
        for dev in ("cuda", "cpu"):
            prefix = str(tmp_path / f"{mode}-{dev}")
            eng = GoldenPathEngine(PathConfig(input=path, prefix_file=prefix,
                                              mibf_mode=mode, **cfg),
                                   device=dev)
            st = eng.run()
            files = [open(f"{prefix}_{i}.fq", "rb").read() for i in (1, 2)
                     if os.path.exists(f"{prefix}_{i}.fq")]
            state = (tcz.state_to_numpy(eng.cstate).values()
                     if mode == "compressed"
                     else tdm.state_to_numpy(eng.state))
            runs[dev] = (files, st.recruits, st.queries, st.hits,
                         eng.last_rows.tolist(), list(state))
        gpu, cpu = runs["cuda"], runs["cpu"]
        assert gpu[:5] == cpu[:5] and len(gpu[0]) == 2
        for a, b in zip(gpu[5], cpu[5]):
            np.testing.assert_array_equal(a, b)
