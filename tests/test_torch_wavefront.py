"""PyTorch port, the wavefront consume (K23) window by window, and its gate.

``wave_window_plain`` against the JAX engine's own wave executable
(``GoldenPathEngine._consume_for(B, T)`` with ``_wave`` on, the route
tests/test_torch_consume.py takes), both starting from one filter filled
by the JAX package, on the two windows of tests/test_wavefront.py's reads
(64 reads, then 16 padded to 64): the rows of every read, ``scal``, the
id table and the side table, bit for bit, with either filter, around a
silver rotation inside the window, in golden mode, at a window that ends
``done`` and at insert_stride 2 (no trim recheck).  ``wave_adjacency``
against a NumPy transcription of goldrush_tpu/path/wavefront.py:308-343
on windows whose reads overlap, with padding rows (invalid frames) and
with repeated k-mers.  The gate: ``wavefront=True`` under the exact
policy or ``debug`` runs the sequential scan in both packages, and the
wavefront refuses filters of 2^31 slots or more."""

import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
import jax.numpy as jnp
from goldrush_tpu.config import PathConfig as JPathConfig
from goldrush_tpu.ops import nthash as jnthash
from goldrush_tpu.path.engine import GoldenPathEngine as JEngine

from goldrush_tpu_torch.config import PathConfig
from goldrush_tpu_torch.mibf import mibf as tdm
from goldrush_tpu_torch.path import engine as teng
from goldrush_tpu_torch.path import wavefront as wave
from tests.test_torch_consume import port_state
from tests.test_torch_wavefront_engine import (  # noqa: F401
    CFG, path_files, two_torch_threads, wave_reads)

WINDOW = dict(wave_window=64)
TARGET = int(0.5 * 60_000)

# case: (config, scal at the first window's start, event)
CASES = {
    # the first commit fills the silver path: the filter resets inside
    # the window and the drops past it reopen
    "direct-rotation": ({}, [0, TARGET - 1, 1, 0], "rotation"),
    "compressed-rotation": (dict(mibf_mode="compressed"),
                            [0, TARGET - 1, 1, 0], "rotation"),
    "direct-golden": (dict(silver_path=False), [0, 0, 1, 0], None),
    "compressed-golden": (dict(silver_path=False, mibf_mode="compressed"),
                          [0, 0, 1, 0], None),
    # the first commit fills the last silver path
    "compressed-done": (dict(mibf_mode="compressed"),
                        [0, TARGET - 1, 2, 0], "done"),
    "direct-is2": (dict(insert_stride=2), [0, 0, 1, 0], None),
}


def engines(d, path, tag, over):
    kw = dict(CFG, input=path, **{"silver_path": True, **WINDOW, **over})
    je = JEngine(JPathConfig(prefix_file=str(d / f"j{tag}"), **kw))
    je.calc_phred_threshold(path)
    je.fill(path)
    te = teng.GoldenPathEngine(PathConfig(prefix_file=str(d / f"t{tag}"),
                                          **kw), device="cpu")
    te.phred_min = je.phred_min
    te.filter_out = set(je.filter_out)
    return je, te


def windows(te, path):
    recs = list(te._eligible(path))
    k = te.batch_reads
    return [te._pack_batch(recs[i: i + k]) for i in range(0, len(recs), k)]


@pytest.mark.parametrize("case", list(CASES))
def test_window_plain_matches_jax(wave_reads, case):
    d, path = wave_reads
    over, scal0, event = CASES[case]
    je, te = engines(d, path, case, over)
    assert je._wave and te.wave and te.batch_reads == 64
    compressed = te.compressed
    state = port_state(je, compressed)
    if compressed:
        te.cstate = state
    else:
        te.state = state
    jfilt = je.cstate if compressed else je.state
    table = state.ids if compressed else state.words
    side = torch.zeros_like(table)
    jside = jnp.zeros(table.shape, jnp.uint32)
    scal_j = jnp.asarray(scal0, dtype=jnp.int64)
    scal = torch.tensor(scal0, dtype=torch.int64)
    counters = wave.new_counters("cpu")
    _, _, ranked, limit, _ = wave._filter_view(state, te.size)
    for w, (codes, lengths, full, T) in enumerate(windows(te, path)):
        B = codes.shape[0]
        assert B == 64 and T == 8
        fn = je._consume_for(B, T)
        # the executable donates its inputs: hand it copies
        jfilt, rows_j, scal_j, jside = fn(
            jfilt, jnp.array(codes), jnp.array(lengths), jnp.array(full),
            scal_j, jnp.zeros((B, 8), jnp.int64), jside)
        codes_t, grid, ok, grid_ins, ok_ins, n_t, full_t = te._window_inputs(
            codes, lengths, full, T)
        adj = wave.wave_adjacency(te.wave_spec, grid_ins, codes_t, limit,
                                  ranked, T)
        rows = torch.empty((B, 8), dtype=torch.int64)
        before = counters.tolist()
        wave.wave_window_plain(te.wave_spec, state, side, grid, ok, grid_ins,
                               ok_ins, n_t, full_t, adj, scal, rows,
                               counters, T)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(rows_j))
        assert scal.tolist() == np.asarray(scal_j).tolist()
        jt = np.asarray(jfilt.ids if compressed else jfilt.words)
        n = table.shape[0] if compressed else te.size
        np.testing.assert_array_equal(table.numpy().view(np.uint32)[:n],
                                      jt[:n])
        np.testing.assert_array_equal(side.numpy().view(np.uint32),
                                      np.asarray(jside))
        if w == 0:
            after = counters.tolist()
            assert after[0] > before[0] and after[3] > 0   # rounds, commits
            if event == "rotation":
                assert after[4] > 0 and scal[2] >= 2
            elif event == "done":
                assert scal[3] == 1 and scal[2] == 3
            elif not te.cfg.silver_path:
                assert after[4] == 0
            # the next window starts from the JAX package's side table
            side = tdm.side_from_numpy(np.asarray(jside), device="cpu")
    if not te.rech_on:
        assert counters[2] == 0
    else:
        assert counters[2] > 0


def np_adjacency(grid, fp, limit, ranked):
    """goldrush_tpu/path/wavefront.py:308-343 in NumPy: uint64 keys, the
    unique keys of invalid frames included, one global sort."""
    B, H, TF = grid.shape
    ob = max((B - 1).bit_length(), 1)
    conf_size = limit + 1 if ranked else 1 << wave.DIRECT_CONFLICT_BITS
    conf = np.where(grid < limit,
                    grid if ranked else grid & ((1 << 24) - 1), conf_size)
    u64 = np.uint64
    key = ((conf.astype(u64) << u64(wave.FP_BITS + ob))
           | (fp.astype(u64) << u64(ob))
           | np.arange(B, dtype=u64)[:, None, None])
    uniq = (u64(1) << u64(62)) + (np.arange(B * H * TF, dtype=u64)
                                  << u64(ob)).reshape(B, H, TF)
    sk = np.sort(np.where(conf < conf_size, key, uniq).reshape(-1))
    same = (sk[1:] >> u64(ob)) == (sk[:-1] >> u64(ob))
    o1 = (sk[1:] & u64((1 << ob) - 1)).astype(np.int64)
    o0 = (sk[:-1] & u64((1 << ob) - 1)).astype(np.int64)
    pair = same & (o1 != o0)
    cnt = np.zeros(B * B, np.int32)
    np.add.at(cnt, (np.maximum(o1, o0) * B + np.minimum(o1, o0))[pair], 1)
    return cnt.reshape(B, B)


@pytest.mark.parametrize("mode,over,window", [
    ("direct", {}, 0), ("compressed", {}, 0), ("direct", {}, 1),
    ("compressed", dict(insert_stride=2), 0), ("direct", {}, "repeats")])
def test_adjacency_matches_numpy(wave_reads, mode, over, window):
    """Windows of overlapping reads (the first), with 48 padding rows (the
    second), and of reads repeating one k-mer and copying each other."""
    d, path = wave_reads
    je, te = engines(d, path, f"adj_{mode}_{window}",
                     dict(over, mibf_mode=mode))
    state = port_state(je, te.compressed)
    if te.compressed:
        te.cstate = state
    else:
        te.state = state
    wins = windows(te, path)
    if window == "repeats":
        codes, lengths, full, T = wins[0]
        codes[1] = 0                          # a homopolymer read
        codes[2:6] = codes[6]                 # four copies of read 6
        codes[7, 1000:3000] = codes[8, 2000:4000]
    else:
        codes, lengths, full, T = wins[window]
    _, _, ranked, limit, _ = wave._filter_view(state, te.size)
    codes_t, _, _, grid_ins, _, _, _ = te._window_inputs(codes, lengths,
                                                         full, T)
    got = wave.wave_adjacency(te.wave_spec, grid_ins, codes_t, limit, ranked,
                              T)
    S, TL = te.params_ins.frame_stride, te.params.tile_length
    hh = np.asarray(jnthash.hash_positions(jnp.asarray(codes), je.fam_ins,
                                           T * TL))
    fp = (hh[:, :, ::S][:, :, : grid_ins.shape[2]]
          & np.uint64((1 << wave.FP_BITS) - 1)).astype(np.int64)
    want = np_adjacency(grid_ins.numpy(), fp, limit, ranked)
    np.testing.assert_array_equal(got.numpy(), want)
    if window == 0:
        assert (want >= wave.ADJ_MIN).sum() > 0
    if window == 1:
        assert not want[16:].any()        # padding rows share nothing
    if window == "repeats":
        assert (want[3:6, 2:5] > 1000).any()


@pytest.mark.parametrize("over", [dict(recheck="exact"),
                                  dict(debug=True)])
def test_gate_runs_the_scan(wave_reads, over, capsys):
    """wavefront=True under the exact policy, or with debug, runs the
    sequential scan in both packages: the port's files and rows equal its
    own run with wavefront=False and the JAX engine's."""
    d, path = wave_reads
    tag = "exact" if "recheck" in over else "debug"
    kw = dict(CFG, input=path, silver_path=True, **over)
    je = JEngine(JPathConfig(prefix_file=str(d / f"gj{tag}"), **kw))
    je.run()
    runs = {}
    for flag in (True, False):
        te = teng.GoldenPathEngine(PathConfig(
            prefix_file=str(d / f"gt{tag}{flag}"), **dict(kw, wavefront=flag)),
            device="cpu")
        te.run()
        assert not te.wave and te.wave_side is None
        runs[flag] = (path_files(str(d / f"gt{tag}{flag}"), True),
                      te.last_rows)
    assert not je._wave
    jfiles = path_files(str(d / f"gj{tag}"), True)
    assert runs[True][0] == runs[False][0] == jfiles and jfiles
    np.testing.assert_array_equal(runs[True][1], runs[False][1])
    np.testing.assert_array_equal(runs[True][1], np.asarray(je.last_rows))
    capsys.readouterr()


@pytest.mark.parametrize("mode", ["direct", "compressed"])
def test_wavefront_refuses_2_31_slots(mode):
    """The JAX wavefront's int32 slots and ranks wrap at 2^31 (ROADMAP
    queue 3): the port's wavefront refuses such filters before allocating
    them, and the scan (the exact policy) takes the compressed one."""
    kw = dict(CFG, hash_universe=230_000_000, mibf_mode=mode)
    with pytest.raises(NotImplementedError, match="2\\^31"):
        teng.GoldenPathEngine(PathConfig(**kw), device="cpu")
    if mode == "compressed":
        te = teng.GoldenPathEngine(PathConfig(**dict(kw, recheck="exact")),
                                   device="cpu")
        assert 1 << 31 <= te.size < 1 << 32 and not te.wave
