"""PyTorch port, tile classifier: the 1200 reference-generated fixtures and
random vote tables give goldrush_tpu's decisions, trims, smoothed vectors
and per-pass debug traces exactly."""

import json

import jax
import numpy as np
import pytest
import torch

import tests.conftest  # noqa: F401
from goldrush_tpu_torch import hard_cases as hard
from tests.conftest import FIXTURES
from goldrush_tpu.path import oracle
from goldrush_tpu.path.classify import classify_batch as jclassify

from goldrush_tpu_torch.path.classify import classify_batch, row_cummax

THRESHOLD, U_MIN, A_MAX = 10, 5, 1


def fixture_batch(cases, T, K=8):
    B = len(cases)
    curr_id = np.zeros((B, T), np.int32)
    cand_ids = np.zeros((B, T, K), np.int32)
    cand_counts = np.zeros((B, T, K), np.int32)
    n = np.zeros(B, np.int32)
    for b, c in enumerate(cases):
        n[b] = len(c["id_vec"])
        curr_id[b, :n[b]] = c["id_vec"]
        for t, lst in enumerate(c["all_id"]):
            for j, (i, cnt) in enumerate(lst):
                cand_ids[b, t, j], cand_counts[b, t, j] = i, cnt
    return curr_id, cand_ids, cand_counts, n


@pytest.mark.parametrize("group", ["short", "long"])
def test_classifier_matches_fixtures(group):
    cases = json.load(open(FIXTURES / "classify_fixtures.json"))
    cs = [c for c in cases if (len(c["id_vec"]) <= 16) == (group == "short")]
    T = 16 if group == "short" else 160
    curr_id, ci, cc, n = fixture_batch(cs, T)
    res = classify_batch(*(torch.from_numpy(a) for a in
                           (curr_id, np.zeros_like(curr_id), ci, cc, n)),
                         THRESHOLD, U_MIN, A_MAX)
    DEC = {"drop": 0, "whole": 1, "trimmed": 2}
    for b, c in enumerate(cs):
        id_vec = list(c["id_vec"])
        want = oracle.classify_read(
            [[tuple(p) for p in tile] for tile in c["all_id"]], id_vec,
            [0] * len(id_vec), THRESHOLD, U_MIN, A_MAX)
        nt = len(c["id_vec"])
        assert res.ids[b, :nt].tolist() == want["id_vec"], b
        assert res.bools[b, :nt].tolist() == want["bool_vec"], b
        assert int(res.num_assigned[b]) == want["num_assigned"], b
        assert int(res.decision[b]) == DEC[want["decision"]], b
        if want["decision"] == "trimmed":
            assert (int(res.trim_start[b]), int(res.trim_end[b])) == \
                want["trim"], b


def random_tables(rng, B, T, K, n_ids):
    """Vote tables shaped like probe_and_vote's: candidates with count > 2
    sorted by (count desc, id asc), zero padding, curr_id the top id."""
    curr_id = np.zeros((B, T), np.int32)
    ci = np.zeros((B, T, K), np.int32)
    cc = np.zeros((B, T, K), np.int32)
    for b in range(B):
        for t in range(T):
            m = int(rng.integers(0, K + 1))
            ids = rng.choice(np.arange(1, n_ids + 1), size=min(m, n_ids),
                             replace=False)
            counts = rng.integers(3, 40, len(ids))
            order = np.lexsort((ids, -counts))
            ci[b, t, :len(ids)] = ids[order]
            cc[b, t, :len(ids)] = counts[order]
            curr_id[b, t] = ci[b, t, 0] if len(ids) else \
                int(rng.integers(0, n_ids + 1))
    lengths = [0, 1, 2, 3, 4, 5, 14, 15, 16, 20]
    n = np.array([lengths[b % len(lengths)] if b < 2 * len(lengths)
                  else rng.integers(0, T + 1) for b in range(B)], np.int32)
    n = np.minimum(n, T)
    return curr_id, ci, cc, n


@pytest.mark.parametrize("seed,n_ids,K", [(0, 3, 4), (1, 6, 8), (2, 12, 8),
                                          (3, 40, 32)])
def test_classifier_matches_jax_on_random_tables(seed, n_ids, K):
    rng = np.random.default_rng(seed)
    T = 20
    curr_id, ci, cc, n = random_tables(rng, 96, T, K, n_ids)
    top = np.zeros_like(curr_id)
    jr, jids, jbools = jclassify(curr_id, top, ci, cc, n, THRESHOLD, U_MIN,
                                 A_MAX, debug=True)
    tr, tids, tbools = classify_batch(
        *(torch.from_numpy(a) for a in (curr_id, top, ci, cc, n)),
        THRESHOLD, U_MIN, A_MAX, debug=True)
    for name in tr._fields:
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(getattr(jr, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tbools.numpy(), np.asarray(jbools))
    assert set(np.unique(tr.decision.numpy())) == {0, 1, 2}


def assert_matches_jax(curr_id, top, ci, cc, n):
    jr, jids, jbools = jclassify(curr_id, top, ci, cc, n, THRESHOLD, U_MIN,
                                 A_MAX, debug=True)
    tr, tids, tbools = classify_batch(
        *(torch.from_numpy(a) for a in (curr_id, top, ci, cc, n)),
        THRESHOLD, U_MIN, A_MAX, debug=True)
    for name in tr._fields:
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(getattr(jr, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tbools.numpy(), np.asarray(jbools))
    return tr


@pytest.mark.parametrize("n", [1, 2, 3, 14, 15, 16])
def test_classifier_read_lengths_match_jax(n):
    """Reads of n tiles in a 20-tile bucket, at the branches kernel C keeps
    exact: no smoothing below 3 tiles, whole-flank evaluation below 15,
    5-tile windows from 15 on, the end-tile fix, short runs."""
    tr = assert_matches_jax(*hard.classify_case([n] * 24, 20, 8, seed=n))
    assert bool((tr.num_assigned <= n).all())
    if n >= 14:
        assert set(tr.decision.tolist()) >= {0, 2}


def test_classifier_long_bucket_matches_jax():
    """A 2,048-tile bucket (the engine's largest) holding a full read, a
    short one, a 1,500-tile one and an empty one."""
    tr = assert_matches_jax(*hard.classify_case([2048, 5, 1500, 0], 2048, 8,
                                                seed=5))
    assert int(tr.num_assigned[0]) > 1000 and int(tr.num_assigned[3]) == 0


@pytest.mark.parametrize("R,T", [(32, 20), (1, 20), (4, 2048)])
def test_row_cummax_matches_jax(R, T):
    """The running max that kernel C's passes 5 and 10 take their run
    starts from, against jax.lax.cummax, on rows of run starts and on rows
    of any int32."""
    rng = np.random.default_rng(T)
    bv = rng.random((R, T)) < 0.6
    starts = np.where(bv & ~np.roll(bv, 1, axis=1), np.arange(T), 0)
    for x in (starts.astype(np.int32),
              rng.integers(-2**31, 2**31, (R, T)).astype(np.int32)):
        np.testing.assert_array_equal(
            row_cummax(torch.from_numpy(x)).numpy(),
            np.asarray(jax.lax.cummax(x, axis=1)))
