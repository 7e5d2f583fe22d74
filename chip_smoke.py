#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (goldrush_tpu_torch) on one GPU.

    python3 chip_smoke.py                 # one card

Phases (one line each; any failure raises, so the exit code is non-zero):
  1. device: require CUDA; print the card and its power limit;
  2. build: compile the kernels of goldrush_tpu_torch/csrc with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the slice's shapes (B=32 reads, T=20 tiles of 1000, h=3, K=32, a
     142,368,384-slot filter filled from seeded reads, then frozen into
     the rank-compressed filter; B=1 for the live re-probe), bit for bit
     (every output is an integer), with both times;
  4. end to end: goldrush-path (silver M=5, then golden) through the CLI
     entry point on 3,000 x 20 kb reads of a 5 Mbp genome at 5% error
     (bench.py's dataset, seeds 11/12), once with the direct filter and
     once with the rank-compressed one; every kernel must have launched,
     recruits > 0, each completed silver path > r*G bases;
  5. digests: the port's silver paths on the 1 Mbp quality-gate dataset,
     with either filter, must match tests/fixtures/torch_port_digests.json
     (written by the JAX package on the CPU).
The line before the last is the per-kernel JSON record, the last line
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "smoke_work")
PRESET = "1011011110110111101101"
BENCH = dict(genome=5_000_000, genome_seed=11, n_reads=3_000,
             read_len=20_000, reads_seed=12, err_rate=0.05)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call between CUDA events, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(pairs) -> int:
    """Largest |a - b| over pairs of integer tensors (exactness check)."""
    worst = 0
    for a, b in pairs:
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs "
                                 f"{b.shape} {b.dtype}")
        d = (a.long() - b.long()).abs().max().item() if a.numel() else 0
        worst = max(worst, int(d))
    return worst


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda is not available")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        count=torch.cuda.device_count())
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    return name


def phase_build():
    from goldrush_tpu_torch import kernels
    t0 = time.time()
    so = kernels.build(verbose=True)
    kernels.lib()
    say("build", seconds=f"{time.time() - t0:.2f}",
        library=os.path.relpath(so, REPO))


def phase_kernels() -> dict:
    """Each kernel vs its plain version at the slice's shapes."""
    import numpy as np
    import torch
    from goldrush_tpu_torch.config import calc_optimal_size
    from goldrush_tpu_torch.io.fastq import encode
    from goldrush_tpu_torch.mibf import compressed as cz
    from goldrush_tpu_torch.mibf import mibf as dm
    from goldrush_tpu_torch.ops.nthash import build_seed_family
    from goldrush_tpu_torch.ops.seeds import make_seed_pattern
    from goldrush_tpu_torch.path import classify as clf
    from goldrush_tpu_torch.utils import synth

    dev = torch.device("cuda", 0)
    fam = build_seed_family(make_seed_pattern(PRESET, 22, 16, 3))
    size = calc_optimal_size(15_000_000, 1, 0.1)      # G = 5 Mbp universe
    B, T, TL, K = 32, 20, 1000, 32
    params = dm.MibfParams(size=size, h=3, k=22, spans=fam.spans,
                           tile_length=TL, threshold=10, block_size=10,
                           vote_topk=K, vote_min=2)
    genome = synth.random_genome(400_000, seed=7)   # ~3x coverage
    reads = synth.simulate_reads(genome, 64, 20_000, seed=8, err_rate=0.05)
    out = {}

    # --- A, fill entry: 64 reads x 32,768 positions ---------------------
    Lb = 32_768
    codes = np.zeros((64, Lb), np.uint8)
    lengths = np.zeros(64, np.int32)
    for i, (_, seq, _) in enumerate(reads):
        codes[i, :len(seq)] = encode(seq)
        lengths[i] = len(seq)
    codes_d = torch.from_numpy(codes).to(dev)
    lengths_d = torch.from_numpy(lengths).to(dev)
    st_k = dm.init_state(params, dev)
    st_p = dm.init_state(params, dev)
    dm.fill_presence(st_k.words, codes_d, lengths_d, fam, size, "fastrange")
    dm._fill_presence_plain(st_p.words, codes_d, lengths_d, fam, size,
                            "fastrange")
    err = max_abs_err([(st_k.words, st_p.words)])
    ms = cuda_ms(lambda: dm.fill_presence(
        st_k.words, codes_d, lengths_d, fam, size, "fastrange"), 20)
    pms = cuda_ms(lambda: dm._fill_presence_plain(
        st_p.words, codes_d, lengths_d, fam, size, "fastrange"), 3)
    out["seed_hash_fill"] = (err, ms, pms)
    present = int((st_k.words != 0).sum())
    say("kernels", kernel="seed_hash_fill", shape="64x32768x3",
        present_slots=present, max_abs_err=err, ms=f"{ms:.4f}",
        plain_ms=f"{pms:.4f}")

    # --- A, grid entry: B=32, T=20 ---------------------------------------
    qc = torch.from_numpy(codes[:B, : T * TL + TL].copy()).to(dev)
    ql = torch.from_numpy(lengths[:B].copy()).to(dev)
    slots, ok = dm.build_slot_grid(qc, ql, fam, params, T)
    ps, pok = dm.build_slot_grid(qc.cpu(), ql.cpu(), fam, params, T)
    ps_d, pok_d = ps.to(dev), pok.to(dev)
    err = max_abs_err([(slots, ps_d), (ok, pok_d)])
    ms = cuda_ms(lambda: dm.build_slot_grid(qc, ql, fam, params, T), 20)

    def plain_grid():
        from goldrush_tpu_torch.ops.nthash import hash_positions
        return dm.tile_slot_grid(hash_positions(qc, fam, T * TL), ql,
                                 params, T)
    pg = plain_grid()
    err = max(err, max_abs_err([(pg[0], slots), (pg[1], ok)]))
    pms = cuda_ms(plain_grid, 3)
    out["seed_hash_grid"] = (err, ms, pms)
    say("kernels", kernel="seed_hash_grid", shape=f"{B}x3x{T * TL}",
        max_abs_err=err, ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}")

    # --- D: insert 8 recruits (whole, trimmed, repeated slots) ----------
    plan = [(0, T - 1, 1, False), (0, T - 1, 3, False), (3, 14, 5, True),
            (0, T - 1, 7, False), (5, 5, 9, True), (0, T - 1, 11, False),
            (2, 17, 13, True), (0, T - 1, 15, False)]
    for i, (lo, hi, base, tr) in enumerate(plan):
        dm.insert_read_sorted(st_k, slots[i], lo, hi, base, tr, params, T)
        dm._insert_plain(st_p.words, st_p.counts, slots[i], lo, hi, base, tr,
                         params, T, size, dm.PRESENT_BIT)
    err = max_abs_err([(st_k.words, st_p.words), (st_k.counts, st_p.counts)])
    scratch_k = dm.MibfState(st_k.words.clone(), st_k.counts.clone())
    scratch_p = dm.MibfState(st_k.words.clone(), st_k.counts.clone())
    ms = cuda_ms(lambda: dm.insert_read_sorted(
        scratch_k, slots[8], 0, T - 1, 17, False, params, T), 20)
    pms = cuda_ms(lambda: dm._insert_plain(
        scratch_p.words, scratch_p.counts, slots[8], 0, T - 1, 17, False,
        params, T, size, dm.PRESENT_BIT), 3)
    del scratch_k, scratch_p
    out["insert_sorted"] = (err, ms, pms)
    say("kernels", kernel="insert_sorted", recruits=len(plan),
        max_abs_err=err, ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}")

    # --- B: probe + vote, B=32 and the B=1 live re-probe ----------------
    vk = dm.probe_and_vote(st_k.words, slots, ok, params, T)
    vp = dm._probe_and_vote_plain(st_k.words, slots, ok, params, T)
    err = max_abs_err(zip(vk, vp))
    v1k = dm.probe_and_vote(st_k.words, slots[9:10], ok[9:10], params, T)
    v1p = dm._probe_and_vote_plain(st_k.words, slots[9:10], ok[9:10],
                                   params, T)
    err = max(err, max_abs_err(zip(v1k, v1p)))
    ms = cuda_ms(lambda: dm.probe_and_vote(st_k.words, slots, ok, params, T),
                 20)
    pms = cuda_ms(lambda: dm._probe_and_vote_plain(st_k.words, slots, ok,
                                                   params, T), 3)
    ms1 = cuda_ms(lambda: dm.probe_and_vote(
        st_k.words, slots[9:10], ok[9:10], params, T), 20)
    pms1 = cuda_ms(lambda: dm._probe_and_vote_plain(
        st_k.words, slots[9:10], ok[9:10], params, T), 3)
    out["probe_vote"] = (err, ms, pms)
    voted = int((vk.top_count > 0).sum())
    say("kernels", kernel="probe_vote", shape=f"{B}x{T}x{K}",
        tiles_with_votes=voted, max_abs_err=err, ms=f"{ms:.4f}",
        plain_ms=f"{pms:.4f}", ms_b1=f"{ms1:.4f}", plain_ms_b1=f"{pms1:.4f}")

    # --- C: classify with debug traces ----------------------------------
    n_t = (ql // TL).int()
    ck = clf.classify_batch(vk.curr_id, vk.top_count, vk.cand_ids,
                            vk.cand_counts, n_t, 10, 5, 1, debug=True)
    cp = clf._classify_plain(vk.curr_id, vk.cand_ids, vk.cand_counts, n_t,
                             10, 5, 1, True)
    err = max_abs_err(list(zip(ck[0], cp[0])) + [(ck[1], cp[1]),
                                                 (ck[2], cp[2])])
    ms = cuda_ms(lambda: clf.classify_batch(
        vk.curr_id, vk.top_count, vk.cand_ids, vk.cand_counts, n_t, 10, 5, 1),
        20)
    pms = cuda_ms(lambda: clf._classify_plain(
        vk.curr_id, vk.cand_ids, vk.cand_counts, n_t, 10, 5, 1, False), 3)
    out["classify"] = (err, ms, pms)
    decisions = np.bincount(ck[0].decision.cpu().numpy(), minlength=3)
    say("kernels", kernel="classify", shape=f"{B}x{T}x{K}",
        decisions=decisions.tolist(), max_abs_err=err, ms=f"{ms:.4f}",
        plain_ms=f"{pms:.4f}")
    # --- the rank-compressed filter: freeze, lookup, D and B on ranks ----
    bk, tk = cz.rank_pack(st_k.words, size)
    bp, tp = cz._rank_pack_plain(st_k.words, size)
    err = max_abs_err([(bk, bp), (tk, tp)])
    ms = cuda_ms(lambda: cz.rank_pack(st_k.words, size), 20)
    pms = cuda_ms(lambda: cz._rank_pack_plain(st_k.words, size), 3)
    out["rank_pack"] = (err, ms, pms)
    say("kernels", kernel="rank_pack", slots=size, max_abs_err=err,
        ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}")
    # timed on a scratch copy: each call adds its carry again
    scratch = bk.clone()
    pop = cz.rank_carry(bk, tk)
    pop_p = int(cz._rank_carry_plain(bp, tp))
    err = max(max_abs_err([(bk, bp)]), abs(pop - pop_p))
    ms = cuda_ms(lambda: cz._rank_carry_cuda(scratch, tk), 20)
    pms = cuda_ms(lambda: cz._rank_carry_plain(scratch, tk), 3)
    out["rank_carry"] = (err, ms, pms)
    say("kernels", kernel="rank_carry", present=pop, max_abs_err=err,
        ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}")
    del scratch, bp, tp
    cs_k = cz.freeze(st_k.words, size)
    if max_abs_err([(cs_k.bitrank, bk)]) != 0:
        raise AssertionError("freeze differs from rank_pack + rank_carry")
    ranks = cz.rank_grid(cs_k, slots, size)
    err = max_abs_err([(ranks, cz._rank_grid_plain(cs_k, slots, size))])
    ms = cuda_ms(lambda: cz.rank_grid(cs_k, slots, size), 20)
    pms = cuda_ms(lambda: cz._rank_grid_plain(cs_k, slots, size), 3)
    out["rank_lookup"] = (err, ms, pms)
    ranked = int((ranks < cs_k.sentinel).sum())
    say("kernels", kernel="rank_lookup", shape=f"{B}x3x{T * TL}",
        present=ranked, max_abs_err=err, ms=f"{ms:.4f}",
        plain_ms=f"{pms:.4f}")
    cs_p = cz.CompressedState(cs_k.bitrank, cs_k.supers, cs_k.ids.clone(),
                              cs_k.counts.clone())
    for i, (lo, hi, base, tr) in enumerate(plan):
        cz.insert_read_sorted(cs_k, ranks[i], lo, hi, base, tr, params, T)
        dm._insert_plain(cs_p.ids, cs_p.counts, ranks[i], lo, hi, base, tr,
                         params, T, cs_p.sentinel, 0)
    err = max_abs_err([(cs_k.ids, cs_p.ids), (cs_k.counts, cs_p.counts)])
    vk = cz.probe_and_vote(cs_k, ranks, ok, params, T)
    vp = dm._probe_and_vote_plain(cs_k.ids, ranks, ok, params, T, True)
    v1k = cz.probe_and_vote(cs_k, ranks[9:10], ok[9:10], params, T)
    v1p = dm._probe_and_vote_plain(cs_k.ids, ranks[9:10], ok[9:10], params,
                                   T, True)
    err_b = max_abs_err(list(zip(vk, vp)) + list(zip(v1k, v1p)))
    ms = cuda_ms(lambda: cz.probe_and_vote(cs_k, ranks, ok, params, T), 20)
    pms = cuda_ms(lambda: dm._probe_and_vote_plain(cs_k.ids, ranks, ok,
                                                   params, T, True), 3)
    say("kernels", kernel="probe_vote", filter="compressed",
        tiles_with_votes=int((vk.top_count > 0).sum()), max_abs_err=err_b,
        ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}")
    say("kernels", kernel="insert_sorted", filter="compressed",
        recruits=len(plan), max_abs_err=err)
    out["insert_sorted"] = (max(out["insert_sorted"][0], err),
                            *out["insert_sorted"][1:])
    out["probe_vote"] = (max(out["probe_vote"][0], err_b),
                         *out["probe_vote"][1:])
    del cs_k, cs_p
    bad = {k: v[0] for k, v in out.items() if v[0] != 0}
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    if present == 0 or voted == 0 or decisions.sum() != B or ranked == 0:
        raise AssertionError("kernel check inputs are degenerate")
    del st_k, st_p
    torch.cuda.empty_cache()
    return out


def make_reads(path: str, genome: int, genome_seed: int, n_reads: int,
               read_len: int, reads_seed: int, err_rate: float,
               indel_frac: float = 0.0) -> None:
    from goldrush_tpu_torch.utils import synth
    g = synth.random_genome(genome, seed=genome_seed)
    reads = synth.simulate_reads(g, n_reads, read_len, seed=reads_seed,
                                 err_rate=err_rate, indel_frac=indel_frac)
    synth.write_fastq(path, reads)


def phase_e2e() -> dict:
    """goldrush-path through the CLI entry point at the bench scale, with
    the direct and then the rank-compressed filter; every kernel's launch
    count is read after both."""
    import torch
    from goldrush_tpu_torch import cli, kernels
    from goldrush_tpu_torch.io import fastq
    t0 = time.time()
    reads = os.path.join(WORK, "bench_reads")
    make_reads(reads + ".fq", **BENCH)
    say("e2e", dataset="5Mbp/3000x20kb/5%err",
        synth_s=f"{time.time() - t0:.1f}")
    for k in kernels.ALL:
        k.launches = 0
    for mode in ("direct", "compressed"):
        outdir = os.path.join(WORK, f"bench_{mode}")
        argv = ["goldrush-path", f"reads={reads}", "G=5000000",
                "device=cuda", f"mibf_mode={mode}", f"prefix={outdir}",
                "dev=1"]
        cmd, cfg, extra = cli.parse_args(argv)
        torch.cuda.reset_peak_memory_stats()
        t1 = time.time()
        out = cli.run(cmd, cfg, extra)
        wall = time.time() - t1
        peak = torch.cuda.max_memory_allocated()
        for stage, st in out["stats"].items():
            rate = st.num_reads / max(st.wall_assign_s, 1e-9)
            say("e2e", filter=mode, stage=stage,
                fill_s=f"{st.wall_fill_s:.3f}",
                assign_s=f"{st.wall_assign_s:.3f}",
                submit_s=f"{st.wall_submit_s:.3f}",
                replay_s=f"{st.wall_replay_s:.3f}",
                reads=st.num_reads, recruits=st.recruits,
                reads_per_s=f"{rate:.2f}",
                paths_completed=st.paths_completed)
        silver = out["stats"]["silver"]
        if silver.recruits <= 0 or out["stats"]["golden"].recruits <= 0:
            raise AssertionError(f"{mode}: no recruits")
        target = cfg.r * cfg.G
        for i in range(1, silver.paths_completed + 1):
            p = os.path.join(outdir, f"{cfg.silver_prefix()}_{i}.fq")
            bases = sum(len(r.seq) for r in fastq.read_records(p))
            if bases <= target:
                raise AssertionError(f"{mode} silver path {i}: {bases} <= "
                                     f"r*G {target}")
        golden = sum(len(r.seq) for r in fastq.read_records(
            os.path.join(outdir, out["golden"])))
        if golden <= 0:
            raise AssertionError(f"{mode}: empty golden path")
        say("e2e", filter=mode, wall_s=f"{wall:.2f}",
            max_memory_allocated=peak,
            silver_paths_ok=silver.paths_completed, golden_bases=golden)
    launches = {k.name: k.launches for k in kernels.ALL}
    say("e2e", launches=json.dumps(launches).replace(" ", ""))
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    return launches


def phase_digests() -> None:
    """Silver digests of the port on the card vs the JAX package's."""
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.path.engine import GoldenPathEngine
    with open(os.path.join(REPO, "tests", "fixtures",
                           "torch_port_digests.json")) as f:
        fx = json.load(f)
    ds = {k: v for k, v in fx["dataset"].items() if k != "sha256"}
    fq = os.path.join(WORK, "qgate.fq")
    make_reads(fq, **ds)
    if sha256_file(fq) != fx["dataset"]["sha256"]:
        raise AssertionError("synth did not regenerate the gate dataset")
    for mode in ("direct", "compressed"):
        want = fx if mode == "direct" else fx[mode]
        prefix = os.path.join(WORK, f"qgate_{mode}")
        t0 = time.time()
        st = GoldenPathEngine(PathConfig(input=fq, prefix_file=prefix,
                                         mibf_mode=mode, **fx["engine"]),
                              device="cuda").run()
        got = {str(i): sha256_file(f"{prefix}_{i}.fq")
               for i in range(1, fx["engine"]["max_paths"] + 1)
               if os.path.exists(f"{prefix}_{i}.fq")}
        say("digests", filter=mode, files=len(got), recruits=st.recruits,
            seconds=f"{time.time() - t0:.1f}", match=got == want["silver"])
        if got != want["silver"]:
            raise AssertionError(f"{mode} silver digests differ: {got} vs "
                                 f"{want['silver']}")


def main() -> int:
    # the port must come from this checkout, never from an installed copy
    if not os.path.isdir(os.path.join(REPO, "goldrush_tpu_torch", "csrc")):
        raise SystemExit(f"chip_smoke: no goldrush_tpu_torch checkout beside "
                         f"{os.path.basename(__file__)}")
    sys.path.insert(0, REPO)
    from goldrush_tpu_torch import kernels
    name = phase_device()
    import torch
    phase_build()
    checks = phase_kernels()
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        launches = phase_e2e()
        phase_digests()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    record = [dict(name=k.name, route="cuda", source=k.source,
                   replaces=k.replaces, launches=launches[k.name],
                   max_abs_err=checks[k.name][0], ms=checks[k.name][1],
                   plain_ms=checks[k.name][2]) for k in kernels.ALL]
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
