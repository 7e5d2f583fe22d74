"""Where a consume batch's time goes inside the kernel, on one GPU.

Builds a copy of the port (into smoke_work/consume_parts/) whose consume
kernel reads %globaltimer at the steps of its per-read loop in CTA 0 (a
runner) and CTA 2 (a key owner that gathers tile 0), whose kernel C reads
clock64 between its passes on the runner, and whose kernel B tile code
reads clock64 between its steps in CTA 2, all summed over one launch.
Then, for bench.py's engine in exact mode and in the throughput cell
(direct filter, filled from chip_smoke.py's bench reads), it times one
batch of overlapping reads (500 bases apart) and one of bench reads
(chip_smoke.py's `bench_reads`, reads 200..) from the filled filter, and
prints per batch: the launch's ms, the scan's counters, the microseconds
each step took in each of the two CTAs, C's cycles per probe by pass and
B's cycles per probe by step.  The stamps themselves cost time: the
per-step split is for finding where the time goes, and chip_smoke.py's
phase 3 times the kernel as shipped.

    python3 tools/torch_port_consume_parts.py
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE = os.path.join(REPO, "smoke_work", "consume_parts")

# the per-read loop's steps, each stamped where it ends
STEPS = ("head", "dirty_barrier", "gather", "scatter", "gather_barrier",
         "classify", "owner_sort", "await", "insert", "tail", "c_stage",
         "c_masks", "c_passes")
C_PASSES = ("initial", "pass1", "pass2", "pass3_4", "pass5", "pass6",
            "pass7", "pass8_9", "pass10", "assigned", "longest_stretch",
            "flanks", "decision")
B_STEPS = ("zero", "gather_loop", "key_reduce", "candidates", "emit")


def patch(path: str, edits, head: str = "", after: str = "namespace gr {\n"
          ) -> str:
    """Apply (old, new) edits to a copied source; each must match once."""
    with open(path) as f:
        s = f.read()
    if head:
        s = s.replace(after, after + head, 1)
    for old, new in edits:
        if s.count(old) != 1:
            raise SystemExit(f"{os.path.basename(path)}: the source moved; "
                             f"no single match for {old!r}")
        s = s.replace(old, new, 1)
    with open(path, "w") as f:
        f.write(s)
    return s


def build_tree() -> None:
    shutil.rmtree(TREE, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, "goldrush_tpu_torch"),
                    os.path.join(TREE, "goldrush_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = os.path.join(TREE, "goldrush_tpu_torch", "csrc")
    step = {n: i for i, n in enumerate(STEPS)}

    def stamp(name):
        return f"STAMP({step[name]});\n"
    patch(os.path.join(csrc, "consume.cu"), [
        ("  for (int i = 0; i < a.B; ++i) {\n",
         "  if (threadIdx.x == 0 && (blockIdx.x == 0 || blockIdx.x == 2))\n"
         "    gr_tlast[blockIdx.x ? 1 : 0] = gtime();\n"
         "  for (int i = 0; i < a.B; ++i) {\n    " + stamp("head")),
        ("      if (dirty != kClean) grid.sync();\n"
         "      gather(a, tiers, live, rech, i);\n    }\n",
         "      if (dirty != kClean) grid.sync();\n      " +
         stamp("dirty_barrier") +
         "      gather(a, tiers, live, rech, i);\n      " + stamp("gather") +
         "      if (threadIdx.x == 0 && blockIdx.x == 0) gr_stamp[127] += 1;\n"
         "    }\n"),
        ("    if (probe || scatter) {\n      grid.sync();",
         "    " + stamp("scatter") +
         "    if (probe || scatter) {\n      grid.sync();"),
        ("    const int64_t seq = probe ? ++probes : 0;\n",
         "    " + stamp("gather_barrier") +
         "    const int64_t seq = probe ? ++probes : 0;\n"),
        ("    int n_own = 0;\n", "    " + stamp("classify") +
         "    int n_own = 0;\n"),
        ("    if (probe) {\n      if (threadIdx.x == 0) {\n",
         "    " + stamp("owner_sort") +
         "    if (probe) {\n      if (threadIdx.x == 0) {\n"),
        ("    if (scatter) ++scatters;\n", "    " + stamp("await") +
         "    if (scatter) ++scatters;\n"),
        ("    if (!done) {\n      ids_ins += blocks;",
         "    " + stamp("insert") + "    if (!done) {\n      ids_ins += blocks;"),
        ("    changed = changed || o.dec > 0;\n", "    " + stamp("tail") +
         "    changed = changed || o.dec > 0;\n"),
        ("    __syncthreads();\n    if (n <= 32) {\n",
         "    __syncthreads();\n    " + stamp("c_stage") +
         "    if (n <= 32) {\n"),
        ("      __syncthreads();\n    }\n    if (threadIdx.x < 32)\n"
         "      o = read_outcome<true>(",
         "      __syncthreads();\n    }\n    " + stamp("c_masks") +
         "    if (threadIdx.x < 32)\n      o = read_outcome<true>("),
        ("  if (threadIdx.x == 0) {\n    *sh = o;",
         "  " + stamp("c_passes") + "  if (threadIdx.x == 0) {\n    *sh = o;"),
        ('extern "C" {\n',
         'extern "C" {\n'
         "int gr_parts_read(void* s, void* c, void* b) {\n"
         "  cudaMemcpyFromSymbol(s, gr::gr_stamp, sizeof(gr::gr_stamp));\n"
         "  cudaMemcpyFromSymbol(c, gr::gr_cstamp, sizeof(gr::gr_cstamp));\n"
         "  return cudaMemcpyFromSymbol(b, gr::gr_bstamp,"
         " sizeof(gr::gr_bstamp));\n}\n"
         "int gr_parts_zero() {\n  static unsigned long long z[128] = {0};\n"
         "  cudaMemcpyToSymbol(gr::gr_cstamp, z, sizeof(gr::gr_cstamp));\n"
         "  cudaMemcpyToSymbol(gr::gr_bstamp, z, sizeof(gr::gr_bstamp));\n"
         "  return cudaMemcpyToSymbol(gr::gr_stamp, z, sizeof(z));\n}\n"),
    ], head=(
        "__device__ unsigned long long gr_stamp[128];\n"
        "__device__ unsigned long long gr_tlast[2];\n"
        "__device__ __forceinline__ unsigned long long gtime() {\n"
        "  unsigned long long t;\n"
        '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
        "  return t;\n}\n"
        "#define STAMP(k) do { if (threadIdx.x == 0 && "
        "(blockIdx.x == 0 || blockIdx.x == 2)) { \\\n"
        "  const int c_ = blockIdx.x ? 1 : 0; const unsigned long long n_ = "
        "gtime(); \\\n"
        "  gr_stamp[64 * c_ + (k)] += n_ - gr_tlast[c_]; gr_tlast[c_] = n_; "
        "} } while (0)\n"),
        after="namespace cg = cooperative_groups;\n\nnamespace gr {\n")
    edits = [("  const Read r{id, bv, cand_ids, cand_counts, sci, scc,",
              "  CSTAMP(0);\n  const Read r{id, bv, cand_ids, cand_counts, "
              "sci, scc,"),
             ("  const bool whole = n - na >= u_min && na <= a_max;",
              "  CSTAMP(13);\n  if (kStaged && lane == 0 && blockIdx.x == 0)\n"
              "    for (int k = 1; k < 14; ++k) gr_cstamp[k] += s_cst[k] - "
              "s_cst[k - 1];\n"
              "  const bool whole = n - na >= u_min && na <= a_max;"),
             ("  // find_longest_stretch (:195-233)",
              "  CSTAMP(10);\n  // find_longest_stretch (:195-233)"),
             ("  // eval_flanks (:341-527)", "  CSTAMP(11);\n"
              "  // eval_flanks (:341-527)"),
             ("  // decision (process_read :968-1081) and the rows",
              "  CSTAMP(12);\n  // decision (process_read :968-1081) and "
              "the rows")]
    edits += [(f"trace(r, ids_tr, bools_tr, {k});",
               f"trace(r, ids_tr, bools_tr, {k}); CSTAMP({k + 1});")
              for k in range(9)]
    patch(os.path.join(csrc, "classify.cuh"), edits, head=(
        "static __device__ long long gr_cstamp[32];\n"
        "static __shared__ long long s_cst[16];\n"
        "#define CSTAMP(k) do { if (kStaged && (threadIdx.x & 31) == 0 && "
        "blockIdx.x == 0) s_cst[(k)] = clock64(); } while (0)\n"))
    patch(os.path.join(csrc, "probe_vote.cuh"), [
        ("  const int FH = H * F;\n",
         "  const int FH = H * F;\n  long long b_last = clock64();\n"),
        ("  // 1-2. gather, gate, dedupe, count;",
         "  BSTAMP(0);\n  // 1-2. gather, gate, dedupe, count;"),
        ("  // 3. key every entry in place;",
         "  BSTAMP(1);\n  // 3. key every entry in place;"),
        ("  block_reduce5(v, red);\n", "  block_reduce5(v, red);\n"
         "  BSTAMP(2);\n"),
        ("  if (threadIdx.x == 0) {\n    const unsigned long long best = v[0];",
         "  BSTAMP(3);\n  if (threadIdx.x == 0) {\n"
         "    const unsigned long long best = v[0];"),
        ("      atomicAdd(misses + b, v[4]);\n    }\n  }\n}",
         "      atomicAdd(misses + b, v[4]);\n    }\n  }\n  BSTAMP(4);\n}"),
    ], head=(
        "static __device__ long long gr_bstamp[16];\n"
        "#define BSTAMP(k) do { if (kFused && threadIdx.x == 0 && "
        "blockIdx.x == 2) { \\\n"
        "  const long long n_ = clock64(); gr_bstamp[(k)] += n_ - b_last; "
        "b_last = n_; } } while (0)\n"))


def main() -> int:
    build_tree()
    sys.path.insert(0, TREE)
    sys.path.insert(1, REPO)
    import numpy as np
    import torch
    import chip_smoke as cs
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.config import PathConfig
    from goldrush_tpu_torch.mibf import mibf as dm
    from goldrush_tpu_torch.path import consume as tcons
    from goldrush_tpu_torch.path.engine import GoldenPathEngine
    if not torch.cuda.is_available():
        raise SystemExit("torch_port_consume_parts: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    dev = torch.device("cuda", 0)
    dll = kernels.lib()
    dll.gr_parts_read.argtypes = [ctypes.c_void_p] * 3
    genome, reads = cs.bench_reads(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    L, T = cs.BENCH["read_len"], 20
    overlap = cs.sample_reads(genome, (1_000_000 + 500 * torch.arange(
        64, device=dev))[:, None], g)
    for cell in ("exact", "throughput"):
        extra = cs.THROUGHPUT if cell == "throughput" else {}
        te = GoldenPathEngine(PathConfig(**cs.BENCH_ENGINE, **extra),
                              device=dev)
        B = te.batch_reads
        bits = dm.presence_bitmap(te.size, dev)
        for c, n in cs.fill_pass_batches(dev, torch.cat([reads, overlap])):
            dm.fill_presence_bits(bits, c, n, te.fam_ins, te.size,
                                  te.cfg.slot_map)
        dm.merge_presence(te.state.words, bits, te.size, first_write=True)
        del bits
        filt = te.state
        saved = [t.clone() for t in filt]
        for name, rd in (("overlap", overlap), ("bench", reads[200:])):
            codes = np.zeros((B, (T + 1) * te.cfg.tile_length), np.uint8)
            codes[:, :L] = rd[:B].cpu().numpy()
            for t, v in zip(filt, saved):
                t.copy_(v)
            inputs = te._batch_inputs(codes, np.full(B, L, np.int32),
                                      np.full(B, L, np.int64), T)
            rows = torch.empty((B, 8), dtype=torch.int64, device=dev)
            sc = tcons.ConsumeScratch()
            for timed in (False, True):          # a warm-up, then the run
                for t, v in zip(filt, saved):
                    t.copy_(v)
                scal = torch.tensor([0, 0, 1, 0], dtype=torch.int64,
                                    device=dev)
                ck = tcons.new_counters(dev)
                dll.gr_parts_zero()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(1_000_000)
                start.record()
                tcons.consume_batch(te.spec, filt, *inputs, scal, rows, ck,
                                    T, scratch=sc)
                stop.record()
                torch.cuda.synchronize()
            st = (ctypes.c_uint64 * 128)()
            cy = (ctypes.c_int64 * 32)()
            bt = (ctypes.c_int64 * 16)()
            dll.gr_parts_read(ctypes.cast(st, ctypes.c_void_p),
                              ctypes.cast(cy, ctypes.c_void_p),
                              ctypes.cast(bt, ctypes.c_void_p))
            probes = max(int(st[127]), 1)
            print(f"[parts] cell={cell} batch={name} "
                  f"ms={start.elapsed_time(stop):.4f} "
                  f"counters={ck.tolist()} probes={st[127]}")
            for k, cta in ((0, "runner CTA 0"), (64, "owner CTA 2")):
                print(f"  {cta} us: " + " ".join(
                    f"{n}={st[k + i] / 1e3:.1f}" for i, n in
                    enumerate(STEPS)))
            print("  C cycles per probe: " + " ".join(
                f"{n}={cy[i + 1] / probes:.0f}"
                for i, n in enumerate(C_PASSES)))
            print("  B cycles per probe (CTA 2): " + " ".join(
                f"{n}={bt[i] / probes:.0f}" for i, n in enumerate(B_STEPS)))
        del te, filt, saved
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
