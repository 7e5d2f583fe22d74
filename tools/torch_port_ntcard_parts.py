"""Where an ntcard_count (K22) launch's time goes, on one GPU.

Builds variants of a tree's csrc/ntcard.cu (this checkout's, or with
--tree DIR another checkout's, such as the parent's from `git archive`)
into smoke_work/ntcard_parts/<variant>/ (one nvcc per variant, all at
once, `-Xptxas=-v` printing each one's registers), then calls the tree's
own Python wrapper with each variant's library in place of the built one,
on chip_smoke.py phase 8(a)'s first bench batch (16,780,000 bases of 20 kb
reads, the engine's family, rbits 22, sbits 7) and on a homopolymer batch
of the same shape (read i all base i % 4), every variant timed in turns
(each once, then again in the reverse order).  A variant keeps its work
alive by folding what it would have counted into one value that it stores
only if it equals a constant no input gives.  The shipped variant is held
to the plain version first.

    python3 tools/torch_port_ntcard_parts.py [--tree DIR]

It also prints, for the shipped variant: its theoretical occupancy
(cudaOccupancyMaxActiveBlocksPerMultiprocessor at the launch's shared
memory), the achieved one (a `stamps` variant records %globaltimer at each
CTA's start and end: the CTAs' summed time over the launch's span and the
SMs, in resident warps of 64), and the SASS of the kernel's loops
(`cuobjdump -sass`: each backward branch's body, its instructions and
shared-memory loads), from which the issued instructions per position are
counted by hand.

The variants are those of the source's design, whichever design's edits
all match the source once; otherwise the tool stops with the text it
missed.  The care design (one CTA per work item of 1,024 positions,
kernel A's staging and lookups from seed_hash.cuh, a lookup per care
offset):
  full    the kernel as shipped;
  codes   the CTA stages the table, the care offsets and the item's codes
          (and four right partials), then stops;
  stage   and every right partial: the whole of `stage`;
  left    and every position's left partials: no seed hashed;
  hash    and every seed's canonical hash and bank test: no atomic.
The block design (persistent CTAs, a warp per half item, block tables of
4 positions, packed codes):
  full    the kernel as shipped;
  tables  each CTA stages its copies of the tables, then stops;
  codes   and every warp packs its units' codes: nothing hashed;
  partial and every lane's left and right partials: no seed tested;
  hash    and every seed's bank test and the sampled hashes: no atomic;
  rep1    the kernel with one copy of the tables a CTA, not eight;
  bytes   the kernel packing the codes a byte load each, not from five
          aligned 4-byte loads a word;
  t512    the kernel with CTAs of 512 threads, not 1,024.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "smoke_work", "ntcard_parts")
MAGIC = "0x9E3779B97F4A7C15ull"
INT_OPS = ("LOP3", "SHF", "IADD3", "ISETP", "SEL", "PRMT", "IMNMX", "LEA",
           "FLO", "POPC")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-shared")

STAMP_DEF = (
    "__device__ unsigned long long gr_stamp_buf[3 * 65536];\n"
    "extern \"C\" int gr_stamps(unsigned long long* host, int n) {\n"
    "  return cudaMemcpyFromSymbol(host, gr_stamp_buf,\n"
    "                              sizeof(unsigned long long) * 3 * n);\n"
    "}\n")
STAMP_START = ("  unsigned long long t_start;\n"
               "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
               "\"=l\"(t_start));\n")
STAMP_END = ("  __syncthreads();\n  if (threadIdx.x == 0) {\n"
             "    unsigned long long t;\n    unsigned sm;\n"
             "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
             "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
             "    gr_stamp_buf[3 * blockIdx.x] = t_start;\n"
             "    gr_stamp_buf[3 * blockIdx.x + 1] = t;\n"
             "    gr_stamp_buf[3 * blockIdx.x + 2] = sm;\n  }\n")

# the care design: a lookup per care offset, one CTA per work item
C_INC = '#include "seed_hash.cuh"\n'
C_SMEM = "  extern __shared__ ulonglong2 smem[];\n"
C_STAGE = "  stage(f, codes + start, len, p0, m, 1, st);\n"
C_BANK = "  const int64_t bank_words = 2ll << rbits;\n"
C_LEFT = "    const ulonglong2 left = left_at(f, st, i);\n"
C_ATOMIC = ("      atomicAdd(counters + s * bank_words + (bank << rbits) + "
            "(hv & rmask),\n                w);\n")
C_END = "    }\n  }\n}\n\n}  // namespace gr\n"
C_ACC = (C_BANK, C_BANK + "  uint64_t acc = 0;\n")
C_FOLD = (C_END, "    }\n  }\n  if (acc == " + MAGIC + ") counters[0] = 1;\n"
          "}\n\n}  // namespace gr\n")
C_OCC = ("\nextern \"C\" int gr_occupancy(int threads, size_t smem, "
         "int* per_sm) {\n"
         "  const cudaError_t e = gr::allow_smem(gr::ntcard_count_kernel, "
         "smem);\n  if (e != cudaSuccess) return e;\n"
         "  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n"
         "      per_sm, gr::ntcard_count_kernel, threads, smem);\n}\n")
CARE = {
    "full": [],
    "codes": [(C_STAGE, "  stage(f, codes + start, len, p0, m, 1 << 30, "
                        "st);\n  if (st.right[0].x == " + MAGIC + ") "
                        "counters[0] = 1;\n  return;\n")],
    "stage": [(C_STAGE, C_STAGE + "  if (st.right[threadIdx.x % m].x == "
                                  + MAGIC + ") counters[0] = 1;\n"
                                  "  return;\n")],
    "left": [C_ACC, (C_LEFT, C_LEFT + "    acc ^= left.x ^ left.y;\n"
                                      "    continue;\n"), C_FOLD],
    "hash": [C_ACC, (C_ATOMIC, "      acc ^= hv + w + bank;\n"), C_FOLD],
    "stamps": [(C_INC, C_INC + STAMP_DEF), (C_SMEM, STAMP_START + C_SMEM),
               (C_END, "    }\n  }\n" + STAMP_END + "}\n\n}  // namespace "
                       "gr\n")],
}
CARE_ORDER = ("full", "codes", "stage", "left", "hash")

# the block design: block tables, persistent CTAs, a warp per half item
B_INC = '#include "common.cuh"\n'
B_TABLES = "  __syncthreads();\n  const int lane = threadIdx.x & 31;\n"
B_UNIT = "    // the unit's codes are staged: hash the lane's run\n"
B_PARTIAL = ("        const ulonglong2 left = block_xor<kRep, kNb>(l0, l1, "
             "tl);\n")
B_ATOMIC = ("        atomicAdd(a.counters + s * bank_words + (bank << "
            "a.rbits) +\n                      (hv & rmask), w);\n")
B_PACK = "        x = pack16(row + qb);\n"
B_END = "  }\n}\n\n// Shared-memory bytes"
B_ACC = (B_TABLES, B_TABLES + "  uint64_t acc = 0;\n")
B_FOLD = (B_END, "  }\n  if (acc == " + MAGIC + ") a.counters[0] = 1;\n"
          "}\n\n// Shared-memory bytes")
B_REP = "  if (nb == 3) return gr::ntcard_launch_h<8, 3>(a, stream);\n"
B_OCC = ("\nextern \"C\" int gr_occupancy(int threads, size_t smem, "
         "int* per_sm) {\n"
         "  const cudaError_t e = gr::allow_smem(gr::ntcard_block_kernel<8, "
         "4, 3>, smem);\n  if (e != cudaSuccess) return e;\n"
         "  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n"
         "      per_sm, gr::ntcard_block_kernel<8, 4, 3>, threads, smem);\n}\n")
BLOCK = {
    "full": [],
    "tables": [(B_TABLES, B_TABLES + "  if (threadIdx.x == 0 && "
                                     "tab[blockIdx.x % 256].x == " + MAGIC
                                     + ") a.counters[0] = 1;\n  return;\n")],
    "codes": [B_ACC, (B_UNIT, B_UNIT + "    acc ^= words[lane];\n"
                                       "    continue;\n"), B_FOLD],
    "partial": [B_ACC, (B_PARTIAL, B_PARTIAL + "      acc ^= left.x ^ "
                                               "ring[0].y;\n      continue;"
                                               "\n"), B_FOLD],
    "hash": [B_ACC, (B_ATOMIC, "        acc ^= hv + w + bank;\n"), B_FOLD],
    "bytes": [(B_PACK, "#pragma unroll\n        for (int t = 0; t < kNtRun; "
                       "++t) {\n          x |= (row[qb + t] & 3u) << (2 * "
                       "t);\n        }\n")],
    "rep1": [(B_REP, B_REP.replace("<8, 3>", "<1, 3>"))],
    "t512": [("  return kMaxH <= 4 ? 1024 : 512;", "  return 512;")],
    "stamps": [(B_INC, B_INC + STAMP_DEF),
               ("  const NtArgs a) {\n", "  const NtArgs a) {\n"
                + STAMP_START),
               (B_END, "  }\n" + STAMP_END + "}\n\n// Shared-memory bytes")],
}
BLOCK_ORDER = ("full", "tables", "codes", "partial", "hash", "rep1",
               "bytes", "t512")
DESIGNS = (("block", BLOCK, BLOCK_ORDER, B_OCC),
           ("care", CARE, CARE_ORDER, C_OCC))


def missing(src: str, edits):
    """The first edit's text that does not match the source once."""
    return next((old for old, _ in edits if src.count(old) != 1), None)


def patched(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"ntcard.cu: the source moved; no single match "
                             f"for {old!r}")
        src = src.replace(old, new, 1)
    return src


def design(src: str) -> tuple:
    for d in DESIGNS:
        if all(missing(src, e) is None for e in d[1].values()):
            return d
    old = missing(src, [e for edits in BLOCK.values() for e in edits])
    raise SystemExit(f"ntcard.cu: the source moved; no single match for "
                     f"{old!r}")


def build(csrc: str, variants: dict, occ: str) -> dict:
    """Compile every variant at once; returns name -> library path."""
    shutil.rmtree(OUT, ignore_errors=True)
    with open(os.path.join(csrc, "ntcard.cu")) as f:
        src = f.read()
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    procs, libs = {}, {}
    for name, edits in variants.items():
        d = os.path.join(OUT, name)
        os.makedirs(d)
        for h in os.listdir(csrc):
            if h.endswith(".cuh"):
                shutil.copy(os.path.join(csrc, h), d)
        with open(os.path.join(d, "ntcard.cu"), "w") as f:
            f.write(patched(src, edits) + (occ if name == "full" else ""))
        libs[name] = os.path.join(d, "libntcard.so")
        procs[name] = subprocess.Popen(
            [nvcc, "-Xptxas=-v", *FLAGS, os.path.join(d, "ntcard.cu"),
             "-o", libs[name]], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name}:\n{err}")
        lines = err.splitlines()
        regs = [f"{lines[i - 1].split('for')[-1].strip()} "
                f"{ln.split(': ', 1)[-1].strip()}"
                for i, ln in enumerate(lines) if "registers" in ln]
        print(f"[build] {name}: " + " | ".join(regs), flush=True)
    return libs


def sass_loops(lib: str) -> None:
    """Print each kernel function's loops (a backward branch and the
    instructions from its target to it) from cuobjdump's SASS."""
    exe = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                       "bin", "cuobjdump")
    r = subprocess.run([exe, "-sass", lib], capture_output=True, text=True,
                       timeout=300)
    fn, body = None, []
    funcs = {}
    for ln in r.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            funcs[fn] = body = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln)
        if fn and m:
            body.append((int(m.group(1), 16), m.group(2).strip()))
    for fn, ins in funcs.items():
        if "ntcard" not in fn:
            continue
        ops = [i for _, i in ins if not i.startswith("NOP")]
        print(f"[sass] function={fn} instructions={len(ops)} "
              f"lds={sum('LDS' in i for i in ops)} "
              f"atom={sum('ATOM' in i or 'RED' in i for i in ops)}")
        addr = [a for a, _ in ins]
        for a, i in ins:
            t = re.search(r"BRA[^;]*?0x([0-9a-f]+)", i)
            if not t or int(t.group(1), 16) >= a:
                continue
            target = int(t.group(1), 16)
            loop = [x for y, x in ins if target <= y <= a
                    and not x.startswith("NOP")]
            integer = sum(x.split()[-1 if x.startswith("@") else 0]
                          .startswith(INT_OPS) for x in loop
                          if x.split())
            print(f"[sass] loop {target:#x}-{a:#x} (instruction "
                  f"{addr.index(target) if target in addr else -1}): "
                  f"{len(loop)} instructions, "
                  f"{sum('LDS' in x for x in loop)} LDS, "
                  f"{sum('ATOM' in x or 'RED' in x for x in loop)} "
                  f"atomics, {integer} integer ALU")


class VariantLib:
    """A variant's library, bound as kernels.lib() binds the built one."""

    def __init__(self, path: str, argtypes):
        self.dll = ctypes.CDLL(path)
        self.gr_ntcard_count = self.dll.gr_ntcard_count
        self.gr_ntcard_count.argtypes = list(argtypes)
        self.gr_ntcard_count.restype = ctypes.c_int

    @staticmethod
    def gr_error_string(err: int) -> bytes:
        return f"cudaError {err}".encode()


def main(argv: list[str]) -> int:
    tree = REPO
    if argv[:1] == ["--tree"] and len(argv) == 2:
        tree = os.path.abspath(argv[1])
    elif argv:
        raise SystemExit(__doc__)
    csrc = os.path.join(tree, "goldrush_tpu_torch", "csrc")
    with open(os.path.join(csrc, "ntcard.cu")) as f:
        name, variants, order, occ = design(f.read())
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import chip_smoke as cs
    from goldrush_tpu_torch import kernels
    from goldrush_tpu_torch.ops.nthash import build_seed_family
    from goldrush_tpu_torch.ops.seeds import make_seed_pattern
    from goldrush_tpu_torch.utils import ntcard as nt
    if not torch.cuda.is_available():
        raise SystemExit("torch_port_ntcard_parts: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    print(f"[tree] {tree} design={name}", flush=True)
    libs = build(csrc, variants, occ)
    dev = torch.device("cuda", 0)
    fam = build_seed_family(make_seed_pattern(cs.PRESET, 22, 16, 3))
    rbits, sbits = 22, 7
    os.makedirs(OUT, exist_ok=True)
    fq = os.path.join(OUT, "bench_reads.fq")
    cs.make_reads(fq, **cs.BENCH)
    codes, offsets = next(iter(nt.read_batches(fq)))
    lens = np.diff(offsets)
    homo = np.repeat((np.arange(len(lens)) % 4).astype(np.uint8), lens)
    batches = {"bench": nt.pack_batch(codes, offsets, fam.k, dev),
               "homopolymer": nt.pack_batch(homo, offsets, fam.k, dev)}
    counters = torch.zeros((fam.h, 2 << rbits), dtype=torch.int32,
                           device=dev)
    argtypes = kernels._SIGNATURES["gr_ntcard_count"]
    bound = {v: VariantLib(p, argtypes) for v, p in libs.items()}

    def use(v):
        kernels._lib = bound[v]

    for tag, b in batches.items():
        use("full")
        counters.zero_()
        nt.ntcard_count(counters, b, fam, rbits, sbits)
        plain = torch.zeros_like(counters)
        nt._ntcard_count_plain(plain, b.codes, b.offsets, fam, rbits, sbits)
        same = torch.equal(counters, plain)
        print(f"[check] input={tag} items={b.item_read.numel()} "
              f"counted={int(plain.sum())} equal={same}", flush=True)
        if not same:
            raise SystemExit(f"the shipped kernel differs on {tag}")
        del plain
    times = {}
    for direction in (1, -1):
        for v in order[::direction]:
            use(v)
            for tag, b in batches.items():
                times.setdefault((v, tag), []).append(cs.cuda_ms(
                    lambda: nt.ntcard_count(counters, b, fam, rbits, sbits),
                    10))
    for (v, tag), ms in sorted(times.items(), key=lambda x: (
            x[0][1], order.index(x[0][0]))):
        print(f"[parts] input={tag} variant={v} ms="
              + ",".join(f"{t:.4f}" for t in ms))
    # occupancy: theoretical at the launch's shared memory, and achieved
    # from the stamps of the bench batch
    full = bound["full"].dll
    full.gr_occupancy.argtypes = [ctypes.c_int, ctypes.c_size_t,
                                  ctypes.POINTER(ctypes.c_int)]
    nc = len(fam.care_left) + len(fam.care_right)
    m = nt.CHUNK + fam.h - 1
    if name == "care":
        threads, smem = 256, 16 * (4 * nc + m) + 4 * nc + m + fam.pad_needed
    else:
        # the engine's family: 3 blocks a half, 8 copies, 1,024 threads
        # (csrc/ntcard.cu ntcard_smem_bytes)
        threads, smem = 1024, 16 * 2 * 3 * 256 * 8 + 4 * (1024 // 32) * 40
    per_sm = ctypes.c_int(0)
    err = full.gr_occupancy(threads, smem, ctypes.byref(per_sm))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[occupancy] threads={threads} smem={smem} err={err} "
          f"ctas_per_sm={per_sm.value} warps_per_sm="
          f"{per_sm.value * threads // 32} of 64 sms={sms}")
    stamps_lib = VariantLib(os.path.join(OUT, "stamps", "libntcard.so"),
                            argtypes)
    stamps_lib.dll.gr_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    kernels._lib = stamps_lib
    b = batches["bench"]
    grid = b.item_read.numel() if name == "care" else min(
        per_sm.value * sms, b.item_read.numel())
    for _ in range(3):
        nt.ntcard_count(counters, b, fam, rbits, sbits)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * (3 * grid))()
    stamps_lib.dll.gr_stamps(ctypes.cast(buf, ctypes.c_void_p), grid)
    st = np.frombuffer(buf, dtype=np.uint64).reshape(grid, 3).astype(
        np.float64)
    st = st[st[:, 1] > 0]
    span = st[:, 1].max() - st[:, 0].min()
    busy = (st[:, 1] - st[:, 0]).sum()
    ctas = busy / (span * sms)
    ends = np.sort(st[:, 1] - st[:, 0].min())
    print(f"[stamps] ctas={len(st)} span_us={span / 1e3:.2f} "
          f"resident_ctas_per_sm={ctas:.3f} achieved_warps_per_sm="
          f"{ctas * threads / 32:.2f} of 64 cta_us_median="
          f"{np.median(st[:, 1] - st[:, 0]) / 1e3:.2f} "
          f"first_end_us={ends[0] / 1e3:.2f} last_end_us="
          f"{ends[-1] / 1e3:.2f}")
    sass_loops(libs["full"])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
