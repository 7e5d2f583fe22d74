"""The in-order consume scan of one batch (K9), with the trim recheck's zone
predicate (K18) and the silver rotation's reset (K10/K19) inside it.

The counterpart of the ``consume`` closure of the JAX engine
(goldrush_tpu/path/engine.py:700-1026), after its batched probe and
classify: the batch's reads are taken in order against the live filter.  A
read whose batch-time verdict may be stale re-probes (the exact policy:
every read after an in-batch change; the optimistic policy: candidates
after a change, and every read after a silver reset), a read in the
boundary zone re-classifies at full resolution with the exact gates (trim
recheck), a recruit inserts its blocks (the reservoir rule, or max id wins
under the optimistic policy) and a silver path that fills up rotates.

``consume_batch`` launches ``gr_consume`` (csrc/consume.cu), one
cooperative kernel per batch, for CUDA tensors, and runs
``consume_batch_plain`` for CPU tensors; mixed devices raise.  The filter
may be banked (``mibf.Banks``, a mesh row's model axis,
parallel/mesh.py): the kernel reaches every bank through its device
pointer, the plain version routes every key to its bank.  The kernel
never returns to the host inside a batch: ``scal`` and the rows stay on the
card until the caller fetches them.  Its scratch (``ConsumeScratch``) is
made once per engine pass and grows only when a batch needs more.  The
plain version is a host loop over the plain PyTorch versions of kernels B,
C, D and insert_max.

The launch's host-side arithmetic is here, where the CPU tests reach it
(``launch_shape``, ``gather_ctas``, ``scatter_sources``,
``scatter_slices``, ``stage_fits``, ``ConsumeScratch.sizes``; the key
owners are ``mibf.insert_part``): the kernel computes the same maps.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import kernels
from ..mibf import compressed as cz
from ..mibf import mibf as dm
from .classify import _classify_plain
from .engine_util import recheck_zone

# the counters' order
COUNTS = ("live", "recheck", "insert", "reset")
# CTAs 0 and 1 of the consume kernel's grid classify (kernel C) the query
# tier's and the recheck tier's probes; the others own the insert keys
RUNNERS = 2
# int64 words of a runner's outcome slot (csrc/consume.cu kSlot)
OUTCOME_SLOT = 16
# under the optimistic policy each key owner stages its share of a probed
# read's insert keys in this many bytes of shared memory (8 a key) while
# the read is classified; a read whose shares do not fit reads its keys at
# the insert.  16 KB holds a read of up to 88 tiles of 1,000 frames at
# h = 3 on 130 owners; 0 stages none
STAGE_BYTES = 16 * 1024


def launch_shape(sms: int) -> tuple[int, int]:
    """(CTAs, key owners) of the consume kernel on a card of ``sms`` SMs:
    one CTA per SM, all but the runners owning keys."""
    if sms <= RUNNERS:
        raise ValueError(f"the consume kernel needs more than {RUNNERS} "
                         f"SMs, not {sms}")
    return sms, sms - RUNNERS


def gather_ctas(ctas: int, jobs: int) -> list[int]:
    """The CTA that runs each tile job of a probe (csrc/consume.cu gather):
    jobs are tier-major (the query tier's T tiles, then the recheck tier's),
    job j on CTA (j + RUNNERS) % ctas, so the owners take the first jobs
    and the runners the last, if any."""
    return [(j + RUNNERS) % ctas for j in range(jobs)]


def scatter_slices(ctas: int, entries: int) -> list[tuple[int, int]]:
    """The slice [lo, hi) of a window's ``entries`` that each CTA scatters
    to the key owners (csrc/insert.cuh slice_of): ceil(entries / ctas)
    each, in CTA order, clipped to the window."""
    per = -(-entries // ctas)
    return [(min(entries, c * per), min(entries, c * per + per))
            for c in range(ctas)]


def scatter_sources(ctas: int, jobs: int) -> list[int]:
    """The CTAs that scatter a window to the key owners, in slice order
    (csrc/consume.cu): beside a probe of ``jobs`` tile jobs that take at
    most half the owners, every CTA without a job (the runners, then the
    CTAs after the busy ones); otherwise, and for a recruit that is not
    probed (0 jobs), every CTA."""
    busy = jobs if 2 * jobs <= ctas - RUNNERS else 0
    return list(range(RUNNERS)) + list(range(RUNNERS + busy, ctas))


def stage_fits(H: int, tiles: int, F: int, owners: int, cap: int) -> bool:
    """Whether the consume kernel stages a probed read of ``tiles`` tiles
    (csrc/insert.cuh stage_fits): its window of H * tiles * F keys, cut by
    ``scatter_slices`` over the key owners, at most ``cap`` keys each
    (ceil(W / owners) <= cap, which is W <= owners * cap)."""
    return cap > 0 and tiles > 0 and H * tiles * F <= owners * cap


@dataclasses.dataclass
class ConsumeScratch:
    """The consume kernel's scratch on one device, kept across the batches
    of a pass: a vote buffer per tier, the runners' outcome slots, and
    under the exact policy two rounds of key buckets (``cap`` entries per
    owner) with their counters and the spill for an owner past its bucket.
    The counters and the outcomes' sequence numbers are zero between
    launches (the kernel clears what it set)."""
    sums: torch.Tensor | None = None
    vals: torch.Tensor | None = None
    binit: torch.Tensor | None = None
    outcome: torch.Tensor | None = None
    bucket_count: torch.Tensor | None = None
    bucket: torch.Tensor | None = None
    spill: torch.Tensor | None = None

    @staticmethod
    def sizes(T: int, K: int, window: int, parts: int, cap: int,
              exact: bool) -> dict:
        """Elements of each buffer for a batch of T tiles, K candidates a
        tile and insert windows of at most ``window`` entries (Hi * T * Fi):
        sums uint64 [2, 3, T], vals int32 [2, 3T + 2TK], binit bool [2, T],
        outcome int64 [2, OUTCOME_SLOT]; exact only: bucket_count uint32
        [2, parts], bucket uint64 [2, parts, cap], spill uint64 [2 +
        2 * window] (two counters, then power-of-two slices that together
        take less than twice a window)."""
        out = dict(sums=2 * 3 * T, vals=2 * (3 * T + 2 * T * K),
                   binit=2 * T, outcome=2 * OUTCOME_SLOT)
        if exact:
            out.update(bucket_count=2 * parts, bucket=2 * parts * cap,
                       spill=2 + 2 * window)
        return out

    def ensure(self, sizes: dict, device) -> None:
        """Grow each buffer that is smaller than ``sizes`` asks; a new
        counter buffer starts at zero."""
        dtypes = dict(sums=torch.int64, vals=torch.int32, binit=torch.bool,
                      outcome=torch.int64, bucket_count=torch.int32,
                      bucket=torch.int64, spill=torch.int64)
        for name, n in sizes.items():
            have = getattr(self, name)
            if have is not None and have.numel() >= n \
                    and have.device == torch.device(device):
                continue
            zeroed = name in ("outcome", "bucket_count", "spill")
            make = torch.zeros if zeroed else torch.empty
            setattr(self, name, make(n, dtype=dtypes[name], device=device))


@dataclasses.dataclass(frozen=True)
class ConsumeSpec:
    """What the scan needs of the engine's configuration."""
    params: dm.MibfParams       # the query tier (threshold = x_eff)
    params_full: dm.MibfParams  # the trim recheck's tier (cfg.threshold)
    params_ins: dm.MibfParams   # the insert grid's
    unassigned_min: int
    assigned_max: int
    fast: bool                  # the optimistic policy and max-id inserts
    rech_on: bool               # the trim recheck
    silver: bool
    target: int                 # bases per silver path
    max_paths: int


def new_counters(device) -> torch.Tensor:
    """The scan's counters (int64 [4], ``COUNTS``), on ``device``."""
    return torch.zeros(len(COUNTS), dtype=torch.int64, device=device)


def _filter_view(state, size: int):
    """(table, counts, ranked, insert key limit, or_bits) of either filter:
    the direct words keyed by slot (``size`` real slots), or the compressed
    filter's rank-indexed ids keyed by rank; table and counts each a tensor
    or its banks (``mibf.Banks``)."""
    if isinstance(state, cz.CompressedState):
        return state.ids, state.counts, True, state.sentinel, 0
    return state.words, state.counts, False, size, dm.PRESENT_BIT


def check_row(who: str, arrays, tensors, row=None) -> None:
    """The device rule of a launch on a data row of the mesh: the batch's
    ``tensors`` and the first bank of each filter array of ``arrays``
    (tensors or ``mibf.Banks``) lie on one device, the row's lead; with
    ``row`` (that row's devices) bank j of a banked array lies on
    ``row[j]``, and without it every bank on a device of the lead's
    type."""
    devices = {t.device for t in (*arrays, *tensors)}
    if len(devices) != 1:
        raise ValueError(f"{who}: tensors on several devices "
                         f"{sorted(map(str, devices))}")
    lead = devices.pop()
    for arr in arrays:
        parts = getattr(arr, "parts", (arr,))
        want = (tuple(torch.device(d) for d in row[:len(parts)])
                if row is not None and len(parts) > 1 else None)
        got = tuple(p.device for p in parts)
        if (want is not None and got != want) or any(
                d.type != lead.type for d in got):
            raise ValueError(f"{who}: filter banks on "
                             f"{[str(d) for d in got]}, batch on {lead}"
                             + (f", row {[str(d) for d in want]}"
                                if want else ""))


def consume_batch(spec: ConsumeSpec, state, grid, frame_ok, grid_ins, ok_ins,
                  n_tiles, full_lengths, rows0, scal, rows_out, counters,
                  num_tiles: int, scratch: ConsumeScratch | None = None,
                  row=None) -> None:
    """Consume one padded batch in order, in place: the filter ``state``
    (dm.MibfState or cz.CompressedState), ``scal`` (int64 [4]: ids
    inserted, bases inserted, path index, done; carried across batches),
    ``rows_out`` (int64 [B, 8]: decision, trim start, trim end, tiles
    assigned, queries, hits, misses, overflow) and ``counters`` (int64 [4],
    ``COUNTS``).

    grid int64 [B, h, T*F] and frame_ok bool [B, T*F]: the query tier's
    grid, one row per probed seed (slots, or ranks in the compressed
    filter); grid_ins / ok_ins the
    full-resolution grid of every insert seed; n_tiles int32 [B];
    full_lengths int64 [B]; rows0 int64 [B, 8] (or [B, 9] with the trim
    recheck, the ninth column each read's ``tile_min_count``): the batched
    verdicts against the filter at batch start.  ``scratch``: the kernel's,
    kept by the caller across a pass (a fresh one when not given).

    The batch's tensors and the filter's first bank (or whole tables) lie
    on one device, the lead of the filter's mesh row; with ``row`` (that
    row's devices) bank j of a banked filter must lie on ``row[j]``, and
    without it every bank on a device of the lead's type."""
    check_row("consume_batch", _filter_view(state, spec.params.size)[:2],
              (grid, frame_ok, grid_ins, ok_ins, n_tiles, full_lengths,
               rows0, scal, rows_out, counters), row)
    if grid.is_cuda:
        _consume_cuda(spec, state, grid, frame_ok, grid_ins, ok_ins, n_tiles,
                      full_lengths, rows0, scal, rows_out, counters,
                      num_tiles, scratch or ConsumeScratch())
    else:
        consume_batch_plain(spec, state, grid, frame_ok, grid_ins, ok_ins,
                            n_tiles, full_lengths, rows0, scal, rows_out,
                            counters, num_tiles)


def _consume_cuda(spec, state, grid, frame_ok, grid_ins, ok_ins, n_tiles,
                  full_lengths, rows0, scal, rows_out, counters, T, scratch):
    p, pf = spec.params, spec.params_full
    table, counts, ranked, limit, or_bits = _filter_view(state, p.size)
    B, Hq, TFq = grid.shape
    _, Hi, TFi = grid_ins.shape
    dev = grid.device
    K = p.vote_topk
    cols = 9 if spec.rech_on else 8
    banks = kernels.banks_args(table, counts, dev)
    kernels.check(grid, "grid", torch.int64, device=dev)
    kernels.check(frame_ok, "frame_ok", torch.bool, (B, TFq), dev)
    kernels.check(grid_ins, "grid_ins", torch.int64, (B, Hi, TFi), dev)
    kernels.check(ok_ins, "ok_ins", torch.bool, (B, TFi), dev)
    kernels.check(n_tiles, "n_tiles", torch.int32, (B,), dev)
    kernels.check(full_lengths, "full_lengths", torch.int64, (B,), dev)
    kernels.check(rows0, "rows0", torch.int64, (B, cols), dev)
    kernels.check(scal, "scal", torch.int64, (4,), dev)
    kernels.check(rows_out, "rows_out", torch.int64, (B, 8), dev)
    kernels.check(counters, "counters", torch.int64, (len(COUNTS),), dev)
    if TFq % T or TFi % T or pf.vote_topk != K:
        raise ValueError(f"unsupported grids {tuple(grid.shape)}, "
                         f"{tuple(grid_ins.shape)} for T={T}")
    _, parts = launch_shape(
        torch.cuda.get_device_properties(dev).multi_processor_count)
    scratch.ensure(ConsumeScratch.sizes(T, K, Hi * TFi, parts,
                                        dm.INSERT_CAP, not spec.fast), dev)
    sc = scratch
    exact = not spec.fast
    kernels.CONSUME(
        dev, *banks, int(ranked), table.shape[0] - 1, int(limit),
        int(or_bits),
        kernels.ptr(grid), kernels.ptr(frame_ok), Hq, TFq // T,
        kernels.ptr(grid_ins), kernels.ptr(ok_ins), Hi, TFi // T,
        kernels.ptr(n_tiles), kernels.ptr(full_lengths), kernels.ptr(rows0),
        cols, B, T, K, p.vote_min, p.threshold, pf.vote_min, pf.threshold,
        spec.unassigned_min, spec.assigned_max, p.tile_length,
        p.block_size, p.frame_stride, int(spec.fast), int(spec.rech_on),
        int(spec.silver), int(spec.target), int(spec.max_paths),
        dm.INSERT_CAP, parts, STAGE_BYTES // 8,
        kernels.ptr(scal), kernels.ptr(rows_out), kernels.ptr(counters),
        kernels.ptr(sc.sums), kernels.ptr(sc.vals), kernels.ptr(sc.binit),
        kernels.ptr(sc.outcome),
        kernels.ptr(sc.bucket_count if exact else None),
        kernels.ptr(sc.bucket if exact else None),
        kernels.ptr(sc.spill if exact else None))


def _probe_plain(table, ranked, grid, frame_ok, n_tiles, params, T,
                 u_min, a_max) -> list[int]:
    """One read's row against the live filter with the plain versions of
    kernels B and C: the eight row values and its tile_min_count."""
    v = dm._probe_and_vote_plain(table, grid, frame_ok, params, T, ranked)
    r = _classify_plain(v.curr_id, v.cand_ids, v.cand_counts, n_tiles,
                        params.threshold, u_min, a_max, False)
    n = int(n_tiles[0])
    tops = v.top_count[0, :n]
    tmin = int(tops.min()) if n > 0 else 1 << 30
    return [int(r.decision[0]), int(r.trim_start[0]), int(r.trim_end[0]),
            int(r.num_assigned[0]), int(v.queries[0]), int(v.hits[0]),
            int(v.misses[0]), int(v.overflow.long().sum()), tmin]


def consume_batch_plain(spec: ConsumeSpec, state, grid, frame_ok, grid_ins,
                        ok_ins, n_tiles, full_lengths, rows0, scal, rows_out,
                        counters, num_tiles: int) -> None:
    """``consume_batch`` as a host loop over the plain PyTorch versions of
    kernels B, C, D and insert_max, and the plain zone predicate and reset;
    the tensors may lie on any one device.  The loop of the JAX scan body
    (goldrush_tpu/path/engine.py:892-1022), read by read."""
    T = num_tiles
    p, pf, pi = spec.params, spec.params_full, spec.params_ins
    u_min, a_max = spec.unassigned_min, spec.assigned_max
    TL, bs, S = p.tile_length, p.block_size, p.frame_stride
    table, counts, ranked, limit, or_bits = _filter_view(state, p.size)
    rows0_l = rows0.tolist()
    n_l = n_tiles.tolist()
    L_l = full_lengths.tolist()
    ids_ins, ins_bases, path_idx, done = scal.tolist()
    changed = reset_seen = False
    n_live = n_rech = n_ins = n_reset = 0
    out = []
    for i in range(grid.shape[0]):
        row = rows0_l[i]
        if spec.fast:
            # optimistic: a batch-time drop stays dropped; after an
            # in-batch silver reset every later read re-probes
            live = (changed and row[0] != 0) or reset_seen
        else:
            # exact: every read after an in-batch change re-probes
            live = changed
        n_t, L = n_l[i], L_l[i]
        if live and not done:
            row = _probe_plain(table, ranked, grid[i:i + 1],
                               frame_ok[i:i + 1], n_tiles[i:i + 1], p, T,
                               u_min, a_max)
            n_live += 1
        dec, ts, te, na, q, h, m, ov = row[:8]
        if (spec.rech_on and not done
                and recheck_zone(dec, na, n_t, ts, te, row[8], S,
                                 pf.threshold, a_max)):
            # boundary zone: re-classify at full resolution, all insert
            # seeds, the exact gates
            dec, ts, te, na, q, h, m, ov = _probe_plain(
                table, ranked, grid_ins[i:i + 1], ok_ins[i:i + 1],
                n_tiles[i:i + 1], pf, T, u_min, a_max)[:8]
            n_rech += 1
        if done:
            dec = 0
        if dec == 1:
            rec_len, lo, hi = L, 0, n_t - 1
            blocks = 1 + L // (TL * bs)
        elif dec == 2:
            rec_len = (L - ts * TL if te == n_t - 1
                       else (te - ts + 1) * TL)
            lo, hi = ts, te
            blocks = 1 + (te - ts) // bs
        else:
            rec_len, blocks = 0, 0
        if dec > 0 and not done:
            if spec.fast:
                dm._insert_max_plain(table, grid_ins[i], lo, hi, ids_ins + 1,
                                     dec == 2, bs, T, limit, or_bits)
            else:
                dm._insert_plain(table, counts, grid_ins[i], lo, hi,
                                 ids_ins + 1, dec == 2, pi, T, limit,
                                 or_bits)
            n_ins += 1
        if not done:
            ids_ins += blocks
            ins_bases += rec_len
        # silver rotation (goldrush_path.cpp:156-187)
        if spec.silver and dec > 0 and spec.target < ins_bases and not done:
            path_idx += 1
            if spec.max_paths < path_idx:
                done = 1
            else:
                # the optimistic policy keeps the counters
                if ranked:
                    cz.reset_ids(state, counts=not spec.fast)
                else:
                    dm.reset_ids(state, counts=not spec.fast)
                ids_ins, ins_bases = 0, 0
                reset_seen = True
                n_reset += 1
        changed = changed or dec > 0
        out.append((dec, ts, te, na, q, h, m, ov))
    rows_out.copy_(torch.tensor(out, dtype=torch.int64).reshape(-1, 8))
    scal.copy_(torch.tensor([ids_ins, ins_bases, path_idx, done],
                            dtype=torch.int64))
    counters += torch.tensor([n_live, n_rech, n_ins, n_reset],
                             dtype=torch.int64, device=counters.device)
