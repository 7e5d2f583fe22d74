"""The wavefront consume (K23): one window of reads resolved as a fixpoint of
batched rounds, the opt-in alternative to the in-order consume scan.

The counterpart of ``build_wave_consume`` (goldrush_tpu/path/wavefront.py:
159-728), whose module docstring gives the design: the window's reads are
classified together against the filter, and those that can commit in the
same round do, while a read waits on any earlier unresolved read it shares
k-mers with (the window's overlap adjacency).  Block ids come from
read-order reservations, and a second, earliest-wins table (the side
table: ``INV_BASE`` - id by scatter-max) lets each read see the filter as
the sequential scan would (``mibf.bracket_words``).

Two kernels, each with its plain PyTorch version here (CPU tensors) and its
CUDA kernel in csrc/wavefront.cu (CUDA tensors; mixed devices raise; the
round loop takes the tables banked over a mesh row's devices, as the
consume scan does):

  wave_adjacency  the [B, B] counts of k-mers that pairs of reads share
                  (wavefront.py:298-345): every valid insert-grid frame
                  keyed by (slot or rank, fingerprint, read order); a pair
                  counts once per key whose group holds both reads as
                  consecutive distinct orders.  A pair is an overlap at
                  ADJ_MIN shared k-mers or more;
  wave_window     the round loop to its fixpoint (wavefront.py:491-726):
                  classify the reads whose view changed, the trim
                  recheck's zone, drops, conflicts, the two-phase commit
                  under the rotation horizon, the scatter-max inserts into
                  both tables, stale marking and the silver rotation that
                  reopens drops past it.

Chunking (CLASSIFY/CONFLICT/RECHECK/INSERT_CHUNK, ``chunk_loop``),
``_cumsum64``, the diagnostic toggles and trace, ``adj_sym`` and
``rechecked`` of the JAX module are not ported: per-row classify does not
depend on its chunk, scatter-max is commutative, and the rest never decides
an output.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .. import kernels
from ..mibf import mibf as dm
from ..ops.nthash import SeedFamily, fingerprints
from .classify import _classify_plain
from .consume import ConsumeSpec, _filter_view, check_row
from .engine_util import recheck_zone, tile_min_count

# a pair of window reads overlaps at this many shared k-mers (wavefront.py:
# 145, where the census behind it is)
ADJ_MIN = 6
# fingerprint bits of a conflict key: the low bits of the k-mer's hash
FP_BITS = 15
# the direct filter keys conflicts by the slot's low 24 bits
DIRECT_CONFLICT_BITS = 24
# the side table holds INV_BASE - id, so that its scatter-max keeps the
# earliest writer
INV_BASE = 1 << 28
# wave_rounds' CTA (csrc/wavefront.cu kWaveThreads), its seeds (probe_vote.cuh
# kMaxH), the largest vote table a warp probes (kWarpBits) and the vote
# tables' largest, and the shared memory a CTA may take (classify.cuh
# kMaxSmem)
WAVE_THREADS = 512
MAX_H = 8
WARP_BITS = 8
MAX_TABLE_BITS = 14
MAX_SMEM = 232_448
# the shared memory wave_rounds' static arrays may take beside its dynamic
# region (csrc/wavefront.cu kWaveStatic: the launcher checks its kernel's)
WAVE_STATIC_SMEM = 2_048
# the round loop's counters, per window summed over a pass: rounds, rows
# classified, rows rechecked at full resolution, commits, silver
# rotations, and windows that faulted (past the round cap, or ids reaching
# INV_BASE: the pass raises)
WAVE_COUNTS = ("rounds", "classified", "rechecked", "commits", "rotations",
               "faults")
# keys of a partition that wave_adjacency groups in shared memory; a larger
# partition takes its distinct keys there (up to ADJ_CAP / 2: a heavy
# group's repeats), and past that sorts its slice in global memory
ADJ_CAP = 2_048
# partitions of wave_adjacency: about this many keys each
ADJ_KEYS_PER_PART = 1_024
ADJ_MAX_PARTS = 1 << 20
# the partitions are split in two steps: the window's keys into at most
# ADJ_BUCKETS buckets of consecutive partitions (few enough that each CTA's
# runs in them fill whole sectors of L2), then each bucket into its
# partitions
ADJ_BUCKETS = 256
# the most reads a window's adjacency pairs: a group's entry holds a read
# order in 14 bits (csrc/wavefront.cu adj_group_kernel), which takes the
# tile budget's 8,192 reads and the mesh's padding of them to a multiple
# of the data rows
MAX_ADJ_READS = 1 << 14


@dataclasses.dataclass(frozen=True)
class WaveSpec:
    """What the wavefront needs of the engine's configuration: the consume
    scan's (the tiers' gates, the trim recheck, the silver path) and the
    insert seeds' family, whose hashes give the fingerprints."""
    scan: ConsumeSpec
    fam_ins: SeedFamily


def new_counters(device) -> torch.Tensor:
    """The wave's counters (int64 [6], ``WAVE_COUNTS``), on ``device``."""
    return torch.zeros(len(WAVE_COUNTS), dtype=torch.int64, device=device)


def ord_bits(B: int) -> int:
    """Bits of a read's order in a conflict key of a window of B reads."""
    return max((B - 1).bit_length(), 1)


# ---------------------------------------------------------------------------
# the adjacency
# ---------------------------------------------------------------------------

def wave_adjacency(spec: WaveSpec, grid_ins: torch.Tensor,
                   codes: torch.Tensor, limit: int, ranked: bool,
                   num_tiles: int) -> torch.Tensor:
    """Shared k-mer counts of a window: int32 [B, B], entry [hi, lo] (hi >
    lo) the number of (conflict key, fingerprint) groups in which reads hi
    and lo are consecutive distinct orders.  grid_ins int64 [B, H, T*F]:
    the insert grid (slots, or ranks in the compressed filter; entries at
    ``limit`` or above are invalid frames, which never pair); codes uint8
    [B, L], the window's zero-padded reads, from which the fingerprints
    are hashed at the grid's plain positions."""
    if grid_ins.is_cuda != codes.is_cuda:
        raise ValueError("wave_adjacency: tensors on several devices")
    if grid_ins.is_cuda:
        return _adjacency_cuda(spec, grid_ins, codes, limit, ranked,
                               num_tiles)
    S = spec.scan.params_ins.frame_stride
    TL = spec.scan.params.tile_length
    fp = fingerprints(codes, spec.fam_ins, num_tiles * TL, S, FP_BITS)
    return wave_adjacency_plain(grid_ins, fp, limit, ranked)


def wave_adjacency_plain(grid_ins: torch.Tensor, fp: torch.Tensor,
                         limit: int, ranked: bool) -> torch.Tensor:
    """``wave_adjacency`` from the fingerprints ``fp`` [B, H, T*F]: the
    keys conf << (FP_BITS + ord) | fp << ord | order of the valid frames,
    sorted (wavefront.py:308-343; its unique keys of invalid frames never
    pair, so they are left out)."""
    B = grid_ins.shape[0]
    ob = ord_bits(B)
    valid = grid_ins < limit
    conf = grid_ins if ranked else grid_ins & ((1 << DIRECT_CONFLICT_BITS) - 1)
    order = torch.arange(B, device=grid_ins.device)[:, None, None]
    key = ((conf << FP_BITS | fp) << ob) | order
    sk = torch.sort(key[valid]).values
    same = (sk[1:] >> ob) == (sk[:-1] >> ob)
    o1, o0 = sk[1:] & ((1 << ob) - 1), sk[:-1] & ((1 << ob) - 1)
    pair = same & (o1 != o0)
    cnt = torch.zeros(B * B, dtype=torch.int32, device=grid_ins.device)
    idx = (torch.maximum(o1, o0) * B + torch.minimum(o1, o0))[pair]
    cnt.index_add_(0, idx, torch.ones(idx.shape, dtype=torch.int32,
                                      device=grid_ins.device))
    return cnt.reshape(B, B)


def adjacency_parts(n_keys: int) -> int:
    """wave_adjacency's partitions for a grid of n_keys entries: a power
    of two near n_keys / ADJ_KEYS_PER_PART, at most ADJ_MAX_PARTS."""
    return min(1 << max(0, (max(n_keys // ADJ_KEYS_PER_PART, 1) - 1)
                        .bit_length()), ADJ_MAX_PARTS)


def adjacency_units(n_tiles: int, sms: int) -> int:
    """Tiles of the window that each CTA of wave_adjacency's count and
    scatter keys: about two CTAs per SM."""
    return max(1, -(-n_tiles // (2 * sms)))


def adjacency_plan(B: int, H: int, TF: int, T: int, S: int, TL: int,
                   h: int, limit: int, sms: int) -> tuple[int, int, int]:
    """wave_adjacency's launch for a window of B reads with an insert grid
    [B, H, TF] of T tiles at stride S (h seeds in the family) and keys
    below ``limit``, on a card of ``sms`` SMs: (partitions, buckets, tiles
    a CTA keys).  Raises ValueError where the launcher refuses: past
    MAX_ADJ_READS reads, 2^31 grid entries or keys."""
    n = B * H * TF
    if (TF % T or TF // T * S != TL or h != H or not 0 < limit < 1 << 31
            or B > MAX_ADJ_READS or n >= 1 << 31):
        raise ValueError(f"unsupported adjacency grid {(B, H, TF)} for "
                         f"T={T}, stride {S}, limit {limit}")
    parts = adjacency_parts(n)
    return parts, min(parts, ADJ_BUCKETS), adjacency_units(B * T, sms)


def _adjacency_cuda(spec, grid_ins, codes, limit, ranked, T, cap=ADJ_CAP):
    B, H, TF = grid_ins.shape
    dev = grid_ins.device
    fam = spec.fam_ins
    S = spec.scan.params_ins.frame_stride
    TL = spec.scan.params.tile_length
    kernels.check(grid_ins, "grid_ins", torch.int64, device=dev)
    kernels.check(codes, "codes", torch.uint8, device=dev)
    if codes.shape[0] != B:
        raise ValueError(f"{codes.shape[0]} reads of codes for a grid of {B}")
    parts, nb, units = adjacency_plan(
        B, H, TF, T, S, TL, fam.h, limit,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    n = B * H * TF
    i32 = dict(dtype=torch.int32, device=dev)
    pcount = torch.empty((-(-(B * T) // units), nb), **i32)
    boff = torch.empty(nb + 1, **i32)
    part_off = torch.empty(parts + 1, **i32)
    # the valid keys bucket by bucket, then partition by partition
    keys = torch.empty(n, dtype=torch.int64, device=dev)
    buckets = torch.empty(n, dtype=torch.int64, device=dev)
    cnt = torch.zeros((B, B), **i32)
    kernels.WAVE_ADJACENCY(
        dev, kernels.ptr(grid_ins), B, H, T, TF // T, S, TL,
        kernels.ptr(codes), codes.shape[1], *dm._family_args(fam, dev),
        int(limit), int(not ranked), parts, (parts // nb).bit_length() - 1,
        units, cap, kernels.ptr(pcount), kernels.ptr(boff),
        kernels.ptr(part_off), kernels.ptr(keys), kernels.ptr(buckets),
        kernels.ptr(cnt))
    return cnt


# ---------------------------------------------------------------------------
# the round loop
# ---------------------------------------------------------------------------

def wave_window(spec: WaveSpec, state, side: torch.Tensor,
                grid: torch.Tensor, frame_ok: torch.Tensor,
                grid_ins: torch.Tensor, ok_ins: torch.Tensor,
                n_tiles: torch.Tensor, full_lengths: torch.Tensor,
                adj: torch.Tensor, scal: torch.Tensor,
                rows_out: torch.Tensor, counters: torch.Tensor,
                num_tiles: int, row=None) -> None:
    """Resolve one padded window, in place: the filter ``state``
    (dm.MibfState or cz.CompressedState: its ids), the side table ``side``
    (int32, the id table's shape, banked as it is), ``scal`` (int64 [4]:
    id reservations, bases inserted, path index, done; carried across
    windows),
    ``rows_out`` (int64 [B, 8], the consume scan's rows) and ``counters``
    (``WAVE_COUNTS``).

    grid / frame_ok: the query tier's grid [B, h, T*F] (slots, or ranks);
    grid_ins / ok_ins: the insert grid of every insert seed (what recruits
    insert and the trim recheck probes); n_tiles int32 [B]; full_lengths
    int64 [B]; adj int32 [B, B], ``wave_adjacency``'s counts.  On the card
    one cooperative launch of wave_rounds (csrc/wavefront.cu) runs every
    round; a window that faults there (``WAVE_COUNTS``) is reported by
    the counters, which the engine reads once per pass and raises on.

    The window's tensors and the first bank of each table lie on one
    device, the lead of the filter's mesh row; with ``row`` (that row's
    devices) bank j of banked tables must lie on ``row[j]``
    (``consume.check_row``)."""
    table = _filter_view(state, spec.scan.params.size)[0]
    check_row("wave_window", (table, side),
              (grid, frame_ok, grid_ins, ok_ins, n_tiles, full_lengths, adj,
               scal, rows_out, counters), row)
    if grid.is_cuda:
        _window_cuda(spec, state, side, grid, frame_ok, grid_ins, ok_ins,
                     n_tiles, full_lengths, adj, scal, rows_out, counters,
                     num_tiles)
    else:
        wave_window_plain(spec, state, side, grid, frame_ok, grid_ins,
                          ok_ins, n_tiles, full_lengths, adj, scal,
                          rows_out, counters, num_tiles)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


class RoundsPlan(NamedTuple):
    """wave_rounds' launch plan (``rounds_smem``)."""
    smem: int          # dynamic shared memory of a CTA
    slice_bytes: int   # each CTA's spill slice, 0 while none is needed
    c_warps: int       # the warps of a CTA that run kernel C


def rounds_smem(B: int, T: int, K: int, votes_q: int, votes_f: int,
                rech_on: bool) -> RoundsPlan:
    """wave_rounds' launch plan for a window of B reads of T tiles, K
    candidates a tile and ``votes_q`` / ``votes_f`` votes a tile in the
    query and recheck tiers (csrc/wavefront.cu gr_wave_rounds, which plans
    alike): the dynamic shared memory; the bytes of each CTA's spill
    slice, 0 while the commit pass's insert index (12 B a read) and the
    per-read state (~16.6 B a read) fit beside the work region, else both;
    and the warps of a CTA that run kernel C, all 16 while their buffers
    fit in the work region, else as many as fit beside the index and the
    state, or, failing that, alone (reads of ~1,024 tiles or more at K =
    32).  The dynamic region takes what the card's MAX_SMEM leaves beside
    the kernel's static arrays (WAVE_STATIC_SMEM).  Raises ValueError
    where the launcher refuses."""
    bits_q, bits_f = [max(1, (v - 1).bit_length()) for v in (votes_q,
                                                             votes_f)]
    if bits_q > MAX_TABLE_BITS or (rech_on and bits_f > MAX_TABLE_BITS):
        raise ValueError(f"tiles of {votes_q} / {votes_f} votes: wave_rounds"
                         f" takes at most 2^{MAX_TABLE_BITS}")
    warp_q = bits_q <= WARP_BITS
    warp_f = rech_on and bits_f <= WARP_BITS
    # kernel C's buffer, a warp tile's vote table, a CTA tile's
    cbuf = max(1 << max(0, (T - 1).bit_length()), min(T, 32) * K)
    c_bytes = _align16(8 * (((T + 1) & ~1) + cbuf))
    probe = _align16(max([16 << b for on, b in ((warp_q, bits_q),
                                               (warp_f, bits_f)) if on],
                         default=0))
    tile = _align16(max(((1 << bits) + WAVE_THREADS) * 8 for bits in (
        1 if warp_q else bits_q, 1 if warp_f or not rech_on else bits_f)))
    index = _align16(12 * B)
    state = -(-B // 16) * 16 + 16 * B + 4 * -(-B // 32)
    warps = WAVE_THREADS // 32

    def work_of(cw):
        if cw == warps:
            return max(warps * max(c_bytes, probe), tile)
        return max(warps * probe, tile, cw * c_bytes)

    budget = MAX_SMEM - WAVE_STATIC_SMEM
    c_warps = warps
    if work_of(warps) > budget:
        fits = [cw for cw in range(warps - 1, 0, -1)
                if max(work_of(cw), index) + state <= budget] or \
               [cw for cw in range(warps - 1, 0, -1)
                if work_of(cw) <= budget]
        if not fits:
            raise ValueError(f"reads of {T} tiles at K={K}: one warp's "
                             f"kernel C buffer ({c_bytes} bytes) and the "
                             f"work region pass {budget} bytes of shared "
                             "memory")
        c_warps = fits[0]
    work = work_of(c_warps)
    if max(work, index) + state <= budget:
        return RoundsPlan(max(work, index) + state, 0, c_warps)
    return RoundsPlan(work, index + _align16(state), c_warps)


def _window_cuda(spec, state, side, grid, frame_ok, grid_ins, ok_ins,
                 n_tiles, full_lengths, adj, scal, rows_out, counters, T):
    sc = spec.scan
    p, pf = sc.params, sc.params_full
    table, _, ranked, limit, or_bits = _filter_view(state, p.size)
    dev = grid.device
    # a remote bank without peer access and native atomics raises here
    banks = kernels.banks_args(table, side, dev)
    B, Hq, TFq = grid.shape
    _, Hi, TFi = grid_ins.shape
    K = p.vote_topk
    kernels.check(grid, "grid", torch.int64, device=dev)
    kernels.check(frame_ok, "frame_ok", torch.bool, (B, TFq), dev)
    kernels.check(grid_ins, "grid_ins", torch.int64, (B, Hi, TFi), dev)
    kernels.check(ok_ins, "ok_ins", torch.bool, (B, TFi), dev)
    kernels.check(n_tiles, "n_tiles", torch.int32, (B,), dev)
    kernels.check(full_lengths, "full_lengths", torch.int64, (B,), dev)
    kernels.check(adj, "adj", torch.int32, (B, B), dev)
    kernels.check(scal, "scal", torch.int64, (4,), dev)
    kernels.check(rows_out, "rows_out", torch.int64, (B, 8), dev)
    kernels.check(counters, "counters", torch.int64, (len(WAVE_COUNTS),),
                  dev)
    if (TFq % T or TFi % T or pf.vote_topk != K or not 0 < limit < 1 << 31
            or B * Hi * TFi >= 1 << 31 or not 0 < Hq <= MAX_H
            or not 0 < Hi <= MAX_H or K > Hq * (TFq // T)
            or (sc.rech_on and K > Hi * (TFi // T))):
        raise ValueError(f"unsupported grids {tuple(grid.shape)}, "
                         f"{tuple(grid_ins.shape)} for T={T}, K={K}")
    slice_bytes = rounds_smem(B, T, K, Hq * (TFq // T), Hi * (TFi // T),
                              sc.rech_on).slice_bytes
    # per read: its vote buffer (the consume kernel's layout), tile_min,
    # and its row of adjacency bits
    sums = torch.empty((B, 3, T), dtype=torch.int64, device=dev)
    vals = torch.empty((B, 3 * T + 2 * T * K), dtype=torch.int32,
                       device=dev)
    binit = torch.empty((B, T), dtype=torch.bool, device=dev)
    tmin = torch.empty(B, dtype=torch.int64, device=dev)
    adj_bits = torch.empty((B, -(-B // 32)), dtype=torch.int32, device=dev)
    # a window whose per-read state leaves shared memory: a slice a CTA,
    # at most one CTA an SM
    ctas = (torch.cuda.get_device_properties(dev).multi_processor_count
            if slice_bytes else 0)
    spill = (torch.empty(ctas * slice_bytes, dtype=torch.uint8, device=dev)
             if slice_bytes else None)
    kernels.WAVE_ROUNDS(
        dev, *banks, int(ranked), int(limit), int(or_bits),
        kernels.ptr(grid), kernels.ptr(frame_ok), Hq, TFq // T,
        kernels.ptr(grid_ins), kernels.ptr(ok_ins), Hi, TFi // T,
        kernels.ptr(n_tiles), kernels.ptr(full_lengths), kernels.ptr(adj),
        B, T, K, p.vote_min, p.threshold, pf.vote_min, pf.threshold,
        sc.unassigned_min, sc.assigned_max, p.tile_length, p.block_size,
        p.frame_stride, int(sc.rech_on), int(sc.silver), int(sc.target),
        int(sc.max_paths), kernels.ptr(scal), kernels.ptr(rows_out),
        kernels.ptr(counters), kernels.ptr(sums), kernels.ptr(vals),
        kernels.ptr(binit), kernels.ptr(tmin), kernels.ptr(adj_bits),
        kernels.ptr(spill), ctas)


def _classify_rows(sc, table, side, ranked, limit, grid, ok, n_tiles, ceil,
                   params, T):
    """Rows int64 [R, 8] and tile_min int64 [R] of the R reads whose grid
    rows, frame_ok, n_tiles and ceilings are given, through the bracket
    view of the two tables (plain B and C)."""
    ws = dm.bracket_words(table, side, grid, ceil, limit, ranked)
    v = dm._vote_from_words(ws, ok, params, T)
    r = _classify_plain(v.curr_id, v.cand_ids, v.cand_counts, n_tiles,
                        params.threshold, sc.unassigned_min,
                        sc.assigned_max, False)
    rows = torch.stack([r.decision.long(), r.trim_start.long(),
                        r.trim_end.long(), r.num_assigned.long(), v.queries,
                        v.hits, v.misses, v.overflow.long().sum(dim=1)],
                       dim=1)
    return rows, tile_min_count(v.top_count, n_tiles)


def _insert_rows(table, side, grid_ins, rows, lo, hi, base, trimmed, bs,
                 limit, or_bits, T):
    """The scatter-max insert of the given reads' tiles lo..hi (block ids
    from ``base``) into both tables (each a tensor or ``mibf.Banks``):
    or_bits | id into ``table``, INV_BASE - id into ``side``
    (wavefront.py:456-489)."""
    if rows.numel() == 0:
        return
    TF = grid_ins.shape[2]
    F = TF // T
    g = grid_ins[rows]                                      # [R, H, TF]
    t = torch.arange(TF, device=g.device)[None, :] // F
    lo, hi = lo[rows, None], hi[rows, None]
    in_rng = (t >= lo) & (t <= hi)
    mm = torch.where(in_rng, t - lo, 0) // bs
    bid = base[rows, None] + torch.where(trimmed[rows, None],
                                         (mm * bs + 1) // bs, mm)
    ok = in_rng[:, None, :] & (g < limit)
    keys = g[ok]
    ids = bid[:, None, :].expand(g.shape)[ok]
    dm.amax_(table, keys, (or_bits | ids).to(torch.int32))
    dm.amax_(side, keys, (INV_BASE - ids).to(torch.int32))


def wave_window_plain(spec: WaveSpec, state, side, grid, frame_ok, grid_ins,
                      ok_ins, n_tiles, full_lengths, adj, scal, rows_out,
                      counters, num_tiles: int) -> None:
    """``wave_window`` as a host loop of plain PyTorch over [B] vectors,
    the rounds of wavefront.py:491-697 one for one; the tensors may lie on
    any one device, the tables' banks (``mibf.Banks``) on any devices.
    Raises where the kernel reports a fault."""
    sc = spec.scan
    T = num_tiles
    p, pf = sc.params, sc.params_full
    TL, bs, S = p.tile_length, p.block_size, p.frame_stride
    table, _, ranked, limit, or_bits = _filter_view(state, p.size)
    dev = grid.device
    B = grid.shape[0]
    order = torch.arange(B, device=dev)
    linked = adj >= ADJ_MIN             # [B, B]: row i's earlier partners
    ids0, bases0, path_idx, done = scal.tolist()
    L = full_lengths.long()
    n = n_tiles.long()
    maxb = torch.where(L > 0, 1 + L // (TL * bs), 0)
    target_eff = sc.target if sc.silver else 1 << 62
    zeros = torch.zeros(B, dtype=torch.bool, device=dev)
    pending = zeros | (done == 0)
    stale = ~zeros
    rows = torch.zeros((B, 8), dtype=torch.int64, device=dev)
    tmin = torch.zeros(B, dtype=torch.int64, device=dev)
    clen = torch.zeros(B, dtype=torch.int64, device=dev)
    rot_pos = -1
    counts = [0] * len(WAVE_COUNTS)
    cap = B * (sc.max_paths + 2)

    def geometry():
        dec, ts, te = rows[:, 0], rows[:, 1], rows[:, 2]
        l_trim = torch.where(te == n - 1, L - ts * TL, (te - ts + 1) * TL)
        rec_len = torch.where(dec == 1, L, torch.where(dec == 2, l_trim, 0))
        lo = torch.where(dec == 1, 0, ts)
        hi = torch.where(dec == 1, n - 1, te)
        return rec_len, lo, hi

    def first_of(mask):
        return mask & (torch.cumsum(mask.long(), 0) == 1)

    while bool(pending.any()):
        if counts[0] >= cap:
            raise RuntimeError(f"wave window of {B} reads unresolved after "
                               f"{cap} rounds")
        counts[0] += 1
        # read-order id reservations and each read's id ceiling
        in_path = order > rot_pos
        base0 = bases0 if rot_pos < 0 else 0
        resv = torch.where(in_path, maxb, 0)
        ceil = (ids0 if rot_pos < 0 else 0) + torch.cumsum(resv, 0) - resv
        if int(ceil[-1] + resv[-1]) >= INV_BASE:
            raise RuntimeError(f"wave ids reach INV_BASE ({INV_BASE})")
        # 1. classify the reads whose view an earlier commit changed
        work = pending & stale
        idx = work.nonzero().flatten()
        if idx.numel():
            rows[idx], tmin[idx] = _classify_rows(
                sc, table, side, ranked, limit, grid[idx], frame_ok[idx],
                n_tiles[idx], ceil[idx], p, T)
            counts[1] += idx.numel()
        stale = stale & ~work
        # 2-4. the zone, drops, candidates and conflicts
        dec, ts, te, na = rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3]
        zone = (recheck_zone(dec, na, n, ts, te, tmin, S, pf.threshold,
                             sc.assigned_max) & pending) if sc.rech_on \
            else zeros
        dropf = pending & (dec == 0) & ~zone
        cand = pending & ((dec > 0) | zone)
        unresolved = pending & ~dropf
        confl = cand & (linked & unresolved[None, :]).any(dim=1)
        committable = cand & ~confl
        base = ceil + 1

        def horizon(commit_m, act_m, rec_len):
            pot = torch.where(commit_m, rec_len, torch.where(act_m, L, 0))
            pess = base0 + torch.cumsum(torch.where(in_path, clen + pot, 0),
                                        0)
            first = first_of(act_m)
            return commit_m & ((pess <= target_eff) | first) & (done == 0), \
                first

        # 5-7. phase A: the commits outside the zone
        rec_len, lo, hi = geometry()
        allowed_a, first_a = horizon(committable & ~zone & (dec > 0),
                                     pending & ~dropf, rec_len)
        _insert_rows(table, side, grid_ins, allowed_a.nonzero().flatten(),
                     lo, hi, base, dec == 2, bs, limit, or_bits, T)
        clen = torch.where(allowed_a, rec_len, clen)
        # phase B: the zone recheck against the updated tables, then the
        # zone's commits
        if sc.rech_on:
            idx = (zone & committable).nonzero().flatten()
            if idx.numel():
                rows[idx] = _classify_rows(
                    sc, table, side, ranked, limit, grid_ins[idx],
                    ok_ins[idx], n_tiles[idx], ceil[idx], pf, T)[0]
                counts[2] += idx.numel()
        dec = rows[:, 0]
        dropf = dropf | (committable & (dec == 0))
        rec_len, lo, hi = geometry()
        allowed_b, first_b = horizon(committable & zone & (dec > 0),
                                     pending & ~dropf & ~allowed_a, rec_len)
        _insert_rows(table, side, grid_ins, allowed_b.nonzero().flatten(),
                     lo, hi, base, dec == 2, bs, limit, or_bits, T)
        clen = torch.where(allowed_b, rec_len, clen)
        allowed = allowed_a | allowed_b
        first_active = (allowed_a & first_a) | (allowed_b & first_b)
        counts[3] += int(allowed.sum())
        # commits make every later pending read stale
        if bool(allowed.any()):
            stale = stale | (pending & (order > order[allowed].min()))
        do_reset = False
        if sc.silver:
            cumc = base0 + torch.cumsum(torch.where(in_path, clen, 0), 0)
            if bool((first_active & (cumc > target_eff)).any()):
                path_idx += 1
                if sc.max_paths < path_idx:
                    done = 1
                else:
                    do_reset = True
                rot_pos = int(order[first_active].min())
            if do_reset:
                if ranked:
                    table.zero_()
                else:
                    table.bitwise_and_(dm.PRESENT_BIT)
                side.zero_()
                stale = ~zeros
                counts[4] += 1
        # 8. finalize; a rotation reopens the drops past it
        pending = pending & ~(dropf | allowed) & (done == 0)
        if do_reset:
            pending = pending | ((order > rot_pos) & ~pending & (clen == 0))
    in_path = order > rot_pos
    scal.copy_(torch.tensor([
        (ids0 if rot_pos < 0 else 0) + int(maxb[in_path].sum()),
        (bases0 if rot_pos < 0 else 0) + int(clen[in_path].sum()),
        path_idx, done], dtype=torch.int64))
    rows_out.copy_(rows)
    counters += torch.tensor(counts, dtype=torch.int64, device=counters.device)

