"""Direct multi-index Bloom filter: two flat arrays on an explicit device.

The layout is the JAX package's direct mode (goldrush_tpu/mibf/mibf.py):

  words[slot]  = [31: saturation][30: presence][29..0: block ID]
  counts[slot] = reservoir counter (MIBFConstructSupport.hpp m_counts)

both carried as int32 tensors holding the uint32 bits (PyTorch has no
uint32 arithmetic on the CPU), with slot ``size`` the sentinel that invalid
probe frames point at.  Slot grids are int64 throughout.

Four functions own a kernel; each runs its plain PyTorch version for a CPU
tensor and launches its CUDA kernel for a CUDA tensor (or raises):

  fill_presence      kernel A, fill entry  (csrc/seed_hash.cu)
  build_slot_grid    kernel A, grid entry  (csrc/seed_hash.cu)
  probe_and_vote     kernel B              (csrc/probe_vote.cu)
  insert_blocks      kernel D              (csrc/insert_sorted.cu)

``probe_and_vote`` and ``insert_blocks`` also serve the rank-compressed
filter (``compressed.py``), keyed on ranks instead of slots.

Unlike the JAX package, the filter is updated in place (``fill_presence``,
``insert_read_sorted``, ``reset_ids``): a 1.14 GB filter is never copied.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..ops.nthash import SeedFamily, hash_positions

SAT_BIT = 1 << 31
PRESENT_BIT = 1 << 30
ID_MASK = (1 << 30) - 1
_MASK32 = 0xFFFFFFFF
_I64_MAX = (1 << 63) - 1


@dataclasses.dataclass(frozen=True)
class MibfParams:
    """Static geometry of the filter + classifier."""
    size: int                  # number of real slots (slot `size` = sentinel)
    h: int                     # number of seed patterns
    k: int                     # span of seed 0
    spans: tuple[int, ...]     # per-seed spans
    tile_length: int = 1000
    threshold: int = 10        # -x
    block_size: int = 10       # -b
    vote_topk: int = 16
    frame_stride: int = 1      # 1 = every frame (the only stride ported)
    vote_min: int = 2          # candidate gate "count > vote_min"
    probe_seeds: int = 0       # 0 = all h (the only value ported)
    slot_map: str = "fastrange"   # "fastrange" | "mod"

    @property
    def alloc(self) -> int:
        """Array length: size real slots + 1 sentinel, padded to a 1024
        multiple (the JAX package's layout, so saved filters interchange)."""
        return -(-(self.size + 1) // 1024) * 1024


class MibfState(NamedTuple):
    words: torch.Tensor        # int32 [alloc] (uint32 bits)
    counts: torch.Tensor       # int32 [alloc] (uint32 bits)


def init_state(params: MibfParams, device="cpu") -> MibfState:
    return MibfState(
        words=torch.zeros(params.alloc, dtype=torch.int32, device=device),
        counts=torch.zeros(params.alloc, dtype=torch.int32, device=device))


def state_from_numpy(words: np.ndarray, counts: np.ndarray,
                     device="cpu") -> MibfState:
    """The JAX package's uint32 arrays as a state on ``device`` (bit view)."""
    def conv(a):
        a = np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)
        return torch.from_numpy(a.copy()).to(device)
    return MibfState(words=conv(words), counts=conv(counts))


def state_to_numpy(state: MibfState) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of ``state_from_numpy``: uint32 numpy arrays on the host."""
    return (state.words.cpu().numpy().view(np.uint32).copy(),
            state.counts.cpu().numpy().view(np.uint32).copy())


def fastrange(h: torch.Tensor, size: int) -> torch.Tensor:
    """floor(h * size / 2**64) for uint64 bits in int64 and size < 2**32.

    The partial products wrap in int64 exactly as uint64 does; the true sum
    stays below 2**64, so the logical shift of the wrapped bits is exact."""
    hi = (h >> 32) & _MASK32
    lo = h & _MASK32
    p = hi * size + ((lo * size >> 32) & _MASK32)
    return (p >> 32) & _MASK32


def slot_of(h: torch.Tensor, size: int, mode: str = "fastrange"
            ) -> torch.Tensor:
    """hash -> slot under the configured map (see MibfParams.slot_map)."""
    if mode == "mod":
        # unsigned 64-bit modulo from the non-negative upper 63 bits
        half = (h >> 1) & _I64_MAX
        return (2 * (half % size) + (h & 1)) % size
    return fastrange(h, size)


def _slot_mode(mode: str) -> int:
    if mode not in ("fastrange", "mod"):
        raise ValueError(f"unknown slot_map {mode!r}")
    return int(mode == "mod")


def _family_tensor(fam: SeedFamily, device) -> torch.Tensor:
    return torch.from_numpy(fam.descriptor()).to(device)


# ---------------------------------------------------------------------------
# pass-1 presence fill
# ---------------------------------------------------------------------------

def fill_presence(words: torch.Tensor, codes: torch.Tensor,
                  lengths: torch.Tensor, fam: SeedFamily, size: int,
                  slot_mode: str = "fastrange") -> torch.Tensor:
    """Pass-1 presence fill (MIBFConstructSupport.hpp:134-147), in place:
    set PRESENT at the slot of every valid hash of every read.

    codes: uint8 [B, L] zero-padded reads; lengths: int32 [B].  Frame p of
    seed s is valid when p < lengths[b] - span_s + 1, the mask the JAX
    engine builds for ``goldrush_tpu.mibf.mibf.fill_presence``
    (engine.py:465-471).  Returns ``words``."""
    if words.is_cuda:
        return _fill_presence_cuda(words, codes, lengths, fam, size,
                                   slot_mode)
    return _fill_presence_plain(words, codes, lengths, fam, size, slot_mode)


def _fill_presence_cuda(words, codes, lengths, fam, size, slot_mode):
    B, L = codes.shape
    dev = words.device
    kernels.check(words, "words", torch.int32, device=dev)
    kernels.check(codes, "codes", torch.uint8, device=dev)
    kernels.check(lengths, "lengths", torch.int32, (B,), dev)
    if size + 1 > words.shape[0] or size >= 1 << 32:
        raise ValueError(f"size {size} does not fit words [{words.shape[0]}]")
    kernels.SEED_HASH_FILL(
        dev, kernels.ptr(codes), B, L, kernels.ptr(lengths),
        kernels.ptr(_family_tensor(fam, dev)), size, _slot_mode(slot_mode),
        kernels.ptr(words))
    return words


def _fill_presence_plain(words, codes, lengths, fam, size, slot_mode):
    B, L = codes.shape
    P = max(L - fam.k + 1, 1)
    hashes = hash_positions(codes, fam, P)                  # [B, h, P]
    p = torch.arange(P, device=codes.device)
    spans = torch.tensor(fam.spans, device=codes.device)
    n_valid = lengths.to(torch.int64)[:, None] - spans[None, :] + 1
    valid = p[None, None, :] < n_valid[:, :, None]          # [B, h, P]
    slots = slot_of(hashes[valid], size, slot_mode)
    words[slots] = words[slots] | PRESENT_BIT
    return words


# ---------------------------------------------------------------------------
# tile/frame slot grid
# ---------------------------------------------------------------------------

def tile_slot_grid(hashes: torch.Tensor, lengths: torch.Tensor,
                   params: MibfParams, num_tiles_max: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: map whole-read position hashes to the per-tile probe
    grid (goldrush_tpu/mibf/mibf.py:158-211, stride 1).

    hashes: int64 [B, h, P] (P >= num_tiles_max * tile_length); lengths:
    [B].  Returns (slots int64 [B, h, T*F] with the sentinel ``size`` where
    frame_ok is False, frame_ok bool [B, T*F]).  Frame f of tile t probes
    global position t*TL + min(f, F_ts - 1): the clamp reproduces the
    stale-tail lockstep of multiLensfrHashIterator.hpp:49-67."""
    TL, k = params.tile_length, params.k
    B, _, P = hashes.shape
    T, F, H = num_tiles_max, TL, params.h
    dev = hashes.device
    spos = slot_of(hashes, params.size, params.slot_map)
    t_idx = torch.arange(T, device=dev)[None, :]                  # [1,T]
    f_idx = torch.arange(F, device=dev)[None, None, :]            # [1,1,F]
    L = lengths.to(torch.int64)[:, None]                          # [B,1]
    tile_len = torch.clamp(L - t_idx * TL, max=TL + k - 1)        # [B,T]
    frames_t = tile_len - k + 1
    in_read = t_idx < torch.div(L, TL, rounding_mode="floor")
    frame_ok = (in_read[:, :, None]
                & (f_idx < frames_t[:, :, None])).reshape(B, T * F)
    slots = torch.empty((B, H, T * F), dtype=torch.int64, device=dev)
    for s in range(H):
        base = spos[:, s, : T * TL]
        F_ts = frames_t - (params.spans[s] - k)                   # [B,T]
        clamp_idx = torch.clamp(t_idx * TL + F_ts - 1, 0, P - 1)
        vals = torch.gather(spos[:, s, :], 1, clamp_idx)          # [B,T]
        fix = (f_idx >= torch.clamp(F_ts, min=0)[:, :, None]
               ).reshape(B, T * F)
        vals_exp = vals[:, :, None].expand(B, T, F).reshape(B, T * F)
        arr = torch.where(fix, vals_exp, base)
        slots[:, s] = torch.where(frame_ok, arr, params.size)
    return slots, frame_ok


def build_slot_grid(codes: torch.Tensor, lengths: torch.Tensor,
                    fam: SeedFamily, params: MibfParams, num_tiles_max: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """codes uint8 [B, L] + lengths int32 [B] -> (slots, frame_ok) probe
    grid of ``tile_slot_grid``, hashing fused in (kernel A on the card)."""
    if params.frame_stride != 1:
        raise NotImplementedError(
            "frame_stride > 1 is ROADMAP queue 1 item 7 (sampled grids)")
    if codes.is_cuda:
        return _build_slot_grid_cuda(codes, lengths, fam, params,
                                     num_tiles_max)
    T, TL = num_tiles_max, params.tile_length
    hashes = hash_positions(codes, fam, T * TL)
    return tile_slot_grid(hashes, lengths, params, T)


def _build_slot_grid_cuda(codes, lengths, fam, params, T):
    B, L = codes.shape
    TL = params.tile_length
    dev = codes.device
    kernels.check(codes, "codes", torch.uint8, device=dev)
    kernels.check(lengths, "lengths", torch.int32, (B,), dev)
    if fam.h != params.h or fam.k != params.k:
        raise ValueError("seed family does not match params")
    slots = torch.empty((B, params.h, T * TL), dtype=torch.int64, device=dev)
    frame_ok = torch.empty((B, T * TL), dtype=torch.bool, device=dev)
    kernels.SEED_HASH_GRID(
        dev, kernels.ptr(codes), B, L, kernels.ptr(lengths),
        kernels.ptr(_family_tensor(fam, dev)), T, TL, params.size,
        _slot_mode(params.slot_map), kernels.ptr(slots),
        kernels.ptr(frame_ok))
    return slots, frame_ok


# ---------------------------------------------------------------------------
# probe + vote
# ---------------------------------------------------------------------------

class VoteResult(NamedTuple):
    curr_id: torch.Tensor      # int32 [B, T]  max-count id (ties -> smallest)
    top_count: torch.Tensor    # int32 [B, T]  its count
    cand_ids: torch.Tensor     # int32 [B, T, K]  ids with count>vote_min
    cand_counts: torch.Tensor  # int32 [B, T, K]  (count desc, id asc)
    bool_init: torch.Tensor    # bool  [B, T]  initial assignment gate
    overflow: torch.Tensor     # int32 [B, T]  candidates dropped beyond K
    queries: torch.Tensor      # int64 [B]
    hits: torch.Tensor         # int64 [B]
    misses: torch.Tensor       # int64 [B]


def probe_and_vote(words: torch.Tensor, slots: torch.Tensor,
                   frame_ok: torch.Tensor, params: MibfParams,
                   num_tiles: int, ranked: bool = False) -> VoteResult:
    """Batched miBF probe + per-tile ID voting (goldrush_path.cpp:544-634,
    goldrush_tpu/mibf/mibf.py:361-441).

    slots: int64 [B, H, T*F] probe grid; frame_ok: bool [B, T*F].  With
    ``ranked`` the grid holds ranks and ``words`` is the compressed filter's
    rank-indexed id table: a frame reads PRESENT | ids[rank], or 0 for the
    sentinel rank ids.numel() - 1 (goldrush_tpu/mibf/compressed.py:248)."""
    if params.probe_seeds:
        raise NotImplementedError(
            "probe_seeds > 0 is ROADMAP queue 1 item 7 (throughput mode)")
    if words.is_cuda:
        return _probe_and_vote_cuda(words, slots, frame_ok, params,
                                    num_tiles, ranked)
    return _probe_and_vote_plain(words, slots, frame_ok, params, num_tiles,
                                 ranked)


def _probe_and_vote_cuda(words, slots, frame_ok, params, num_tiles,
                         ranked=False):
    B, H, TF = slots.shape
    T, K = num_tiles, params.vote_topk
    F = TF // T
    dev = words.device
    kernels.check(words, "words", torch.int32, device=dev)
    kernels.check(slots, "slots", torch.int64, device=dev)
    kernels.check(frame_ok, "frame_ok", torch.bool, (B, TF), dev)
    if F * T != TF or H > 8 or K > H * F:
        raise ValueError(f"unsupported probe grid {tuple(slots.shape)} "
                         f"for T={T}, K={K}")
    n2 = kernels.next_pow2(H * F)
    if (2 * n2 + 4 + 256) * 8 > kernels.MAX_SMEM:
        raise ValueError(f"tile of {H}x{F} frames exceeds the probe_vote "
                         "kernel's shared memory")
    i32 = dict(dtype=torch.int32, device=dev)
    out = VoteResult(
        curr_id=torch.empty((B, T), **i32),
        top_count=torch.empty((B, T), **i32),
        cand_ids=torch.empty((B, T, K), **i32),
        cand_counts=torch.empty((B, T, K), **i32),
        bool_init=torch.empty((B, T), dtype=torch.bool, device=dev),
        overflow=torch.empty((B, T), **i32),
        # accumulated with atomics across a read's tiles
        queries=torch.zeros(B, dtype=torch.int64, device=dev),
        hits=torch.zeros(B, dtype=torch.int64, device=dev),
        misses=torch.zeros(B, dtype=torch.int64, device=dev))
    kernels.PROBE_VOTE(
        dev, kernels.ptr(words), kernels.ptr(slots), int(ranked),
        words.shape[0] - 1, kernels.ptr(frame_ok), B, H, T, F, K,
        params.vote_min, params.threshold, n2,
        *(kernels.ptr(t) for t in out))
    return out


def _probe_and_vote_plain(words, slots, frame_ok, params, num_tiles,
                          ranked=False):
    B, H, TF = slots.shape
    T = num_tiles
    F = TF // T
    K = params.vote_topk
    FH = F * H
    ws = [words[slots[:, s, :]] for s in range(H)]       # H gathers [B, TF]
    if ranked:
        sent = words.shape[0] - 1
        ws = [torch.where(slots[:, s, :] < sent, w | PRESENT_BIT, 0)
              for s, w in enumerate(ws)]
    present = ws[0] & PRESENT_BIT
    for s in range(1, H):
        present = present & ws[s]
    frame_present = (present != 0) & frame_ok             # atRank gate
    id_list = [torch.where(frame_present, w & ID_MASK, 0).to(torch.int64)
               for w in ws]
    queries = frame_ok.sum(dim=1, dtype=torch.int64)
    hits = sum((frame_present & (v != 0)).sum(dim=1, dtype=torch.int64)
               for v in id_list)
    misses = sum((frame_present & (v == 0)).sum(dim=1, dtype=torch.int64)
                 for v in id_list)
    # dedupe ids within a frame (the reference's per-frame unique_ids set)
    for j in range(1, H):
        dup = torch.zeros_like(frame_present)
        for i in range(j):
            dup |= id_list[j] == id_list[i]
        id_list[j] = torch.where(dup, 0, id_list[j])
    votes = torch.cat([v.reshape(B * T, F) for v in id_list], dim=1)
    votes = torch.sort(votes, dim=1).values               # 0s first
    prev = torch.nn.functional.pad(votes[:, :-1], (1, 0))
    is_start = (votes != 0) & (votes != prev)
    idx = torch.arange(FH, device=votes.device)[None, :]
    start_pos = torch.where(is_start, idx, FH)
    # next run start after each position -> run length at starts
    nxt = torch.flip(torch.cummin(torch.flip(start_pos[:, 1:], [1]),
                                  dim=1).values, [1])
    next_start = torch.cat(
        [nxt, torch.full((B * T, 1), FH, device=votes.device)], dim=1)
    run_len = torch.where(is_start, next_start - idx, 0)
    # unique ids ordered by (count desc, id asc) with one int64 key
    key = torch.where(is_start, ((FH + 1 - run_len) << 32) | votes, _I64_MAX)
    key = torch.sort(key, dim=1).values
    top_counts = torch.where(key == _I64_MAX, 0, FH + 1 - (key >> 32))
    top_ids = torch.where(top_counts > 0, key & _MASK32, 0)
    curr_id = top_ids[:, 0]
    top_count = top_counts[:, 0]
    over = top_counts > params.vote_min
    cand_ids = torch.where(over[:, :K], top_ids[:, :K], 0)
    cand_counts = torch.where(over[:, :K], top_counts[:, :K], 0)
    overflow = torch.clamp(over.sum(dim=1) - K, min=0)
    bool_init = (top_count > params.vote_min) & (top_count > params.threshold)
    i32 = torch.int32
    return VoteResult(
        curr_id=curr_id.reshape(B, T).to(i32),
        top_count=top_count.reshape(B, T).to(i32),
        cand_ids=cand_ids.reshape(B, T, K).to(i32),
        cand_counts=cand_counts.reshape(B, T, K).to(i32),
        bool_init=bool_init.reshape(B, T),
        overflow=overflow.reshape(B, T).to(i32),
        queries=queries, hits=hits, misses=misses)


# ---------------------------------------------------------------------------
# insertion
# ---------------------------------------------------------------------------

def insert_read_sorted(state: MibfState, slots: torch.Tensor, tile_lo: int,
                       tile_hi: int, base_id: int, trimmed: bool,
                       params: MibfParams, num_tiles: int) -> MibfState:
    """Exact reservoir insert of one read's tile blocks, in place
    (process_read goldrush_path.cpp:983-994 / :1041-1053,
    MIBFConstructSupport.hpp:247-283).

    slots: int64 [H, T*F] the read's probe grid (sentinel-padded).  Tiles
    lo..hi group into blocks of ``block_size``; block m gets id base + m,
    or base + (m*bs + 1) // bs when trimmed.  Blocks go in order; within a
    block every distinct real slot bumps its counter once and takes the
    block id iff (u32(slot) ^ id) % cnt == cnt - 1, so the last accepting
    block wins.  The word becomes PRESENT | id: the JAX engine's
    ``assume_present=True`` path (every inserted slot was presence-filled in
    pass 1, and goldrush-path never sets the saturation bit).  This is the
    semantics of ``build_insert_keys`` + ``insert_read_sorted``
    (goldrush_tpu/mibf/mibf.py:524-634)."""
    insert_blocks(state.words, state.counts, slots, tile_lo, tile_hi,
                  base_id, trimmed, params, num_tiles, params.size,
                  PRESENT_BIT)
    return state


def insert_blocks(table: torch.Tensor, counts: torch.Tensor,
                  grid: torch.Tensor, lo: int, hi: int, base_id: int,
                  trimmed: bool, params: MibfParams, num_tiles: int,
                  limit: int, or_bits: int) -> None:
    """The reservoir insert over any key space (kernel D), in place: grid
    entries < ``limit`` are real keys into ``table``/``counts``, and an
    accepted key's entry becomes ``or_bits | id``.  Direct filter: slots,
    limit = size, or_bits = PRESENT; compressed filter: ranks, limit = the
    sentinel rank, or_bits = 0 (compressed.py:414-476)."""
    if params.frame_stride != 1:
        raise NotImplementedError(
            "insert_stride > 1 is ROADMAP queue 1 item 7 (throughput mode)")
    if table.is_cuda:
        _insert_cuda(table, counts, grid, lo, hi, base_id, trimmed, params,
                     num_tiles, limit, or_bits)
    else:
        _insert_plain(table, counts, grid, lo, hi, base_id, trimmed, params,
                      num_tiles, limit, or_bits)


def _block_id(base_id: int, m: int, bs: int, trimmed: bool) -> int:
    return (base_id + ((m * bs + 1) // bs if trimmed else m)) & _MASK32


def _insert_cuda(words, counts, slots, lo, hi, base_id, trimmed, params, T,
                 limit, or_bits):
    dev = words.device
    H, TF = slots.shape
    F = TF // T
    bs = params.block_size
    kernels.check(words, "words", torch.int32, device=dev)
    kernels.check(counts, "counts", torch.int32, words.shape, dev)
    kernels.check(slots, "slots", torch.int64, device=dev)
    if F * T != TF or limit >= 1 << 32 or limit >= words.shape[0]:
        raise ValueError(f"unsupported insert grid {tuple(slots.shape)} "
                         f"or key limit {limit}")
    n2 = kernels.next_pow2(min(bs, T) * F * H)
    # one block's slot list sorts in shared memory when it fits; past
    # that the kernel sorts in a global scratch buffer allocated here
    scratch = (None if 4 * n2 <= kernels.MAX_SMEM
               else torch.empty(n2, dtype=torch.int32, device=dev))
    kernels.INSERT_SORTED(
        dev, kernels.ptr(words), kernels.ptr(counts), kernels.ptr(slots),
        H, TF, F, int(limit), int(or_bits), int(lo), int(hi),
        int(base_id) & _MASK32, int(bool(trimmed)), bs,
        kernels.ptr(scratch), n2)


def _insert_plain(words, counts, slots, lo, hi, base_id, trimmed, params, T,
                  limit, or_bits):
    H, TF = slots.shape
    F = TF // T
    bs = params.block_size
    m = 0
    while lo + m * bs <= hi:
        t0 = lo + m * bs
        t1 = min(hi, t0 + bs - 1, T - 1)
        bid = _block_id(base_id, m, bs, trimmed)
        blk = slots[:, t0 * F: (t1 + 1) * F].reshape(-1)
        u = torch.unique(blk[blk < limit])                # sorted, distinct
        cnt = (counts[u].to(torch.int64) & _MASK32) + 1
        counts[u] = cnt.to(torch.int32)
        accept = (((u & _MASK32) ^ bid) % cnt) == cnt - 1
        word = or_bits | bid
        words[u[accept]] = word - (1 << 32) if word > 0x7FFFFFFF else word
        m += 1


def reset_ids(state: MibfState) -> MibfState:
    """Silver-path rotation (goldrush_path.cpp:156-187), in place: zero IDs
    and counters, keep presence bits."""
    state.words.bitwise_and_(PRESENT_BIT)
    state.counts.zero_()
    return state


def save_state(state: MibfState, params: MibfParams, path: str) -> None:
    """Persist the filter in the JAX package's .npz format
    (goldrush_tpu/mibf/mibf.py:693-700): either package loads it."""
    words, counts = state_to_numpy(state)
    np.savez_compressed(
        path, words=words, counts=counts, size=params.size, h=params.h,
        k=params.k, spans=np.asarray(params.spans),
        tile_length=params.tile_length)


def load_state(path: str, device="cpu") -> tuple[MibfState, dict]:
    z = np.load(path)
    state = state_from_numpy(z["words"], z["counts"], device)
    meta = {k: (int(z[k]) if z[k].ndim == 0 else tuple(int(x) for x in z[k]))
            for k in ("size", "h", "k", "spans", "tile_length")}
    return state, meta
