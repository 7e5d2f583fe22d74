"""Direct multi-index Bloom filter: two flat arrays on an explicit device.

The layout is the JAX package's direct mode (goldrush_tpu/mibf/mibf.py):

  words[slot]  = [31: saturation][30: presence][29..0: block ID]
  counts[slot] = reservoir counter (MIBFConstructSupport.hpp m_counts)

both carried as int32 tensors holding the uint32 bits (PyTorch has no
uint32 arithmetic on the CPU), with slot ``size`` the sentinel that invalid
probe frames point at.  Slot grids are int64 throughout.

Six functions own a kernel; each runs its plain PyTorch version for CPU
tensors and launches its CUDA kernel for CUDA tensors (or raises):

  fill_presence_bits kernel A, fill entry  (csrc/seed_hash.cu)
  merge_presence     presence_merge        (csrc/seed_hash.cu)
  build_slot_grid    kernel A, grid entry  (csrc/seed_hash.cu), any stride
  probe_and_vote     kernel B              (csrc/probe_vote.cu)
  insert_blocks      kernel D              (csrc/insert_sorted.cu), exact
  insert_max         insert_max (K15)      (csrc/insert_max.cu), throughput

A fill pass sets bits in a presence bitmap of ceil(size / 32) words batch
by batch (``fill_presence_bits``), then the direct filter stores PRESENT
into the words of its set slots once (``merge_presence``): as their first
write into words allocated without a zero-fill, or as an OR into words
that already hold bits.  ``fill_presence`` does the OR for one batch.

``probe_and_vote``, ``insert_blocks`` and ``insert_max`` also serve the
rank-compressed filter (``compressed.py``), keyed on ranks instead of slots.

Unlike the JAX package, the filter is updated in place (``merge_presence``,
``insert_read_sorted``, ``insert_read_max``, ``reset_ids``): a 1.14 GB
filter is never copied.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..ops.nthash import SeedFamily, hash_positions, hash_sampled

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
    frame_stride: int = 1      # probe every S-th frame of a tile (1 = all)
    vote_min: int = 2          # candidate gate "count > vote_min"
    probe_seeds: int = 0       # probe the first N seeds of a grid (0 = all)
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


# kernel A's table of each seed family, on each device it was used on
_FAMILY_TABLES: dict = {}


def _family_args(fam: SeedFamily, device) -> tuple:
    """Kernel A's family arguments: its ``kernel_table`` on ``device``,
    copied there once per family and device, and its scalars."""
    table = _FAMILY_TABLES.get((fam, device))
    if table is None:
        table = torch.from_numpy(fam.kernel_table().view(np.int64)).to(device)
        _FAMILY_TABLES[(fam, device)] = table
    return (kernels.ptr(table), fam.h, fam.k, fam.half, len(fam.care_left),
            len(fam.care_right), fam.pad_needed)


# ---------------------------------------------------------------------------
# pass-1 presence fill
# ---------------------------------------------------------------------------

def presence_bitmap(size: int, device="cpu") -> torch.Tensor:
    """A zeroed presence bitmap: int32 [ceil(size / 32)] (uint32 bits), bit
    slot & 31 of word slot >> 5 standing for slot."""
    return torch.zeros(-(-size // 32), dtype=torch.int32, device=device)


def fill_presence(words: torch.Tensor, codes: torch.Tensor,
                  lengths: torch.Tensor, fam: SeedFamily, size: int,
                  slot_mode: str = "fastrange") -> torch.Tensor:
    """Pass-1 presence fill (MIBFConstructSupport.hpp:134-147) of one
    batch, in place: set PRESENT at the slot of every valid hash of every
    read, through a bitmap of its own (``fill_presence_bits``, then
    ``merge_presence``).  Returns ``words``."""
    bits = presence_bitmap(size, words.device)
    fill_presence_bits(bits, codes, lengths, fam, size, slot_mode)
    return merge_presence(words, bits, size)


def fill_presence_bits(bits: torch.Tensor, codes: torch.Tensor,
                       lengths: torch.Tensor, fam: SeedFamily, size: int,
                       slot_mode: str = "fastrange") -> torch.Tensor:
    """Set, in the bitmap ``bits`` (``presence_bitmap``), the bit of the
    slot of every valid hash of a batch (kernel A's fill entry).

    codes: uint8 [B, L] zero-padded reads; lengths: int32 [B].  Frame p of
    seed s is valid when p < lengths[b] - span_s + 1, the mask the JAX
    engine builds for ``goldrush_tpu.mibf.mibf.fill_presence``
    (engine.py:465-471).  Returns ``bits``."""
    if bits.is_cuda or codes.is_cuda or lengths.is_cuda:
        return _fill_bits_cuda(bits, codes, lengths, fam, size, slot_mode)
    return _fill_bits_plain(bits, codes, lengths, fam, size, slot_mode)


def _fill_bits_cuda(bits, codes, lengths, fam, size, slot_mode):
    B, L = codes.shape
    dev = bits.device
    kernels.check(bits, "bits", torch.int32, (-(-size // 32),), dev)
    kernels.check(codes, "codes", torch.uint8, device=dev)
    kernels.check(lengths, "lengths", torch.int32, (B,), dev)
    if not 0 < size < 1 << 32:
        raise ValueError(f"size {size} is not a uint32 slot count")
    kernels.SEED_HASH_FILL(
        dev, kernels.ptr(codes), B, L, kernels.ptr(lengths),
        *_family_args(fam, dev), size, _slot_mode(slot_mode),
        kernels.ptr(bits))
    return bits


def _fill_bits_plain(bits, codes, lengths, fam, size, slot_mode):
    B, L = codes.shape
    P = max(L - fam.k + 1, 1)
    hashes = hash_positions(codes, fam, P)                  # [B, h, P]
    p = torch.arange(P, device=codes.device)
    spans = torch.tensor(fam.spans, device=codes.device)
    n_valid = lengths.to(torch.int64)[:, None] - spans[None, :] + 1
    valid = p[None, None, :] < n_valid[:, :, None]          # [B, h, P]
    # no scatter-OR here: distinct slots give each word distinct bits,
    # whose sum is their OR
    slots = torch.unique(slot_of(hashes[valid], size, slot_mode))
    word, inv = torch.unique(slots >> 5, return_inverse=True)
    new = torch.zeros(word.shape, dtype=torch.int64, device=bits.device)
    new.index_add_(0, inv, torch.ones_like(slots) << (slots & 31))
    bits[word] = _as_int32((bits[word].to(torch.int64) & _MASK32) | new)
    return bits


def merge_presence(words: torch.Tensor, bits: torch.Tensor, size: int,
                   first_write: bool = False) -> torch.Tensor:
    """Set PRESENT in ``words[slot]`` for every slot < size set in the
    bitmap ``bits``, in place.  By default an OR that keeps every other bit
    of every word; with ``first_write`` every word of ``words`` is stored,
    whatever it held: PRESENT where the bit is set, 0 elsewhere (slot
    ``size`` and the padding included).  Returns ``words``."""
    if words.is_cuda or bits.is_cuda:
        return _merge_cuda(words, bits, size, first_write)
    return _merge_plain(words, bits, size, first_write)


def _merge_cuda(words, bits, size, first_write=False):
    dev = words.device
    kernels.check(words, "words", torch.int32, device=dev)
    kernels.check(bits, "bits", torch.int32, (-(-size // 32),), dev)
    n = words.shape[0]
    # the kernel moves 4 slots' words at a time, as one aligned 16 bytes
    if (n < -(-size // 4) * 4 or (first_write and n % 4)
            or words.data_ptr() % 16):
        raise ValueError(f"words [{n}] must be 16-byte aligned and cover "
                         f"{size} slots in groups of 4")
    kernels.PRESENCE_MERGE(dev, kernels.ptr(bits), size, kernels.ptr(words),
                           n, int(first_write))
    return words


def _merge_plain(words, bits, size, first_write=False):
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    present = ((bits[:, None] >> shifts) & 1).reshape(-1)[:size]
    if first_write:
        words.zero_()
    words[:size].bitwise_or_(present << 30)                 # PRESENT_BIT
    return words


# ---------------------------------------------------------------------------
# tile/frame slot grid
# ---------------------------------------------------------------------------

def tile_slot_grid(hashes: torch.Tensor, lengths: torch.Tensor,
                   params: MibfParams, num_tiles_max: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: map whole-read position hashes to the per-tile probe
    grid (goldrush_tpu/mibf/mibf.py:158-211).

    hashes: int64 [B, h, P] (P >= num_tiles_max * tile_length); lengths:
    [B].  Returns (slots int64 [B, h, T*F] with the sentinel ``size`` where
    frame_ok is False, frame_ok bool [B, T*F]), F = TL / frame_stride.
    Frame j of tile t probes global position t*TL + min(j*S, F_ts - 1): the
    clamp reproduces the stale-tail lockstep of
    multiLensfrHashIterator.hpp:49-67.  At a stride S > 1 this is the dense
    grid subsampled, which both sampled paths equal."""
    TL, k, S = params.tile_length, params.k, params.frame_stride
    B, _, P = hashes.shape
    T, F, H = num_tiles_max, TL // S, params.h
    dev = hashes.device
    spos = slot_of(hashes, params.size, params.slot_map)
    t_idx = torch.arange(T, device=dev)[None, :]                  # [1,T]
    f_idx = torch.arange(F, device=dev)[None, None, :] * S        # [1,1,F]
    frames_t, in_read, _ = clamp_tile_geometry(lengths, params, T)
    frame_ok = (in_read[:, :, None]
                & (f_idx < frames_t[:, :, None])).reshape(B, T * F)
    slots = torch.empty((B, H, T * F), dtype=torch.int64, device=dev)
    for s in range(H):
        base = spos[:, s, : T * TL: S]
        F_ts = frames_t - (params.spans[s] - k)                   # [B,T]
        clamp_idx = torch.clamp(t_idx * TL + F_ts - 1, 0, P - 1)
        vals = torch.gather(spos[:, s, :], 1, clamp_idx)          # [B,T]
        fix = (f_idx >= torch.clamp(F_ts, min=0)[:, :, None]
               ).reshape(B, T * F)
        vals_exp = vals[:, :, None].expand(B, T, F).reshape(B, T * F)
        arr = torch.where(fix, vals_exp, base)
        slots[:, s] = torch.where(frame_ok, arr, params.size)
    return slots, frame_ok


def clamp_tile_geometry(lengths: torch.Tensor, params: MibfParams,
                        num_tiles_max: int) -> tuple:
    """[B, T] tile geometry (goldrush_tpu/mibf/mibf.py:214): (frames_t,
    in_read, each seed's clamp position int64 [B, h, T])."""
    TL, k = params.tile_length, params.k
    t_idx = torch.arange(num_tiles_max, device=lengths.device)[None, :]
    L = lengths.to(torch.int64)[:, None]                          # [B,1]
    tile_len = torch.clamp(L - t_idx * TL, max=TL + k - 1)        # [B,T]
    frames_t = tile_len - k + 1
    in_read = t_idx < torch.div(L, TL, rounding_mode="floor")
    clamp = torch.stack([torch.clamp(t_idx * TL + frames_t
                                     - (params.spans[s] - k) - 1, min=0)
                         for s in range(params.h)], dim=1)
    return frames_t, in_read, clamp


def _sampled_frames(lengths, params, T):
    """frames_t, in_read, the sampled frame positions f_idx [1, 1, F] and
    frame_ok [B, T*F] of both sampled grids."""
    S = params.frame_stride
    B = lengths.shape[0]
    F = params.tile_length // S
    f_idx = torch.arange(F, device=lengths.device)[None, None, :] * S
    frames_t, in_read, _ = clamp_tile_geometry(lengths, params, T)
    frame_ok = (in_read[:, :, None]
                & (f_idx < frames_t[:, :, None])).reshape(B, T * F)
    return frames_t, in_read, f_idx, frame_ok


def tile_slot_grid_sampled(h_strided: torch.Tensor, h_clamp: torch.Tensor,
                           lengths: torch.Tensor, params: MibfParams,
                           num_tiles_max: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of goldrush_tpu/mibf/mibf.py:234: the sampled grid
    from strided hashes [B, h, >= T*F] and the hashes at every tile's
    clamp positions [B, h, T] (``clamp_tile_geometry``)."""
    T, k = num_tiles_max, params.k
    B, H = h_strided.shape[0], params.h
    F = params.tile_length // params.frame_stride
    frames_t, _, f_idx, frame_ok = _sampled_frames(lengths, params, T)
    spos = slot_of(h_strided[:, :, : T * F], params.size, params.slot_map)
    cvals = slot_of(h_clamp, params.size, params.slot_map)        # [B,H,T]
    slots = torch.empty((B, H, T * F), dtype=torch.int64,
                        device=h_strided.device)
    for s in range(H):
        F_ts = frames_t - (params.spans[s] - k)
        fix = (f_idx >= torch.clamp(F_ts, min=0)[:, :, None]).reshape(B, -1)
        vals = cvals[:, s, :, None].expand(B, T, F).reshape(B, T * F)
        slots[:, s] = torch.where(frame_ok,
                                  torch.where(fix, vals, spos[:, s]),
                                  params.size)
    return slots, frame_ok


def clamp_last_tile_positions(lengths: torch.Tensor, params: MibfParams
                              ) -> torch.Tensor:
    """Each seed's clamp position in each read's last tile only: int64
    [B, h, 1] (goldrush_tpu/mibf/mibf.py:269).  At a stride S >= h a full
    tile's stale-tail frames hold no multiple of S, so only the last tile
    can clamp."""
    TL, k = params.tile_length, params.k
    L = lengths.to(torch.int64)[:, None]                          # [B,1]
    t = torch.clamp(torch.div(L, TL, rounding_mode="floor"), min=1) - 1
    frames_t = torch.clamp(L - t * TL, max=TL + k - 1) - k + 1
    return torch.stack([torch.clamp(t * TL + frames_t - (params.spans[s] - k)
                                    - 1, min=0)
                        for s in range(params.h)], dim=1)


def tile_slot_grid_sampled_lt(h_strided: torch.Tensor,
                              h_clamp_last: torch.Tensor,
                              lengths: torch.Tensor, params: MibfParams,
                              num_tiles_max: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of goldrush_tpu/mibf/mibf.py:288: the sampled grid at a
    stride >= h, whose clamp fix-ups lie in each read's last tile
    (``h_clamp_last`` [B, h, 1])."""
    if params.frame_stride < params.h:
        raise ValueError("the last-tile sampled grid needs stride >= h")
    T, k, TL = num_tiles_max, params.k, params.tile_length
    B, H = h_strided.shape[0], params.h
    F = TL // params.frame_stride
    frames_t, in_read, f_idx, frame_ok = _sampled_frames(lengths, params, T)
    t_idx = torch.arange(T, device=lengths.device)[None, :]
    n_tiles = torch.div(lengths.to(torch.int64), TL, rounding_mode="floor")
    is_last = t_idx == (n_tiles[:, None] - 1)                     # [B,T]
    spos = slot_of(h_strided[:, :, : T * F], params.size, params.slot_map)
    cvals = slot_of(h_clamp_last[:, :, 0], params.size, params.slot_map)
    slots = torch.empty((B, H, T * F), dtype=torch.int64,
                        device=h_strided.device)
    for s in range(H):
        F_ts = frames_t - (params.spans[s] - k)
        fix = ((f_idx >= torch.clamp(F_ts, min=0)[:, :, None])
               & is_last[:, :, None]).reshape(B, T * F)
        slots[:, s] = torch.where(
            frame_ok, torch.where(fix, cvals[:, s, None], spos[:, s]),
            params.size)
    return slots, frame_ok


def build_slot_grid(codes: torch.Tensor, lengths: torch.Tensor,
                    fam: SeedFamily, params: MibfParams, num_tiles_max: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """codes uint8 [B, L] + lengths int32 [B] -> (slots [B, h, T*TL/S],
    frame_ok [B, T*TL/S]) probe grid of ``tile_slot_grid``, hashing fused in
    (kernel A on the card).  The plain version takes the JAX package's
    route by stride (goldrush_tpu/mibf/mibf.py:323-341): dense at stride 1,
    the last-tile sampled grid at S >= h, the general sampled one below."""
    if codes.is_cuda or lengths.is_cuda:
        return _build_slot_grid_cuda(codes, lengths, fam, params,
                                     num_tiles_max)
    return _build_slot_grid_plain(codes, lengths, fam, params, num_tiles_max)


def _build_slot_grid_cuda(codes, lengths, fam, params, T):
    grid, frame_ok, args = grid_launch_args(codes, lengths, fam, params, T)
    kernels.SEED_HASH_GRID(*args, kernels.ptr(grid), kernels.ptr(frame_ok))
    return grid, frame_ok


def _build_slot_grid_plain(codes, lengths, fam, params, T):
    P, S = T * params.tile_length, params.frame_stride
    if S == 1:
        return tile_slot_grid(hash_positions(codes, fam, P), lengths, params,
                              T)
    if S >= params.h:
        hs, hc = hash_sampled(codes, fam, P, S,
                              clamp_last_tile_positions(lengths, params))
        return tile_slot_grid_sampled_lt(hs, hc, lengths, params, T)
    hs, hc = hash_sampled(codes, fam, P, S,
                          clamp_tile_geometry(lengths, params, T)[2])
    return tile_slot_grid_sampled(hs, hc, lengths, params, T)


def grid_launch_args(codes, lengths, fam, params, T) -> tuple:
    """Kernel A's grid entries: the checked inputs as the leading launch
    arguments (device first, the slot map last), and the empty grid
    [B, h, T*TL/S] (int64) and frame_ok [B, T*TL/S] they fill."""
    B, L = codes.shape
    TL, S = params.tile_length, params.frame_stride
    dev = codes.device
    kernels.check(codes, "codes", torch.uint8, device=dev)
    kernels.check(lengths, "lengths", torch.int32, (B,), dev)
    if fam.h != params.h or fam.k != params.k:
        raise ValueError("seed family does not match params")
    # the kernel's stale-tail clamp stays inside the tile (seed_hash.cu)
    if TL < fam.k + fam.h - 1:
        raise ValueError(f"tile_length {TL} < k + h - 1")
    if S < 1 or TL % S:
        raise ValueError(f"frame_stride {S} does not divide tile_length {TL}")
    grid = torch.empty((B, params.h, T * TL // S), dtype=torch.int64,
                       device=dev)
    frame_ok = torch.empty((B, T * TL // S), dtype=torch.bool, device=dev)
    args = (dev, kernels.ptr(codes), B, L, kernels.ptr(lengths),
            *_family_args(fam, dev), T, TL, S, params.size,
            _slot_mode(params.slot_map))
    return grid, frame_ok, args


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
    sentinel rank ids.numel() - 1 (goldrush_tpu/mibf/compressed.py:248).
    With ``params.probe_seeds`` only the grid's first seeds are probed
    (goldrush_tpu/mibf/mibf.py:370)."""
    if 0 < params.probe_seeds < slots.shape[1]:
        slots = slots[:, : params.probe_seeds].contiguous()
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
    # the kernel's vote table in shared memory holds up to 16,384 votes
    if H * F > 1 << 14:
        raise ValueError(f"tile of {H}x{F} frames exceeds the probe_vote "
                         "kernel's shared memory")
    i32 = dict(dtype=torch.int32, device=dev)
    # queries, hits, misses: accumulated with atomics across a read's
    # tiles, so zeroed first, by one fill
    counters = torch.zeros((3, B), dtype=torch.int64, device=dev)
    out = VoteResult(
        curr_id=torch.empty((B, T), **i32),
        top_count=torch.empty((B, T), **i32),
        cand_ids=torch.empty((B, T, K), **i32),
        cand_counts=torch.empty((B, T, K), **i32),
        bool_init=torch.empty((B, T), dtype=torch.bool, device=dev),
        overflow=torch.empty((B, T), **i32),
        queries=counters[0], hits=counters[1], misses=counters[2])
    kernels.PROBE_VOTE(
        dev, kernels.ptr(words), kernels.ptr(slots), int(ranked),
        words.shape[0] - 1, kernels.ptr(frame_ok), B, H, T, F, K,
        params.vote_min, params.threshold, *(kernels.ptr(t) for t in out))
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
    block every distinct real slot bumps its uint32 counter once and takes
    the block id iff (u32(slot) ^ id) % max(cnt, 1) == cnt - 1, so the last
    accepting block wins.  The word becomes PRESENT | id: the JAX engine's
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
            "insert_stride > 1 is ROADMAP queue 1 item 7 (after 7d)")
    if table.is_cuda:
        _insert_cuda(table, counts, grid, lo, hi, base_id, trimmed, params,
                     num_tiles, limit, or_bits)
    else:
        _insert_plain(table, counts, grid, lo, hi, base_id, trimmed, params,
                      num_tiles, limit, or_bits)


def _block_id(base_id: int, m: int, bs: int, trimmed: bool) -> int:
    return (base_id + ((m * bs + 1) // bs if trimmed else m)) & _MASK32


# Kernel D's launch shape, measured on an H100 (PERF.md): CTAs (each owns
# the keys insert_part gives it), CTAs per thread-block cluster (which
# share the window read), threads per CTA, and the entries a CTA holds in
# shared memory (a power of two; a CTA owning more sorts in global scratch)
INSERT_PARTS = 264
INSERT_CLUSTER = 8
INSERT_THREADS = 512
INSERT_CAP = 8_192


def insert_part(keys: torch.Tensor) -> torch.Tensor:
    """The CTA of kernel D that owns each key (< 2^32): a multiplicative
    hash of the key scaled to [0, INSERT_PARTS) (csrc/insert_sorted.cu
    part_of).  The products wrap in int64 as uint64 does; only their low
    32 bits are kept."""
    return (((keys * 0x9E3779B1) & _MASK32) * INSERT_PARTS) >> 32


def _insert_cuda(words, counts, slots, lo, hi, base_id, trimmed, params, T,
                 limit, or_bits):
    dev = words.device
    H, TF = slots.shape
    F = TF // T
    bs = params.block_size
    kernels.check(words, "words", torch.int32, device=dev)
    kernels.check(counts, "counts", torch.int32, words.shape, dev)
    kernels.check(slots, "slots", torch.int64, device=dev)
    if (F * T != TF or T >= 1 << 16 or TF >= 1 << 31 or lo < 0
            or not 0 <= limit < min(1 << 32, words.shape[0])):
        raise ValueError(f"unsupported insert grid {tuple(slots.shape)}, "
                         f"tiles from {lo} or key limit {limit}")
    window = H * max(0, min(hi, T - 1) - lo + 1) * F
    # a CTA owning more than INSERT_CAP entries takes a power-of-two slice
    # of this buffer (after its allocation counter): less than 2x the window
    scratch = (torch.empty(1 + 2 * window, dtype=torch.int64, device=dev)
               if window > INSERT_CAP else None)
    kernels.INSERT_SORTED(
        dev, kernels.ptr(words), kernels.ptr(counts), kernels.ptr(slots),
        H, TF, F, int(limit), int(or_bits), int(lo), int(hi),
        int(base_id) & _MASK32, int(bool(trimmed)), bs, INSERT_PARTS,
        INSERT_CLUSTER, INSERT_THREADS, INSERT_CAP, kernels.ptr(scratch))


def _as_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 values holding uint32 bits -> the int32 tensor of those bits."""
    return torch.where(v > 0x7FFFFFFF, v - (1 << 32), v).to(torch.int32)


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
        # uint32 counter; a wrap to 0 never accepts (the JAX max(cnt, 1))
        cnt = ((counts[u].to(torch.int64) & _MASK32) + 1) & _MASK32
        counts[u] = _as_int32(cnt)
        accept = ((((u & _MASK32) ^ bid) % torch.clamp(cnt, min=1))
                  == (cnt - 1) & _MASK32)
        word = or_bits | bid
        words[u[accept]] = word - (1 << 32) if word > 0x7FFFFFFF else word
        m += 1


def insert_read_max(state: MibfState, slots: torch.Tensor, tile_lo: int,
                    tile_hi: int, base_id: int, trimmed: bool,
                    params: MibfParams, num_tiles: int) -> MibfState:
    """Throughput-mode insert of one read, in place: a scatter-max of
    PRESENT | block id into the words at every real slot of tiles lo..hi of
    its full-resolution grid ``slots`` [H, T*F]; the counters stay as they
    are (goldrush_tpu/mibf/mibf.py:637-683)."""
    insert_max(state.words, slots, tile_lo, tile_hi, base_id, trimmed,
               params, num_tiles, params.size, PRESENT_BIT)
    return state


def insert_max(table: torch.Tensor, grid: torch.Tensor, lo: int, hi: int,
               base_id: int, trimmed: bool, params: MibfParams,
               num_tiles: int, limit: int, or_bits: int) -> None:
    """Max-id-wins insert over any key space (K15), in place: every grid
    entry of tiles lo..hi below ``limit`` takes ``table[key] = max(
    table[key], or_bits | id)``, id the entry's block id (``_block_id``).
    Direct filter: slots, limit = size, or_bits = PRESENT; compressed
    filter: ranks, limit = the sentinel rank, or_bits = 0.  Ids stay below
    2^30 and the table holds no saturation bit, so the int32 max is the
    JAX package's uint32 max."""
    if params.frame_stride != 1:
        raise NotImplementedError(
            "insert_stride > 1 is ROADMAP queue 1 item 7 (after 7d)")
    bs = params.block_size
    blocks = max(0, min(hi, num_tiles - 1) - lo) // bs + 1
    if not 0 < base_id or base_id + blocks > ID_MASK:
        raise ValueError(f"block ids {base_id}..+{blocks} leave (0, 2^30)")
    if table.is_cuda:
        _insert_max_cuda(table, grid, lo, hi, base_id, trimmed, bs,
                         num_tiles, limit, or_bits)
    else:
        _insert_max_plain(table, grid, lo, hi, base_id, trimmed, bs,
                          num_tiles, limit, or_bits)


def _insert_max_cuda(table, grid, lo, hi, base_id, trimmed, bs, T, limit,
                     or_bits):
    dev = table.device
    H, TF = grid.shape
    kernels.check(table, "table", torch.int32, device=dev)
    kernels.check(grid, "grid", torch.int64, device=dev)
    if (TF % T or TF >= 1 << 31 or lo < 0
            or not 0 <= limit < min(1 << 32, table.shape[0] + 1)):
        raise ValueError(f"unsupported insert grid {tuple(grid.shape)}, "
                         f"tiles from {lo} or key limit {limit}")
    kernels.INSERT_MAX(dev, kernels.ptr(table), kernels.ptr(grid), H, TF,
                       TF // T, int(limit), int(or_bits), int(lo), int(hi),
                       int(base_id), int(bool(trimmed)), bs)


def _insert_max_plain(table, grid, lo, hi, base_id, trimmed, bs, T, limit,
                      or_bits):
    H, TF = grid.shape
    F = TF // T
    t0, t1 = lo, min(hi, T - 1)
    if t1 < t0:
        return
    keys = grid[:, t0 * F: (t1 + 1) * F]
    m = (torch.arange(t0 * F, (t1 + 1) * F, device=grid.device) // F
         - lo) // bs
    ids = base_id + ((m * bs + 1) // bs if trimmed else m)
    vals = (or_bits | ids).to(torch.int32).expand(H, -1)
    real = keys < limit
    table.scatter_reduce_(0, keys[real], vals[real], "amax")


def reset_ids(state: MibfState, counts: bool = True) -> MibfState:
    """Silver-path rotation (goldrush_path.cpp:156-187), in place: zero IDs,
    keep presence bits; with ``counts`` (the exact policy) zero the
    counters too, which the throughput policy leaves as they are
    (goldrush_tpu/path/engine.py:824-825)."""
    state.words.bitwise_and_(PRESENT_BIT)
    if counts:
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
