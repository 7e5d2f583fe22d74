"""Rank-compressed miBF: one presence bit per slot, ids and counters per rank.

The layout is the JAX package's (goldrush_tpu/mibf/compressed.py), itself
the reference's (MIBloomFilter.hpp:94-101, MIBFConstructSupport::setup()):

  bitrank[w] = [63..32: present slots before slot 32w within its superblock
               of 2^32 slots][31..0: presence bits of slots 32w .. 32w+31],
               one zero word appended
  supers[s]  = present slots before superblock s (slots s * 2^32 ..): one
               entry, 0, below 2^32 slots; 14 at 56,947,329,536 slots
  ids[rank], counts[rank] = block id and reservoir counter of the rank-th
               present slot; the last entry is the sentinel rank

carried as int64 (bitrank, supers) and int32 (ids, counts) tensors holding
the unsigned bits; ranks are int64 everywhere, so a filter of more than
2^32 present slots needs nothing else.  The engine fills presence into a
bitmap of ceil(size / 32) words (kernel A's fill: the JAX package's
byte-per-slot transient of ``fill_bytes``, a bit per slot here), freezes the
bitmap into this structure (K12's ``freeze_device``), and from then on
hashes each batch straight to ranks once (kernel A's rank grid): probes
and inserts read and write the rank-indexed tables through kernels B and
D, keyed on the rank exactly like the reference's accept rule
(MIBFConstructSupport.hpp:274-282).  The direct filter's words are never
allocated.

Two functions own a kernel; each runs its plain PyTorch version for a CPU
tensor and its kernel for a CUDA tensor (or raises):

  build_rank       the freeze: popcount the bitmap, each word's rank within
                   its superblock, the superblock bases and the population
                   (rank_build, one launch; the plain version in three
                   steps: rank_pack's block cumsum, rank_scan's carries,
                   rank_carry's add)
  build_rank_grid  hash a batch to its probe grid of ranks at any stride
                   (kernel A's rank grid entry; ``build_rank_grids``: with
                   the query grid inside it); ``rank_grid`` is the plain
                   slot -> rank map

The probe (kernel B) and both inserts (kernel D, and insert_max for the
throughput mode) are the direct filter's, keyed on ranks; the blockwise
``insert_read`` runs kernel D on the slot grid, mapping each slot to its
rank inside the launch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from . import mibf as dm

SUPER_BITS = 32          # slots per superblock = 2^32
# slots per block of the plain freeze's int32 cumsum
RANK_BLOCK_SLOTS = 65_536
# blocks per superblock: a block never straddles two
SUPER_BLOCKS = (1 << SUPER_BITS) // RANK_BLOCK_SLOTS
# bitmap words rank_build takes a CTA (csrc/rank.cu kTileWords): a
# superblock is 16,384 tiles
RANK_TILE_WORDS = 8_192
_MASK32 = 0xFFFFFFFF


def n_supers(size: int) -> int:
    """Superblocks of a filter of ``size`` slots (the JAX package's
    n_super, compressed.py:163)."""
    return max(-(-size // (1 << SUPER_BITS)), 1)


class CompressedState(NamedTuple):
    bitrank: torch.Tensor    # int64 [nw + 1] (uint64 bits)
    supers: torch.Tensor     # int64 [n_super]
    ids: torch.Tensor        # int32 [alloc] (uint32 bits), rank-indexed,
                             # or dm.Banks (the mesh's model axis)
    counts: torch.Tensor     # int32 [alloc] (uint32 bits), rank-indexed,
                             # or dm.Banks

    @property
    def sentinel(self) -> int:
        """The rank absent and invalid slots map to (never written)."""
        return self.ids.shape[0] - 1


def rank_alloc(size: int) -> int:
    """The JAX package's size-deterministic rank-array length
    (goldrush_tpu/mibf/compressed.py:56-62)."""
    return -(-int(size * 0.105 + 2) // 1024) * 1024


def freeze(words: torch.Tensor, size: int) -> CompressedState:
    """Freeze a direct-layout presence fill into the rank structure
    (goldrush_tpu/mibf/compressed.py:132-182, ``freeze_device_words``):
    bit 30 of every slot word packed into a bitmap with plain torch ops,
    then ``build_rank`` and ``with_tables``.  The engine never holds direct
    words in this filter: it freezes its fill's bitmap."""
    return with_tables(*build_rank(_present_bits(words, size), size), size)


def _present_bits(words: torch.Tensor, size: int) -> torch.Tensor:
    """The presence bitmap of direct-layout words: bit slot & 31 of word
    slot >> 5 is bit 30 of ``words[slot]``, for slot < size (int32
    [ceil(size / 32)])."""
    nw = -(-size // 32)
    if words.shape[0] < nw * 32:
        raise ValueError(f"words [{words.shape[0]}] do not cover {size} "
                         "slots")
    b = ((words[: nw * 32] >> 30) & 1).to(torch.int64)
    b[size:] = 0
    bits = (b.reshape(nw, 32) << torch.arange(32, device=words.device)
            ).sum(dim=1)
    return dm._as_int32(bits)


def build_rank(bits: torch.Tensor, size: int
               ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Rank the presence bitmap ``bits`` (int32 [ceil(size / 32)], the fill's
    ``dm.presence_bitmap``; bits at or past ``size`` are ignored): (bitrank,
    supers, number of present slots), at any size.  ``bits`` is only read;
    a caller that owns it drops it before ``with_tables``, so the bitmap and
    the rank-indexed tables are never on the device together.  On the card
    one launch of rank_build, one zeroed scratch and one fetch of the
    population."""
    if size <= 0:
        raise ValueError(f"size {size}: a filter has slots")
    if bits.shape != (-(-size // 32),):
        raise ValueError(f"bitmap {tuple(bits.shape)} is not ceil({size} / "
                         "32) words")
    if bits.is_cuda:
        bitrank, supers, pop = _build_rank_cuda(bits, size)
        return bitrank, supers, int(pop.item())
    return _build_rank_plain(bits, size)


def _build_rank_cuda(bits, size):
    """rank_build's launch: bitrank, supers and the population (int64 [1]),
    not fetched."""
    nw = -(-size // 32)
    dev = bits.device
    kernels.check(bits, "bits", torch.int32, (nw,), dev)
    if bits.data_ptr() % 16:
        raise ValueError("bits must be 16-byte aligned")
    bitrank = torch.empty(nw + 1, dtype=torch.int64, device=dev)
    supers = torch.empty(n_supers(size), dtype=torch.int64, device=dev)
    pop = torch.empty(1, dtype=torch.int64, device=dev)
    # the tile ticket, the superblocks finished, a status word per tile
    scratch = torch.zeros(-(-nw // RANK_TILE_WORDS) + 2, dtype=torch.int64,
                          device=dev)
    kernels.RANK_BUILD(dev, kernels.ptr(bits), size, nw, kernels.ptr(bitrank),
                       kernels.ptr(supers), kernels.ptr(pop),
                       kernels.ptr(scratch))
    return bitrank, supers, pop


def _build_rank_plain(bits, size):
    """The plain freeze: rank_pack's per-block cumsum, rank_scan's
    carries, rank_carry's add."""
    bitrank, carries = _rank_pack_plain(bits, size)
    supers, pop = _rank_scan_plain(carries, size)
    _rank_carry_plain(bitrank, carries)
    return bitrank, supers, pop


def with_tables(bitrank: torch.Tensor, supers: torch.Tensor, pop: int,
                size: int, banks=None) -> CompressedState:
    """The compressed state over a frozen ``bitrank`` and ``supers``:
    zeroed rank-indexed id/counter tables of ``max(rank_alloc(size), pop +
    1)`` entries rounded up to 1024, the JAX package's allocation
    (compressed.py:172-182), on bitrank's device, or banked over the
    devices ``banks`` (a mesh row: ``dm.new_banks``)."""
    alloc = max(rank_alloc(size), -(-(pop + 1) // 1024) * 1024)
    devices = banks or [bitrank.device]
    return CompressedState(bitrank=bitrank, supers=supers,
                           ids=dm.new_banks(alloc, devices),
                           counts=dm.new_banks(alloc, devices))


def _rank_pack_plain(bits, size):
    """The plain freeze's first step: bitrank [nw + 1] with each bitmap
    word's presence bits (slots at or past ``size`` cleared) and its
    exclusive rank within its block of RANK_BLOCK_SLOTS slots, and the
    per-block totals."""
    nw = -(-size // 32)
    bw = RANK_BLOCK_SLOTS // 32
    nblk = -(-nw // bw)
    b = bits.clone()
    if size % 32:                                 # slots >= size are not real
        b[-1] &= (1 << (size % 32)) - 1
    # int32 throughout the block cumsum (a block holds 65,536 slots), in
    # place: a 2^32-slot bitmap is 512 MB of words
    pops = torch.zeros(nblk * bw, dtype=torch.int32, device=bits.device)
    pops[:nw] = _popcount32_(b.clone())
    pops = pops.reshape(nblk, bw)
    local = torch.cumsum(pops, 1, dtype=torch.int32).sub_(pops)
    bitrank = torch.zeros(nw + 1, dtype=torch.int64, device=bits.device)
    bitrank[:nw] = local.reshape(-1)[:nw]
    bitrank[:nw] <<= 32
    bitrank[:nw] |= b.to(torch.int64) & _MASK32
    return bitrank, pops.sum(dim=1, dtype=torch.int64)


def _rank_scan_plain(totals, size):
    """The second step, in place: the per-block totals become each block's
    carry, the totals of the blocks before it in its superblock of 2^32
    slots.  Returns (supers, pop): int64 [n_super], the present slots
    before each superblock (the JAX package's super_base), and the number
    of present slots."""
    if totals.shape[0] != -(-size // RANK_BLOCK_SLOTS):
        raise ValueError(f"{totals.shape[0]} block totals for {size} slots")
    cum = torch.cumsum(totals, 0) - totals       # global exclusive prefix
    supers = cum[::SUPER_BLOCKS].clone()
    sup_of = torch.arange(totals.shape[0], device=totals.device) \
        // SUPER_BLOCKS
    pop = int(totals.sum())
    totals.copy_(cum - supers[sup_of])
    return supers, pop


def _rank_carry_plain(bitrank, carries):
    """The last step, in place: each word's in-block rank gains its block's
    carry, making it the word's rank within its superblock; the appended
    word is zeroed."""
    nw = bitrank.shape[0] - 1
    bitrank[:nw] += torch.repeat_interleave(
        carries << 32, RANK_BLOCK_SLOTS // 32)[:nw]
    bitrank[nw] = 0


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Population count of the low 32 bits of int64 values (SWAR)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def _popcount32_(v: torch.Tensor) -> torch.Tensor:
    """``_popcount32`` of int32 words holding uint32 bits, in place.  The
    signed shifts give the unsigned ones' bits wherever the masks keep
    them, and the count (at most 32) leaves the sign bit clear."""
    t = v >> 1
    v.sub_(t.bitwise_and_(0x55555555))
    torch.bitwise_right_shift(v, 2, out=t).bitwise_and_(0x33333333)
    v.bitwise_and_(0x33333333).add_(t)
    torch.bitwise_right_shift(v, 4, out=t)
    v.add_(t).bitwise_and_(0x0F0F0F0F)
    return v.mul_(0x01010101).bitwise_right_shift_(24)


def rank_grid(state: CompressedState, slots: torch.Tensor, size: int
              ) -> torch.Tensor:
    """Map a slot grid (any shape, int64, sentinel ``size`` for invalid
    frames) through the frozen rank structure with plain torch ops: the
    rank of every present slot, the sentinel rank for the rest
    (goldrush_tpu/mibf/compressed.py:218-244, :506-517).  The plain half of
    ``build_rank_grid``; the card's main path hashes straight to ranks."""
    nw = state.bitrank.shape[0] - 1
    in_range = (slots >= 0) & (slots < size)
    e = state.bitrank[torch.where(in_range, slots >> 5, nw)]
    bit = slots & 31
    bits = e & _MASK32
    present = in_range & (((bits >> bit) & 1) == 1)
    below = bits & ((torch.ones_like(bit) << bit) - 1)
    rank = ((e >> 32) & _MASK32) + _popcount32(below)
    n_super = state.supers.shape[0]
    if n_super > 1:
        rank += state.supers[torch.clamp(slots >> SUPER_BITS, 0,
                                         n_super - 1)]
    return torch.where(present, rank, state.sentinel)


def build_rank_grid(state: CompressedState, codes: torch.Tensor,
                    lengths: torch.Tensor, fam, params: dm.MibfParams,
                    num_tiles_max: int) -> tuple[torch.Tensor, torch.Tensor]:
    """codes uint8 [B, L] + lengths int32 [B] -> (ranks int64 [B, h,
    T*TL/S], frame_ok bool [B, T*TL/S]): ``dm.build_slot_grid`` at the
    params' stride S mapped through ``rank_grid``, the sentinel rank for
    absent slots and invalid frames.  The structure never changes after
    the freeze, so a batch's grid is mapped once and serves every later
    probe and insert of its reads.  On the card one launch of kernel A
    hashes straight to ranks."""
    if codes.is_cuda or lengths.is_cuda:
        return _build_rank_grid_cuda(state, codes, lengths, fam, params,
                                     num_tiles_max)
    return _build_rank_grid_plain(state, codes, lengths, fam, params,
                                  num_tiles_max)


def _build_rank_grid_cuda(state, codes, lengths, fam, params, T):
    ranks, frame_ok, args = dm.grid_launch_args(codes, lengths, fam, params,
                                                T)
    kernels.SEED_HASH_RANK_GRID(*args, *_rank_args(state, params,
                                                   ranks.device),
                                kernels.ptr(ranks), kernels.ptr(frame_ok),
                                *dm.NO_QUERY)
    return ranks, frame_ok


def _rank_args(state, params, dev) -> tuple:
    """The rank grid entry's arguments of the frozen structure, checked to
    lie on ``dev``: bitrank, supers, their number and the sentinel rank."""
    kernels.check(state.bitrank, "bitrank", torch.int64,
                  (-(-params.size // 32) + 1,), dev)
    n_super = n_supers(params.size)
    kernels.check(state.supers, "supers", torch.int64, (n_super,), dev)
    return (kernels.ptr(state.bitrank), kernels.ptr(state.supers), n_super,
            state.sentinel)


def build_rank_grids(state: CompressedState, codes: torch.Tensor,
                     lengths: torch.Tensor, fam, params_ins: dm.MibfParams,
                     params_q: dm.MibfParams, num_tiles_max: int) -> tuple:
    """(ranks_q, ok_q, ranks_ins, ok_ins): ``build_rank_grid`` at
    ``params_ins`` and the query grid of ``params_q`` inside it
    (``dm.query_in_insert_grid``, else ValueError), the slots mapped to
    ranks once, from one launch of kernel A on the card.  The plain version
    maps the plain insert grid and takes the query grid from it
    (``dm.query_of``)."""
    if not dm.query_in_insert_grid(params_q, params_ins):
        raise ValueError("the query grid does not lie in the insert grid")
    if codes.is_cuda or lengths.is_cuda:
        ranks, ok, args = dm.grid_launch_args(codes, lengths, fam,
                                              params_ins, num_tiles_max)
        q, ok_q, qargs = dm.query_launch_args(ranks, params_q, params_ins)
        kernels.SEED_HASH_RANK_GRID(*args,
                                    *_rank_args(state, params_ins,
                                                ranks.device),
                                    kernels.ptr(ranks), kernels.ptr(ok),
                                    *qargs)
        return q, ok_q, ranks, ok
    ranks, ok = _build_rank_grid_plain(state, codes, lengths, fam,
                                       params_ins, num_tiles_max)
    return (*dm.query_of(ranks, ok, params_q, params_ins), ranks, ok)


def _build_rank_grid_plain(state, codes, lengths, fam, params, T):
    slots, frame_ok = dm._build_slot_grid_plain(codes, lengths, fam, params,
                                                T)
    return rank_grid(state, slots, params.size), frame_ok


def probe_and_vote(state: CompressedState, ranks: torch.Tensor,
                   frame_ok: torch.Tensor, params: dm.MibfParams,
                   num_tiles: int) -> dm.VoteResult:
    """Probe + vote on a rank grid (kernel B on the id table): the vote of
    goldrush_tpu/mibf/compressed.py:248-334."""
    return dm.probe_and_vote(state.ids, ranks, frame_ok, params, num_tiles,
                             ranked=True)


def insert_read_sorted(state: CompressedState, ranks: torch.Tensor,
                       tile_lo: int, tile_hi: int, base_id: int,
                       trimmed: bool, params: dm.MibfParams,
                       num_tiles: int) -> CompressedState:
    """Exact reservoir insert on the rank-indexed tables, in place: the
    semantics of build_insert_keys + insert_read_sorted with
    ``assume_present=True`` (goldrush_tpu/mibf/compressed.py:398-476): the
    counter and the accept rule key on the rank, and an accepted rank's id
    becomes the block id."""
    dm.insert_blocks(state.ids, state.counts, ranks, tile_lo, tile_hi,
                     base_id, trimmed, params, num_tiles, state.sentinel, 0)
    return state


def insert_read(state: CompressedState, slots: torch.Tensor, tile_lo: int,
                tile_hi: int, base_id: int, trimmed: bool,
                params: dm.MibfParams, max_blocks: int, num_tiles: int
                ) -> CompressedState:
    """Blockwise reservoir insert of one read on the rank-indexed tables,
    in place: the JAX package's ``insert_read``
    (goldrush_tpu/mibf/compressed.py:338-395).  ``slots`` [H, T*F] is the
    read's slot grid; each slot maps to its rank (the sentinel rank when
    absent, which never inserts), the first ``max_blocks`` blocks of tiles
    lo..hi insert as ``insert_read_sorted``'s do, and an accepted id keeps
    its SAT bit.  Kernel D with its rank map and keep = SAT on the card."""
    dm.insert_blocks(state.ids, state.counts, slots, tile_lo, tile_hi,
                     base_id, trimmed, params, num_tiles, state.sentinel, 0,
                     keep=dm.SAT_BIT, max_blocks=max_blocks, rank_map=state)
    return state


def insert_read_max(state: CompressedState, ranks: torch.Tensor,
                    tile_lo: int, tile_hi: int, base_id: int, trimmed: bool,
                    params: dm.MibfParams, num_tiles: int) -> CompressedState:
    """Throughput-mode insert on the rank-indexed id table, in place: a
    scatter-max of the bare block id into ``ids[rank]`` for every rank
    below the sentinel in tiles lo..hi of the read's full-resolution rank
    grid; counts stay as they are.  The semantics of both
    ``insert_read_max`` and ``insert_ranks_max``
    (goldrush_tpu/mibf/compressed.py:480-503, :536-556)."""
    dm.insert_max(state.ids, ranks, tile_lo, tile_hi, base_id, trimmed,
                  params, num_tiles, state.sentinel, 0)
    return state


def reset_ids(state: CompressedState, counts: bool = True
              ) -> CompressedState:
    """Silver-path rotation, in place: forget ids, and with ``counts`` (the
    exact policy) the counters, which the throughput policy leaves as they
    are (goldrush_tpu/path/engine.py:771-772); the rank structure
    (presence) stays.  The plain version of K19: on the card the consume
    kernel resets inside its launch (csrc/consume.cu)."""
    state.ids.zero_()
    if counts:
        state.counts.zero_()
    return state


def state_from_numpy(bitrank, supers, ids, counts, device="cuda"
                     ) -> CompressedState:
    """The JAX package's arrays (uint64 bitrank/supers, uint32 ids/counts)
    as a state on ``device`` (bit views; the card unless the caller asks
    for the CPU); the inverse of
    ``state_to_numpy``.  When ``device`` is a sequence of devices (a mesh
    row), ``ids``/``counts`` are banked over it (``dm.to_banks``) and
    ``bitrank``/``supers`` lie whole on its first."""
    import numpy as np
    row = device if isinstance(device, (list, tuple)) else None

    def conv(a, dtype, view, banked=False):
        a = torch.from_numpy(
            np.ascontiguousarray(a, dtype=dtype).view(view).copy())
        if row is None:
            return a.to(device)
        return dm.to_banks(a, row) if banked else a.to(row[0])
    return CompressedState(
        bitrank=conv(bitrank, np.uint64, np.int64),
        supers=conv(supers, np.uint64, np.int64),
        ids=conv(ids, np.uint32, np.int32, True),
        counts=conv(counts, np.uint32, np.int32, True))


def state_to_numpy(state: CompressedState) -> dict:
    """The JAX package's dtypes on the host: uint64 bitrank/supers, uint32
    ids/counts, banks gathered."""
    import numpy as np
    state = dm.gather_state(state)
    return dict(
        bitrank=state.bitrank.cpu().numpy().view(np.uint64).copy(),
        supers=state.supers.cpu().numpy().view(np.uint64).copy(),
        ids=state.ids.cpu().numpy().view(np.uint32).copy(),
        counts=state.counts.cpu().numpy().view(np.uint32).copy())
