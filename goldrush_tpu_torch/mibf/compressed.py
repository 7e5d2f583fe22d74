"""Rank-compressed miBF: one presence bit per slot, ids and counters per rank.

The layout is the JAX package's (goldrush_tpu/mibf/compressed.py), itself
the reference's (MIBloomFilter.hpp:94-101, MIBFConstructSupport::setup()):

  bitrank[w] = [63..32: present slots before slot 32w][31..0: presence bits
               of slots 32w .. 32w+31], one zero word appended
  supers     = the per-2^32-slot superblock bases (one, 0, below 2^32 slots)
  ids[rank], counts[rank] = block id and reservoir counter of the rank-th
               present slot; the last entry is the sentinel rank

carried as int64 (bitrank, supers) and int32 (ids, counts) tensors holding
the unsigned bits.  The engine fills presence into a bitmap of ceil(size /
32) words (kernel A's fill), freezes the bitmap into this structure, and
from then on hashes each batch straight to ranks once (kernel A's rank
grid): probes and inserts read and write the rank-indexed tables through
kernels B and D, keyed on the rank exactly like the reference's accept
rule (MIBFConstructSupport.hpp:274-282).  The direct filter's words are
never allocated.

Three functions own a kernel; each runs its plain PyTorch version for a CPU
tensor and its kernel for a CUDA tensor (or raises), and ``build_rank``
chains the first two:

  rank_pack        popcount the bitmap, cumsum within 65,536-slot blocks
  rank_carry       add each block's carry (the totals of the blocks before it)
  build_rank_grid  hash a batch to its probe grid of ranks at any stride
                   (kernel A's rank grid entry); ``rank_grid`` is the plain
                   slot -> rank map

The probe (kernel B) and both inserts (kernel D, and insert_max for the
throughput mode) are the direct filter's, keyed on ranks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from . import mibf as dm

SUPER_BITS = 32          # slots per superblock = 2^32
RANK_BLOCK_SLOTS = 65_536   # slots per rank_pack block (csrc/rank.cu)
_MASK32 = 0xFFFFFFFF


class CompressedState(NamedTuple):
    bitrank: torch.Tensor    # int64 [nw + 1] (uint64 bits)
    supers: torch.Tensor     # int64 [n_super]
    ids: torch.Tensor        # int32 [alloc] (uint32 bits), rank-indexed
    counts: torch.Tensor     # int32 [alloc] (uint32 bits), rank-indexed

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


def build_rank(bits: torch.Tensor, size: int) -> tuple[torch.Tensor, int]:
    """Rank the presence bitmap ``bits`` (int32 [ceil(size / 32)], the fill's
    ``dm.presence_bitmap``; bits at or past ``size`` are ignored): (bitrank,
    number of present slots).  ``bits`` is only read; a caller that owns it
    drops it before ``with_tables``, so the bitmap and the rank-indexed
    tables are never on the device together."""
    if size <= 0 or size >= 1 << SUPER_BITS:
        raise ValueError(f"size {size}: the port's filters have one "
                         "superblock (0 < size < 2^32)")
    if bits.shape != (-(-size // 32),):
        raise ValueError(f"bitmap {tuple(bits.shape)} is not ceil({size} / "
                         "32) words")
    bitrank, totals = rank_pack(bits, size)
    return bitrank, rank_carry(bitrank, totals)


def with_tables(bitrank: torch.Tensor, pop: int, size: int
                ) -> CompressedState:
    """The compressed state over a frozen ``bitrank``: zeroed rank-indexed
    id/counter tables of ``max(rank_alloc(size), pop + 1)`` entries rounded
    up to 1024, the JAX package's allocation (compressed.py:172-182)."""
    alloc = max(rank_alloc(size), -(-(pop + 1) // 1024) * 1024)
    dev = bitrank.device
    return CompressedState(
        bitrank=bitrank,
        supers=torch.zeros(1, dtype=torch.int64, device=dev),
        ids=torch.zeros(alloc, dtype=torch.int32, device=dev),
        counts=torch.zeros(alloc, dtype=torch.int32, device=dev))


def rank_pack(bits: torch.Tensor, size: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """First half of the freeze: bitrank [nw + 1] with each bitmap word's
    presence bits (slots at or past ``size`` cleared) and its exclusive
    in-block rank (blocks of 65,536 slots), and the per-block totals."""
    if bits.is_cuda:
        return _rank_pack_cuda(bits, size)
    return _rank_pack_plain(bits, size)


def _rank_pack_cuda(bits, size):
    nw = -(-size // 32)
    dev = bits.device
    kernels.check(bits, "bits", torch.int32, (nw,), dev)
    if bits.data_ptr() % 8:
        raise ValueError("bits must be 8-byte aligned")
    bitrank = torch.empty(nw + 1, dtype=torch.int64, device=dev)
    bitrank[nw:].zero_()     # the appended word; the kernel writes the rest
    totals = torch.empty(-(-nw * 32 // RANK_BLOCK_SLOTS), dtype=torch.int64,
                         device=dev)
    kernels.RANK_PACK(dev, kernels.ptr(bits), size, nw, kernels.ptr(bitrank),
                      kernels.ptr(totals))
    return bitrank, totals


def _rank_pack_plain(bits, size):
    nw = -(-size // 32)
    bw = RANK_BLOCK_SLOTS // 32
    nblk = -(-nw // bw)
    b = bits.to(torch.int64) & _MASK32
    if size % 32:                                 # slots >= size are not real
        b[-1] &= (1 << (size % 32)) - 1
    pops = torch.zeros(nblk * bw, dtype=torch.int64, device=bits.device)
    pops[:nw] = _popcount32(b)
    pops = pops.reshape(nblk, bw)
    local = (torch.cumsum(pops, 1) - pops).reshape(-1)[:nw]
    bitrank = torch.zeros(nw + 1, dtype=torch.int64, device=bits.device)
    bitrank[:nw] = (local << 32) | b
    return bitrank, pops.sum(dim=1)


def rank_carry(bitrank: torch.Tensor, totals: torch.Tensor) -> int:
    """Second half of the freeze, in place: add to every word's in-block
    rank the totals of the blocks before its block, zero the appended
    word; returns the total number of present slots."""
    if bitrank.is_cuda:
        return int(_rank_carry_cuda(bitrank, totals).item())
    return int(_rank_carry_plain(bitrank, totals))


def _rank_carry_cuda(bitrank, totals):
    nw = bitrank.shape[0] - 1
    dev = bitrank.device
    kernels.check(bitrank, "bitrank", torch.int64, device=dev)
    kernels.check(totals, "totals", torch.int64,
                  (-(-nw * 32 // RANK_BLOCK_SLOTS),), dev)
    pop = torch.empty(1, dtype=torch.int64, device=dev)
    kernels.RANK_CARRY(dev, kernels.ptr(bitrank), kernels.ptr(totals), nw,
                       kernels.ptr(pop))
    return pop


def _rank_carry_plain(bitrank, totals):
    nw = bitrank.shape[0] - 1
    carry = torch.cumsum(totals, 0) - totals
    blk = torch.arange(nw, device=bitrank.device) // (RANK_BLOCK_SLOTS // 32)
    bitrank[:nw] += carry[blk] << 32
    bitrank[nw] = 0
    return totals.sum()


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Population count of the low 32 bits of int64 values (SWAR)."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


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
    kernels.check(state.bitrank, "bitrank", torch.int64,
                  (-(-params.size // 32) + 1,), ranks.device)
    kernels.SEED_HASH_RANK_GRID(*args, kernels.ptr(state.bitrank),
                                state.sentinel, kernels.ptr(ranks),
                                kernels.ptr(frame_ok))
    return ranks, frame_ok


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
    (presence) stays."""
    state.ids.zero_()
    if counts:
        state.counts.zero_()
    return state


def state_to_numpy(state: CompressedState) -> dict:
    """The JAX package's dtypes on the host: uint64 bitrank/supers, uint32
    ids/counts."""
    import numpy as np
    return dict(
        bitrank=state.bitrank.cpu().numpy().view(np.uint64).copy(),
        supers=state.supers.cpu().numpy().view(np.uint64).copy(),
        ids=state.ids.cpu().numpy().view(np.uint32).copy(),
        counts=state.counts.cpu().numpy().view(np.uint32).copy())
