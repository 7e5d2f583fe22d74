"""Rank-compressed miBF: one presence bit per slot, ids and counters per rank.

The layout is the JAX package's (goldrush_tpu/mibf/compressed.py), itself
the reference's (MIBloomFilter.hpp:94-101, MIBFConstructSupport::setup()):

  bitrank[w] = [63..32: present slots before slot 32w][31..0: presence bits
               of slots 32w .. 32w+31], one zero word appended
  supers     = the per-2^32-slot superblock bases (one, 0, below 2^32 slots)
  ids[rank], counts[rank] = block id and reservoir counter of the rank-th
               present slot; the last entry is the sentinel rank

carried as int64 (bitrank, supers) and int32 (ids, counts) tensors holding
the unsigned bits.  The engine fills presence into the direct layout's
words (kernel A), freezes them into this structure, and from then on maps
each batch's slot grid to ranks once: probes and inserts read and write the
rank-indexed tables through kernels B and D, keyed on the rank exactly like
the reference's accept rule (MIBFConstructSupport.hpp:274-282).

Three functions own the kernels of csrc/rank.cu; each runs its plain
PyTorch version for a CPU tensor and its kernel for a CUDA tensor (or
raises), and ``freeze`` chains the first two:

  rank_pack    pack presence bits, popcount, cumsum within 65,536-slot blocks
  rank_carry   add each block's carry (the totals of the blocks before it)
  rank_grid    slot -> rank lookup (kernel rank_lookup)
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
    ``build_rank`` then ``with_tables``.  ``words`` is only read; a caller
    that owns them drops them between the two steps, so the direct words
    and the rank-indexed tables are never on the device together."""
    bitrank, pop = build_rank(words, size)
    return with_tables(bitrank, pop, size)


def build_rank(words: torch.Tensor, size: int) -> tuple[torch.Tensor, int]:
    """Pack bit 30 of every slot word and rank them: (bitrank, number of
    present slots)."""
    if size <= 0 or size >= 1 << SUPER_BITS:
        raise ValueError(f"size {size}: the port's filters have one "
                         "superblock (0 < size < 2^32)")
    nw = -(-size // 32)
    if words.shape[0] < nw * 32:
        raise ValueError(f"words [{words.shape[0]}] do not cover {size} "
                         "slots")
    bitrank, totals = rank_pack(words, size)
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


def rank_pack(words: torch.Tensor, size: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """First half of the freeze: bitrank [nw + 1] with each word's presence
    bits and its exclusive in-block rank (blocks of 65,536 slots), and the
    per-block totals."""
    if words.is_cuda:
        return _rank_pack_cuda(words, size)
    return _rank_pack_plain(words, size)


def _rank_pack_cuda(words, size):
    nw = -(-size // 32)
    dev = words.device
    kernels.check(words, "words", torch.int32, device=dev)
    if words.data_ptr() % 16:
        raise ValueError("words must be 16-byte aligned")
    bitrank = torch.empty(nw + 1, dtype=torch.int64, device=dev)
    totals = torch.empty(-(-nw * 32 // RANK_BLOCK_SLOTS), dtype=torch.int64,
                         device=dev)
    kernels.RANK_PACK(dev, kernels.ptr(words), size, nw, kernels.ptr(bitrank),
                      kernels.ptr(totals))
    return bitrank, totals


def _rank_pack_plain(words, size):
    nw = -(-size // 32)
    bw = RANK_BLOCK_SLOTS // 32
    nblk = -(-nw // bw)
    b = ((words[: nw * 32] >> 30) & 1).to(torch.int64)
    b[size:] = 0                                  # slots >= size are not real
    b = b.reshape(nw, 32)
    bits = (b << torch.arange(32, device=words.device)).sum(dim=1)
    pops = torch.zeros(nblk * bw, dtype=torch.int64, device=words.device)
    pops[:nw] = b.sum(dim=1)
    pops = pops.reshape(nblk, bw)
    local = (torch.cumsum(pops, 1) - pops).reshape(-1)[:nw]
    bitrank = torch.zeros(nw + 1, dtype=torch.int64, device=words.device)
    bitrank[:nw] = (local << 32) | bits
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
    frames) through the frozen rank structure: the rank of every present
    slot, the sentinel rank for the rest (goldrush_tpu/mibf/compressed.py:
    218-244, :506-517).  The structure never changes after ``freeze``, so
    a batch's grid is mapped once and serves every later probe and insert
    of its reads."""
    if slots.is_cuda:
        return _rank_grid_cuda(state, slots, size)
    return _rank_grid_plain(state, slots, size)


def _rank_grid_cuda(state, slots, size):
    dev = slots.device
    kernels.check(slots, "slots", torch.int64, device=dev)
    kernels.check(state.bitrank, "bitrank", torch.int64,
                  (-(-size // 32) + 1,), dev)
    ranks = torch.empty_like(slots)
    kernels.RANK_LOOKUP(dev, kernels.ptr(slots), slots.numel(),
                        kernels.ptr(state.bitrank), size, state.sentinel,
                        kernels.ptr(ranks))
    return ranks


def _rank_grid_plain(state, slots, size):
    nw = state.bitrank.shape[0] - 1
    in_range = (slots >= 0) & (slots < size)
    e = state.bitrank[torch.where(in_range, slots >> 5, nw)]
    bit = slots & 31
    bits = e & _MASK32
    present = in_range & (((bits >> bit) & 1) == 1)
    below = bits & ((torch.ones_like(bit) << bit) - 1)
    rank = ((e >> 32) & _MASK32) + _popcount32(below)
    return torch.where(present, rank, state.sentinel)


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


def reset_ids(state: CompressedState) -> CompressedState:
    """Silver-path rotation, in place: forget ids and counters; the rank
    structure (presence) stays."""
    state.ids.zero_()
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
