"""Streaming golden/silver path engine (goldrush-path) on PyTorch + CUDA.

The two-pass GoldRush-Path flow (goldrush_path.cpp:1096-1275) of
``goldrush_tpu/path/engine.py``, with either filter layout (``mibf_mode``),
in exact mode or the throughput mode (sampled query grids, optimistic
staleness, max-id-wins insert, full-resolution trim recheck), inserting
every frame of every seed or a sample of them (``insert_stride``,
``insert_seeds``), the filter sized by the closed form or by ntCard's
estimate of the reads (``ntcard``, utils/ntcard.py: kernel K22 on the
card):

  pass 1: host gates (length/phred/ACGT) -> presence fill of every insert
          seed into a bitmap (kernel A); the direct filter then writes its
          words from the bitmap (presence_merge), the compressed filter
          freezes the bitmap into its rank structure (rank_build, one
          launch: superblocks of 2^32 slots, at any size) and never holds
          direct words;
  pass 2: reads stream IN ORDER through batches: a batched classify
          (kernel A's slot grid, or its rank grid in the compressed
          filter, at the query stride over the probed seeds -> kernel B
          probe/vote -> kernel C classify) against the filter at batch
          start, and where inserts or rechecks need it the insert grid of
          every insert seed (full resolution, or every insert_stride-th
          frame); then the in-order consume scan of the
          batch (path/consume.py: one launch of the consume kernel on the
          card), which re-probes reads against the live filter once it
          changed inside the batch (under the optimistic policy only
          candidates, and every read after a silver reset), re-classifies
          the boundary zone at full resolution (trim recheck), inserts
          recruits (the reservoir rule, or max id wins under the
          optimistic policy) and rotates silver paths.  Nothing returns to
          the host inside the pass: the rows and the scan's scalars are
          fetched once, after the last batch;
  replay: path files and stats are rebuilt on the host from the per-read
          decision rows, as the JAX engine does.

The "exact" staleness policy makes the result bit-identical to sequential
processing at any batch size; both policies are bit-identical to the JAX
engine under the same config.  Either filter takes any size (slots and
ranks are 64-bit on the card; the direct filter holds 8 B a slot); the
wavefront at 2^31 slots or more raises ``NotImplementedError`` at
construction (see ``_check_size``).

With ``devices > 1`` or ``model_shards > 1`` the engine runs on a
``(data, model)`` mesh of explicit devices in one process
(parallel/mesh.py), as the JAX engine runs on its device mesh: data row i
keeps its own replica of the filter, banked by index range over the row's
devices when ``model_shards > 1``; it fills its share of each fill batch
into its own bitmap (the rows' bitmaps are ORed once a pass), classifies
its share of each pass-2 batch, and, once the grids and verdicts of the
whole batch are copied to every row, runs the consume scan of the whole
batch against its replica, so the replicas stay identical.  Rows, ``scal``
and the counters are read from row 0.

With ``wavefront=True`` under the optimistic policy (and not ``debug``),
as in the JAX engine, pass 2 runs windows of ``wave_window`` reads
through the wavefront consume instead of the scan (path/wavefront.py:
the window's overlap adjacency, then its rounds, one launch each on the
card); elsewhere ``wavefront`` is ignored.  Under a mesh each data row
computes the grids of its share of a window against its replica, the
whole window's grids go to every row, the adjacency of the whole window
is computed once, on row 0's lead, and copied to the other rows' leads,
and each row runs the window's rounds against its replica and its own
side table (banked as its filter), so the replicas and the side tables
stay identical.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import PathConfig, calc_optimal_size
from ..io import fastq, ingest
from ..mibf import compressed as cz
from ..mibf import mibf as dm
from ..ops.nthash import build_seed_family
from ..ops.phred import (MEDIAN_SAMPLES_NEEDED, MINIMUM_PHRED_THRESHOLD,
                         calc_median_phred, sum_phred)
from ..ops.seeds import make_seed_pattern
from ..parallel.mesh import make_mesh, resolve_device, shard_state
from ..utils import observability as obs
from ..utils.ntcard import NtCardParams, estimate_genome_size
from .classify import classify_batch
from . import wavefront as wave
from .consume import (COUNTS, ConsumeScratch, ConsumeSpec, _filter_view,
                      consume_batch, new_counters)
from .engine_util import tile_min_count

# tile-bucket sizes and the per-batch tile budget of the JAX engine
# (goldrush_tpu/path/engine.py:47-52): the same batching gives the same
# batches, so every per-batch observable matches
BUCKETS = (1, 2, 4, 8, 12, 16, 20, 24, 32, 48, 64, 96, 128, 192, 256,
           384, 512, 768, 1024, 1536, 2048)
TILE_BUDGET = 4096
# the wavefront's windows take a larger budget (goldrush_tpu/path/
# engine.py:53-56)
WAVE_TILE_BUDGET = 8192
FILL_BATCH = 64
# replay-record cache cap in retained allocation bytes: past it the replay
# pass re-streams the input instead of holding every record
REPLAY_CACHE_BYTES = 3_000_000_000


@dataclass
class EngineStats:
    valid_reads: int = 0
    total_tiles: int = 0
    assigned_tiles: int = 0
    unassigned_tiles: int = 0
    queries: int = 0
    hits: int = 0
    misses: int = 0
    reads_in_path: int = 0
    phred_sum_in_path: float = 0.0
    num_reads: int = 0
    num_passed_reads: int = 0
    skipped_phred: int = 0
    skipped_delta: int = 0
    skipped_length: int = 0
    skipped_invalid: int = 0
    vote_overflow: int = 0
    recruits: int = 0
    paths_completed: int = 0
    inserted_bases_in_path: int = 0
    wall_fill_s: float = 0.0
    wall_fill_stream_s: float = 0.0   # fill stream + presence kernels
    wall_assign_s: float = 0.0
    wall_submit_s: float = 0.0        # assign: device submit pass
    wall_submit_first_s: float = 0.0  # first batch (includes kernel load)
    wall_replay_s: float = 0.0        # assign: host replay pass
    wall_freeze_s: float = 0.0        # fill: the compressed filter's freeze
    wall_ntcard_s: float = 0.0        # construction: ntCard's estimate
    num_batches: int = 0
    # the process's peak device memory (torch.cuda.max_memory_allocated)
    # after pass 2, the largest over the mesh's cards; 0 on the CPU.  Not a
    # field of the JAX engine's stats
    device_peak_bytes: int = 0


def _bucket_for(num_tiles: int, cap: int) -> int:
    for b in BUCKETS:
        if num_tiles <= b:
            return min(b, cap)
    return cap


def _wave_on(cfg: PathConfig) -> bool:
    """Whether pass 2 runs the wavefront: the JAX engine's gate
    (goldrush_tpu/path/engine.py:244-247) without its environment
    toggles."""
    return cfg.recheck == "optimistic" and cfg.wavefront and not cfg.debug


def _check_size(cfg: PathConfig, size: int) -> None:
    """Raise for the wavefront at ``size`` >= 2^31 slots, before the filter
    is allocated.  The JAX wavefront casts slots and ranks to int32
    (goldrush_tpu/path/wavefront.py:205-207, :243-244), so past 2^31 its
    gathers and scatters wrap to other entries (ROADMAP queue 3); a
    compressed filter's ranks stay below its slots.  Either filter takes
    any size otherwise."""
    if _wave_on(cfg) and size >= 1 << 31:
        raise NotImplementedError(
            f"the wavefront at {size} >= 2^31 slots: the JAX wavefront's "
            "int32 slots and ranks wrap there (ROADMAP.md queue 3)")


class GoldenPathEngine:
    """goldrush-path equivalent.  Construct, then call run().

    ``device``: one device, or under a mesh (``devices > 1`` or
    ``model_shards > 1``: n = devices if devices > 1 else model_shards, as
    the JAX engine counts them) a sequence of n devices in mesh order
    (row-major ``[data, model]``; a card may repeat), ``"cpu"`` for n
    logical CPU devices or ``"cuda"`` for ``cuda:0 .. cuda:n-1``."""

    def __init__(self, cfg: PathConfig, device="cuda"):
        cfg.validate()
        self.cfg = cfg
        n = cfg.devices if cfg.devices > 1 else cfg.model_shards
        if n % cfg.model_shards:
            raise ValueError(f"devices ({n}) must be divisible by "
                             f"model_shards ({cfg.model_shards})")
        self.data_shards = n // cfg.model_shards
        self.banked = cfg.model_shards > 1
        self.mesh = make_mesh(n, data=self.data_shards,
                              model=cfg.model_shards, devices=device)
        self.device = self.mesh.lead(0)
        self.seeds = make_seed_pattern(cfg.seed_preset, cfg.kmer_size,
                                       cfg.weight, cfg.hash_num)
        self.fam = build_seed_family(self.seeds)
        self.stats = EngineStats()
        if cfg.ntcard and not cfg.hash_universe:
            # --ntcard: size the universe from a streaming F0 estimate of
            # the reads on the engine's device (goldrush_path.cpp:1110-1112;
            # rbits 22 as the JAX engine takes it,
            # goldrush_tpu/path/engine.py:130-138)
            t0 = time.time()
            self.universe = estimate_genome_size(
                cfg.input, self.seeds, NtCardParams(rbits=22, sbits=7),
                device=self.device)
            self.stats.wall_ntcard_s = time.time() - t0
        else:
            self.universe = cfg.derived_hash_universe()
        self.size = calc_optimal_size(self.universe, 1, cfg.occupancy)
        _check_size(cfg, self.size)
        # the query tier probes every S-th frame of the first probe_seeds
        # seeds with the gates scaled to S; the fill covers the insert
        # seeds at full resolution and recruits insert every
        # insert_stride-th frame of them (params_ins); params_full, the
        # trim recheck's classifier, probes them at full resolution with
        # the exact gates (goldrush_tpu/path/engine.py:141-186)
        S = cfg.frame_stride
        if cfg.tile_length % S:
            raise ValueError("frame_stride must divide tile_length")
        self.x_eff = max(1, cfg.threshold // S)
        self.h_active = cfg.probe_seeds or cfg.hash_num
        seeds_q = self.seeds[: self.h_active]
        self.fam_q = (self.fam if self.h_active == cfg.hash_num
                      else build_seed_family(seeds_q))
        self.h_ins = cfg.insert_seeds or cfg.hash_num
        self.fam_ins = (self.fam if self.h_ins == cfg.hash_num
                        else build_seed_family(self.seeds[: self.h_ins]))
        self.params = dm.MibfParams(
            size=self.size, h=self.h_active, k=cfg.kmer_size,
            spans=tuple(len(s) for s in seeds_q),
            tile_length=cfg.tile_length, threshold=self.x_eff,
            block_size=cfg.block_size, vote_topk=cfg.vote_topk,
            frame_stride=S, vote_min=2 if S == 1 else max(1, 2 // S),
            probe_seeds=0, slot_map=cfg.slot_map)
        self.params_full = dataclasses.replace(
            self.params, h=self.h_ins,
            spans=tuple(len(s) for s in self.seeds[: self.h_ins]),
            frame_stride=1, vote_min=2, threshold=cfg.threshold)
        if cfg.tile_length % cfg.insert_stride:
            raise ValueError("insert_stride must divide tile_length")
        self.params_ins = dataclasses.replace(
            self.params_full, frame_stride=cfg.insert_stride)
        # the optimistic policy re-probes only candidates and inserts by
        # scatter-max; the trim recheck runs where the query tier is not
        # already the full classifier; the query grid doubles as the
        # insert grid at full common resolution over the same seeds
        # (goldrush_tpu/path/engine.py:665-686)
        self.fast = cfg.recheck == "optimistic"
        self.rech_on = (cfg.trim_recheck and cfg.insert_stride == 1
                        and (S > 1 or self.h_active < self.h_ins))
        self.reuse_q = (S == 1 and cfg.insert_stride == 1
                        and self.h_active == self.h_ins)
        # elsewhere, where the query grid lies inside the insert grid (its
        # seeds the first insert seeds, the insert stride dividing S), one
        # launch of kernel A writes both (mibf.query_in_insert_grid)
        self.fuse_q = (not self.reuse_q
                       and dm.query_in_insert_grid(self.params,
                                                   self.params_ins))
        # one filter per data row of the mesh (``state`` / ``cstate`` are
        # row 0's): the compressed filter freezes pass 1's bitmap into it
        # (fill) and never holds the direct words; the direct filter's
        # words need no zero-fill, since the merge that closes pass 1
        # writes every one of them
        self.compressed = cfg.mibf_mode == "compressed"
        self.replicas: list = [None] * self.mesh.data
        if not self.compressed:
            alloc = self.params.alloc
            self.replicas = [
                dm.MibfState(words=dm.new_banks(alloc, self._row(r),
                                                torch.empty),
                             counts=dm.new_banks(alloc, self._row(r)))
                for r in range(self.mesh.data)]
        # -f: read names to exclude from pass 2 (pass 1 still inserts their
        # presence bits — goldrush_path.cpp:1163-1170)
        self.filter_out: set[str] = set()
        if cfg.filter_file:
            print(f"Using only reads not found in: {cfg.filter_file}",
                  file=sys.stderr)
            with open(cfg.filter_file) as f:
                self.filter_out.update(f.read().split())
        # --debug dumps per-pass tile states of every read against the live
        # filter, so batches are single reads (goldrush_path.cpp:1229)
        self.batch_reads = 1 if cfg.debug else cfg.batch_reads
        # the wavefront's windows are batches of at least wave_window reads
        # under their own tile budget
        self.wave = _wave_on(cfg)
        if self.wave:
            self.batch_reads = max(self.batch_reads, cfg.wave_window)
        self.tile_budget = WAVE_TILE_BUDGET if self.wave else TILE_BUDGET
        self._prefetch = max(1, min(int(cfg.jobs), 16))
        self.phred_min = cfg.phred_min
        self.writers: list[fastq.PathWriter] = []
        self.last_rows = np.zeros((0, 8), dtype=np.int64)
        self.spec = ConsumeSpec(
            params=self.params, params_full=self.params_full,
            params_ins=self.params_ins,
            unassigned_min=cfg.unassigned_min,
            assigned_max=cfg.assigned_max, fast=self.fast,
            rech_on=self.rech_on, silver=bool(cfg.silver_path),
            target=int(cfg.target_bases()), max_paths=int(cfg.max_paths))
        self.wave_spec = wave.WaveSpec(self.spec, self.fam_ins)
        # the wavefront's earliest-wins side table of each data row, banked
        # as the row's filter: zeroed at the start of each pass, threaded
        # through its windows, kept with the filter
        self.wave_sides: list = []
        # the consume scan's counts over the last pass (consume.COUNTS:
        # live re-probes, trim rechecks, inserts, silver resets; under the
        # wavefront wave.WAVE_COUNTS); kept out of EngineStats, whose
        # fields are the JAX engine's
        self.consume_counts: dict[str, int] = {}

    @property
    def state(self) -> dm.MibfState | None:
        """Row 0's direct filter, or None."""
        r = self.replicas[0]
        return r if isinstance(r, dm.MibfState) else None

    @state.setter
    def state(self, value) -> None:
        self.replicas[0] = value

    @property
    def wave_side(self):
        """Row 0's side table (a tensor or ``mibf.Banks``), or None before
        a wavefront pass."""
        return self.wave_sides[0] if self.wave_sides else None

    @property
    def cstate(self) -> cz.CompressedState | None:
        """Row 0's compressed filter, or None."""
        r = self.replicas[0]
        return r if isinstance(r, cz.CompressedState) else None

    @cstate.setter
    def cstate(self, value) -> None:
        self.replicas[0] = value

    def _row(self, r: int) -> tuple:
        """The devices that hold row r's filter tables: the whole row when
        the filter is banked, else its lead."""
        row = self.mesh.rows[r]
        return row if self.banked else row[:1]

    # ------------------------------------------------------------------
    def calc_phred_threshold(self, path: str) -> None:
        """Auto threshold = max(10, median of first 50k passing reads)
        (goldrush_path.cpp:79-107)."""
        if self.phred_min != 0:
            return
        scores = np.zeros(MEDIAN_SAMPLES_NEEDED, dtype=np.uint32)
        count = 0
        with ingest.ReadStream(path, prefetch=self._prefetch) as rs:
            for block in rs:
                block = [r for r in block
                         if r.length >= self.cfg.min_length]
                take = min(len(block), MEDIAN_SAMPLES_NEEDED - count)
                scores[count:count + take] = [r.phred_avg
                                              for r in block[:take]]
                count += take
                if count >= MEDIAN_SAMPLES_NEEDED:
                    break
        self.phred_min = max(MINIMUM_PHRED_THRESHOLD,
                             calc_median_phred(scores, count))

    def _to_device(self, a: np.ndarray, r: int = 0) -> torch.Tensor:
        return torch.from_numpy(a).to(self.mesh.lead(r))

    def _upload(self, a: np.ndarray, r: int = 0) -> torch.Tensor:
        """A batch array on row r's lead device without waiting for it: on
        the card through pinned memory, asynchronously (a pageable copy
        would wait for the stream)."""
        dev = self.mesh.lead(r)
        if dev.type == "cpu":
            return torch.from_numpy(a)
        return torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)

    # ------------------------------------------------------------------
    def fill(self, path: str) -> None:
        """Pass 1: presence fill over all gate-passing reads."""
        t0 = time.time()
        st = self.stats
        if self.cfg.load_mibf:
            # resume from a saved filter (either package's .npz): skip
            # pass 1; its gate bookkeeping is not reconstructed.  Staged on
            # the host, so that a banked filter is never whole on one card
            state, meta = dm.load_state(self.cfg.load_mibf, device="cpu")
            # the fill's geometry: every insert seed (a probed prefix of
            # them loads the same filter)
            p = self.params_full
            want = dict(size=p.size, h=p.h, k=p.k, spans=tuple(p.spans),
                        tile_length=p.tile_length)
            if meta != want:
                raise ValueError(
                    f"saved miBF geometry {meta} != engine {want}")
            # a replica per row, banked as the engine banks its filter
            self.replicas = shard_state(state, self.mesh, self.banked)
            st.num_passed_reads = -1     # unknown; loaded
            st.wall_fill_s += time.time() - t0
            return
        # pass 1 sets bits in a presence bitmap, batch by batch; the
        # direct filter writes its words from it once at the end: the
        # filter that ORing every batch into zeroed words would give.  Each
        # data row fills its share of every batch (reads split in order,
        # as the JAX engine's in_shardings split its padded batch) into a
        # bitmap of its own
        d = self.mesh.data
        share = -(-FILL_BATCH // d)
        bits_rows = [dm.presence_bitmap(self.size, self.mesh.lead(r))
                     for r in range(d)]
        with ingest.ReadStream(path, prefetch=self._prefetch) as rs:
            for block in rs:
                st.num_reads += len(block)
                good = []
                for r in block:
                    if r.length < self.cfg.min_length:
                        st.skipped_length += 1
                        continue
                    bad_p = r.phred_avg < self.phred_min
                    bad_d = r.phred_delta >= self.cfg.phred_delta
                    if bad_p or bad_d:
                        st.skipped_phred += int(bad_p)
                        st.skipped_delta += int(bad_d)
                        self.filter_out.add(r.id)
                        continue
                    if r.invalid:
                        st.skipped_invalid += 1
                        self.filter_out.add(r.id)
                        continue
                    good.append(r)
                st.num_passed_reads += len(good)
                # length-bucketed batches, as the JAX engine pads them
                good.sort(key=lambda r: r.length)
                for i in range(0, len(good), FILL_BATCH):
                    batch = good[i: i + FILL_BATCH]
                    L = max(r.length for r in batch)
                    Lb = 1 << max(10, (L - 1).bit_length())
                    codes = np.zeros((len(batch), Lb), dtype=np.uint8)
                    lengths = np.zeros(len(batch), dtype=np.int32)
                    for j, r in enumerate(batch):
                        codes[j, : r.length] = r.codes
                        lengths[j] = r.length
                    for q in range(d):
                        a, b = q * share, (q + 1) * share
                        if a >= len(batch):
                            break
                        dm.fill_presence_bits(
                            bits_rows[q], self._to_device(codes[a:b], q),
                            self._to_device(lengths[a:b], q), self.fam_ins,
                            self.size, self.cfg.slot_map)
        if st.num_passed_reads == 0:
            raise RuntimeError(
                "no reads passed the Phred score and min length requirements")
        if d > 1:
            # the rows' bitmaps ORed, and the union copied back to each row
            union = bits_rows[0]
            for q in range(1, d):
                union |= bits_rows[q].to(union.device)
            bits_rows = [union] + [union.to(self.mesh.lead(q), copy=True)
                                   for q in range(1, d)]
            del union
        if not self.compressed:
            # one first-write merge per bank of each row's words
            for q in range(d):
                dm.merge_presence_banks(self.replicas[q].words, bits_rows[q],
                                        self.size)
        self._sync()
        st.wall_fill_stream_s = time.time() - t0
        if self.compressed:
            # each row freezes its bitmap; it goes before the rank-indexed
            # tables (banked, zeroed) come
            t1 = time.time()
            for q in range(d):
                bitrank, supers, pop = cz.build_rank(bits_rows[q], self.size)
                bits_rows[q] = None
                self.replicas[q] = cz.with_tables(bitrank, supers, pop,
                                                  self.size, self._row(q))
            self._sync()
            st.wall_freeze_s += time.time() - t1
        st.wall_fill_s += time.time() - t0

    def _sync(self) -> None:
        for dev in self.mesh.cards():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # ------------------------------------------------------------------
    def _open_writer(self, curr_path: int) -> None:
        cfg = self.cfg
        if cfg.silver_path:
            w = fastq.PathWriter(f"{cfg.prefix_file}_{curr_path}.fq", True)
        else:
            w = fastq.PathWriter(f"{cfg.prefix_file}.fa", False)
        self.writers.append(w)

    def _grid(self, codes, lengths, T, fam, params, r=0):
        """A batch's probe grid for ``fam``/``params``: slots (direct
        filter) or their ranks (compressed filter: row r's rank tables),
        with frame_ok."""
        if self.compressed:
            return cz.build_rank_grid(self.replicas[r], codes, lengths, fam,
                                      params, T)
        return dm.build_slot_grid(codes, lengths, fam, params, T)

    def _vote(self, grid, frame_ok, T, params, r=0):
        """Kernel B against row r's filter."""
        if self.compressed:
            return cz.probe_and_vote(self.replicas[r], grid, frame_ok,
                                     params, num_tiles=T)
        return dm.probe_and_vote(self.replicas[r].words, grid, frame_ok,
                                 params, num_tiles=T)

    def _probe_classify(self, grid, frame_ok, n_tiles, T, r=0):
        """The batched verdicts against row r's filter at batch start, on
        its lead device: rows int64 [B, 8] = (decision, trim_start,
        trim_end, num_assigned, queries, hits, misses, overflow), with the
        trim recheck on a ninth column, each read's minimum in-read top
        count (``tile_min_count``)."""
        votes = self._vote(grid, frame_ok, T, self.params, r)
        res = classify_batch(votes.curr_id, votes.top_count, votes.cand_ids,
                             votes.cand_counts, n_tiles, self.x_eff,
                             self.cfg.unassigned_min, self.cfg.assigned_max)
        cols = [res.decision.long(), res.trim_start.long(),
                res.trim_end.long(), res.num_assigned.long(), votes.queries,
                votes.hits, votes.misses, votes.overflow.long().sum(dim=1)]
        if self.rech_on:
            cols.append(tile_min_count(votes.top_count, n_tiles))
        return torch.stack(cols, dim=1)

    def _debug_dump(self, codes, lengths, n_tiles, T, num_reads):
        """--debug: per-pass tile-state dumps of the batch's real reads
        against the live filter (log_tile_states parity,
        goldrush_path.cpp:109-124)."""
        grid, frame_ok = self._grid(codes, lengths, T, self.fam_q,
                                    self.params)
        votes = self._vote(grid, frame_ok, T, self.params)
        _, ids_tr, bools_tr = classify_batch(
            votes.curr_id, votes.top_count, votes.cand_ids,
            votes.cand_counts, n_tiles, self.x_eff,
            self.cfg.unassigned_min, self.cfg.assigned_max, debug=True)
        ids_tr, bools_tr = ids_tr.cpu().numpy(), bools_tr.cpu().numpy()
        for i, n in enumerate(n_tiles.cpu().tolist()[:num_reads]):
            for p in range(ids_tr.shape[1]):
                obs.log_tile_states(ids_tr[i, p, :n], bools_tr[i, p, :n])

    def _window_inputs(self, codes, lengths, full_lengths, T, r=0) -> tuple:
        """One padded batch on row r's lead device: its codes, its query
        grid and frame_ok, the full-resolution grid of every insert seed
        (what recruits insert and the trim recheck probes) and its
        frame_ok, n_tiles and the full lengths.  One grid serves both where
        they are equal (``reuse_q``), one launch of kernel A writes both
        where the query grid lies inside the insert grid (``fuse_q``), and
        two launches write them elsewhere."""
        TL = self.params.tile_length
        codes_d, lengths_d = self._upload(codes, r), self._upload(lengths, r)
        n_tiles_d = self._upload((lengths // TL).astype(np.int32), r)
        full_d = self._upload(full_lengths, r)
        if self.fuse_q:
            if self.compressed:
                grids = cz.build_rank_grids(self.replicas[r], codes_d,
                                            lengths_d, self.fam_ins,
                                            self.params_ins, self.params, T)
            else:
                grids = dm.build_slot_grids(codes_d, lengths_d, self.fam_ins,
                                            self.params_ins, self.params, T)
            return (codes_d, *grids, n_tiles_d, full_d)
        grid, frame_ok = self._grid(codes_d, lengths_d, T, self.fam_q,
                                    self.params, r)
        if self.reuse_q:
            grid_ins, ok_ins = grid, frame_ok
        else:
            grid_ins, ok_ins = self._grid(codes_d, lengths_d, T, self.fam_ins,
                                          self.params_ins, r)
        return codes_d, grid, frame_ok, grid_ins, ok_ins, n_tiles_d, full_d

    def _batch_inputs(self, codes, lengths, full_lengths, T, r=0) -> tuple:
        """The consume scan's inputs of one padded batch on row r's lead
        device: the grids, n_tiles and full lengths of ``_window_inputs``,
        and the batched verdicts against row r's filter at batch start
        (``_probe_classify``)."""
        _, grid, frame_ok, grid_ins, ok_ins, n_tiles_d, full_d = \
            self._window_inputs(codes, lengths, full_lengths, T, r)
        rows0 = self._probe_classify(grid, frame_ok, n_tiles_d, T, r)
        return grid, frame_ok, grid_ins, ok_ins, n_tiles_d, full_d, rows0

    def _mesh_inputs(self, inputs, codes, lengths, full_lengths, T) -> list:
        """``inputs`` (``_batch_inputs`` or ``_window_inputs``) of one
        padded batch for every data row: row i computes those of reads
        [i B/d, (i+1) B/d) against its replica (the batched classify, or
        the window's grids, split by read, as the JAX engine's
        ``P("data")``), then every row gets the whole batch's, on its lead
        device."""
        d = self.mesh.data
        if d == 1:
            return [inputs(codes, lengths, full_lengths, T)]
        per = codes.shape[0] // d
        parts = [inputs(codes[i * per: (i + 1) * per],
                        lengths[i * per: (i + 1) * per],
                        full_lengths[i * per: (i + 1) * per], T, i)
                 for i in range(d)]
        return [tuple(torch.cat([p[k].to(self.mesh.lead(r)) for p in parts])
                      for k in range(len(parts[0])))
                for r in range(d)]

    def _consume(self, codes, lengths, full_lengths, T, scal, rows_out,
                 counters):
        """One padded batch: its grids and the batched classify against the
        filter at batch start, then the in-order consume scan
        (path/consume.py; goldrush_tpu/path/engine.py:865-1024), which
        updates the filter, ``scal`` = [ids_inserted, inserted_bases,
        path_idx, done] (carried across batches) and ``counters`` in place
        and writes one row per read into ``rows_out``, all on the device.
        Under a mesh ``scal``, ``rows_out`` and ``counters`` are lists, one
        per data row, and every row scans the whole batch against its own
        replica.  Under the wavefront the batch is a window: its adjacency,
        then its rounds (path/wavefront.py), which also update each row's
        side table, and ``scal[0]`` counts id reservations."""
        if not self.wave:
            for r, inputs in enumerate(self._mesh_inputs(
                    self._batch_inputs, codes, lengths, full_lengths, T)):
                consume_batch(self.spec, self.replicas[r], *inputs, scal[r],
                              rows_out[r], counters[r], T,
                              scratch=self.consume_scratch[r],
                              row=self._row(r))
            return
        # the wave's first round classifies every read: no batched verdicts
        per_row = self._mesh_inputs(self._window_inputs, codes, lengths,
                                    full_lengths, T)
        # the adjacency pairs reads of the whole window, whichever rows
        # computed their grids: once, on row 0's lead, then copied to the
        # other rows' leads (the same tensor where a lead repeats)
        codes_d, _, _, grid_ins, *_ = per_row[0]
        _, _, ranked, limit, _ = _filter_view(self.replicas[0], self.size)
        adj = wave.wave_adjacency(self.wave_spec, grid_ins, codes_d, limit,
                                  ranked, T)
        for r, (_, *inputs) in enumerate(per_row):
            wave.wave_window(self.wave_spec, self.replicas[r],
                             self.wave_sides[r], *inputs,
                             adj.to(self.mesh.lead(r)), scal[r], rows_out[r],
                             counters[r], T, row=self._row(r))

    # ------------------------------------------------------------------
    def _eligible(self, path: str):
        """Stream the pass-2-eligible reads in order (deterministic gates,
        so the submit pass and the replay pass see identical sequences)."""
        cfg = self.cfg
        with ingest.ReadStream(path, prefetch=self._prefetch) as rs:
            for rec in rs.records():
                if rec.length < cfg.min_length or \
                        rec.id in self.filter_out:
                    continue
                yield rec

    def _pad_batch(self, B: int, T: int) -> int:
        Bpad = max(B, self.batch_reads)
        if Bpad * T > self.tile_budget:
            Bpad = 1 << max(0, (B - 1)).bit_length()
        # the data axis splits the batch (goldrush_tpu/path/engine.py:1067)
        d = self.data_shards
        return -(-Bpad // d) * d

    def _pack_batch(self, batch) -> tuple:
        """A batch of records as the device takes it: codes uint8 [Bpad,
        T*TL + TL], lengths int32 [Bpad] (capped at the tile bucket T),
        the full lengths int64 [Bpad], and T."""
        TL = self.cfg.tile_length
        T = max(_bucket_for(r.length // TL, self.cfg.max_tiles)
                for r in batch)
        Bpad = self._pad_batch(len(batch), T)
        Lmax = T * TL + TL
        codes = np.zeros((Bpad, Lmax), dtype=np.uint8)
        lengths = np.zeros(Bpad, dtype=np.int32)
        full_lengths = np.zeros(Bpad, dtype=np.int64)
        for i, r in enumerate(batch):
            L = min(r.length, Lmax)
            codes[i, :L] = r.codes[:L]
            # reads longer than the bucket classify on its first tiles
            lengths[i] = min(r.length, T * TL + TL - 1)
            full_lengths[i] = r.length
        return codes, lengths, full_lengths, T

    def assign(self, path: str) -> None:
        """Pass 2: the submit pass runs the batches on the device, then the
        replay pass writes the path files from the per-read rows.  The
        submit pass neither fetches nor waits inside the pass: the scan's
        scalars and rows stay on the device, in a rows buffer that grows by
        doubling, and are fetched once after the last batch."""
        t0 = time.time()
        cfg, st = self.cfg, self.stats
        TL = cfg.tile_length
        cap = cfg.max_tiles
        read_T: list[int] = []                  # per-eligible-read bucket
        # submit-pass record cache: replay skips the second input stream
        # when the eligible records fit the cap
        cache: list | None = []
        cached_bytes = 0
        cache_bufs: set = set()
        dev = self.device
        leads = [self.mesh.lead(r) for r in range(self.mesh.data)]
        # per data row: the scan's scalars, counters and rows (row 0's are
        # read after the pass) and the consume kernel's scratch, made once
        # for the pass
        scal_d = [torch.tensor([0, 0, 1, 0], dtype=torch.int64).to(ld)
                  for ld in leads]
        counters = [wave.new_counters(ld) if self.wave else new_counters(ld)
                    for ld in leads]
        self.consume_scratch = [ConsumeScratch() for _ in leads]
        if self.wave:
            # the last pass's side tables go before this pass's come
            self.wave_sides = []
            self.wave_sides = [
                dm.new_banks(_filter_view(rep, self.size)[0].shape[0],
                             self._row(r))
                for r, rep in enumerate(self.replicas)]
        rows_d = [torch.empty((4096, 8), dtype=torch.int64, device=ld)
                  for ld in leads]
        n_rows = 0

        def submit(batch):
            nonlocal rows_d, n_rows
            B = len(batch)
            codes, lengths, full_lengths, T = self._pack_batch(batch)
            read_T.extend([T] * B)
            Bpad = codes.shape[0]
            if cfg.debug:
                self._debug_dump(self._to_device(codes),
                                 self._to_device(lengths),
                                 self._to_device(lengths // TL), T, B)
            tb = time.time()
            if n_rows + Bpad > rows_d[0].shape[0]:
                grown = [torch.empty((2 * (n_rows + Bpad), 8),
                                     dtype=torch.int64, device=ld)
                         for ld in leads]
                for g, old in zip(grown, rows_d):
                    g[:n_rows] = old[:n_rows]
                rows_d = grown
            # the padding's rows are overwritten by the next batch
            self._consume(codes, lengths, full_lengths, T, scal_d,
                          [rd[n_rows: n_rows + Bpad] for rd in rows_d],
                          counters)
            n_rows += B
            if st.num_batches == 0:
                st.wall_submit_first_s += time.time() - tb
            st.num_batches += 1

        # reads group in ORDER (the golden path is an online algorithm); a
        # batch closes at batch_reads, or earlier when padding every pending
        # read to the batch's tile bucket would blow the tile budget
        pending = []
        pend_T = 1
        for rec in self._eligible(path):
            if cache is not None:
                cache.append(rec)
                cached_bytes += rec.pinned_nbytes(cache_bufs)
                if cached_bytes > REPLAY_CACHE_BYTES:
                    cache = None
                    cache_bufs.clear()
            T_r = _bucket_for(rec.length // TL, cap)
            T_new = max(pend_T, T_r)
            if pending and (len(pending) + 1) * T_new > self.tile_budget:
                submit(pending)
                pending = []
                T_new = T_r
            pending.append(rec)
            pend_T = T_new
            if len(pending) >= self.batch_reads:
                submit(pending)
                pending = []
                pend_T = 1
        if pending:
            submit(pending)
        # the pass's one fetch, from row 0
        rows = rows_d[0][:n_rows].cpu().numpy()
        scal = scal_d[0].tolist()
        self.consume_counts = dict(zip(
            wave.WAVE_COUNTS if self.wave else COUNTS, counters[0].tolist()))
        if self.consume_counts.get("faults"):
            raise RuntimeError(f"wavefront: {self.consume_counts['faults']} "
                               "windows faulted (past the round cap, or ids "
                               f"at INV_BASE): {self.consume_counts}")
        st.wall_submit_s += time.time() - t0
        self.last_rows = rows

        # ---- replay pass ---------------------------------------------------
        t1 = time.time()
        target_bases = cfg.target_bases()
        inserted_bases = 0
        curr_path = 1
        done = False
        self._open_writer(curr_path)
        records = cache if cache is not None else self._eligible(path)
        for ri, r in enumerate(records):
            if done or ri >= len(read_T):
                break
            T = read_T[ri]
            dec, ts, te, na, q, h, m, ov = (int(x) for x in rows[ri])
            num_tiles = min(r.length, T * TL + TL - 1) // TL
            st.total_tiles += num_tiles
            st.queries += q
            st.hits += h
            st.misses += m
            st.vote_overflow += ov
            st.assigned_tiles += na
            st.unassigned_tiles += num_tiles - na
            if dec == 1:        # recruited whole read
                qual = r.qual_bytes()
                self.writers[-1].write(r.id, "_untrimmed",
                                       r.seq_bytes(), qual)
                inserted_bases += r.length
                st.inserted_bases_in_path += r.length
                st.reads_in_path += 1
                st.recruits += 1
                if qual is not None:
                    st.phred_sum_in_path += r.phred_sum
            elif dec == 2:      # recruited trimmed
                rseq, rqual = r.seq_bytes(), r.qual_bytes()
                if te == num_tiles - 1:
                    seq = rseq[ts * TL:]
                    qual = rqual[ts * TL:] if rqual else None
                else:
                    end = ts * TL + (te - ts + 1) * TL
                    seq = rseq[ts * TL:end]
                    qual = rqual[ts * TL:end] if rqual else None
                self.writers[-1].write(r.id, "_trimmed", seq, qual)
                inserted_bases += len(seq)
                st.inserted_bases_in_path += len(seq)
                st.reads_in_path += 1
                st.recruits += 1
                if qual is not None:
                    st.phred_sum_in_path += sum_phred(
                        np.frombuffer(qual, dtype=np.uint8))
            st.valid_reads += 1
            # silver rotation bookkeeping mirrors the scan's reset
            # (goldrush_path.cpp:156-187)
            if dec in (1, 2) and cfg.silver_path and \
                    target_bases < inserted_bases:
                st.paths_completed += 1
                curr_path += 1
                if cfg.max_paths < curr_path:
                    done = True
                    # the reference exit(0)s here; we stop consuming
                    st.valid_reads -= 1   # exit happens before ++valid
                    break
                inserted_bases = 0
                st.reads_in_path = 0
                st.inserted_bases_in_path = 0
                st.phred_sum_in_path = 0.0
                self.writers[-1].close()
                self._open_writer(curr_path)
        if not done:
            assert inserted_bases == scal[1], (inserted_bases, scal[1])
            assert curr_path == scal[2], (curr_path, scal[2])
        for w in self.writers:
            w.close()
        if cfg.silver_path and cfg.max_paths > curr_path:
            print(f"WARNING: Expected {cfg.max_paths} silver paths, "
                  f"but only {curr_path} generated.")
        st.wall_replay_s += time.time() - t1
        st.wall_assign_s += time.time() - t0
        st.device_peak_bytes = max(
            [torch.cuda.max_memory_allocated(c) for c in self.mesh.cards()
             if c.type == "cuda"] or [0])

    # ------------------------------------------------------------------
    def run(self, input_path: str | None = None) -> EngineStats:
        path = input_path or self.cfg.input
        fmt = fastq.detect_format(path)
        if fmt != "fastq":
            raise RuntimeError("Gold Path requires fastq format")
        self.calc_phred_threshold(path)
        if self.cfg.verbose:
            obs.log_engine_header(self.cfg, self.seeds, self.universe,
                                  self.phred_min)
        with obs.profiler_trace(self.cfg.trace_dir or None):
            with obs.phase_timer("inserting bit vector", self.cfg.verbose):
                self.fill(path)
            if self.cfg.save_mibf:
                dm.save_state(self.state, self.params_full,
                              self.cfg.save_mibf)
            if self.cfg.verbose:
                obs.log_filter_breakdown(self.stats)
            with obs.phase_timer("assigned", self.cfg.verbose):
                self.assign(path)
        if self.cfg.verbose:
            obs.log_path_stat(max(self.stats.paths_completed, 1), self.stats,
                              max(self.stats.inserted_bases_in_path, 1))
        return self.stats
