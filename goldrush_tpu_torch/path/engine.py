"""Streaming golden/silver path engine (goldrush-path) on PyTorch + CUDA.

The two-pass GoldRush-Path flow (goldrush_path.cpp:1096-1275) of
``goldrush_tpu/path/engine.py``, with either filter layout (``mibf_mode``),
in exact mode or the throughput mode (sampled query grids, optimistic
staleness, max-id-wins insert, full-resolution trim recheck):

  pass 1: host gates (length/phred/ACGT) -> presence fill of every insert
          seed into a bitmap (kernel A); the direct filter then writes its
          words from the bitmap (presence_merge), the compressed filter
          freezes the bitmap into its rank structure (rank_pack +
          rank_carry) and never holds direct words;
  pass 2: reads stream IN ORDER through batches: a batched classify
          (kernel A's slot grid, or its rank grid in the compressed
          filter, at the query stride over the probed seeds -> kernel B
          probe/vote -> kernel C classify) against the filter at batch
          start, and where inserts or rechecks need it the full-resolution
          grid of every insert seed; then a host loop over the batch that
          re-probes reads against the live filter once it changed inside
          the batch (kernels B and C on one read; under the optimistic
          policy only candidates, and every read after a silver reset),
          re-classifies the boundary zone at full resolution (trim
          recheck), inserts recruits (kernel D, or insert_max under the
          optimistic policy) and rotates silver paths (reset_ids);
  replay: path files and stats are rebuilt on the host from the per-read
          decision rows, as the JAX engine does.

The "exact" staleness policy makes the result bit-identical to sequential
processing at any batch size; both policies are bit-identical to the JAX
engine under the same config.  Configurations of later slices raise
``NotImplementedError`` at construction (see ``_check_slice``).
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
from ..utils import observability as obs
from .classify import classify_batch
from .engine_util import recheck_zone, tile_min_count

# tile-bucket sizes and the per-batch tile budget of the JAX engine
# (goldrush_tpu/path/engine.py:47-52): the same batching gives the same
# batches, so every per-batch observable matches
BUCKETS = (1, 2, 4, 8, 12, 16, 20, 24, 32, 48, 64, 96, 128, 192, 256,
           384, 512, 768, 1024, 1536, 2048)
TILE_BUDGET = 4096
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
    num_batches: int = 0


def _bucket_for(num_tiles: int, cap: int) -> int:
    for b in BUCKETS:
        if num_tiles <= b:
            return min(b, cap)
    return cap


def _check_slice(cfg: PathConfig) -> None:
    """Raise for every configuration the port does not run yet, naming the
    ROADMAP item that brings it."""
    later = [
        (cfg.insert_seeds not in (0, cfg.hash_num), "insert_seeds < h",
         "queue 1 item 7, after 7d"),
        (cfg.insert_stride != 1, "insert_stride > 1",
         "queue 1 item 7, after 7d"),
        (cfg.wavefront, "wavefront", "queue 1 item 10"),
        (cfg.ntcard, "ntcard", "queue 1 item 9"),
        (cfg.devices > 1 or cfg.model_shards > 1,
         "devices > 1 / model_shards > 1", "queue 1 item 11"),
    ]
    for bad, what, item in later:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP.md {item})")


def resolve_device(device) -> torch.device:
    """An explicit device; 'cuda' without a usable card raises (no silent
    CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but torch.cuda is not "
                           "available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class GoldenPathEngine:
    """goldrush-path equivalent.  Construct, then call run()."""

    def __init__(self, cfg: PathConfig, device="cuda"):
        cfg.validate()
        _check_slice(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seeds = make_seed_pattern(cfg.seed_preset, cfg.kmer_size,
                                       cfg.weight, cfg.hash_num)
        self.fam = build_seed_family(self.seeds)
        self.universe = cfg.derived_hash_universe()
        self.size = calc_optimal_size(self.universe, 1, cfg.occupancy)
        # the query tier probes every S-th frame of the first probe_seeds
        # seeds with the gates scaled to S; fill and insert cover the
        # insert seeds at full resolution, and params_full, the trim
        # recheck's classifier, probes those with the exact gates
        # (goldrush_tpu/path/engine.py:141-186)
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
        # the compressed filter freezes pass 1's bitmap into ``cstate``
        # (fill) and never holds the direct words; the direct filter's
        # words need no zero-fill, since the merge that closes pass 1
        # writes every one of them
        self.compressed = cfg.mibf_mode == "compressed"
        self.cstate: cz.CompressedState | None = None
        self.state: dm.MibfState | None = None
        if not self.compressed:
            alloc = self.params.alloc
            self.state = dm.MibfState(
                words=torch.empty(alloc, dtype=torch.int32,
                                  device=self.device),
                counts=torch.zeros(alloc, dtype=torch.int32,
                                   device=self.device))
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
        self._prefetch = max(1, min(int(cfg.jobs), 16))
        self.phred_min = cfg.phred_min
        self.stats = EngineStats()
        self.writers: list[fastq.PathWriter] = []
        self.last_rows = np.zeros((0, 8), dtype=np.int64)

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

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------------
    def fill(self, path: str) -> None:
        """Pass 1: presence fill over all gate-passing reads."""
        t0 = time.time()
        st = self.stats
        if self.cfg.load_mibf:
            # resume from a saved filter (either package's .npz): skip
            # pass 1; its gate bookkeeping is not reconstructed
            state, meta = dm.load_state(self.cfg.load_mibf, self.device)
            # the fill's geometry: every insert seed (a probed prefix of
            # them loads the same filter)
            p = self.params_full
            want = dict(size=p.size, h=p.h, k=p.k, spans=tuple(p.spans),
                        tile_length=p.tile_length)
            if meta != want:
                raise ValueError(
                    f"saved miBF geometry {meta} != engine {want}")
            self.state = state
            st.num_passed_reads = -1     # unknown; loaded
            st.wall_fill_s += time.time() - t0
            return
        # pass 1 sets bits in a presence bitmap, batch by batch; the
        # direct filter writes its words from it once at the end: the
        # filter that ORing every batch into zeroed words would give
        bits = dm.presence_bitmap(self.size, self.device)
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
                    dm.fill_presence_bits(bits, self._to_device(codes),
                                          self._to_device(lengths),
                                          self.fam_ins, self.size,
                                          self.cfg.slot_map)
        if st.num_passed_reads == 0:
            raise RuntimeError(
                "no reads passed the Phred score and min length requirements")
        if not self.compressed:
            dm.merge_presence(self.state.words, bits, self.size,
                              first_write=True)
        self._sync()
        st.wall_fill_stream_s = time.time() - t0
        if self.compressed:
            # the bitmap goes before the rank-indexed tables come
            bitrank, pop = cz.build_rank(bits, self.size)
            del bits
            self.cstate = cz.with_tables(bitrank, pop, self.size)
            self._sync()
        st.wall_fill_s += time.time() - t0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def _open_writer(self, curr_path: int) -> None:
        cfg = self.cfg
        if cfg.silver_path:
            w = fastq.PathWriter(f"{cfg.prefix_file}_{curr_path}.fq", True)
        else:
            w = fastq.PathWriter(f"{cfg.prefix_file}.fa", False)
        self.writers.append(w)

    def _grid(self, codes, lengths, T, fam, params):
        """A batch's probe grid for ``fam``/``params``: slots (direct
        filter) or their ranks (compressed filter), with frame_ok."""
        if self.compressed:
            return cz.build_rank_grid(self.cstate, codes, lengths, fam,
                                      params, T)
        return dm.build_slot_grid(codes, lengths, fam, params, T)

    def _vote(self, grid, frame_ok, T, params):
        if self.compressed:
            return cz.probe_and_vote(self.cstate, grid, frame_ok, params,
                                     num_tiles=T)
        return dm.probe_and_vote(self.state.words, grid, frame_ok, params,
                                 num_tiles=T)

    def _probe_classify(self, grid, frame_ok, n_tiles, T, full=False):
        """Vote + classify rows [B, 8] = (decision, trim_start, trim_end,
        num_assigned, queries, hits, misses, overflow) on the host, against
        the live filter: with the query tier's params and gates, or with
        ``full`` the trim recheck's (params_full, cfg.threshold).  With the
        recheck on, the query tier's rows carry a ninth column, each read's
        minimum in-read top count (``tile_min_count``)."""
        params = self.params_full if full else self.params
        x = self.cfg.threshold if full else self.x_eff
        votes = self._vote(grid, frame_ok, T, params)
        res = classify_batch(votes.curr_id, votes.top_count, votes.cand_ids,
                             votes.cand_counts, n_tiles, x,
                             self.cfg.unassigned_min, self.cfg.assigned_max)
        cols = [res.decision.long(), res.trim_start.long(),
                res.trim_end.long(), res.num_assigned.long(), votes.queries,
                votes.hits, votes.misses, votes.overflow.long().sum(dim=1)]
        if self.rech_on and not full:
            cols.append(tile_min_count(votes.top_count, n_tiles))
        return torch.stack(cols, dim=1).cpu().numpy()

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

    def _insert(self, grid, lo, hi, base, trimmed, T):
        """Insert one recruit's blocks from its full-resolution grid: the
        reservoir rule (kernel D) or, under the optimistic policy, max id
        wins (insert_max)."""
        p = self.params_ins
        if self.compressed:
            fn = cz.insert_read_max if self.fast else cz.insert_read_sorted
            fn(self.cstate, grid, lo, hi, base, trimmed, p, T)
        else:
            fn = dm.insert_read_max if self.fast else dm.insert_read_sorted
            fn(self.state, grid, lo, hi, base, trimmed, p, T)

    def _consume(self, codes, lengths, full_lengths, T, scal, rows_out):
        """One padded batch: batched classify against the filter at batch
        start, then the in-order scan (goldrush_tpu/path/engine.py:865-1003).
        ``scal`` = [ids_inserted, inserted_bases, path_idx, done] carries
        across batches; one row per read is appended to ``rows_out``."""
        cfg = self.cfg
        TL, bs = self.params.tile_length, self.params.block_size
        S = self.params.frame_stride
        silver = bool(cfg.silver_path)
        target, max_paths = int(cfg.target_bases()), int(cfg.max_paths)
        codes_d, lengths_d = self._to_device(codes), self._to_device(lengths)
        n_tiles_np = (lengths // TL).astype(np.int32)
        n_tiles_d = self._to_device(n_tiles_np)
        grid, frame_ok = self._grid(codes_d, lengths_d, T, self.fam_q,
                                    self.params)
        # the full-resolution grid of every insert seed: what recruits
        # insert and the trim recheck probes
        if self.reuse_q:
            grid_ins, ok_ins = grid, frame_ok
        else:
            grid_ins, ok_ins = self._grid(codes_d, lengths_d, T, self.fam_ins,
                                          self.params_ins)
        rows0 = self._probe_classify(grid, frame_ok, n_tiles_d, T)
        ids_ins, ins_bases, path_idx, done = scal
        changed = reset_seen = False
        for i in range(codes.shape[0]):
            if self.fast:
                # optimistic: a batch-time drop stays dropped; after an
                # in-batch silver reset every later read re-probes
                live = (changed and rows0[i][0] != 0) or reset_seen
            else:
                # exact: every read after an in-batch change re-probes
                live = changed
            if live and not done:
                row = self._probe_classify(grid[i:i + 1], frame_ok[i:i + 1],
                                           n_tiles_d[i:i + 1], T)[0]
            else:
                row = rows0[i]
            dec, ts, te, na, q, h, m, ov = (int(x) for x in row[:8])
            n_t, L = int(n_tiles_np[i]), int(full_lengths[i])
            if (self.rech_on and not done
                    and recheck_zone(dec, na, n_t, ts, te, int(row[8]), S,
                                     cfg.threshold, cfg.assigned_max)):
                # boundary zone: re-classify at full resolution, all insert
                # seeds, the exact gates
                dec, ts, te, na, q, h, m, ov = (int(x) for x in
                                                self._probe_classify(
                    grid_ins[i:i + 1], ok_ins[i:i + 1], n_tiles_d[i:i + 1],
                    T, full=True)[0])
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
                self._insert(grid_ins[i], lo, hi, ids_ins + 1, dec == 2, T)
            if not done:
                ids_ins += blocks
                ins_bases += rec_len
            # silver rotation (goldrush_path.cpp:156-187)
            if silver and dec > 0 and target < ins_bases and not done:
                path_idx += 1
                if max_paths < path_idx:
                    done = 1
                else:
                    # the optimistic policy keeps the counters
                    if self.compressed:
                        cz.reset_ids(self.cstate, counts=not self.fast)
                    else:
                        dm.reset_ids(self.state, counts=not self.fast)
                    ids_ins, ins_bases = 0, 0
                    reset_seen = True
            changed = changed or dec > 0
            rows_out.append((dec, ts, te, na, q, h, m, ov))
        return [ids_ins, ins_bases, path_idx, done]

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
        if Bpad * T > TILE_BUDGET:
            Bpad = 1 << max(0, (B - 1)).bit_length()
        return Bpad

    def assign(self, path: str) -> None:
        """Pass 2: the submit pass runs the batches on the device, then the
        replay pass writes the path files from the per-read rows."""
        t0 = time.time()
        cfg, st = self.cfg, self.stats
        TL = cfg.tile_length
        cap = cfg.max_tiles
        read_T: list[int] = []                  # per-eligible-read bucket
        rows: list[tuple] = []
        # submit-pass record cache: replay skips the second input stream
        # when the eligible records fit the cap
        cache: list | None = []
        cached_bytes = 0
        cache_bufs: set = set()
        scal = [0, 0, 1, 0]

        def submit(batch):
            nonlocal scal
            B = len(batch)
            T = max(_bucket_for(r.length // TL, cap) for r in batch)
            read_T.extend([T] * B)
            Bpad = self._pad_batch(B, T)
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
            if cfg.debug:
                self._debug_dump(self._to_device(codes),
                                 self._to_device(lengths),
                                 self._to_device(lengths // TL), T, B)
            tb = time.time()
            batch_rows: list[tuple] = []
            scal = self._consume(codes, lengths, full_lengths, T, scal,
                                 batch_rows)
            rows.extend(batch_rows[:B])
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
            if pending and (len(pending) + 1) * T_new > TILE_BUDGET:
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
        self._sync()
        st.wall_submit_s += time.time() - t0
        self.last_rows = np.asarray(rows, dtype=np.int64).reshape(-1, 8)

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
