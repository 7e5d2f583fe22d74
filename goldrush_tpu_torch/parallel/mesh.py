"""Multi-device layout of the golden-path engine: a ``(data, model)`` mesh
of explicit torch devices in one process.

The counterpart of ``goldrush_tpu/parallel/mesh.py``.  The JAX engine
places its arrays on a ``(data, model)`` mesh with shardings and lets XLA
route every gather and scatter; this package holds the same placement as
plain tensors:

  data axis   every data row holds its own replica of the whole filter and
              classifies its share of each batch (reads split in order,
              as JAX's ``P("data")`` splits them); the batched verdicts
              and grids are then copied to every row, and each row runs the
              same in-order consume scan on the whole batch against its own
              replica, so the replicas stay identical with no traffic
              between rows ("every device computes the identical update");
  model axis  the filter's per-slot (or per-rank) arrays are banked by
              index range over a row's devices (``bank_bounds``: JAX's
              ``NamedSharding(mesh, P("model"))``), and the kernels reach a
              bank through its device pointer (csrc/common.cuh ``Banks``):
              a bank on the row's lead card is its own allocation, one on
              another card of the host is peer memory.

One process holds the whole mesh: the consume scan probes the filter after
every insert, read by read, inside one launch, so the banks are addressed
from inside the kernel rather than through collectives.  A card may
repeat in the mesh (``["cuda:0"] * 4``); ``"cpu"`` gives logical CPU
devices, where the plain versions run.  ``train_step`` and
``sharded_train_step`` are the JAX module's state-mutating step: a
batched classify, then every recruit's blockwise insert in batch order,
one launch a data row.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..mibf import compressed as cz
from ..mibf import mibf as dm
from ..mibf.mibf import bank_bounds, to_banks  # noqa: F401
from ..ops.nthash import SeedFamily
from ..path.classify import classify_batch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` array of torch devices, row-major: row i's
    devices are ``devices[i]``, its lead ``devices[i][0]``."""
    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def data(self) -> int:
        return len(self.devices)

    @property
    def model(self) -> int:
        return len(self.devices[0])

    @property
    def rows(self) -> tuple[tuple[torch.device, ...], ...]:
        return self.devices

    def lead(self, i: int) -> torch.device:
        """The device on which data row ``i`` fills, classifies and scans."""
        return self.devices[i][0]

    def cards(self) -> list[torch.device]:
        """The distinct devices of the mesh, in mesh order."""
        seen: list[torch.device] = []
        for row in self.devices:
            for d in row:
                if d not in seen:
                    seen.append(d)
        return seen


def resolve_devices(device, n: int) -> list[torch.device]:
    """The ``n`` devices of a mesh in mesh order: a sequence as given (a
    card may repeat), ``"cpu"`` as ``n`` logical CPU devices, ``"cuda"`` as
    ``cuda:0 .. cuda:n-1``; a card that is absent raises (no silent CPU
    fallback)."""
    if isinstance(device, (list, tuple)):
        devs = [resolve_device(d) for d in device]
        if len(devs) != n:
            raise ValueError(f"{len(devs)} devices given for a mesh of {n}")
        return devs
    dev = resolve_device(device)
    if n == 1 or dev.type == "cpu":
        return [dev] * n
    if dev.index is not None:
        raise ValueError(f"device {str(dev)!r} names one card; a mesh of {n} "
                         "takes 'cuda' or a sequence of devices")
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(f"a mesh of {n} devices asked for 'cuda', but "
                           f"torch.cuda.device_count() is {have}")
    return [torch.device("cuda", i) for i in range(n)]


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


def make_mesh(n_devices: int | None = None, data: int | None = None,
              model: int = 1, devices: Sequence | str = "cuda") -> Mesh:
    """The ``(data, model)`` mesh of the first ``n_devices`` of
    ``devices`` (a sequence, or ``"cuda"`` / ``"cpu"`` as
    ``resolve_devices`` reads them), laid out row-major as JAX's
    ``make_mesh`` lays out ``jax.devices()``, with its asserts.  As JAX's
    takes the accelerator, the default is the cards, and too few of them
    raise; the CPU is asked for by name.  Without ``n_devices`` the mesh
    takes every device, as JAX's does: a sequence's length, or
    ``torch.cuda.device_count()`` cards; ``"cpu"`` has no count to take
    and raises."""
    if n_devices is None:
        if isinstance(devices, (list, tuple)):
            n_devices = len(devices)
        elif resolve_device(devices).type == "cpu":
            raise ValueError("make_mesh on 'cpu' needs n_devices: the CPU "
                             "gives as many logical devices as asked for")
        else:
            n_devices = torch.cuda.device_count()
    if isinstance(devices, (list, tuple)):
        assert len(devices) >= n_devices, (len(devices), n_devices)
        devs = resolve_devices(list(devices[:n_devices]), n_devices)
    else:
        devs = resolve_devices(devices, n_devices)
    data = data or (n_devices // model)
    assert data * model == n_devices, (data, model, n_devices)
    return Mesh(tuple(tuple(devs[i * model: (i + 1) * model])
                      for i in range(data)))


def shard_state(state, mesh: Mesh, banked: bool) -> list:
    """The filter placed on the mesh, one replica per data row: a direct
    ``MibfState`` with ``words``/``counts`` banked over the row's devices
    (``banked``) or whole on its lead; a ``CompressedState`` with
    ``ids``/``counts`` so, and ``bitrank``/``supers`` whole on the lead.
    The port's form of JAX's ``shard_state`` (goldrush_tpu/parallel/
    mesh.py:50), which the engine calls."""
    state = dm.gather_state(state)
    out = []
    for i, row in enumerate(mesh.rows):
        devs = row if banked else row[:1]
        if isinstance(state, cz.CompressedState):
            out.append(cz.CompressedState(
                bitrank=state.bitrank.to(mesh.lead(i), copy=True),
                supers=state.supers.to(mesh.lead(i), copy=True),
                ids=to_banks(state.ids, devs),
                counts=to_banks(state.counts, devs)))
        else:
            out.append(dm.MibfState(words=to_banks(state.words, devs),
                                    counts=to_banks(state.counts, devs)))
    return out


def shard_side(side, mesh: Mesh, banked: bool) -> list:
    """The wavefront's side table placed on the mesh as ``shard_state``
    places the filter: one copy per data row, banked over the row's
    devices (``banked``) or whole on its lead.  ``side`` is a tensor, a
    ``Banks``, or the JAX engine's side table as a uint32 numpy array
    (``_wave_side``; JAX's ``NamedSharding(mesh, P("model"))`` when its
    filter is banked)."""
    if isinstance(side, np.ndarray):
        side = dm.side_from_numpy(side, mesh.lead(0))
    side = dm.whole(side)
    return [to_banks(side, row if banked else row[:1]) for row in mesh.rows]


def classify_step(words, codes: torch.Tensor, lengths: torch.Tensor,
                  fam: SeedFamily, params: dm.MibfParams, num_tiles_max: int,
                  threshold: int, unassigned_min: int, assigned_max: int):
    """One classification step on a batch: kernel A's slot grid, kernel B's
    probe and vote against ``words`` (a tensor or ``dm.Banks``), kernel C's
    decisions.  Returns (classify result, slots, votes), as JAX's
    ``classify_step`` (goldrush_tpu/parallel/mesh.py:61)."""
    slots, frame_ok = dm.build_slot_grid(codes, lengths, fam, params,
                                         num_tiles_max)
    votes = dm.probe_and_vote(words, slots, frame_ok, params,
                              num_tiles=num_tiles_max)
    res = classify_batch(
        votes.curr_id, votes.top_count, votes.cand_ids, votes.cand_counts,
        torch.div(lengths, params.tile_length,
                  rounding_mode="floor").to(torch.int32),
        threshold, unassigned_min, assigned_max)
    return res, slots, votes


def train_step(state: dm.MibfState, codes: torch.Tensor,
               lengths: torch.Tensor, base_ids, fam: SeedFamily,
               params: dm.MibfParams, num_tiles_max: int, max_blocks: int,
               threshold: int = 10, unassigned_min: int = 5,
               assigned_max: int = 1):
    """One full step over a read batch, in place: JAX's ``train_step``
    (goldrush_tpu/parallel/mesh.py:77), the state-mutating analog of a
    training step.  Kernel A's grid, B and C classify every read against
    the direct filter ``state`` (``classify_step``; its arrays a tensor or
    ``dm.Banks`` each), then every recruit inserts in batch order
    (``dm.insert_batch``: on the card one launch of kernel D's batch entry,
    which reads C's verdicts where they lie, nothing fetched to the host;
    each recruit's first ``max_blocks`` blocks, as ``insert_read``).
    ``base_ids`` [B] (a tensor or a sequence) are the reads' first block
    ids.  Returns (state, decisions int32 [B] on the state's device)."""
    res, slots, _ = classify_step(state.words, codes, lengths, fam, params,
                                  num_tiles_max, threshold, unassigned_min,
                                  assigned_max)
    dm.insert_batch(state, slots, res.decision, res.trim_start,
                    res.trim_end, lengths, base_ids, params, max_blocks,
                    num_tiles_max)
    return state, res.decision


def sharded_train_step(mesh: Mesh, fam: SeedFamily, params: dm.MibfParams,
                       num_tiles_max: int, max_blocks: int,
                       shard_filter: bool):
    """``train_step`` over ``mesh``: JAX's ``sharded_train_step``
    (goldrush_tpu/parallel/mesh.py:110), the batch split over the data
    rows and the filter replicated, or banked over each row's devices
    (``shard_filter``).  Returns ``step(replicas, codes, lengths,
    base_ids) -> (replicas, decisions)``: ``replicas`` as
    ``shard_state(state, mesh, shard_filter)`` places the filter (one per
    data row); data row i classifies reads [i B/d, (i+1) B/d) on its lead
    against its replica (B through the bank view), as the engine's
    ``_mesh_inputs`` does; every row then gets the whole batch's slot
    grids and verdicts on its lead, device to device, and inserts every
    recruit in batch order into its own replica (``dm.insert_batch``: one
    launch of kernel D's batch entry through the bank view), so the
    replicas stay equal with no traffic between them.  The decisions
    (int32 [B], on row 0's lead) and the replicas equal ``train_step``'s
    on one device.
    The batch size must be a multiple of the data rows, as JAX's
    ``P("data")`` needs."""
    def step(replicas: list, codes: torch.Tensor, lengths: torch.Tensor,
             base_ids):
        d = mesh.data
        B = codes.shape[0]
        if len(replicas) != d or B % d:
            raise ValueError(f"{len(replicas)} replicas and a batch of {B} "
                             f"reads for a mesh of {d} data rows")
        per = B // d
        # JAX's step is train_step at its default gates
        parts = [classify_step(
            replicas[i].words, codes[i * per: (i + 1) * per].to(mesh.lead(i)),
            lengths[i * per: (i + 1) * per].to(mesh.lead(i)), fam, params,
            num_tiles_max, threshold=10, unassigned_min=5, assigned_max=1)
            for i in range(d)]
        verdicts = [torch.cat([p[0][k].to(mesh.lead(0)) for p in parts])
                    for k in range(3)]       # decision, trim_start, trim_end
        for r in range(d):
            dev = mesh.lead(r)
            dm.insert_batch(replicas[r],
                            torch.cat([p[1].to(dev) for p in parts]),
                            *(v.to(dev) for v in verdicts), lengths, base_ids,
                            params, max_blocks, num_tiles_max)
        return replicas, verdicts[0]
    return step
