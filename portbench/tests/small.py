"""The cells cut to a size the CPU runs in seconds, for the harness's tests:
the same drivers, references and checks on a 1 Mbp filter and a few dozen
reads of a 200 kb region."""

from __future__ import annotations

import copy
import time

import torch

from portbench import lib

GENOME_SIZE = 1_000_000


def cell(name: str) -> dict:
    spec = copy.deepcopy(lib.resolve(name))
    spec["config"]["path_config"]["genome_size"] = GENOME_SIZE
    spec["traffic"].update(genome=200_000, reads=60, batch_reads=16,
                           profiled_units=1)
    return spec


def run(name: str, seed: int = 11, control: bool = False,
        trace: bool = False, driver=None) -> dict:
    """One run of the small cell on the CPU: the driver's outcome."""
    spec = cell(name)
    drv = driver or lib.load_module("drivers", spec["traffic"]["driver"])
    torch.set_num_threads(2)
    return drv.run(spec["cell"], spec["config"], spec["traffic"], seed, 0.0,
                   trace, control, "cpu", time.perf_counter())


def correct(out: dict) -> bool:
    return all(v <= lim for v, lim in out["checks"].values())
