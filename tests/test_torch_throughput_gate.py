"""PyTorch port, the throughput mode and the sampled inserts on the 1 Mbp
quality-gate dataset: the port's silver paths hash to the JAX package's
digests (tests/fixtures/torch_port_digests.json, written by
tools/torch_port_digests.py): bench.py's throughput settings with either
filter layout (the "throughput" key), and each case of the "insert" key:
the throughput cell with insert_stride 2 and 8 in both filters, with two
insert seeds over one probed seed, and the exact policy at
insert_stride 2."""

import hashlib
import json
import os

import pytest
import torch

import tests.conftest  # noqa: F401
from tests.conftest import FIXTURES
from goldrush_tpu.utils import synth

from goldrush_tpu_torch.config import PathConfig
from goldrush_tpu_torch.path.engine import GoldenPathEngine

FX = json.loads((FIXTURES / "torch_port_digests.json").read_text())


@pytest.fixture(autouse=True)
def two_torch_threads():
    """The tier-1 run shares the host's cores among parallel workers; two
    intra-op threads run these engines at half the CPU time of one per
    core and little more wall time."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gate_reads(tmp_path_factory):
    ds = FX["dataset"]
    genome = synth.random_genome(ds["genome"], seed=ds["genome_seed"])
    reads = synth.simulate_reads(genome, ds["n_reads"], ds["read_len"],
                                 seed=ds["reads_seed"],
                                 err_rate=ds["err_rate"],
                                 indel_frac=ds["indel_frac"])
    fq = str(tmp_path_factory.mktemp("gate") / "qgate.fq")
    synth.write_fastq(fq, reads)
    return fq


def assert_silver_matches(fq, prefix, want, **cfg):
    """The port's engine on the CPU over ``fq`` with the fixture's engine
    settings and ``cfg``: its silver files' sha256, recruits and paths
    equal ``want``'s."""
    st = GoldenPathEngine(PathConfig(input=fq, prefix_file=prefix,
                                     **FX["engine"], **cfg),
                          device="cpu").run()
    got = {str(i): hashlib.sha256(open(f"{prefix}_{i}.fq", "rb").read()
                                  ).hexdigest()
           for i in (1, 2, 3) if os.path.exists(f"{prefix}_{i}.fq")}
    assert got == want["silver"]
    assert (st.recruits, st.paths_completed) == \
        (want["recruits"], want["paths_completed"])


@pytest.mark.parametrize("mode", ["direct", "compressed"])
def test_gate_dataset_throughput_digests_match_jax(gate_reads, tmp_path,
                                                   mode):
    """The 1 Mbp quality-gate dataset in bench.py's throughput settings
    (stride 8, one probed seed, optimistic, batch_reads 64): the port's
    silver paths hash to the JAX package's digests (the check chip_smoke.py
    makes on the card), with either filter layout."""
    assert_silver_matches(gate_reads, str(tmp_path / "throughput"),
                          FX["throughput"][mode], mibf_mode=mode,
                          **FX["throughput"]["engine"])


@pytest.mark.parametrize("case", sorted(FX["insert"]["cases"]))
def test_gate_dataset_insert_digests_match_jax(gate_reads, tmp_path, case):
    """The sampled inserts (insert_stride > 1, insert_seeds < h) on the
    same dataset: the "insert" key's digests, case by case."""
    assert_silver_matches(gate_reads, str(tmp_path / case),
                          FX["insert"][case], **FX["insert"]["cases"][case])
