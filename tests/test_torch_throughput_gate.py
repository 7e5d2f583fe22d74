"""PyTorch port, the throughput mode on the 1 Mbp quality-gate dataset:
in bench.py's throughput settings the port's silver paths hash to the JAX
package's digests (tests/fixtures/torch_port_digests.json, written by
tools/torch_port_digests.py), with either filter layout."""

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


@pytest.fixture(autouse=True)
def two_torch_threads():
    """The tier-1 run shares the host's cores among parallel workers; two
    intra-op threads run these engines at half the CPU time of one per
    core and little more wall time."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["direct", "compressed"])
def test_gate_dataset_throughput_digests_match_jax(tmp_path, mode):
    """The 1 Mbp quality-gate dataset in bench.py's throughput settings
    (stride 8, one probed seed, optimistic, batch_reads 64): the port's
    silver paths hash to the JAX package's digests (the check chip_smoke.py
    makes on the card), with either filter layout."""
    fx = json.load(open(FIXTURES / "torch_port_digests.json"))
    want = fx["throughput"][mode]
    ds = fx["dataset"]
    genome = synth.random_genome(ds["genome"], seed=ds["genome_seed"])
    reads = synth.simulate_reads(genome, ds["n_reads"], ds["read_len"],
                                 seed=ds["reads_seed"],
                                 err_rate=ds["err_rate"],
                                 indel_frac=ds["indel_frac"])
    fq = str(tmp_path / "qgate.fq")
    synth.write_fastq(fq, reads)
    prefix = str(tmp_path / "throughput")
    st = GoldenPathEngine(PathConfig(
        input=fq, prefix_file=prefix, mibf_mode=mode,
        **fx["engine"], **fx["throughput"]["engine"]), device="cpu").run()
    got = {str(i): hashlib.sha256(open(f"{prefix}_{i}.fq", "rb").read()
                                  ).hexdigest()
           for i in (1, 2, 3) if os.path.exists(f"{prefix}_{i}.fq")}
    assert got == want["silver"]
    assert (st.recruits, st.paths_completed) == \
        (want["recruits"], want["paths_completed"])
