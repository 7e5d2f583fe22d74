"""PyTorch port, the wavefront at the largest windows its tile budget makes:
8,192 one-tile reads a window (and the mesh's padding of it), and at the
largest tile buckets (reads of 1,024-2,048 tiles).

On the card such a window's per-read state and insert index leave
wave_rounds' shared memory for a global scratch (`wavefront.rounds_smem`
plans it as the launcher does; tests/test_torch_kernels.py and
chip_smoke.py phase 9 run it there).  Here the port's CPU engine runs the
fixture's "wave_8192" case (tools/torch_port_digests.py: the JAX
wavefront engine's silver paths over 9,000 reads of 1,500 bases, windows
of 8,192 reads) and its files must match the JAX package's digests."""

import hashlib
import json
import os

import pytest
import torch

from goldrush_tpu_torch.config import PathConfig
from goldrush_tpu_torch.path import wavefront as wave
from goldrush_tpu_torch.path.engine import GoldenPathEngine
from goldrush_tpu_torch.utils import synth

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "torch_port_digests.json")
# tools/torch_port_digests.py ENGINE
ENGINE = dict(genome_size=1_000_000, kmer_size=22, weight=16, hash_num=3,
              seed_preset="1011011110110111101101", silver_path=True,
              max_paths=3, ratio=0.75, min_length=15_000, batch_reads=64)


@pytest.fixture(autouse=True)
def two_torch_threads():
    """The tier-1 run shares the host's cores among parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# (window reads, reads' tiles, query / recheck votes a tile) -> whether the
# insert index and per-read state leave shared memory
@pytest.mark.parametrize("B,T,spills", [(256, 20, False), (7_910, 1, False),
                                        (7_981, 1, True), (8_192, 1, True),
                                        (8_199, 1, True)])
def test_rounds_smem_plan(B, T, spills):
    """The bench cell's tiers (one probed seed at stride 8: 125 votes a
    tile; three seeds at full resolution: 3,000): shared memory within
    the card's 232,448 bytes less the kernel's static arrays at every
    window up to 8,192 reads and the mesh's padding past it, the state
    beside the work region through 7,910 reads and in a slice of 28-30
    bytes a read after, kernel C on every warp. Reads of the largest
    tile buckets (1,024-2,048 tiles, a window of the tile budget plus
    the mesh's padding) run C on fewer warps, whose buffers fit beside
    the state, and spill nothing."""
    smem, slice_bytes, c_warps = wave.rounds_smem(B, T, 32, 125, 3_000,
                                                  True)
    assert smem <= wave.MAX_SMEM - wave.WAVE_STATIC_SMEM and c_warps == 16
    assert (slice_bytes > 0) == spills
    if spills:
        assert 28 * B <= slice_bytes <= 30 * B
    for tiles, warps in ((1_024, 14), (1_536, 8), (2_048, 7)):
        for reads in (1, 8_192 // tiles, 8_192 // tiles + 7):
            plan = wave.rounds_smem(reads, tiles, 32, 125, 3_000, True)
            assert plan.smem <= wave.MAX_SMEM - wave.WAVE_STATIC_SMEM
            assert (plan.slice_bytes, plan.c_warps) == (0, warps)


@pytest.mark.parametrize("d", [3, 5, 6, 7])
def test_adjacency_plan_takes_mesh_padding(d):
    """wave_adjacency takes the windows that the mesh's padding makes of a
    full window of 8,192 one-tile reads (8,193-8,199 reads at d = 3, 5, 6
    and 7 data rows, the engine's _pad_batch), up to the 14-bit read order
    of its group entries, and raises past it."""
    B = -(-8_192 // d) * d
    assert 8_192 < B <= 8_199
    parts, buckets, units = wave.adjacency_plan(B, 3, 1_000, 1, 1, 1_000,
                                                3, 142_368_384, 132)
    assert parts == wave.adjacency_parts(B * 3 * 1_000)
    assert buckets == min(parts, wave.ADJ_BUCKETS) and units >= 1
    assert wave.ord_bits(B) == 14
    wave.adjacency_plan(wave.MAX_ADJ_READS, 3, 1_000, 1, 1, 1_000, 3,
                        142_368_384, 132)
    with pytest.raises(ValueError, match="adjacency"):
        wave.adjacency_plan(wave.MAX_ADJ_READS + 1, 3, 1_000, 1, 1, 1_000,
                            3, 142_368_384, 132)


def test_wave_window_8192_matches_jax_digests(tmp_path):
    """The port's wavefront engine on the CPU over the fixture's one-tile
    dataset in windows of 8,192 reads (direct filter): its silver paths,
    recruits and completed paths equal the JAX engine's."""
    with open(FIXTURE) as f:
        fx = json.load(f)["wave_8192"]
    d = {k: v for k, v in fx["dataset"].items() if k != "sha256"}
    fq = str(tmp_path / "one_tile.fq")
    synth.write_fastq(fq, synth.simulate_reads(
        synth.random_genome(d["genome"], seed=d["genome_seed"]),
        d["n_reads"], d["read_len"], seed=d["reads_seed"],
        err_rate=d["err_rate"], indel_frac=d["indel_frac"]))
    assert sha256(fq) == fx["dataset"]["sha256"]
    prefix = str(tmp_path / "w8k")
    eng = GoldenPathEngine(PathConfig(input=fq, prefix_file=prefix,
                                      mibf_mode="direct",
                                      **{**ENGINE, **fx["engine"]}),
                           device="cpu")
    st = eng.run()
    assert eng.wave and eng.batch_reads == 8_192
    silver = {str(i): sha256(f"{prefix}_{i}.fq")
              for i in range(1, ENGINE["max_paths"] + 1)
              if os.path.exists(f"{prefix}_{i}.fq")}
    got = {"recruits": st.recruits, "paths_completed": st.paths_completed,
           "silver": silver}
    assert got == fx["direct"]
    assert eng.consume_counts["rotations"] > 0
