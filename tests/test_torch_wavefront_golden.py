"""PyTorch port, the wavefront consume (K23) in golden mode (no silver
rotation): GoldenPathEngine with wavefront=True on the CPU against the JAX
wavefront engine, as test_torch_wavefront_engine.py holds silver mode,
with either filter at windows of 16 and 256 reads."""

import pytest

from tests.test_torch_wavefront_engine import (  # noqa: F401
    run_both, small_jax_chunks, two_torch_threads, wave_reads)


@pytest.mark.parametrize("window", [16, 256])
@pytest.mark.parametrize("mode", ["direct", "compressed"])
def test_wavefront_golden_matches_jax(wave_reads, small_jax_chunks, mode,
                                      window):
    d, path = wave_reads
    run_both(d, path, mode, False, window)
