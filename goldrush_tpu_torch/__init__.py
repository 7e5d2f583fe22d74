"""goldrush-tpu-torch: the GoldRush assembler in PyTorch + CUDA: the
golden-path engine and the stages after it (polish, tigmint, ntLink,
targeted polish).

The second implementation of the goldrush-tpu system, beside the JAX package
``goldrush_tpu`` (which stays the reference).  Plain functions on tensors
carry the host glue and the CPU reference paths; the hot device functions are
CUDA kernels written by hand for Hopper (``csrc/``, built at first use by
``kernels.py``).  This package imports neither ``jax`` nor ``goldrush_tpu``.

Every public function that owns a kernel follows one rule: a CPU tensor runs
the plain PyTorch version, a CUDA tensor launches the kernel (or raises).
"""

__version__ = "0.1.0"
