"""(w,k)-minimizers: the shared infrastructure of the stages after the
golden path (goldrush_tpu/ops/minimizers.py).

Every k-mer of a sequence gets its canonical unspaced ntHash (the spaced
seed of k care positions); its key packs the top 44 bits of that hash over
the position in the low 20 bits; a window of w consecutive k-mers selects
its smallest key as an unsigned 64-bit value (ties cannot happen: the
positions differ), which is the smallest hash with the leftmost position
breaking ties.

``minimizer_keys`` is K20: on a CUDA tensor it launches the hand-written
kernel of csrc/minimizers.cu, on a CPU tensor it runs the plain PyTorch
version (``_minimizer_keys_plain``).  ``batch_minimizers`` copies the keys
and hashes to the host and selects each sequence's distinct minimizers of
its valid windows with ``np.unique``, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .nthash import hash_positions, umin64, unspaced_family

POS_BITS = 20
POS_MASK = (1 << POS_BITS) - 1
# the kernel's tile holds the k + w - 1 codes of a window among the 4,096 of
# its CTA (csrc/minimizers.cu min_tile); the stages use k <= 40, w <= 1,000
MAX_K_PLUS_W = 4_067


def _sliding_min_plain(keys: torch.Tensor, w: int) -> torch.Tensor:
    """Unsigned minimum over the VALID windows of w along the minor axis,
    by log-doubling (goldrush_tpu/ops/minimizers.py:31-43): m_p[i] =
    min(keys[i:i+p]) for doubling p, then out[i] = min(m_p[i],
    m_p[i+w-p])."""
    m = keys
    p = 1
    while p * 2 <= w:
        m = umin64(m[:, :m.shape[1] - p], m[:, p:])
        p *= 2
    n_out = keys.shape[1] - w + 1
    return umin64(m[:, :n_out], m[:, w - p: w - p + n_out])


def _minimizer_keys_plain(codes: torch.Tensor, k: int, w: int,
                          num_positions: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    hashes = hash_positions(codes, unspaced_family(k), num_positions)[:, 0]
    pos = torch.arange(num_positions, dtype=torch.int64, device=codes.device)
    # (h >> 20) << 20 keeps the top 44 bits; the low 20 carry the position
    keys = (hashes & ~POS_MASK) | pos
    return _sliding_min_plain(keys, w), hashes


def minimizer_keys(codes: torch.Tensor, k: int, w: int, num_positions: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed minimizer keys per window and the position hashes (K20).

    codes: uint8 [B, L] (low two bits read; positions past L read as A);
    returns (keys int64 [B, num_positions - w + 1], hashes int64 [B,
    num_positions]), both uint64 bits.  The caller masks windows beyond a
    sequence's valid range and dedupes repeated selections.  Positions are
    packed in 20 bits, so num_positions may not exceed 2^20."""
    if not w <= num_positions <= 1 << POS_BITS or k < 1:
        raise ValueError(f"minimizer_keys: need 1 <= k, w <= num_positions "
                         f"<= 2^20; got k={k}, w={w}, "
                         f"num_positions={num_positions}")
    if codes.is_cuda:
        return _minimizer_keys_cuda(codes, k, w, num_positions)
    return _minimizer_keys_plain(codes, k, w, num_positions)


def _minimizer_keys_cuda(codes, k, w, P):
    dev = codes.device
    B, L = codes.shape
    kernels.check(codes, "codes", torch.uint8, device=dev)
    if B >= 1 << 16:
        raise ValueError(f"minimizer_keys: {B} rows exceed one launch")
    if k + w > MAX_K_PLUS_W:
        raise ValueError(f"minimizer_keys: k + w = {k + w} exceeds the "
                         f"kernel's {MAX_K_PLUS_W}")
    keys = torch.empty((B, P - w + 1), dtype=torch.int64, device=dev)
    hashes = torch.empty((B, P), dtype=torch.int64, device=dev)
    kernels.MINIMIZER_KEYS(dev, kernels.ptr(codes), B, L, P, k, w,
                           kernels.ptr(keys), kernels.ptr(hashes))
    return keys, hashes


def batch_minimizers(codes: np.ndarray, lengths: np.ndarray, k: int, w: int,
                     device="cuda") -> list[tuple[np.ndarray, np.ndarray]]:
    """Minimizers of a padded batch computed on ``device``; returns per
    sequence (positions int64, hashes uint64) with window masking and
    dedupe done on the host (goldrush_tpu/ops/minimizers.py:82-101)."""
    B, L = codes.shape
    P = max(L - k + 1, w)
    keys_d, hashes_d = minimizer_keys(
        torch.from_numpy(np.ascontiguousarray(codes, dtype=np.uint8)).to(
            device), k, w, P)
    # the host needs the valid windows' keys and the valid positions' hashes
    n_valid = int(np.max(lengths, initial=0)) - k + 1
    keys = keys_d[:, :max(n_valid - w + 1, 0)].cpu().numpy().view(np.uint64)
    hashes = hashes_d[:, :max(n_valid, 0)].cpu().numpy().view(np.uint64)
    out = []
    for b in range(B):
        nvalid = int(lengths[b]) - k + 1
        nwin = nvalid - w + 1
        if nwin <= 0:
            out.append((np.zeros(0, np.int64), np.zeros(0, np.uint64)))
            continue
        sel = np.unique(keys[b, :nwin])
        pos = (sel & np.uint64(POS_MASK)).astype(np.int64)
        pos = pos[pos < nvalid]
        out.append((pos, hashes[b, pos]))
    return out
