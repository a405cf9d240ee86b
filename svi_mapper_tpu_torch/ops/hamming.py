"""Hamming distances between packed 256-bit descriptors (int32 words).

Two implementations of one contract:
  * :func:`hamming_packed` — XOR + popcount on the packed words;
  * :func:`hamming_mxu`    — the bit-matmul identity
    ``d(i,j) = |a_i| + |b_j| - 2 a_i . b_j`` on unpacked {0,1} float32
    matrices: one ``[N,256] x [256,M]`` matrix product, exact because all
    partial sums are integers <= 256. (The name is the JAX package's.)
"""

from __future__ import annotations

import torch

from svi_mapper_tpu_torch.ops.descriptors import hamming_words, unpack_bits


def hamming_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distance: a [N, 8], b [M, 8] int32 -> [N, M] int32."""
    return hamming_words(a[:, None, :], b[None, :, :])


def hamming_mxu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming via the bit-matmul identity (float32 matmul)."""
    a_bits = unpack_bits(a).to(torch.float32)           # [N, 256]
    b_bits = unpack_bits(b).to(torch.float32)           # [M, 256]
    na = torch.sum(a_bits, dim=-1)
    nb = torch.sum(b_bits, dim=-1)
    dot = a_bits @ b_bits.T
    return (na[:, None] + nb[None, :] - 2.0 * dot).to(torch.int32)
