"""Hamming distances between packed 256-bit descriptors (int32 words).

Distance matrices, one contract:
  * :func:`hamming_packed` — XOR + popcount on the packed words, in plain
    PyTorch; the plain version of kernel K6;
  * :func:`hamming_mxu`    — the bit-matmul identity
    ``d(i,j) = |a_i| + |b_j| - 2 a_i . b_j`` on unpacked {0,1} float32
    matrices: one ``[N,256] x [256,M]`` matrix product, exact because all
    partial sums are integers <= 256. (The name is the JAX package's.)
  * :func:`hamming_distance_matrix` — kernel K6 (``csrc/hamming_matrix.cu``)
    for CUDA tensors, the plain version only for CPU tensors.

And the fused pool score of the closure search, the second entry of K6:
  * :func:`pool_nn_counts` — per query pool and reference pool, how many
    valid queries have their nearest valid reference within a cutoff; the
    kernel for CUDA tensors (the distance matrix is never written), the
    plain version :func:`pool_nn_counts_plain` only for CPU tensors.

Plus the batched matchers built on the distance matrix (nearest and
mutual-nearest with a Hamming cutoff), replacing ``CBTree::match`` and the
one-to-one enforcement of CBPTree.h:41-50 / ``_getMatchNN``
(CTrackerGT.cpp:648-678).

K6 replaces the TPU kernel ``svi_mapper_tpu/ops/hamming.py``
``hamming_pallas`` (``_hamming_kernel``). Its 128 x 128 tile and the padding
of N and M to 128 served the TPU's lanes and are not carried over: the CUDA
kernels take ragged N and M with a bounds test, and a leading batch
dimension as one grid axis.

Bound on the card: the matrix (N = 256, M = 4096) writes N * M * 4 bytes
(4.2 MB), which sets it; the pool count at ``[8, 256, 16 x 256]`` writes
512 bytes and its operations set it (4.3 G on the binary MMA, whose rate
``chip_smoke.py`` measures: no data sheet gives it). Design: one tile core for both, the identity of :func:`hamming_mxu`
on the tensor cores (the binary MMA, AND and popcount), exact (see the
source).
"""

from __future__ import annotations

import math

import torch

from svi_mapper_tpu_torch.ops import cuda_build, paths
from svi_mapper_tpu_torch.ops.descriptors import (
    DESCRIPTOR_WORDS,
    hamming_words,
    unpack_bits,
)

_BIG = 1 << 20
_GRID_MAX = 65535          # CUDA's limit on the y and z extents of a grid
_TILE_N = 64               # a-rows per block in csrc/hamming_matrix.cu


def hamming_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distance: a [..., N, 8], b [..., M, 8] int32 ->
    [..., N, M] int32."""
    return hamming_words(a[..., :, None, :], b[..., None, :, :])


def hamming_mxu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming via the bit-matmul identity (float32 matmul)."""
    a_bits = unpack_bits(a).to(torch.float32)           # [N, 256]
    b_bits = unpack_bits(b).to(torch.float32)           # [M, 256]
    na = torch.sum(a_bits, dim=-1)
    nb = torch.sum(b_bits, dim=-1)
    dot = a_bits @ b_bits.T
    return (na[:, None] + nb[None, :] - 2.0 * dot).to(torch.int32)


hamming_matrix_launches = 0


def hamming_distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance matrix ``[..., N, M]`` of ``a [..., N, 8]`` against
    ``b [..., M, 8]`` (int32 words, the same leading dimensions on both).

    CUDA tensors go through the hand-written kernel (or raise); only CPU
    tensors take the plain version. The kernel takes one batch axis: leading
    dimensions are flattened to it here and restored on the result."""
    if a.dim() != b.dim() or a.dim() < 2 or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(
            f"hamming_distance_matrix: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    if not (a.is_cuda or b.is_cuda):
        return hamming_packed(a, b)
    if a.device != b.device:
        raise ValueError("hamming_distance_matrix: inputs on different devices")
    lead = a.shape[:-2]
    if len(lead) > 1:
        n = math.prod(lead)
        a, b = a.reshape((n,) + a.shape[-2:]), b.reshape((n,) + b.shape[-2:])
    a, b = a.contiguous(), b.contiguous()
    cuda_build.require_int32_contiguous(a, "a", (DESCRIPTOR_WORDS,))
    cuda_build.require_int32_contiguous(b, "b", (DESCRIPTOR_WORDS,))
    d = launch_hamming_matrix(cuda_build.load_library(), a, b)
    return d.reshape(lead + d.shape[-2:]) if len(lead) > 1 else d


def launch_hamming_matrix(lib, a, b, out=None) -> torch.Tensor:
    """Allocate the matrix (unless ``out`` is given) and launch the kernel
    on checked, contiguous CUDA inputs."""
    batched = a.dim() == 3
    B = a.shape[0] if batched else 1
    N, M = a.shape[-2], b.shape[-2]
    if B > _GRID_MAX or -(-N // _TILE_N) > _GRID_MAX:
        raise ValueError(f"hamming_matrix: B={B}, N={N} exceed the grid")
    shape = (B, N, M) if batched else (N, M)
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=a.device)
    elif (out.shape != shape or out.dtype != torch.int32 or not out.is_contiguous()
          or out.device != a.device):
        raise ValueError("hamming_matrix: out must be a contiguous int32 "
                         f"tensor of shape {shape} on {a.device}")
    if B * N * M > 0:
        with torch.cuda.device(a.device):
            err = lib.svi_hamming_matrix(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), B, N, M,
                torch.cuda.current_stream().cuda_stream)
        cuda_build.check_launch(err, "svi_hamming_matrix")
        paths.count_launch(__name__, "hamming_matrix")
    return out


def pool_nn_counts_plain(desc_q, valid_q, desc_r, valid_r, cutoff: int) -> torch.Tensor:
    """Plain version of :func:`pool_nn_counts`: the distance matrix of the
    queries against the C pools laid end to end, invalid references at
    ``1 << 20``, the min over each pool, the cutoff and the count."""
    C, Pr = desc_r.shape[-3], desc_r.shape[-2]
    lead, P = desc_q.shape[:-2], desc_q.shape[-2]
    d = hamming_packed(desc_q, desc_r.reshape(lead + (C * Pr, DESCRIPTOR_WORDS)))
    d = d.reshape(lead + (P, C, Pr))
    d = torch.where(valid_r[..., None, :, :], d, torch.full_like(d, _BIG))
    dmin = torch.amin(d, dim=-1)                                  # [...,P,C]
    hit = (dmin <= cutoff) & valid_q[..., :, None]
    return torch.sum(hit, dim=-2).to(torch.int32)                 # [...,C]


pool_nn_counts_launches = 0


def pool_nn_counts(
    desc_q: torch.Tensor,      # [..., P, 8] int32 query pools
    valid_q: torch.Tensor,     # [..., P] bool
    desc_r: torch.Tensor,      # [..., C, Pr, 8] int32 reference pools
    valid_r: torch.Tensor,     # [..., C, Pr] bool
    cutoff: int,
) -> torch.Tensor:
    """``[..., C]`` int32: the number of valid queries whose nearest valid
    reference in pool ``c`` lies within ``cutoff`` (Hamming).

    CUDA tensors go through the hand-written kernel (or raise); only CPU
    tensors take :func:`pool_nn_counts_plain`. The kernel takes one batch
    axis: leading dimensions are flattened to it here and restored."""
    lead = desc_q.shape[:-2]
    if (desc_r.shape[:-3] != lead or valid_q.shape != desc_q.shape[:-1]
            or valid_r.shape != desc_r.shape[:-1]):
        raise ValueError(f"pool_nn_counts: shapes {tuple(desc_q.shape)}, "
                         f"{tuple(valid_q.shape)}, {tuple(desc_r.shape)}, "
                         f"{tuple(valid_r.shape)}")
    if not desc_q.is_cuda:
        return pool_nn_counts_plain(desc_q, valid_q, desc_r, valid_r, cutoff)
    B = math.prod(lead)
    P, (C, Pr) = desc_q.shape[-2], desc_r.shape[-3:-1]
    q = desc_q.reshape(B, P, DESCRIPTOR_WORDS).contiguous()
    r = desc_r.reshape(B, C, Pr, DESCRIPTOR_WORDS).contiguous()
    vq = valid_q.reshape(B, P).contiguous()
    vr = valid_r.reshape(B, C, Pr).contiguous()
    cuda_build.require_int32_contiguous(q, "desc_q", (DESCRIPTOR_WORDS,))
    cuda_build.require_int32_contiguous(r, "desc_r", (DESCRIPTOR_WORDS,))
    if not (vq.dtype == vr.dtype == torch.bool
            and q.device == r.device == vq.device == vr.device):
        raise ValueError("pool_nn_counts: bool masks and descriptors on one device")
    counts = launch_pool_nn_counts(cuda_build.load_library(), q, vq, r, vr, cutoff)
    return counts.reshape(lead + (C,))


def launch_pool_nn_counts(lib, q, vq, r, vr, cutoff: int, out=None) -> torch.Tensor:
    """Allocate the ``[B, C]`` counts (unless ``out`` is given) and launch
    the kernel on checked, contiguous CUDA inputs."""
    B, P = q.shape[:2]
    C, Pr = r.shape[1:3]
    if B > _GRID_MAX:
        raise ValueError(f"pool_nn_counts: B={B} exceeds the grid")
    if out is None:
        out = torch.empty((B, C), dtype=torch.int32, device=q.device)
    elif (out.shape != (B, C) or out.dtype != torch.int32 or not out.is_contiguous()
          or out.device != q.device):
        raise ValueError("pool_nn_counts: out must be a contiguous int32 tensor "
                         f"of shape {(B, C)} on {q.device}")
    if B * C > 0:
        with torch.cuda.device(q.device):
            err = lib.svi_pool_nn_counts(
                q.data_ptr(), vq.data_ptr(), r.data_ptr(), vr.data_ptr(),
                out.data_ptr(), B, P, C, Pr, int(cutoff),
                torch.cuda.current_stream().cuda_stream)
        cuda_build.check_launch(err, "svi_pool_nn_counts")
        paths.count_launch(__name__, "pool_nn_counts")
    return out


# ---------------------------------------------------------------------------
# matchers
# ---------------------------------------------------------------------------

def _masked(d, query_valid, ref_valid, both: bool):
    big = torch.full_like(d, _BIG)
    if ref_valid is not None:
        d = torch.where(ref_valid[None, :], d, big)
    if both and query_valid is not None:
        d = torch.where(query_valid[:, None], d, big)
    return d


def match_nearest(query: torch.Tensor, ref: torch.Tensor, cutoff: int,
                  query_valid: torch.Tensor | None = None,
                  ref_valid: torch.Tensor | None = None):
    """Nearest-neighbour Hamming matching with a distance cutoff.

    The batched equivalent of ``CBTree::match`` (CBTree.h:198-236): for each
    query descriptor the best reference index (the first on ties), its
    distance, and an acceptance mask (distance <= cutoff, both sides valid).

    Returns: (idx [N] int32, dist [N] int32, ok [N] bool).
    """
    d = _masked(hamming_distance_matrix(query, ref), None, ref_valid, False)
    idx = torch.argmin(d, dim=1)
    dist = torch.gather(d, 1, idx[:, None])[:, 0]
    ok = dist <= cutoff
    if query_valid is not None:
        ok = ok & query_valid
    return idx.to(torch.int32), dist, ok


def match_mutual(query: torch.Tensor, ref: torch.Tensor, cutoff: int,
                 query_valid: torch.Tensor | None = None,
                 ref_valid: torch.Tensor | None = None):
    """Mutual-nearest (one-to-one) Hamming matching: a pair (i, j) survives
    iff j is i's nearest reference AND i is j's nearest query AND
    d <= cutoff (ties go to the first index on both sides).

    Returns: (idx [N] int32, dist [N] int32, ok [N] bool).
    """
    d = _masked(hamming_distance_matrix(query, ref), query_valid, ref_valid, True)
    fwd = torch.argmin(d, dim=1)                     # best ref per query
    bwd = torch.argmin(d, dim=0)                     # best query per ref
    dist = torch.gather(d, 1, fwd[:, None])[:, 0]
    mutual = bwd[fwd] == torch.arange(d.shape[0], device=d.device)
    ok = mutual & (dist <= cutoff)
    if query_valid is not None:
        ok = ok & query_valid
    return fwd.to(torch.int32), dist, ok


def count_matches(query: torch.Tensor, ref: torch.Tensor, cutoff: int,
                  query_valid: torch.Tensor | None = None,
                  ref_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Number of queries whose nearest reference is within the cutoff —
    the place-recognition score (``getNumberOfMatches``, CBTree.h)."""
    _, _, ok = match_nearest(query, ref, cutoff, query_valid, ref_valid)
    return torch.sum(ok)
