"""Per-bit descriptor statistics and probabilistic descriptor matching.

Replacement for the reference's probabilistic-descriptor family:
``CLandmark`` accumulates per-bit probability and permanence vectors over a
landmark's descriptor history (CLandmark.cpp:96-124,260-261 into
``CBitStatistics``, Types.h:83), and the CBPTree/CBPNode/CBPITree trees
match binary queries against those mean-bit vectors (``CPDescriptorBRIEF``,
CPDescriptorBRIEF.h:10-33) with the probability-Hamming cutoff
``MAXIMUM_DISTANCE_HAMMING_PROBABILITY = 50`` (CKeyFrame.h:13).

The tree becomes a matrix product: the expected Hamming distance between a
binary query ``q`` and a mean-bit vector ``p`` is

    E[d(q, x)] = sum_b  q_b (1 - p_b) + (1 - q_b) p_b
               = sum_b p_b  +  q . (1 - 2 p)

so a whole query set against a whole landmark pool is one ``[Q,256] x
[256,N]`` contraction plus a rank-1 bias — exact and batched. Packed
descriptors are ``[..., 8]`` int32 bit patterns, the port's convention.
"""

from __future__ import annotations

import dataclasses

import torch

from svi_mapper_tpu_torch.ops.descriptors import unpack_bits

# Probability-Hamming matching cutoff (ref CKeyFrame.h:13).
MAX_DISTANCE_HAMMING_PROBABILITY = 50.0


@dataclasses.dataclass(frozen=True)
class BitStats:
    """Per-item descriptor bit statistics (ref CBitStatistics, Types.h:83).

    ``prob`` is the running mean of each bit over the observation history;
    ``permanence`` is the fraction of observations in which each bit kept
    the value it had at the previous observation (the reference's
    bit-stability measure, CLandmark.cpp:260-261).
    """

    bit_sum: torch.Tensor     # [..., 256] f32 — sum of observed bits
    stable_sum: torch.Tensor  # [..., 256] f32 — count of bit == previous bit
    count: torch.Tensor       # [...] f32 — observations folded in

    @property
    def prob(self) -> torch.Tensor:
        return self.bit_sum / torch.clamp(self.count[..., None], min=1.0)

    @property
    def permanence(self) -> torch.Tensor:
        # first observation has no predecessor -> count-1 transitions
        return self.stable_sum / torch.clamp(self.count[..., None] - 1.0, min=1.0)


def init_bit_stats(desc: torch.Tensor) -> BitStats:
    """Start statistics from the creation descriptor ``[..., 8]`` int32."""
    bits = unpack_bits(desc).to(torch.float32)
    return BitStats(
        bit_sum=bits,
        stable_sum=torch.zeros_like(bits),
        count=torch.ones(desc.shape[:-1], dtype=torch.float32, device=desc.device),
    )


def update_bit_stats(
    stats: BitStats,
    desc_new: torch.Tensor,   # [..., 8] int32 — newly observed descriptor
    desc_prev: torch.Tensor,  # [..., 8] int32 — previous observation
    mask: torch.Tensor,       # [...] bool — which rows observed this frame
) -> BitStats:
    """Fold one observation per masked row into the statistics (the batched
    per-measurement update of CLandmark::addMeasurement, CLandmark.cpp:96-124)."""
    bits_new = unpack_bits(desc_new).to(torch.float32)
    bits_prev = unpack_bits(desc_prev).to(torch.float32)
    agree = 1.0 - torch.abs(bits_new - bits_prev)
    m = mask[..., None]
    return BitStats(
        bit_sum=torch.where(m, stats.bit_sum + bits_new, stats.bit_sum),
        stable_sum=torch.where(m, stats.stable_sum + agree, stats.stable_sum),
        count=torch.where(mask, stats.count + 1.0, stats.count),
    )


def reset_rows(stats: BitStats, desc: torch.Tensor, rows_mask: torch.Tensor) -> BitStats:
    """Re-initialize masked rows from a fresh creation descriptor (used when
    a landmark slot is recycled)."""
    fresh = init_bit_stats(desc)
    m = rows_mask[..., None]
    return BitStats(
        bit_sum=torch.where(m, fresh.bit_sum, stats.bit_sum),
        stable_sum=torch.where(m, fresh.stable_sum, stats.stable_sum),
        count=torch.where(rows_mask, fresh.count, stats.count),
    )


def expected_hamming(query: torch.Tensor, mean_bits: torch.Tensor) -> torch.Tensor:
    """Expected Hamming distance of binary queries against mean-bit vectors.

    ``query``: [Q, 8] int32 packed descriptors; ``mean_bits``: [N, 256]
    float bit probabilities. Returns [Q, N] float32. One contraction — the
    batched replacement for the CBPTree leaf scan (CBPNode.h:64-201)."""
    q = unpack_bits(query).to(torch.float32)             # [Q, 256]
    bias = torch.sum(mean_bits, dim=-1)                  # [N]
    corr = q @ (1.0 - 2.0 * mean_bits).T                 # [Q, N]
    return bias[None, :] + corr


def match_probabilistic(
    query: torch.Tensor,        # [Q, 8] int32
    mean_bits: torch.Tensor,    # [N, 256] f32
    valid: torch.Tensor,        # [N] bool
    cutoff: float = MAX_DISTANCE_HAMMING_PROBABILITY,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-to-one nearest match under the probability-Hamming cutoff.

    Returns ``(idx, dist, ok)`` per query. One-to-one enforcement mirrors
    the matched-train-ID set of CBPTree::match (CBPTree.h:41-50): a train
    item is awarded to its best-scoring query only (ties between queries
    go to the first, by a stable sort).
    """
    d = expected_hamming(query, mean_bits)               # [Q, N]
    d = torch.where(valid[None, :], d, torch.full_like(d, 1e9))
    dist, idx = torch.min(d, dim=1)                      # first index on ties
    ok = dist <= cutoff
    # one-to-one: for each train index keep only the best query
    Q = query.shape[0]
    N = mean_bits.shape[0]
    order = torch.argsort(dist, stable=True)             # best queries first
    rank = Q - torch.arange(Q, dtype=torch.int64, device=d.device)
    # first[t] holds (Q - rank) of the best query claiming train t; slot N
    # takes the queries over the cutoff
    claim = torch.where(ok[order], idx[order], torch.full_like(idx, N))
    first = torch.zeros((N + 1,), dtype=torch.int64, device=d.device)
    first.scatter_reduce_(0, claim, rank, reduce="amax", include_self=True)
    rank_of_query = torch.zeros((Q,), dtype=torch.int64, device=d.device)
    rank_of_query[order] = rank
    keep = first[idx] == rank_of_query
    return idx.to(torch.int32), dist, ok & keep
