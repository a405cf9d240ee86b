"""Binary bag-of-words vocabulary: hierarchical k-medians over BRIEF bits.

Analog of the reference's DBoW2 place-recognition path: the reference builds
a branching-factor-10, depth-6 BRIEF vocabulary offline
(``create_vocabulary_dbow2.cpp``, vocab file loaded at ``CTrackerGT.cpp:39``)
and queries a ``BriefDatabase`` per keyframe (``CTrackerGT.cpp:411``) before
descriptor-level matching. Here the tree is built as *batched level-wise
k-medians on the device* — every node of a level is clustered at once via
segment sums over unpacked bit planes (no per-node recursion) — and lookup is
a vectorized descent: at each level one gather of the current node's ``k``
centroids plus an XOR-popcount argmin over the whole descriptor batch.

BoW vectors are dense ``[k**levels]`` TF-IDF histograms (default 8^4 = 4096
words), so database scoring is a single ``[K, W]`` broadcast L1 reduction.
Scoring uses the DBoW2 L1 norm: ``s(v, w) = 1 - 0.5 * |v/|v| - w/|w||_1``.

Packed words are int32 bit patterns (the port's convention). The initial
centroids are drawn on the host from ``np.random.default_rng(seed)``, and
the per-cluster bit counts are float32 sums of 0/1 values, exact below 2^24
summands in any order, so one seed gives one tree on every device.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from svi_mapper_tpu_torch.ops.descriptors import (
    hamming_words,
    pack_bits,
    unpack_bits,
    words_from_numpy,
    words_to_numpy,
)
from svi_mapper_tpu_torch.utils.device import resolve_device

_BIG = 1 << 20


# ---------------------------------------------------------------------------
# vocabulary container
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Vocabulary:
    """A depth-``levels`` branching-``k`` binary vocabulary.

    ``centroids[l]`` is ``[k**l, k, 8]`` int32: the ``k`` child centroids of
    every level-``l`` node. ``child_valid[l]`` masks children that received
    training descriptors. ``weights`` is ``[k**levels]`` float32 idf.
    """

    k: int
    levels: int
    centroids: tuple  # of torch.Tensor [k**l, k, 8] int32
    child_valid: tuple  # of torch.Tensor [k**l, k] bool
    weights: torch.Tensor  # [k**levels] float32

    @property
    def num_words(self) -> int:
        return self.k ** self.levels

    @property
    def device(self) -> torch.device:
        return self.weights.device


def save_vocabulary(path: str | Path, vocab: Vocabulary) -> None:
    """The file format of the JAX package: centroid words as uint32."""
    arrs = {"k": np.int64(vocab.k), "levels": np.int64(vocab.levels),
            "weights": vocab.weights.detach().cpu().numpy()}
    for l in range(vocab.levels):
        arrs[f"cent{l}"] = words_to_numpy(vocab.centroids[l])
        arrs[f"valid{l}"] = vocab.child_valid[l].detach().cpu().numpy()
    np.savez_compressed(path, **arrs)


def load_vocabulary(path: str | Path, device=None) -> Vocabulary:
    dev = resolve_device(device)
    z = np.load(path)
    k, levels = int(z["k"]), int(z["levels"])
    return Vocabulary(
        k=k, levels=levels,
        centroids=tuple(words_from_numpy(z[f"cent{l}"], dev) for l in range(levels)),
        child_valid=tuple(torch.from_numpy(z[f"valid{l}"]).to(dev)
                          for l in range(levels)),
        weights=torch.from_numpy(z["weights"].astype(np.float32)).to(dev),
    )


# ---------------------------------------------------------------------------
# build: level-wise batched k-medians
# ---------------------------------------------------------------------------

def _assign(desc: torch.Tensor, node: torch.Tensor, cent: torch.Tensor,
            cvalid: torch.Tensor) -> torch.Tensor:
    """[N] argmin_child popcount(desc ^ cent[node]) (first child on ties)."""
    c = cent[node]                                   # [N, k, 8]
    d = hamming_words(desc[:, None, :], c)           # [N, k] int32
    d = torch.where(cvalid[node], d, torch.full_like(d, _BIG))
    return torch.min(d, dim=1).indices


def _kmedians_level(desc, bits, node, init_cent, num_nodes: int, k: int,
                    iters: int):
    """Cluster every node of one level at once.

    desc [N,8] int32, bits [N,256] float32 (unpacked desc), node [N] int64
    current node id. Returns (assign [N], cent [num_nodes,k,8],
    cvalid [num_nodes,k]).
    """
    nseg = num_nodes * k
    dev = desc.device
    ones = torch.ones((desc.shape[0],), dtype=torch.float32, device=dev)
    all_valid = torch.ones((num_nodes, k), dtype=torch.bool, device=dev)

    def counts(a):
        seg = node * k + a
        cnt = torch.zeros((nseg,), dtype=torch.float32, device=dev)
        return seg, cnt.index_add_(0, seg, ones)

    cent = init_cent
    for _ in range(iters):
        a = _assign(desc, node, cent, all_valid)
        seg, cnt = counts(a)
        bitsum = torch.zeros((nseg, bits.shape[1]), dtype=torch.float32, device=dev)
        bitsum.index_add_(0, seg, bits)                              # [nseg,256]
        maj = (2.0 * bitsum) > cnt[:, None]                          # bit majority
        new = pack_bits(maj).reshape(num_nodes, k, 8)
        keep = (cnt.reshape(num_nodes, k) > 0)[..., None]
        cent = torch.where(keep, new, cent)

    a = _assign(desc, node, cent, all_valid)
    _, cnt = counts(a)
    return a, cent, cnt.reshape(num_nodes, k) > 0


def build_vocabulary(
    desc: np.ndarray,
    *,
    k: int = 8,
    levels: int = 4,
    iters: int = 8,
    seed: int = 0,
    doc_ids: np.ndarray | None = None,
    device=None,
) -> Vocabulary:
    """Train a vocabulary from packed descriptors ``[N, 8]`` (uint32, or
    int32 bit patterns).

    ``doc_ids`` (``[N]`` int, optional) groups descriptors into "documents"
    (images/keyframes) for idf weighting ``log(n_docs / df_w)``; without it
    all word weights are 1 (DBoW2's TF_IDF falls back the same way when
    trained without document structure). ``device=None`` means CUDA.
    """
    dev = resolve_device(device)
    desc = np.ascontiguousarray(desc)
    if desc.dtype == np.int32:
        desc = desc.view(np.uint32)
    desc = np.ascontiguousarray(desc, np.uint32)   # as the JAX package casts
    n = len(desc)
    if n < k:
        raise ValueError(f"need at least k={k} descriptors, got {n}")
    rng = np.random.default_rng(seed)
    desc_t = words_from_numpy(desc, dev)
    bits = unpack_bits(desc_t).to(torch.float32)
    node = np.zeros(n, np.int32)

    centroids, child_valid = [], []
    for level in range(levels):
        num_nodes = k ** level
        # init: k distinct members per node (host side — cheap, once per level)
        init = np.zeros((num_nodes, k, 8), np.uint32)
        order = np.argsort(node, kind="stable")
        sorted_nodes = node[order]
        starts = np.searchsorted(sorted_nodes, np.arange(num_nodes))
        ends = np.searchsorted(sorted_nodes, np.arange(num_nodes) + 1)
        for s_node in range(num_nodes):
            members = order[starts[s_node]:ends[s_node]]
            if len(members) == 0:
                init[s_node] = desc[rng.integers(0, n, size=k)]
            else:
                pick = rng.choice(members, size=k, replace=len(members) < k)
                init[s_node] = desc[pick]
        a, cent, cvalid = _kmedians_level(
            desc_t, bits, torch.from_numpy(node.astype(np.int64)).to(dev),
            words_from_numpy(init, dev), num_nodes=num_nodes, k=k, iters=iters,
        )
        centroids.append(cent)
        child_valid.append(cvalid)
        node = np.asarray(node * k + a.cpu().numpy(), np.int32)

    num_words = k ** levels
    if doc_ids is not None:
        doc_ids = np.asarray(doc_ids)
        n_docs = len(np.unique(doc_ids))
        pairs = np.unique(np.stack([node, doc_ids.astype(np.int64)], 1), axis=0)
        df = np.bincount(pairs[:, 0].astype(np.int64), minlength=num_words)
        weights = np.where(df > 0, np.log(n_docs / np.maximum(df, 1)), 0.0)
        # words seen in every doc get idf 0; keep a tiny floor so they still count
        weights = np.maximum(weights, 1e-3 * (df > 0))
    else:
        weights = np.ones(num_words)
    return Vocabulary(
        k=k, levels=levels, centroids=tuple(centroids),
        child_valid=tuple(child_valid),
        weights=torch.from_numpy(np.asarray(weights, np.float32)).to(dev),
    )


# ---------------------------------------------------------------------------
# lookup + BoW vectors
# ---------------------------------------------------------------------------

def _descend(centroids: tuple, child_valid: tuple, desc: torch.Tensor, k: int,
             levels: int | None = None):
    """Node ids ``[..., M]`` int64 of descriptors ``[..., M, 8]`` after
    ``levels`` levels of descent (all of them when None)."""
    lead = desc.shape[:-1]
    flat = desc.reshape(-1, desc.shape[-1])
    node = torch.zeros(flat.shape[0], dtype=torch.int64, device=desc.device)
    stop = len(centroids) if levels is None else levels
    for cent, cv in zip(centroids[:stop], child_valid[:stop]):
        node = node * k + _assign(flat, node, cent, cv)
    return node.reshape(lead)


def _as_words(vocab: Vocabulary, desc) -> torch.Tensor:
    if isinstance(desc, np.ndarray):
        return words_from_numpy(desc, vocab.device)
    return desc.to(vocab.device)


def word_ids(vocab: Vocabulary, desc) -> torch.Tensor:
    """Vectorized tree descent: packed descriptors ``[M, 8]`` -> word ids
    ``[M]`` int32."""
    return _descend(vocab.centroids, vocab.child_valid, _as_words(vocab, desc),
                    vocab.k).to(torch.int32)


def node_ids(vocab: Vocabulary, desc, levels: int) -> torch.Tensor:
    """Vocabulary-node ids at tree level ``levels`` for each descriptor
    ``[M, 8]`` -> ``[M]`` int32.

    The direct-index key of DBoW2 (``DBOW2_ID_LEVELS 2``, set by the
    reference at CTrackerGT.cpp:38-39 and consumed via the database's
    per-node feature lists at :248-250): two features are correspondence
    candidates iff their descriptors descend through the same vocabulary
    node at this level.

    ``levels`` counts DOWN FROM THE ROOT (level 1 = the root's children),
    clamped at the vocabulary depth. DBoW2's ``DBOW2_ID_LEVELS`` counts up
    from the leaves; this function mirrors the JAX package, not DBoW2, so
    that the two packages give the same ids for the same setting."""
    return _descend(vocab.centroids, vocab.child_valid, _as_words(vocab, desc),
                    vocab.k, levels=min(levels, vocab.levels)).to(torch.int32)


def _bow_vector_jit(centroids, child_valid, weights, desc, tf, k: int):
    """TF-IDF vectors ``[..., W]`` of descriptor pools ``[..., M, 8]`` with
    term weights ``tf [..., M]``. Leading dimensions are a batch of pools
    (where the JAX package maps its function of this name over them)."""
    node = _descend(centroids, child_valid, desc, k)
    lead = node.shape[:-1]
    v = torch.zeros(lead + (weights.shape[0],), dtype=torch.float32,
                    device=desc.device)
    v.scatter_add_(-1, node, tf)
    v = v * weights
    s = torch.sum(v, dim=-1, keepdim=True)
    return torch.where(s > 0, v / s, v)


def _term_weights(vocab, desc, valid):
    if valid is None:
        return torch.ones(desc.shape[:-1], dtype=torch.float32, device=vocab.device)
    return torch.as_tensor(valid, device=vocab.device).to(torch.float32)


def bow_vector(vocab: Vocabulary, desc, valid=None) -> torch.Tensor:
    """TF-IDF BoW vector ``[num_words]`` float32, L1-normalized."""
    desc = _as_words(vocab, desc)
    return _bow_vector_jit(vocab.centroids, vocab.child_valid, vocab.weights,
                           desc, _term_weights(vocab, desc, valid), vocab.k)


def score_l1(v: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score of one vector against a stack: ``[K]`` in [0, 1]."""
    return 1.0 - 0.5 * torch.sum(torch.abs(db - v[None, :]), dim=-1)


class BowDatabase:
    """Dense BoW database: one L1 broadcast reduction scores all keyframes.

    Role of the reference's ``BriefDatabase`` (DBoW2) queried at
    ``CTrackerGT.cpp:411``. Vectors live on the vocabulary's device, so a
    query moves no vector between host and device.
    """

    def __init__(self, vocab: Vocabulary, capacity: int = 1024):
        self.vocab = vocab
        self.vectors = torch.zeros((capacity, vocab.num_words),
                                   dtype=torch.float32, device=vocab.device)
        self.n = 0

    def _grow_to(self, rows: int) -> None:
        while rows > self.vectors.shape[0]:     # grow (amortized O(1))
            self.vectors = torch.cat([self.vectors, torch.zeros_like(self.vectors)])

    def add(self, desc, valid=None) -> int:
        self._grow_to(self.n + 1)
        i = self.n
        self.vectors[i] = bow_vector(self.vocab, desc, valid)
        self.n = i + 1
        return i

    def add_many(self, descs, valids=None, count: int | None = None) -> int:
        """Add keyframe pools ``[B, P, 8]`` in one batched pass; returns the
        first assigned index.

        ``count`` (default B) is how many leading rows are real — callers
        may pad B; pad rows (all-zero tf) write zero vectors into slots the
        next add overwrites."""
        B = int(np.shape(descs)[0])
        n_real = B if count is None else count
        if n_real == 0:
            return self.n
        self._grow_to(self.n + B)
        i0 = self.n
        descs = _as_words(self.vocab, descs)
        self.vectors[i0:i0 + B] = _bow_vector_jit(
            self.vocab.centroids, self.vocab.child_valid, self.vocab.weights,
            descs, _term_weights(self.vocab, descs, valids), self.vocab.k)
        self.n = i0 + n_real
        return i0

    def query(self, desc, valid=None) -> np.ndarray:
        """Scores ``[n]`` of a query pool against every stored keyframe."""
        if self.n == 0:
            return np.zeros(0, np.float32)
        v = bow_vector(self.vocab, desc, valid)
        return score_l1(v, self.vectors).cpu().numpy()[: self.n]
