"""Loop-closure subsystem: place recognition, cloud matching, consensus.

Replacement for the reference's loop-closing stack:
  * DBoW2 vocabulary query + per-keyframe CBTree descriptor matching
    (CTrackerGT.cpp:383-503, CKeyFrame.cpp:6-35) -> exact all-pairs Hamming
    scoring of fixed-capacity descriptor pools (kernel K6: its pool-count
    entry behind :func:`_pool_nn_counts`, its matrix entry behind
    :func:`match_pools`);
  * per-candidate 3D-3D ICP with gates (CTrackerGT.cpp:506-631) ->
    batched ``solvers.icp`` over all candidates at once;
  * windowed single-robot consensus ``LoopClosureChecker``
    (closure_checker.cpp:20-113) -> a [C, C] chi^2 matrix.

The database is a host container of device tensors. ``add`` /
``add_many`` write the rows of new keyframes in place; rows below ``n`` of
the pools are never written again, and a capacity doubling allocates new
tensors and leaves the old ones as they were. ``update_poses`` rebinds new
pose tensors instead of writing the old ones. So a
:meth:`KeyframeDatabase.snapshot` (a shallow copy) reads what it was taken
with while the tracker keeps adding keyframes: the closure worker thread
(``SLAMSystem(async_closure=True)``) searches such snapshots.

With ``native_index=True`` the database also feeds the port's C++
descriptor tree (:class:`svi_mapper_tpu_torch.native.DescriptorIndex`,
internally locked), which shortlists candidates where no vocabulary is
trained. A database with an index trains no in-run vocabulary (as in the
JAX package), so unless a vocabulary is given, the tree shortlists every
query.

Where the JAX package maps a function over queries or candidates, the
functions here take leading batch dimensions. The fused query reads one
flag per call on the host (did any candidate pass the entry floor) before
the match + ICP stage, and the ICP loop reads one flag per iteration.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from svi_mapper_tpu_torch.geometry import se3
from svi_mapper_tpu_torch.mapping.vocabulary import (
    BowDatabase,
    _bow_vector_jit,
    _descend,
    build_vocabulary,
)
from svi_mapper_tpu_torch.ops.descriptors import unpack_bits
from svi_mapper_tpu_torch.ops.hamming import hamming_distance_matrix, pool_nn_counts
from svi_mapper_tpu_torch.solvers import icp
from svi_mapper_tpu_torch.utils.device import (
    fetch_numpy,
    require_fp32_matmul,
    resolve_device,
)

_BIG = 1 << 20


# ---------------------------------------------------------------------------
# keyframe database (host container, device tensors)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KeyframeDatabase:
    """Growable stack of keyframe descriptor/point pools
    (the batched replacement for the BoW database + per-keyframe trees).

    Capacity doubles when full. Closure-query shortlisting is ON by default:
    a bag-of-words vocabulary trains automatically on the first
    ``vocab_train_at`` keyframes' descriptor pools (the reference always
    shortlists with a pretrained DBoW2 vocabulary, CTrackerGT.cpp:39,411 —
    training in-run replaces shipping a vocabulary file).
    """

    capacity: int
    pool_size: int
    desc: torch.Tensor        # [K, P, 8] int32 descriptor pools
    p_cam: torch.Tensor       # [K, P, 3] landmark positions in the keyframe frame
    valid: torch.Tensor       # [K, P] bool
    count: torch.Tensor       # [K] int32
    T_wc: torch.Tensor        # [K, 4, 4] keyframe poses at spawn
    n: int = 0                # number of keyframes stored
    # per-pool-entry descriptor bit probabilities, quantized to uint8
    # (ref CPDescriptorBRIEF mean-bit vectors stored per keyframe,
    # CKeyFrame.h:86-94 / CPDescriptorBRIEF.h:10-33); None = not stored
    prob: torch.Tensor | None = None   # [K, P, 256] uint8
    index: object | None = None  # optional native DescriptorIndex
    bow: BowDatabase | None = None
    auto_vocab: bool = True      # train the BoW vocabulary in-run
    vocab_train_at: int = 8      # keyframes accumulated before training
    count_host: list = dataclasses.field(default_factory=list)  # host mirror
    # host mirror of T_wc: the closure search reads poses for its metric
    # radius gate / ICP init without a device read
    T_wc_host: np.ndarray | None = None  # [K,4,4]

    @property
    def device(self) -> torch.device:
        return self.desc.device

    def count_of(self, k: int) -> int:
        """Pool size of keyframe k without a device read."""
        if k < len(self.count_host):
            return self.count_host[k]
        return int(self.count[k])    # converted-state fallback

    @classmethod
    def create(cls, capacity: int = 512, pool_size: int = 256,
               native_index: bool = False,
               vocabulary: object | None = None,
               auto_vocab: bool = True,
               store_prob: bool = True,
               device=None) -> "KeyframeDatabase":
        """Default shortlisting = in-run BoW (the reference's DBoW2 role);
        the native tree index is opt-in, and a database with one trains no
        vocabulary in-run. ``device=None`` means CUDA (raises without one).

        With ``native_index=True`` the port's C++ library is built (g++) if
        it is not yet; if it cannot be, this raises ``RuntimeError`` with
        the reason (``native.load_error()``) rather than run without the
        index."""
        dev = resolve_device(device)
        index = None
        if native_index:
            from svi_mapper_tpu_torch import native

            index = native.DescriptorIndex()
        bow = None
        if vocabulary is not None:
            bow = BowDatabase(vocabulary, capacity=capacity)
            auto_vocab = False
        return cls(
            capacity=capacity,
            pool_size=pool_size,
            desc=torch.zeros((capacity, pool_size, 8), dtype=torch.int32, device=dev),
            p_cam=torch.zeros((capacity, pool_size, 3), dtype=torch.float32, device=dev),
            valid=torch.zeros((capacity, pool_size), dtype=torch.bool, device=dev),
            count=torch.zeros((capacity,), dtype=torch.int32, device=dev),
            T_wc=torch.eye(4, dtype=torch.float32, device=dev).repeat(capacity, 1, 1),
            prob=(torch.zeros((capacity, pool_size, 256), dtype=torch.uint8, device=dev)
                  if store_prob else None),
            index=index,
            bow=bow,
            auto_vocab=auto_vocab,
            T_wc_host=np.tile(np.eye(4, dtype=np.float32), (capacity, 1, 1)),
        )

    def _grow(self) -> None:
        """Double the pool capacity (amortized O(1) per keyframe)."""
        pad = self.capacity
        for name in ("desc", "p_cam", "valid", "count", "prob"):
            t = getattr(self, name)
            if t is not None:
                setattr(self, name, torch.cat([t, torch.zeros_like(t)]))
        eye = torch.eye(4, dtype=torch.float32, device=self.device).repeat(pad, 1, 1)
        self.T_wc = torch.cat([self.T_wc, eye])
        if self.T_wc_host is not None:
            self.T_wc_host = np.concatenate(
                [self.T_wc_host,
                 np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))])
        self.capacity *= 2

    def _train_vocab(self) -> None:
        """In-run vocabulary training over the stored pools (the shipped-
        vocabulary replacement; ref brief_k10L6.voc.gz, CTrackerGT.cpp:39)."""
        desc_all = self.desc[: self.n].cpu().numpy()
        descs = [desc_all[k][: self.count_of(k)] for k in range(self.n)]
        alld = np.concatenate(descs)
        if len(alld) < 64:
            return
        doc_ids = np.concatenate(
            [np.full(len(d), k, np.int32) for k, d in enumerate(descs)])
        vocab = build_vocabulary(alld, k=8, levels=3, iters=4, doc_ids=doc_ids,
                                 device=self.device)
        self.bow = BowDatabase(vocab, capacity=max(self.capacity, 1024))
        self.bow.add_many(self.desc[: self.n], self.valid[: self.n])

    def _padded(self, desc, p_cam):
        """One pool truncated/padded to ``pool_size`` (host arrays)."""
        P = self.pool_size
        n = min(len(desc), P)
        d = np.zeros((P, 8), np.int32)
        p = np.zeros((P, 3), np.float32)
        v = np.zeros((P,), bool)
        d[:n] = _words_np(desc)[:n]
        p[:n] = p_cam[:n]
        v[:n] = True
        return n, d, p, v

    def add(self, desc: np.ndarray, p_cam: np.ndarray, T_wc: np.ndarray,
            prob: np.ndarray | None = None,
            prob_device: tuple | None = None) -> int:
        """Append one keyframe pool (truncated/padded to pool_size).

        ``desc`` [n, 8] uint32 (or int32 bit patterns), ``p_cam`` [n, 3].
        ``prob`` [n, 256] uint8 — optional quantized bit probabilities of
        the pooled landmarks. ``prob_device`` = (plane [L, 256] uint8 DEVICE
        tensor, sel_idx [n] host int indices): the probability rows stay on
        the device and the pool gather + store run there."""
        return self.add_many([(desc, p_cam, T_wc, None)], None,
                             _single=(prob, prob_device))[0]

    def add_many(self, pools: list, plane: torch.Tensor | None = None,
                 _single: tuple | None = None) -> list[int]:
        """Append a CHUNK of keyframe pools in one batched write.

        ``pools`` is a list of ``(desc [n,8], p_cam [n,3], T_wc [4,4],
        sel_idx [n] | None)`` host tuples, in keyframe order; ``plane`` is
        the chunk's stacked ``[B, L, 256]`` uint8 bit-probability device
        tensor aligned with ``pools`` (``sel_idx`` indexes its L axis).
        Equivalent to ``[self.add(...) for ...]``. Without a plane, a
        database that stores probabilities degrades each pool to binary
        0/255 probabilities, as :meth:`add` does without ``prob``.
        """
        B = len(pools)
        if B == 0:
            return []
        while self.n + B > self.capacity:
            self._grow()
        P = self.pool_size
        dev = self.device
        d = np.zeros((B, P, 8), np.int32)
        p = np.zeros((B, P, 3), np.float32)
        v = np.zeros((B, P), bool)
        nv = np.zeros((B,), np.int32)
        T = np.zeros((B, 4, 4), np.float32)
        idx = np.zeros((B, P), np.int64)     # pad slots re-read row 0;
        for b, (desc, p_cam, T_wc, sel_idx) in enumerate(pools):  # valid is False there
            nv[b], d[b], p[b], v[b] = self._padded(desc, p_cam)
            T[b] = np.asarray(T_wc, np.float32)
            if sel_idx is not None:
                idx[b, : nv[b]] = np.asarray(sel_idx)[: nv[b]]
        k0 = self.n
        sl = slice(k0, k0 + B)
        d_t = torch.from_numpy(d).to(dev)
        v_t = torch.from_numpy(v).to(dev)
        self.desc[sl] = d_t
        self.p_cam[sl] = torch.from_numpy(p).to(dev)
        self.valid[sl] = v_t
        self.count[sl] = torch.from_numpy(nv).to(dev)
        self.T_wc[sl] = torch.from_numpy(T).to(dev)
        if self.prob is not None:
            prob, prob_device = _single or (None, None)
            if plane is not None or prob_device is not None:
                if prob_device is not None:
                    plane, sel_idx = prob_device[0][None], prob_device[1]
                    idx[0, : nv[0]] = np.asarray(sel_idx)[: nv[0]]
                # the plane never crosses to the host: gather on the device
                gi = torch.from_numpy(idx).to(dev)[:, :, None].expand(-1, -1, 256)
                self.prob[sl] = torch.gather(plane.to(dev), 1, gi)
            elif prob is not None:
                prh = np.zeros((1, P, 256), np.uint8)
                prh[0, : nv[0]] = prob[: nv[0]]
                self.prob[sl] = torch.from_numpy(prh).to(dev)
            else:
                # the binary snapshot as a degenerate (0/255) probability, so
                # that probabilistic matching degrades to exact
                self.prob[sl] = (unpack_bits(d_t).to(torch.uint8) * 255
                                 * v_t[:, :, None].to(torch.uint8))
        self.count_host.extend(int(x) for x in nv)
        if self.T_wc_host is not None:
            self.T_wc_host[sl] = T
        if self.index is not None:
            for b in range(B):
                self.index.add(d[b, : nv[b]], k0 + b)
        self.n = k0 + B
        if self.bow is not None:
            self.bow.add_many(d_t, v_t)
        elif (self.auto_vocab and self.index is None
              and self.n >= self.vocab_train_at):
            self._train_vocab()
        return list(range(k0, k0 + B))

    def poses_host(self) -> np.ndarray:
        """[capacity,4,4] stored keyframe poses WITHOUT a device read (host
        mirror; fetched once for a database converted without one)."""
        if self.T_wc_host is None or len(self.T_wc_host) != self.capacity:
            self.T_wc_host = self.T_wc.cpu().numpy().astype(np.float32).copy()
        return self.T_wc_host

    def update_poses(self, T_new: np.ndarray) -> None:
        """Overwrite the first ``len(T_new)`` stored poses (device tensor +
        host mirror) — the pose-graph back-propagation into the closure DB
        (ref _backPropagateTrajectoryToFull, Cg2oOptimizer.cpp:1552-1603).

        Rebinds new tensors instead of writing the old ones: a
        :meth:`snapshot` held by a reader thread keeps the poses it was
        taken with, so its radius gate and ICP initialisations stay
        consistent with one another."""
        n = len(T_new)
        host = self.poses_host().copy()
        host[:n] = np.asarray(T_new, np.float32)
        self.T_wc_host = host
        T_wc = self.T_wc.clone()
        T_wc[:n] = torch.from_numpy(host[:n]).to(self.device)
        self.T_wc = T_wc

    def snapshot(self) -> "KeyframeDatabase":
        """Shallow copy for a reader thread. It reads what it was taken with
        while this database takes more keyframes: rows below ``n`` of the
        pools, the BoW store and the host lists are never rewritten (growth
        and :meth:`update_poses` rebind new tensors), the rows added later
        lie past every query's temporal bound, and the shared native index
        is internally locked and bounds its votes the same way."""
        return dataclasses.replace(self)


def _words_np(desc) -> np.ndarray:
    """uint32 / int32 packed words (numpy) -> int32 with the same bits."""
    desc = np.ascontiguousarray(desc)
    if desc.dtype == np.int32:
        return desc
    return np.ascontiguousarray(desc, np.uint32).view(np.int32)


# ---------------------------------------------------------------------------
# place recognition: batched pool scoring
# ---------------------------------------------------------------------------

def _pool_nn_counts(
    desc_q: torch.Tensor,      # [..., P, 8] query pool
    valid_q: torch.Tensor,     # [..., P]
    desc_r: torch.Tensor,      # [..., C, Pr, 8] reference pools
    valid_r: torch.Tensor,     # [..., C, Pr]
    cutoff: int,
) -> torch.Tensor:
    """[..., C] match counts: #query descriptors whose nearest neighbour in
    pool c is within the Hamming cutoff (the reference's getNumberOfMatches
    score, CBTree.h:198-236 — exact brute force replaces tree descent).

    The ONE home of the [P, C, P] distance-min-count block: every pool-
    scoring entry point routes through here. On the card it is one fused
    kernel (K6's pool entry,
    :func:`~svi_mapper_tpu_torch.ops.hamming.pool_nn_counts`), which never
    writes the distance matrix; on the CPU its plain version
    (:func:`~svi_mapper_tpu_torch.ops.hamming.pool_nn_counts_plain`)."""
    return pool_nn_counts(desc_q, valid_q, desc_r, valid_r, cutoff)


def score_pools(desc_q, valid_q, desc_db, valid_db, cutoff: int = 25) -> torch.Tensor:
    """[K] match counts of the query pool against every database pool
    (cutoff: ref MAXIMUM_DISTANCE_HAMMING, CKeyFrame.h:12)."""
    return _pool_nn_counts(desc_q, valid_q, desc_db, valid_db, cutoff)


def count_pool_matches(desc_q, valid_q, desc_r, valid_r, cutoff: int = 25) -> torch.Tensor:
    """Scalar match count of one query pool against one reference pool
    (single-pool slice of :func:`score_pools`)."""
    return _pool_nn_counts(desc_q, valid_q, desc_r[None], valid_r[None], cutoff)[0]


def _prob_distance(desc_q, prob_q, desc_r, prob_r) -> torch.Tensor:
    """Symmetric expected-Hamming distance matrix [..., Pq, Pr] between two
    pools.

    Each side contributes E[d(bits, mean_bits_other)] = sum(p) + b.(1-2p)
    (mapping.bitstats); averaging both directions uses BOTH observation
    histories (ref: binary queries against stored CPDescriptorBRIEF
    mean-bit vectors, CBPNode.h leaf scan, cutoff CKeyFrame.h:13). Two
    float32 matrix products in full float32."""
    require_fp32_matmul(desc_q)
    bq = unpack_bits(desc_q).to(torch.float32)          # [..., P, 256]
    br = unpack_bits(desc_r).to(torch.float32)
    pq = prob_q.to(torch.float32) / 255.0
    pr = prob_r.to(torch.float32) / 255.0
    d_qr = torch.sum(pr, -1)[..., None, :] + bq @ (1.0 - 2.0 * pr).transpose(-1, -2)
    d_rq = torch.sum(pq, -1)[..., None, :] + br @ (1.0 - 2.0 * pq).transpose(-1, -2)
    return 0.5 * (d_qr + d_rq.transpose(-1, -2))


def match_pools(
    desc_q: torch.Tensor, p_q: torch.Tensor, valid_q: torch.Tensor,
    desc_r: torch.Tensor, p_r: torch.Tensor, valid_r: torch.Tensor,
    cutoff: int = 25,
    prob_q: torch.Tensor | None = None,   # [..., P, 256] u8 bit probabilities
    prob_r: torch.Tensor | None = None,
    prob_cutoff: float = 50.0,
    node_q: torch.Tensor | None = None,   # [..., P] direct-index node ids
    node_r: torch.Tensor | None = None,
):
    """Mutual-nearest matching of two keyframe pools -> aligned point pairs.
    Every argument may carry the same leading batch dimensions.

    Returns (pq [P,3], pr [P,3], ok [P], fwd [P] int32): for each query-pool
    slot, the matched reference point and its pool slot index (one-to-one
    enforced, ref CBPTree.h:41-50 / _getMatchNN CTrackerGT.cpp:648-678;
    the first index wins a tie on both sides).

    With ``prob_q``/``prob_r`` given, the distance is the symmetric expected
    Hamming between each pool's bit-probability history under the
    probabilistic cutoff (ref MAXIMUM_DISTANCE_HAMMING_PROBABILITY = 50,
    CKeyFrame.h:13); otherwise the exact distance matrix of kernel K6.

    With ``node_q``/``node_r`` given, pairs are additionally required to
    share their vocabulary node (the DBoW2 direct-index restriction,
    CTrackerGT.cpp:38-39,248-250) — a node-equality mask on the matrix."""
    both = valid_q[..., :, None] & valid_r[..., None, :]
    if node_q is not None and node_r is not None:
        both = both & (node_q[..., :, None] == node_r[..., None, :])
    if prob_q is not None and prob_r is not None:
        d = _prob_distance(desc_q, prob_q, desc_r, prob_r)
        d = torch.where(both, d, torch.full_like(d, 1e9))
        cut = float(prob_cutoff)
    else:
        d = hamming_distance_matrix(desc_q, desc_r)
        d = torch.where(both, d, torch.full_like(d, _BIG))
        cut = cutoff
    fwd = torch.argmin(d, dim=-1)                       # [..., Pq]
    bwd = torch.argmin(d, dim=-2)                       # [..., Pr]
    dist = torch.gather(d, -1, fwd[..., None])[..., 0]
    mutual = torch.gather(bwd, -1, fwd) == torch.arange(d.shape[-2], device=d.device)
    ok = mutual & (dist <= cut) & valid_q
    pr_m = torch.gather(p_r, -2, fwd[..., None].expand(fwd.shape + (3,)))
    return p_q, pr_m, ok, fwd.to(torch.int32)


def _match_and_align(desc_q, p_q, valid_q, desc_r, p_r, valid_r, T_init, *,
                     cutoff, prob_q, prob_r, prob_cutoff, node_q, node_r,
                     icp_inlier_m2, icp_min_inliers, icp_max_avg_error):
    """Mutual matching + ICP validation of ``[N, P, ...]`` pool pairs:
    ``(n_matches [N], T_qr [N,4,4], icp_ok [N], inliers [N], inl [N,P],
    fwd [N,P])``."""
    pq, prm, okm, fwd = match_pools(
        desc_q, p_q, valid_q, desc_r, p_r, valid_r, cutoff=cutoff,
        prob_q=prob_q, prob_r=prob_r, prob_cutoff=prob_cutoff,
        node_q=node_q, node_r=node_r)
    res = icp._align(pq, prm, okm, T_init, icp_inlier_m2, icp_min_inliers,
                     icp_max_avg_error, 20, 1e-5, 1e-6)
    n_matches = torch.sum(okm, dim=-1).to(torch.int32)
    # post-ICP inlier correspondences (the pair export)
    q = se3.transform(res.T_qr[:, None], prm)
    err2 = torch.sum((q - pq) ** 2, dim=-1)
    inl = okm & (err2 < icp_inlier_m2)
    return n_matches, res.T_qr, res.ok, res.inliers, inl, fwd


def _top_k_stable(x: torch.Tensor, k: int):
    """The ``k`` largest along the last axis, the lower index first among
    equals (``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def closure_query_fused(
    centroids, child_valid, weights,   # the vocabulary
    vectors: torch.Tensor,             # [Nv, W] stored BoW vectors
    query_kf,                          # int, or [B] int tensor (a batch)
    desc_db: torch.Tensor, p_db: torch.Tensor, valid_db: torch.Tensor,
    T_db: torch.Tensor,                # [Nd,4,4] stored keyframe poses
    lo,                                # temporal bound (< lo eligible)
    radius_m2: float,                  # metric candidate gate (inf = off)
    entry_floor,                       # shortlist match-count floor
    k: int, C: int, Cm: int, cutoff: int,
    prob_db: torch.Tensor | None = None,
    prob_cutoff: float = 50.0,
    icp_inlier_m2: float = 1.0,
    icp_min_inliers: int = 25,
    icp_max_avg_error: float = 0.9,
    di_levels: int = 0,
):
    """The WHOLE loop-closure query: BoW scoring -> temporal + metric-radius
    gates -> top-C shortlist -> exact match counts -> top-Cm candidate
    selection -> mutual pool matching (exact or probabilistic) -> batched
    ICP validation.

    ``query_kf``, ``lo`` and ``entry_floor`` are scalars for one query, or
    ``[B]`` tensors for a batch of queries against the same database; the
    results then carry a leading ``B``. ``di_levels > 0`` enables the DBoW2
    direct-index restriction on the match stage (pairs must share their
    vocabulary node at tree level ``di_levels``, counted from the root).

    The match + ICP stage runs only for the queries with a candidate past
    the entry floor (one host read of that flag per call); the other rows
    return zeros and identity ``T_qr``.

    Returns ``(cand [Cm], ok [Cm], n_matches [Cm], T_qr [Cm,4,4],
    icp_ok [Cm], inliers [Cm], inl_mask [Cm,P], fwd [Cm,P])``.
    """
    dev = desc_db.device
    single = not (torch.is_tensor(query_kf) and query_kf.dim() == 1)
    as_vec = lambda x, dt: torch.as_tensor(x, device=dev).to(dt).reshape(-1)  # noqa: E731
    q = as_vec(query_kf, torch.int64)
    lo = as_vec(lo, torch.int64)
    entry_floor = as_vec(entry_floor, torch.int32)
    B = q.shape[0]
    P = desc_db.shape[1]

    desc_q, p_q, valid_q = desc_db[q], p_db[q], valid_db[q]       # [B,P,...]
    v = _bow_vector_jit(centroids, child_valid, weights, desc_q,
                        valid_q.to(torch.float32), k)             # [B,W]
    s = 1.0 - 0.5 * torch.sum(torch.abs(vectors[None] - v[:, None, :]), dim=-1)
    Nv = vectors.shape[0]                 # BoW store capacity
    Nd = T_db.shape[0]                    # pool/pose store capacity
    idx = torch.arange(Nv, device=dev)
    # temporal exclusion + metric search radius (ref CTrackerSV.h:89); the
    # BoW vector store and the pool store grow independently, so the [Nd]
    # distance vector aligns to the [Nv] score vector by index
    centers = -torch.einsum("kji,kj->ki", T_db[:, :3, :3], T_db[:, :3, 3])
    d2 = torch.sum((centers[None] - centers[q][:, None]) ** 2, dim=-1)   # [B,Nd]
    if Nv <= Nd:
        d2v = d2[:, :Nv]
    else:
        d2v = torch.cat([d2, torch.full((B, Nv - Nd), float("inf"),
                                        dtype=d2.dtype, device=dev)], dim=1)
    s = torch.where((idx[None] < lo[:, None]) & (d2v <= radius_m2), s,
                    torch.full_like(s, -1.0))
    top_s, short = _top_k_stable(s, C)
    safe = torch.where(top_s > 0.0, short, torch.zeros_like(short))
    counts = _pool_nn_counts(desc_q, valid_q, desc_db[safe], valid_db[safe], cutoff)
    counts = torch.where(top_s > 0.0, counts, torch.zeros_like(counts))
    # top-Cm candidates by exact match count, gated by the entry floor
    top_c, sel = _top_k_stable(counts, Cm)
    cand = torch.gather(safe, 1, sel)                             # [B,Cm]
    ok = top_c >= entry_floor[:, None]

    n_m = torch.zeros((B, Cm), dtype=torch.int32, device=dev)
    T_qr = torch.eye(4, dtype=T_db.dtype, device=dev).repeat(B, Cm, 1, 1)
    icp_ok = torch.zeros((B, Cm), dtype=torch.bool, device=dev)
    inliers = torch.zeros((B, Cm), dtype=torch.int32, device=dev)
    inl = torch.zeros((B, Cm, P), dtype=torch.bool, device=dev)
    fwd = torch.zeros((B, Cm, P), dtype=torch.int32, device=dev)

    # the expensive match + ICP stage only runs for the queries with a
    # candidate past the entry gate (most keyframes have none)
    rows = torch.nonzero(ok.any(dim=1).cpu())[:, 0]               # the host read
    if len(rows):
        rows = rows.to(dev)
        R = rows.shape[0]
        cand_safe = torch.where(ok, cand, torch.zeros_like(cand))[rows]   # [R,Cm]
        T_init = T_db[q[rows]][:, None] @ se3.inv_T(T_db[cand_safe])
        rep = lambda t: (t[rows][:, None].expand((R, Cm) + t.shape[1:])  # noqa: E731
                         .reshape((R * Cm,) + t.shape[1:]))
        flat = lambda t: t.reshape((R * Cm,) + t.shape[2:])       # noqa: E731
        desc_c = desc_db[cand_safe]
        node_q = node_c = None
        if di_levels > 0:
            node_q = rep(_descend(centroids, child_valid, desc_q, k, levels=di_levels))
            node_c = flat(_descend(centroids, child_valid, desc_c, k, levels=di_levels))
        out = _match_and_align(
            rep(desc_q), rep(p_q), rep(valid_q), flat(desc_c),
            flat(p_db[cand_safe]), flat(valid_db[cand_safe]), flat(T_init),
            cutoff=cutoff,
            prob_q=None if prob_db is None else rep(prob_db[q]),
            prob_r=None if prob_db is None else flat(prob_db[cand_safe]),
            prob_cutoff=prob_cutoff, node_q=node_q, node_r=node_c,
            icp_inlier_m2=icp_inlier_m2, icp_min_inliers=icp_min_inliers,
            icp_max_avg_error=icp_max_avg_error)
        for dst, src in zip((n_m, T_qr, icp_ok, inliers, inl, fwd), out):
            dst[rows] = src.reshape((R, Cm) + src.shape[1:])
    result = (cand.to(torch.int32), ok, n_m, T_qr, icp_ok, inliers, inl, fwd)
    return tuple(x[0] for x in result) if single else result


def match_pools_many(
    query_kf: int,                # query pool index
    cand_idx: torch.Tensor,       # [C] database keyframe indices
    desc_db: torch.Tensor, p_db: torch.Tensor, valid_db: torch.Tensor,
    T_init: torch.Tensor,         # [C,4,4] ICP initializations
    cutoff: int = 25,
    icp_inlier_m2: float = 1.0,
    icp_min_inliers: int = 25,
    icp_max_avg_error: float = 0.9,
    prob_db: torch.Tensor | None = None,   # [K,P,256] u8 — enables prob matching
    prob_cutoff: float = 50.0,
):
    """Mutual matching + ICP validation of one query pool against C
    candidate pools at once (batched match_pools + ICP)."""
    dev = desc_db.device
    cand_idx = torch.as_tensor(cand_idx, device=dev).long()
    C = cand_idx.shape[0]
    rep = lambda t: t[int(query_kf)][None].expand((C,) + t.shape[1:])  # noqa: E731
    return _match_and_align(
        rep(desc_db), rep(p_db), rep(valid_db), desc_db[cand_idx],
        p_db[cand_idx], valid_db[cand_idx],
        torch.as_tensor(T_init, device=dev, dtype=p_db.dtype),
        cutoff=cutoff,
        prob_q=None if prob_db is None else rep(prob_db),
        prob_r=None if prob_db is None else prob_db[cand_idx],
        prob_cutoff=prob_cutoff, node_q=None, node_r=None,
        icp_inlier_m2=icp_inlier_m2, icp_min_inliers=icp_min_inliers,
        icp_max_avg_error=icp_max_avg_error)


# ---------------------------------------------------------------------------
# consensus: batched LoopClosureChecker
# ---------------------------------------------------------------------------

def consensus_matrix(
    M: torch.Tensor,          # [C,4,4] measured closure transforms T_q<-r
    T_i: torch.Tensor,        # [C,4,4] reference keyframe pose estimates (world->cam)
    T_j: torch.Tensor,        # [C,4,4] query keyframe pose estimates
    valid: torch.Tensor,      # [C]
) -> torch.Tensor:
    """[C, C] chi^2: error of candidate d under the rigid correction that
    makes candidate c exact (closure_checker.cpp:53-113: push the candidate's
    zero-error transform onto the movable set, re-evaluate all candidates)."""
    # correction that zeroes candidate c: D_c = M_c T_i_c inv(T_j_c)
    D = (M @ T_i) @ se3.inv_T(T_j)                                # [C,4,4]
    # candidate d error with all query poses moved rigidly by D_c
    Tj_corr = D[:, None] @ T_j[None, :]                           # [C,C,4,4]
    E = (Tj_corr @ se3.inv_T(T_i)[None, :]) @ se3.inv_T(M)[None, :]
    r = se3.log_se3(E)
    chi2 = torch.sum(r * r, dim=-1)                               # [C,C]
    return torch.where(valid[None, :] & valid[:, None], chi2,
                       torch.full_like(chi2, float("inf")))


def _log_se3_np(T: np.ndarray) -> np.ndarray:
    """Host float64 SE(3) log ``[..., 4, 4] -> [..., 6]`` (numpy). Exists so
    that the per-keyframe closure consensus — [C <= 16] rigid-transform
    algebra — runs without a device round trip."""
    T = np.asarray(T, np.float64)
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = np.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(cos_t)
    w = 0.5 * np.stack([R[..., 2, 1] - R[..., 1, 2],
                        R[..., 0, 2] - R[..., 2, 0],
                        R[..., 1, 0] - R[..., 0, 1]], -1)  # sin(t) * axis
    sin_t = np.sin(theta)
    small = theta < 1e-6
    near_pi = theta > np.pi - 1e-4
    safe_sin = np.where(small | near_pi, 1.0, sin_t)
    phi = (theta / safe_sin)[..., None] * w
    phi = np.where(small[..., None], w, phi)
    if near_pi.any():
        # axis from the symmetric part; sign from the antisymmetric part
        omc = np.where(near_pi, 1.0 - cos_t, 1.0)
        ax2 = np.clip((np.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]],
                                -1) - cos_t[..., None]) / omc[..., None],
                      0.0, None)
        ax = np.sqrt(ax2)
        ax *= np.where(w >= 0, 1.0, -1.0)
        n = np.linalg.norm(ax, axis=-1, keepdims=True)
        ax = ax / np.where(n > 0, n, 1.0)
        phi = np.where(near_pi[..., None], theta[..., None] * ax, phi)
    th2 = np.sum(phi * phi, -1)
    sm = th2 < 1e-12
    safe_t2 = np.where(sm, 1.0, th2)
    st = np.sqrt(safe_t2)
    A = np.where(sm, 1.0 - th2 / 6.0, np.sin(st) / st)
    B = np.where(sm, 0.5 - th2 / 24.0, (1.0 - np.cos(st)) / safe_t2)
    coef = np.where(sm, 1.0 / 12.0, (1.0 - A / (2.0 * B)) / safe_t2)
    Z = np.zeros_like(phi[..., 0])
    Phi = np.stack([
        np.stack([Z, -phi[..., 2], phi[..., 1]], -1),
        np.stack([phi[..., 2], Z, -phi[..., 0]], -1),
        np.stack([-phi[..., 1], phi[..., 0], Z], -1)], -2)
    Phi2 = Phi @ Phi
    eye = np.broadcast_to(np.eye(3), Phi.shape)
    V_inv = eye - 0.5 * Phi + coef[..., None, None] * Phi2
    rho = np.einsum("...ij,...j->...i", V_inv, t)
    return np.concatenate([rho, phi], -1)


def consensus_matrix_np(M: np.ndarray, T_i: np.ndarray,
                        T_j: np.ndarray) -> np.ndarray:
    """Host mirror of :func:`consensus_matrix` ([C, C] chi^2, float64)."""
    M = np.asarray(M, np.float64)
    T_i = np.asarray(T_i, np.float64)
    T_j = np.asarray(T_j, np.float64)
    inv = np.linalg.inv
    D = M @ T_i @ inv(T_j)                      # [C,4,4]
    Tj_corr = D[:, None] @ T_j[None, :]         # [C,C,4,4]
    E = Tj_corr @ inv(T_i)[None, :] @ inv(M)[None, :]
    r = _log_se3_np(E)
    return np.sum(r * r, axis=-1)               # [C,C]


def consensus_filter(chi2: torch.Tensor, valid: torch.Tensor, threshold: float = 0.25):
    """Keep the largest agreeing candidate set (ref LoopClosureChecker
    inlier counting, closure_checker.cpp:34-50; threshold Cg2oOptimizer.h:125).

    Returns (accept [C] bool, best_count).
    """
    inlier = chi2 < threshold                             # [C,C]
    counts = torch.sum(inlier, dim=1).to(torch.int32)     # consensus per anchor
    counts = torch.where(valid, counts, torch.zeros_like(counts))
    best = torch.argmax(counts)
    return inlier[best] & valid, counts[best]


# ---------------------------------------------------------------------------
# the full query pipeline (host-orchestrated, device-computed)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ClosureCandidate:
    query_kf: int
    ref_kf: int
    T_qr: np.ndarray      # measured relative transform (query <- ref frame)
    inliers: int
    matches: int
    # ICP-inlier correspondence slots (query_pool_slot, ref_pool_slot) —
    # the raw material for landmark-identity closure constraints
    # (ref EdgePointXYZ, Cg2oOptimizer.cpp:444-459)
    pairs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), np.int32))


def _decode_fused(query_kf: int, match_floor: int, max_candidates: int,
                  fused) -> list[ClosureCandidate]:
    """Host-side decode of one closure_query_fused result tuple (numpy) into
    validated ClosureCandidates (shared by the single-query and the
    chunk-batched paths)."""
    cand, okf, n_matches, T_qr, icp_ok, inliers, inl_mask, fwd = fused
    results: list[ClosureCandidate] = []
    seen: set[int] = set()
    for j in range(max_candidates):
        c = int(cand[j])
        if (not bool(okf[j]) or c in seen
                or int(n_matches[j]) < match_floor
                or not bool(icp_ok[j])):
            continue
        seen.add(c)
        slots_q = np.nonzero(inl_mask[j])[0].astype(np.int32)
        pairs = np.stack([slots_q, fwd[j][slots_q].astype(np.int32)], -1)
        results.append(ClosureCandidate(
            query_kf=query_kf, ref_kf=c, T_qr=T_qr[j],
            inliers=int(inliers[j]), matches=int(n_matches[j]),
            pairs=pairs,
        ))
    return results


def _fused_query(db: KeyframeDatabase, query_kf, lo, entry, *, C, Cm, cutoff,
                 use_prob, prob_cutoff, search_radius_m2, icp_kwargs,
                 direct_index_levels):
    kw = icp_kwargs or {}
    vocab = db.bow.vocab
    return closure_query_fused(
        vocab.centroids, vocab.child_valid, vocab.weights, db.bow.vectors,
        query_kf, db.desc, db.p_cam, db.valid, db.T_wc, lo,
        float(search_radius_m2), entry, vocab.k, C, Cm, cutoff,
        prob_db=db.prob if use_prob else None,
        prob_cutoff=prob_cutoff,
        icp_inlier_m2=kw.get("inlier_m2", 1.0),
        icp_min_inliers=kw.get("min_inliers", 25),
        icp_max_avg_error=kw.get("max_avg_error", 0.9),
        di_levels=direct_index_levels)


def find_closures_batch(
    db: KeyframeDatabase,
    query_kfs: list[int],
    *,
    min_matches: int = 25,
    min_relative: float = 0.5,
    hamming_cutoff: int = 25,
    exclude_recent: int = 20,
    max_candidates: int = 4,
    icp_kwargs: dict | None = None,
    probabilistic: bool = True,
    prob_cutoff: float = 50.0,
    search_radius_m2: float = 25.0,
    direct_index_levels: int = 0,
) -> list[list[ClosureCandidate]]:
    """All closure queries of one chunk's keyframes as ONE batched fused
    query and one read of its results.

    Batching rests on chunk-mates never being each other's closure
    references: the temporal exclusion (>= ``exclude_recent`` keyframes, ref
    CTrackerSV.h:84) must be at least the chunk's keyframe count. That is
    checked here: a longer batch, like a single query or a database with no
    trained vocabulary, falls back to sequential :func:`find_closures` calls
    in order. A database with a native index and a trained (given)
    vocabulary batches like any other: the BoW shortlist takes precedence
    over the tree, in :func:`find_closures` too.
    """
    use_prob = probabilistic and db.prob is not None
    if (db.bow is None or db.bow.n == 0 or len(query_kfs) <= 1
            or len(query_kfs) > exclude_recent):
        kw = dict(min_matches=min_matches, min_relative=min_relative,
                  hamming_cutoff=hamming_cutoff,
                  exclude_recent=exclude_recent,
                  max_candidates=max_candidates, icp_kwargs=icp_kwargs,
                  probabilistic=probabilistic, prob_cutoff=prob_cutoff,
                  search_radius_m2=search_radius_m2,
                  direct_index_levels=direct_index_levels)
        return [find_closures(db, q, **kw) for q in query_kfs]

    C = max(4 * max_candidates, 8)
    n_qs = [db.count_of(q) for q in query_kfs]
    floors = [max(min_matches, int(min_relative * n)) for n in n_qs]
    entries = [min_matches if use_prob else f for f in floors]
    los = [max(0, q - exclude_recent) for q in query_kfs]
    dev = db.device
    batched = fetch_numpy(_fused_query(
        db, torch.tensor(query_kfs, dtype=torch.int64, device=dev),
        torch.tensor(los, dtype=torch.int64, device=dev),
        torch.tensor(entries, dtype=torch.int32, device=dev),
        C=C, Cm=max_candidates, cutoff=hamming_cutoff, use_prob=use_prob,
        prob_cutoff=prob_cutoff, search_radius_m2=search_radius_m2,
        icp_kwargs=icp_kwargs, direct_index_levels=direct_index_levels))
    out: list[list[ClosureCandidate]] = []
    for b, q in enumerate(query_kfs):
        match_floor = floors[b] if use_prob else min_matches
        fused_b = tuple(x[b] for x in batched)
        out.append([] if q < 1 or n_qs[b] < min_matches
                   else _decode_fused(q, match_floor, max_candidates, fused_b))
    return out


def find_closures(
    db: KeyframeDatabase,
    query_kf: int,
    *,
    min_matches: int = 25,           # ref CTrackerGT.cpp:422 gate family
    min_relative: float = 0.5,       # ref :479
    hamming_cutoff: int = 25,
    exclude_recent: int = 10,
    max_candidates: int = 4,
    icp_kwargs: dict | None = None,
    probabilistic: bool = True,
    prob_cutoff: float = 50.0,       # ref CKeyFrame.h:13
    direct_index_levels: int = 0,    # ref DBOW2_ID_LEVELS (CTrackerGT.cpp:38)
    search_radius_m2: float = 25.0,  # ref m_dLoopClosingRadiusSquaredMetersL2
                                     # (CTrackerSV.h:89): candidates must lie
                                     # within this squared metric distance of
                                     # the query's CURRENT pose estimate —
                                     # the defense against perceptual
                                     # aliasing. inf = off.
) -> list[ClosureCandidate]:
    """Find validated loop closures of keyframe ``query_kf`` against all
    earlier keyframes (the _getLoopClosuresForKeyFrame pipeline,
    CTrackerGT.cpp:383-645).

    With ``probabilistic`` (and a DB that stores bit probabilities), the
    per-candidate matching stage uses expected-Hamming against the pooled
    bit-statistics under the probability cutoff (the CBPTree role,
    CBPTree.h:41-50): the exact-Hamming shortlist still places candidates,
    but only the absolute match floor gates them in — the relative gate
    (ref :479) moves to the noise-robust probabilistic match count.
    """
    if query_kf < 1:
        return []
    use_prob = probabilistic and db.prob is not None
    n_q = db.count_of(query_kf)          # host mirror — no device read
    if n_q < min_matches:
        return []

    floor = max(min_matches, int(min_relative * n_q))
    kw = icp_kwargs or {}
    if db.bow is not None and db.bow.n > 0:
        # the default path: the fused query, one read of its results
        C = max(4 * max_candidates, 8)
        lo_b = max(0, query_kf - exclude_recent)
        entry = min_matches if use_prob else floor
        fused = fetch_numpy(_fused_query(
            db, int(query_kf), lo_b, entry, C=C, Cm=max_candidates,
            cutoff=hamming_cutoff, use_prob=use_prob, prob_cutoff=prob_cutoff,
            search_radius_m2=search_radius_m2, icp_kwargs=icp_kwargs,
            direct_index_levels=direct_index_levels))
        match_floor = floor if use_prob else min_matches
        return _decode_fused(query_kf, match_floor, max_candidates, fused)
    scores = np.zeros(db.capacity, np.int32)
    if db.index is not None:
        # host-side tree shortlist (the native CBITree/DBoW2 analog): per
        # query descriptor, a vote for the keyframe of its best match in
        # the leaf it descends to. Votes are bounded to pre-exclusion
        # keyframes so that the query keyframe's own (already inserted)
        # descriptors cannot shadow the revisited one (the reference queries
        # before adding, CTrackerGT:411). The index may hold keyframes added
        # after this database was snapshotted; they lie past the bound.
        desc_q, valid_q = fetch_numpy((db.desc[query_kf], db.valid[query_kf]))
        votes = db.index.query(desc_q[valid_q], cutoff=hamming_cutoff,
                               max_keyframe=max(0, query_kf - exclude_recent))
        n_v = min(len(votes), len(scores))
        scores[:n_v] = votes[:n_v]
    else:
        # vocabulary-less database (the first keyframes, before the in-run
        # vocabulary has trained): exact pool scores against every stored
        # pool. Slots past ``n`` hold no valid descriptor and score 0.
        scores[: db.n] = score_pools(
            db.desc[query_kf], db.valid[query_kf], db.desc[: db.n],
            db.valid[: db.n], cutoff=hamming_cutoff).cpu().numpy()
    # only earlier, temporally non-adjacent keyframes are eligible
    lo = max(0, query_kf - exclude_recent)
    scores[lo:] = 0
    # metric search-radius gate (ref CTrackerSV.h:89, radius check
    # CTrackerSV.cpp:980): camera centers of candidate and query must be
    # within sqrt(search_radius_m2) under the CURRENT (post-correction)
    # pose estimates. Host mirror: no device round trip per query.
    T_wc_np = db.poses_host()
    if np.isfinite(search_radius_m2):
        R_all = T_wc_np[: query_kf + 1, :3, :3]
        t_all = T_wc_np[: query_kf + 1, :3, 3]
        centers = -np.einsum("kji,kj->ki", R_all, t_all)
        d2 = np.sum((centers[:-1] - centers[-1]) ** 2, axis=-1)
        scores[: query_kf][d2 > search_radius_m2] = 0
    # relative-match gate (ref :479) + absolute floor. In probabilistic
    # mode only the absolute floor applies here; the relative gate is
    # enforced on the probabilistic match count after the match stage.
    entry = min_matches if use_prob else floor
    cand_idx = np.argsort(scores)[::-1][:max_candidates]
    cand_idx = [int(c) for c in cand_idx if scores[c] >= entry]
    if not cand_idx:
        return []

    # batched match + ICP validation over a FIXED candidate width (padding
    # repeats candidate 0 and is dropped on the host)
    C = max_candidates
    n_cand = len(cand_idx)
    cand_pad = np.asarray(
        (cand_idx + [cand_idx[0]] * C)[:C], np.int32)
    T_init = (T_wc_np[query_kf][None]
              @ np.linalg.inv(T_wc_np[cand_pad].astype(np.float64))
              ).astype(np.float32)
    n_matches, T_qr, icp_ok, inliers, inl_mask, fwd = fetch_numpy(
        match_pools_many(
            query_kf, torch.from_numpy(cand_pad), db.desc, db.p_cam, db.valid,
            torch.from_numpy(T_init), cutoff=hamming_cutoff,
            icp_inlier_m2=kw.get("inlier_m2", 1.0),
            icp_min_inliers=kw.get("min_inliers", 25),
            icp_max_avg_error=kw.get("max_avg_error", 0.9),
            prob_db=db.prob if use_prob else None,
            prob_cutoff=prob_cutoff))

    match_floor = floor if use_prob else min_matches
    results = []
    for k in range(n_cand):
        c = int(cand_pad[k])
        if int(n_matches[k]) < match_floor or not bool(icp_ok[k]):
            continue
        # post-ICP inlier correspondences: the same inlier rule the
        # acceptance gates use (solvers.icp, ref CTrackerGT.cpp:524)
        slots_q = np.nonzero(inl_mask[k])[0].astype(np.int32)
        pairs = np.stack([slots_q, fwd[k][slots_q].astype(np.int32)], -1)
        results.append(
            ClosureCandidate(
                query_kf=query_kf,
                ref_kf=c,
                T_qr=T_qr[k],
                inliers=int(inliers[k]),
                matches=int(n_matches[k]),
                pairs=pairs,
            )
        )
    return results
