"""Fused Schur-complement assembly for bundle adjustment: kernels K4 and K5
and their plain versions.

One LM iteration of ``solvers.ba.bundle_adjust`` needs, from the poses, the
landmarks and the dense ``[K, L, 4]`` observation tensor,

  * ``S = H_pp - W Hll^-1 W^T``  (``[K,6,K,6]``, Levenberg damping of the
    pose blocks NOT included — the caller adds ``lam I``),
  * ``rhs = b_p - (W Hll^-1) b_l``  (``[K,6]``),
  * the damped per-landmark inverse ``Hll^-1`` (``[L,3,3]``), ``b_l``
    (``[L,3]``) and the coupling planes ``W`` (``[3, 6K, L]``, row
    ``6k + a``) for the back-substitution.

The materialised route (``solvers.ba``, ``use_schur_kernel=False``) writes
Jacobian tensors of hundreds of MB to get there. The kernels compute
residuals, robust weights and sqrt-weighted Jacobian rows per (keyframe,
landmark) in registers and write only the results.

:func:`schur_assemble` (K4, ``K <= 32``) and :func:`schur_assemble_tiled`
(K5, ``K % 32 == 0``) launch the hand-written CUDA kernels of
``csrc/schur_assemble.cu`` for CUDA tensors and take
:func:`schur_assemble_plain` / :func:`schur_assemble_tiled_plain` only for
CPU tensors. They replace the TPU kernels ``schur_assemble`` and
``schur_assemble_tiled`` of ``svi_mapper_tpu/ops/ba_kernel.py``. Not carried
over from there: the full ``[6K, 6K]`` products of which only the diagonal
blocks were read (the 21 + 6 numbers per keyframe are summed directly), the
128-lane padding, the 512-landmark block and the transposed input layouts.

Division of work on the card: both entry points launch the same three
kernels (assembly, product, reduction; :class:`SchurTiling` cuts the
window) and compute the whole function there: the product forms only the
upper triangle of 6x6 blocks of the symmetric ``W Hll^-1 W^T``, with
``rhs`` as one more column and ``C = W Hll^-1`` formed in shared memory.
It walks a schedule (:func:`schur_schedule`, plain PyTorch on the mask):
the live (pair of keyframe groups, slab of 16 landmarks) products, those
whose landmark tile both groups observe, cut into items that a persistent
grid shares out; every other product is exact zeros. How many are live
depends on the landmarks' order: a window ordered by each landmark's first
observing keyframe (:func:`landmark_order`, which ``solvers.ba`` applies
to a solve on the card) keeps a landmark tile's observers in a few groups.
The wrappers check, allocate, build the schedule where none is given,
launch and count. The TPU kernel of K5 left the product to XLA.

Bound on the card, where every keyframe observes every landmark: at
K = 32, L = 4096 2.6 MB in, 9.8 MB out (the W planes are 9.4 MB) = 3.7 us
of memory time against 0.55 GFLOP, 0.47 of it the upper block triangle of
the ``[192, 12288] x [12288, 192]`` product, = 8 us at the float32 rate; at
K = 128 7.6 GFLOP (7.3 the triangle) = 0.11 ms against 49 MB = 15 us. A
window whose keyframes see a part of the landmarks needs less: the product
only for the pairs of keyframes that observe a landmark (``chip_smoke.py``
counts those).

Numerics: float32 with another summation order than the materialised
route; the two agree to ~1e-4 relative, not bit-exactly. The kernels use no
atomics: partial sums are reduced in a fixed order, so the kernels equal
themselves from run to run.
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Mapping
from types import MappingProxyType

import numpy as np
import torch

from svi_mapper_tpu_torch.ops import cuda_build, paths

KT = 32                      # keyframes per tile (K5), and K4's ceiling
LANDMARK_TILE = 32           # landmarks per assembly block (one per lane)
_UPPER = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _accumulate_block(T, X, obs_uv, obs_w, fx, fy, cx, cy, bq, kernel_px2):
    """The per-(keyframe range, landmark) body both plain versions share (the
    counterpart of the device function both kernels share): for keyframes
    ``T [Kt,4,4]`` and all landmarks, residuals / robust weights /
    sqrt-weighted Jacobian rows, reduced to

      ``hl [9, L]``      partial ``H_ll`` upper triangle (00 01 02 11 12 22)
                         and ``b_l`` (rows 6-8), summed over these keyframes,
      ``H_pp [Kt,6,6]``, ``b_p [Kt,6]``  summed over landmarks,
      ``W [3, 6Kt, L]``  the coupling planes, row ``6k + a``.
    """
    Kt = T.shape[0]
    L = X.shape[0]
    R = T[:, :3, :3]
    pc = torch.einsum("kij,lj->kli", R, X) + T[:, None, :3, 3]
    xc, yc, zc = pc[..., 0], pc[..., 1], pc[..., 2]
    safe = torch.where(torch.abs(zc) < 1e-6, torch.full_like(zc, 1e-6), zc)
    iz = 1.0 / safe
    iz2 = iz * iz

    u_l = fx * xc * iz + cx
    v_l = fy * yc * iz + cy
    u_r = (fx * xc + bq) * iz + cx
    rs = torch.stack([u_l, v_l, u_r, v_l], dim=-1) - obs_uv          # [Kt,L,4]
    err2 = torch.sum(rs * rs, dim=-1)
    w = torch.where(err2 > kernel_px2,
                    kernel_px2 / torch.clamp(err2, min=1e-12),
                    torch.ones_like(err2))
    w = w * obs_w * (zc > 0.05).to(w.dtype)
    sw = torch.sqrt(w)

    zero = torch.zeros_like(xc)
    Ju = torch.stack([sw * fx * iz, zero, sw * -fx * xc * iz2], dim=-1)
    Jv = torch.stack([zero, sw * fy * iz, sw * -fy * yc * iz2], dim=-1)
    Jr = torch.stack([sw * fx * iz, zero, sw * -(fx * xc + bq) * iz2], dim=-1)
    Juv = torch.stack([Ju, Jv, Jr, Jv], dim=-2)                     # [Kt,L,4,3]
    rss = sw[..., None] * rs                                         # [Kt,L,4]

    # d pc / d xi (left-multiplied se3): [I | -hat(pc)]
    nhat = torch.stack([
        torch.stack([zero, zc, -yc], dim=-1),
        torch.stack([-zc, zero, xc], dim=-1),
        torch.stack([yc, -xc, zero], dim=-1),
    ], dim=-2)                                                       # [Kt,L,3,3]
    jps = torch.cat([Juv, Juv @ nhat], dim=-1)                       # [Kt,L,4,6]
    jls = torch.einsum("klri,kib->klrb", Juv, R)                     # [Kt,L,4,3]

    Hll = torch.einsum("klra,klrb->abl", jls, jls)                   # [3,3,L]
    bl = torch.einsum("klra,klr->al", jls, rss)                      # [3,L]
    hl = torch.cat([torch.stack([Hll[a, b] for a, b in _UPPER]), bl])
    W = torch.einsum("klrb,klra->bkal", jls, jps).reshape(3, 6 * Kt, L)
    H_pp = torch.einsum("klra,klrb->kab", jps, jps)
    b_p = torch.einsum("klra,klr->ka", jps, rss)
    return hl, H_pp, b_p, W


def _damped_inverse(h6, d):
    """Closed-form inverse of the damped symmetric 3x3 blocks: ``h6 [6, L]``
    (upper triangle 00 01 02 11 12 22) plus ``d`` on the diagonal ->
    ``[L,3,3]``, with the ``|det| < 1e-20`` guard. A landmark with no
    observation gives ``1 / d`` on the diagonal: large but finite."""
    a00 = h6[0] + d
    a01 = h6[1]
    a02 = h6[2]
    a11 = h6[3] + d
    a12 = h6[4]
    a22 = h6[5] + d
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    idet = 1.0 / torch.where(torch.abs(det) < 1e-20,
                             torch.full_like(det, 1e-20), det)
    return torch.stack([
        torch.stack([c00 * idet, c01 * idet, c02 * idet], dim=-1),
        torch.stack([c01 * idet, c11 * idet, c12 * idet], dim=-1),
        torch.stack([c02 * idet, c12 * idet, c22 * idet], dim=-1),
    ], dim=-2)


def _c_planes(W, Hll_inv):
    """``C = W Hll^-1`` as planes ``[3, 6K, L]``."""
    return torch.einsum("bql,lbc->cql", W, Hll_inv)


def _rhs(b_p, C, b_l):
    K = b_p.shape[0]
    return b_p - torch.einsum("cql,lc->q", C, b_l).reshape(K, 6)


def _schur_from_planes(H_pp, C, W):
    """``S = diag(H_pp) - W Hll^-1 W^T`` with the product as one matmul."""
    K = H_pp.shape[0]
    K6 = 6 * K
    WW = C.permute(1, 0, 2).reshape(K6, -1) @ W.permute(1, 0, 2).reshape(K6, -1).T
    S = (-WW).reshape(K, 6, K, 6)
    kk = torch.arange(K, device=S.device)
    S[kk, :, kk, :] += H_pp
    return S


def _damping(lam, point_damping, like):
    """``lam + point_damping`` in the working type; a Python ``lam`` stays on
    the host (no copy to the device)."""
    if isinstance(lam, torch.Tensor):
        return lam.to(device=like.device, dtype=like.dtype) + point_damping
    if like.dtype == torch.float32:
        return float(np.float32(lam) + np.float32(point_damping))
    return float(lam) + point_damping


def schur_assemble_plain(T_wc, points_w, obs_uv, obs_w, lam, *,
                         fx, fy, cx, cy, bq, kernel_px2=10.0,
                         point_damping=1e-6):
    """Plain PyTorch version of :func:`schur_assemble` (any K, any float
    dtype). Same return contract."""
    hl, H_pp, b_p, W = _accumulate_block(
        T_wc, points_w, obs_uv, obs_w, fx, fy, cx, cy, bq, kernel_px2)
    Hll_inv = _damped_inverse(hl[:6], _damping(lam, point_damping, hl))
    b_l = hl[6:9].T.contiguous()
    C = _c_planes(W, Hll_inv)
    return _schur_from_planes(H_pp, C, W), _rhs(b_p, C, b_l), Hll_inv, b_l, W


def _check_tiled(K: int) -> None:
    if K % KT != 0:
        raise ValueError(f"tiled Schur assembly needs K % {KT} == 0, got {K}")


def _finish_tiled(hl_part, H_pp, b_p, W, lam, point_damping):
    """What the tiled route leaves to PyTorch: the sum of the per-tile
    partial ``H_ll``/``b_l``, the 3x3 inverse, the coupling product, ``rhs``."""
    hs = torch.sum(hl_part, dim=0)                                  # [9, L]
    Hll_inv = _damped_inverse(hs[:6], _damping(lam, point_damping, hs))
    b_l = hs[6:9].T.contiguous()
    C = _c_planes(W, Hll_inv)
    return _schur_from_planes(H_pp, C, W), _rhs(b_p, C, b_l), Hll_inv, b_l, W


def schur_assemble_tiled_plain(T_wc, points_w, obs_uv, obs_w, lam, *,
                               fx, fy, cx, cy, bq, kernel_px2=10.0,
                               point_damping=1e-6):
    """Plain PyTorch version of :func:`schur_assemble_tiled`: goes through
    the per-tile partial sums of 32 keyframes, as the kernel does."""
    K = T_wc.shape[0]
    _check_tiled(K)
    parts = [_accumulate_block(
        T_wc[k0:k0 + KT], points_w, obs_uv[k0:k0 + KT], obs_w[k0:k0 + KT],
        fx, fy, cx, cy, bq, kernel_px2) for k0 in range(0, K, KT)]
    hl_part = torch.stack([p[0] for p in parts])                    # [nk, 9, L]
    H_pp = torch.cat([p[1] for p in parts])
    b_p = torch.cat([p[2] for p in parts])
    W = torch.cat([p[3] for p in parts], dim=1)
    return _finish_tiled(hl_part, H_pp, b_p, W, lam, point_damping)


# How far a kernel's output may be from its plain version's: relative to the
# largest entry of the plain version's output; rhs cancels, so it is held
# against 100 x max|b_l|. The largest entries of Hll_inv are the unobserved
# landmarks' 1 / damping, a thousand times an observed landmark's, so
# Hll_inv is held per landmark as well, each 3x3 block against its own
# largest entry: 5e-3, because the cofactors cancel (float32 alone is up to
# 8e-4 from float64 on a weakly observed landmark); a wrong block is off by
# its own size.
SCHUR_NAMES = ("S", "rhs", "Hll_inv", "b_l", "W")
SCHUR_TOL = MappingProxyType(dict(S=2e-4, rhs=5e-3, Hll_inv=2e-4, b_l=2e-4, W=2e-4,
                                  Hll_inv_block=5e-3))


def schur_errors(got, want) -> dict:
    """Per output of :func:`schur_assemble`: max |got - want| over the scale
    its entry of :data:`SCHUR_TOL` names."""
    scale_rhs = float(torch.max(torch.abs(want[3]))) * 100
    out = {}
    for nm, a, b in zip(SCHUR_NAMES, got, want):
        scale = scale_rhs if nm == "rhs" else max(float(torch.max(torch.abs(b))), 1e-9)
        out[nm] = float(torch.max(torch.abs(a.double() - b.double()))) / scale
    block_scale = want[2].double().abs().amax((1, 2)).clamp(min=1e-30)
    out["Hll_inv_block"] = float(torch.max(
        (got[2].double() - want[2].double()).abs().amax((1, 2)) / block_scale))
    return out


# ---------------------------------------------------------------------------
# the tiling of the CUDA kernels, the product's schedule, the landmark order
# ---------------------------------------------------------------------------

ASSEMBLY_WARPS = 4           # warps of an assembly block, one keyframe each
PRODUCT_SLAB = 16            # landmarks a product block stages at a time
ITEMS_PER_SLOT = 2           # the schedule's item slots per block the card
                             # holds at once
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class SchurTiling:
    """How ``csrc/schur_assemble.cu`` cuts a ``[K, L]`` window; the kernels
    take ``ks``, ``g``, :attr:`max_items` and :attr:`product_blocks` from
    here and mirror the rest.

    * assembly: blocks of ``LANDMARK_TILE`` landmarks x ``ks`` keyframes
      (grid ``nlt x nks``);
    * product: keyframe groups of ``g``; its products are (tile of the upper
      triangle of groups, ``I <= J``) x (slab of ``PRODUCT_SLAB``
      landmarks). A schedule (:func:`schur_schedule`) lists the live ones
      and cuts each tile's into items; a persistent grid of
      :attr:`product_blocks` blocks (``slots`` fit on the card at once)
      takes item ``n`` in block ``n % product_blocks`` and writes its
      partial into slot ``n``;
    * reduction: one thread per entry of the upper block triangle and of
      ``rhs``, adding its tile's items in item order.
    """

    K: int
    L: int
    g: int
    ks: int
    slots: int

    @property
    def nlt(self) -> int:
        return -(-self.L // LANDMARK_TILE)

    @property
    def nks(self) -> int:
        return -(-self.K // self.ks)

    @property
    def n_slabs(self) -> int:
        return -(-self.L // PRODUCT_SLAB)

    @property
    def n_groups(self) -> int:
        return -(-self.K // self.g)

    @property
    def n_tiles(self) -> int:
        return self.n_groups * (self.n_groups + 1) // 2

    @property
    def pairs(self) -> int:
        return self.K * (self.K + 1) // 2

    @property
    def max_items(self) -> int:
        """The items a schedule may cut: ``ITEMS_PER_SLOT`` a slot, or one a
        product where there are fewer products, and one a tile at least."""
        return max(min(ITEMS_PER_SLOT * self.slots, self.n_tiles * self.n_slabs),
                   self.n_tiles)

    @property
    def product_blocks(self) -> int:
        return min(self.slots, self.max_items)

    def tiles(self) -> list[tuple[int, int]]:
        """The product's tiles ``(I, J)``, in the order of their index."""
        n = self.n_groups
        return [(i, j) for i in range(n) for j in range(i, n)]

    def blocks(self, tile: tuple[int, int]) -> list[tuple[int, int]]:
        """The 6x6 blocks ``(i, j)`` a tile forms: ``i <= j < K``."""
        I, J = tile
        return [(i, j)
                for i in range(I * self.g, min(self.K, (I + 1) * self.g))
                for j in range(J * self.g, min(self.K, (J + 1) * self.g))
                if I < J or i <= j]

    @functools.cache
    def layout(self) -> Mapping[str, tuple[int, int]]:
        """Offset and length, in 4-byte words, of every region of the one
        buffer a call allocates besides ``W``: the outputs ``S``, ``rhs``,
        ``Hll_inv``, ``b_l`` and the scratch (every region 16-byte aligned).
        An item's partial holds its tile's ``g x g``
        blocks and ``g`` rows of the rhs column."""
        K, L = self.K, self.L
        sizes = [("part", self.max_items * 36 * self.g * self.g),
                 ("rhs_part", self.max_items * 6 * self.g),
                 ("hrec", 12 * L), ("pp_part", self.nlt * K * 27),
                 ("hl_part", self.nks * 9 * L),
                 ("S", 36 * K * K), ("rhs", 6 * K), ("Hll_inv", 9 * L), ("b_l", 3 * L)]
        out, at = {}, 0
        for name, n in sizes:
            out[name] = (at, n)
            at += -(-n // 4) * 4
        out["total"] = (0, at)
        return MappingProxyType(out)

    @functools.cache
    def schedule_layout(self) -> Mapping[str, tuple[int, int]]:
        """Offset and length, in int32 words, of every region of a
        schedule's table (:class:`SchurSchedule`), in the kernels' order."""
        sizes = [("tile_items", self.n_tiles + 1), ("item_tile", self.max_items),
                 ("item_first", self.max_items), ("item_count", self.max_items),
                 ("slabs", self.n_tiles * self.n_slabs), ("live", 1)]
        out, at = {}, 0
        for name, n in sizes:
            out[name] = (at, n)
            at += n
        out["total"] = (0, at)
        return MappingProxyType(out)


@functools.lru_cache(maxsize=256)
def schur_tiling(K: int, L: int, sms: int = H100_SMS) -> SchurTiling:
    """The tiling of a ``[K, L]`` window on a card of ``sms`` SMs.

    Groups of 8 keyframes up to K = 8, of 16 beyond (the two instances of
    the product kernel: 64 threads, four blocks per SM; 256 threads, two:
    its ``slots``). The assembly splits the keyframe axis, in splits of at
    least two keyframes per warp, until the grid has about eight blocks of
    four warps per SM, so that the W planes' stores have warps enough in
    flight.
    """
    if K < 1 or L < 1:
        raise ValueError(f"an empty window: K = {K}, L = {L}")
    g = 8 if K <= 8 else 16
    nlt = -(-L // LANDMARK_TILE)
    nks = min(-(-K // (2 * ASSEMBLY_WARPS)), max(1, -(-8 * sms // nlt)))
    ks = -(-(-(-K // nks)) // ASSEMBLY_WARPS) * ASSEMBLY_WARPS
    return SchurTiling(K=K, L=L, g=g, ks=ks, slots=sms * (4 if g == 8 else 2))


@dataclasses.dataclass(frozen=True)
class SchurSchedule:
    """The product's work for one mask. ``table`` (int32, on the mask's
    device) holds the regions of :meth:`SchurTiling.schedule_layout`:

    * ``slabs``: the live slabs of every tile, tile by tile, in slab order
      (then the others, which no item reaches);
    * ``tile_items [n_tiles + 1]``: each tile's first item, and the number
      of items;
    * ``item_tile``, ``item_first``, ``item_count``: each item's tile, its
      first entry of ``slabs`` and its number of slabs (0 past the last);
    * ``live``: the number of live products.
    """

    tiling: SchurTiling
    table: torch.Tensor

    def region(self, name: str) -> torch.Tensor:
        at, n = self.tiling.schedule_layout()[name]
        return self.table.narrow(0, at, n)

    @property
    def live(self) -> torch.Tensor:
        """Live (tile, slab) products, a 0-d tensor on the table's device."""
        return self.region("live")[0]


def schur_schedule(obs_w: torch.Tensor, sms: int | None = None) -> SchurSchedule:
    """The product's schedule for the ``[K, L]`` weights ``obs_w`` (any
    dtype; an entry other than 0 is an observation), made on their device
    without a host read.

    A (tile, slab) product is live where both keyframe groups of the tile
    observe the slab's landmark tile; the others multiply exact zeros (an
    observation's weight scales every W entry of it), and the product
    never visits them. Each tile's live slabs are cut into items of ``c``
    slabs (its last item fewer), ``c`` the largest of those that minimise
    the slabs a block of the persistent grid walks, items a block x ``c``
    (the largest: fewer partials to add), among those whose items fit
    ``max_items``. ``sms`` is the card's SM count; ``None`` reads it from a CUDA
    tensor's card and takes the H100's on the CPU. Every order here is
    fixed by the mask."""
    K, L = obs_w.shape
    dev = obs_w.device
    if sms is None:
        sms = _sm_count(dev.index) if dev.type == "cuda" else H100_SMS
    t = schur_tiling(K, L, sms)
    n_g, T = t.n_groups, t.n_tiles
    seen = torch.zeros((n_g * t.g, t.nlt * LANDMARK_TILE), dtype=torch.bool, device=dev)
    seen[:K, :L] = obs_w != 0
    groups = seen.view(n_g, t.g, t.nlt, LANDMARK_TILE).any(3).any(1)    # [n_g, nlt]
    I, J = torch.triu_indices(n_g, n_g, device=dev)                      # tile order
    live = (groups[I] & groups[J])[:, :, None].expand(
        T, t.nlt, LANDMARK_TILE // PRODUCT_SLAB).reshape(T, -1)[:, :t.n_slabs]  # [T, n_slabs]
    counts = live.sum(1)
    c = torch.arange(1, t.n_slabs + 1, device=dev)
    items = ((counts + c[:, None] - 1) // c[:, None]).sum(1)
    cost = torch.where(items <= t.max_items,
                       (items + t.product_blocks - 1) // t.product_blocks * c, 2**40)
    c = torch.where(cost == cost.min(), c, 0).amax()
    per_tile = (counts + c - 1) // c
    ends = torch.cumsum(per_tile, 0)
    n = torch.arange(t.max_items, device=dev)
    tile = torch.searchsorted(ends, n, right=True).clamp(max=T - 1)
    k = n - (ends - per_tile)[tile]                                      # item of its tile
    count = torch.where(n < ends[-1], torch.minimum(counts[tile] - k * c, c), 0)
    first = (torch.cumsum(counts, 0) - counts)[tile] + k * c
    slabs = torch.sort((~live).flatten().to(torch.uint8), stable=True).indices % t.n_slabs
    table = torch.cat([torch.zeros(1, dtype=ends.dtype, device=dev), ends, tile, first,
                       count, slabs, counts.sum().reshape(1)]).to(torch.int32)
    return SchurSchedule(tiling=t, table=table)


def landmark_order(obs_mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The landmark order the product's schedule wants for the ``[K, L]``
    mask: ``(perm, inv)``, ``x[perm]`` the landmarks sorted by their first
    observing keyframe (a stable sort: ties keep the caller's order; the
    landmarks nobody observes last), ``x[perm][inv] == x``. A window whose
    landmarks each keyframes of a short span observe, as a map segment's
    are, then has each landmark tile observed by one or two keyframe
    groups. On the mask's device, without a host read."""
    K, L = obs_mask.shape
    dev = obs_mask.device
    k = torch.arange(K, dtype=torch.int32, device=dev)
    first = torch.where(obs_mask != 0, k[:, None], K).amin(0)
    perm = torch.sort(first, stable=True).indices
    inv = torch.empty_like(perm).scatter_(0, perm, torch.arange(L, device=dev))
    return perm, inv


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------

schur_assemble_launches = 0
schur_assemble_tiled_launches = 0


_election_counters: dict[tuple[int, int], torch.Tensor] = {}


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _counters(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """The assembly's completion counters, one per landmark tile: zero
    between calls (the block a counter elects resets it), kept per device
    and stream. The launches on one stream run one after another, so no
    two calls share a counter at once."""
    key = (dev.index, stream)
    have = _election_counters.get(key)
    if have is None or have.numel() < n:
        have = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _election_counters[key] = have
    return have


def _cuda_inputs(T_wc, points_w, obs_uv, obs_w, name: str):
    """Check and lay out the kernels' inputs: float32 CUDA tensors of one
    device, contiguous, the observations 16-byte aligned."""
    K, L = obs_w.shape
    dev = T_wc.device
    tensors = dict(T_wc=T_wc, points_w=points_w, obs_uv=obs_uv, obs_w=obs_w)
    for nm, t in tensors.items():
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: {nm} must lie on {dev}, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {nm} must be float32, got {t.dtype}")
    if (T_wc.shape != (K, 4, 4) or points_w.shape != (L, 3)
            or obs_uv.shape != (K, L, 4) or K < 1 or L < 1):
        raise ValueError(
            f"{name}: shapes T_wc {tuple(T_wc.shape)}, points_w "
            f"{tuple(points_w.shape)}, obs_uv {tuple(obs_uv.shape)}, obs_w "
            f"{tuple(obs_w.shape)} do not form a [K, L] window")
    out = [t.contiguous() for t in (T_wc, points_w, obs_uv, obs_w)]
    if out[2].data_ptr() % 16:
        out[2] = out[2].clone()
    return out


def schur_out(K: int, L: int, dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The three kernels' output buffers for a ``[K, L]`` window on ``dev``:
    ``(buf, W)``, ``buf`` holding every region of
    :meth:`SchurTiling.layout`. A caller that passes them as ``out=`` to
    every call of one window keeps its outputs at fixed addresses."""
    lay = schur_tiling(K, L, _sm_count(dev.index)).layout()
    return (torch.empty(lay["total"][1], dtype=torch.float32, device=dev),
            torch.empty((3, 6 * K, L), dtype=torch.float32, device=dev))


def schur_views(out) -> tuple[torch.Tensor, ...]:
    """``(S, rhs, Hll_inv, b_l, W)``: the outputs inside ``out = (buf, W)``
    of :func:`schur_out`, as views."""
    buf, W = out
    K, L = W.shape[1] // 6, W.shape[2]
    lay = schur_tiling(K, L, _sm_count(W.device.index)).layout()
    view = lambda name, *shape: buf.narrow(0, lay[name][0], lay[name][1]).view(shape)  # noqa: E731
    return (view("S", K, 6, K, 6), view("rhs", K, 6), view("Hll_inv", L, 3, 3),
            view("b_l", L, 3), W)


def launch_schur_system(T, X, obs, ow, lam, cam_scalars, point_damping, *,
                        tiled: bool, out=None, schedule: SchurSchedule | None = None):
    """Launch the three kernels on checked, contiguous CUDA inputs into
    ``out`` (:func:`schur_out`'s buffers; allocated here when ``None``) and
    count the launch under K5 (``tiled``) or K4. ``schedule`` is the
    product's schedule of ``ow``'s mask (:func:`schur_schedule`), made here
    when ``None``: a caller that keeps one mask for many calls makes it
    once. Returns ``(S, rhs, Hll_inv, b_l, W)``, views of ``out``;
    ``cam_scalars`` is ``(fx, fy, cx, cy, bq, kernel_px2)``."""
    K, L = ow.shape
    dev = T.device
    sms = _sm_count(dev.index)
    tiling = schur_tiling(K, L, sms)
    buf, W = schur_out(K, L, dev) if out is None else out
    if (buf.shape != (tiling.layout()["total"][1],) or W.shape != (3, 6 * K, L)
            or any(t.device != dev or t.dtype != torch.float32 or not t.is_contiguous()
                   for t in (buf, W))):
        raise ValueError(f"out: buffers {tuple(buf.shape)}, {tuple(W.shape)} are not "
                         f"schur_out({K}, {L}) on {dev}")
    if schedule is None:
        schedule = schur_schedule(ow, sms)
    table = schedule.table
    if (schedule.tiling != tiling or table.device != dev or table.dtype != torch.int32
            or table.shape != (tiling.schedule_layout()["total"][1],)):
        raise ValueError(f"schedule: made for {schedule.tiling} on {table.device}, not "
                         f"for the {K} x {L} window on {dev}")
    base = buf.data_ptr()
    ptr = {name: base + 4 * at for name, (at, _) in tiling.layout().items()}
    damping = float(np.float32(float(lam)) + np.float32(point_damping))
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.svi_schur_system(
            T.data_ptr(), X.data_ptr(), obs.data_ptr(), ow.data_ptr(), ptr["S"],
            ptr["rhs"], ptr["Hll_inv"], ptr["b_l"], W.data_ptr(), ptr["pp_part"],
            ptr["hl_part"], ptr["hrec"], ptr["part"], ptr["rhs_part"],
            _counters(dev, stream, tiling.nlt).data_ptr(), table.data_ptr(), K, L,
            tiling.ks, tiling.g, tiling.max_items, tiling.product_blocks,
            *[float(v) for v in cam_scalars], damping, stream)
    cuda_build.check_launch(err, "svi_schur_system")
    work = lambda: (lambda c: (c["bytes"], c["flops"]))(paths.schur_work(ow, K, L))  # noqa: E731
    paths.count_launch(__name__, "schur_assemble_tiled" if tiled else "schur_assemble",
                       work=work)
    return schur_views((buf, W))


def _no_card_buffers_on_cpu(out, schedule) -> None:
    if out is not None or schedule is not None:
        raise ValueError("out= and schedule= take the kernels' buffers on the card; "
                         "the plain version allocates its outputs")


def schur_assemble(T_wc, points_w, obs_uv, obs_w, lam, *,
                   fx, fy, cx, cy, bq, kernel_px2=10.0, point_damping=1e-6,
                   out=None, schedule=None):
    """Fused Schur assembly for ``K <= 32`` keyframes. Returns
    ``(S [K,6,K,6], rhs [K,6], Hll_inv [L,3,3], b_l [L,3], W [3,6K,L])``.

    ``obs_w`` is the observation mask (times any information scale) as
    float; ``lam`` a Python float or a 0-d tensor. CUDA tensors go through
    the hand-written kernels (or raise), writing into ``out`` where given
    (:func:`schur_out`), with the product's ``schedule`` of ``obs_w``
    where given (:func:`schur_schedule`); only CPU tensors take
    :func:`schur_assemble_plain`. The outputs follow the caller's landmark
    order, whatever it is.
    """
    if not T_wc.is_cuda:
        _no_card_buffers_on_cpu(out, schedule)
        return schur_assemble_plain(
            T_wc, points_w, obs_uv, obs_w, lam, fx=fx, fy=fy, cx=cx, cy=cy,
            bq=bq, kernel_px2=kernel_px2, point_damping=point_damping)
    K = obs_w.shape[0]
    if K > KT:
        raise ValueError(f"schur_assemble takes K <= {KT} keyframes, got {K}")
    return launch_schur_system(
        *_cuda_inputs(T_wc, points_w, obs_uv, obs_w, "schur_assemble"), lam,
        (fx, fy, cx, cy, bq, kernel_px2), point_damping, tiled=False, out=out,
        schedule=schedule)


def schur_assemble_tiled(T_wc, points_w, obs_uv, obs_w, lam, *,
                         fx, fy, cx, cy, bq, kernel_px2=10.0,
                         point_damping=1e-6, out=None, schedule=None):
    """Fused Schur assembly for ``K % 32 == 0`` keyframes. Same
    return contract as :func:`schur_assemble`, and on the card the same
    kernels; its plain version goes through per-tile partial sums of 32
    keyframes, as the TPU kernel did."""
    _check_tiled(obs_w.shape[0])
    if not T_wc.is_cuda:
        _no_card_buffers_on_cpu(out, schedule)
        return schur_assemble_tiled_plain(
            T_wc, points_w, obs_uv, obs_w, lam, fx=fx, fy=fy, cx=cx, cy=cy,
            bq=bq, kernel_px2=kernel_px2, point_damping=point_damping)
    return launch_schur_system(
        *_cuda_inputs(T_wc, points_w, obs_uv, obs_w, "schur_assemble_tiled"), lam,
        (fx, fy, cx, cy, bq, kernel_px2), point_damping, tiled=True, out=out,
        schedule=schedule)
