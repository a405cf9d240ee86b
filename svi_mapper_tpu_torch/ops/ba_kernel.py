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
``rhs`` as one more column and ``C = W Hll^-1`` formed in shared memory;
landmark tiles that a keyframe group does not observe are skipped (their
terms are exact zeros). The wrappers check, allocate, launch and count;
they do no arithmetic. The TPU kernel of K5 left the product to XLA.

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


# ---------------------------------------------------------------------------
# the tiling of the CUDA kernels
# ---------------------------------------------------------------------------

ASSEMBLY_WARPS = 4           # warps of an assembly block, one keyframe each
PRODUCT_SLAB = 16            # landmarks a product block stages at a time
MAX_CHUNK_SLABS = 512        # slabs per product chunk (the kernel's list of
                             # live slabs)
MAX_CHUNKS = 128             # product chunks: the reduction adds an entry's
                             # partials one after another
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class SchurTiling:
    """How ``csrc/schur_assemble.cu`` cuts a ``[K, L]`` window; the kernels
    take ``ks``, ``sc`` and ``g`` from here and mirror the rest.

    * assembly: blocks of ``LANDMARK_TILE`` landmarks x ``ks`` keyframes
      (grid ``nlt x nks``);
    * product: keyframe groups of ``g``; one block per (tile of the upper
      triangle of groups, ``I <= J``) x (chunk of ``sc`` slabs of
      ``PRODUCT_SLAB`` landmarks);
    * reduction: one thread per entry of the upper block triangle and of
      ``rhs``.
    """

    K: int
    L: int
    g: int
    ks: int
    sc: int

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
    def nc(self) -> int:
        return -(-self.n_slabs // self.sc)

    @property
    def n_groups(self) -> int:
        return -(-self.K // self.g)

    @property
    def pairs(self) -> int:
        return self.K * (self.K + 1) // 2

    def tiles(self) -> list[tuple[int, int]]:
        """The product grid's tiles ``(I, J)``, in ``blockIdx.x`` order."""
        n = self.n_groups
        return [(i, j) for i in range(n) for j in range(i, n)]

    def blocks(self, tile: tuple[int, int]) -> list[tuple[int, int]]:
        """The 6x6 blocks ``(i, j)`` a tile forms: ``i <= j < K``."""
        I, J = tile
        return [(i, j)
                for i in range(I * self.g, min(self.K, (I + 1) * self.g))
                for j in range(J * self.g, min(self.K, (J + 1) * self.g))
                if I < J or i <= j]

    def chunks(self) -> list[tuple[int, int]]:
        """Landmark range ``[l0, l1)`` of each product chunk."""
        step = self.sc * PRODUCT_SLAB
        return [(l0, min(self.L, l0 + step)) for l0 in range(0, self.L, step)]

    def partial_floats(self) -> int:
        """The product's partials: per chunk, the upper block triangle and
        the rhs column."""
        return self.nc * (36 * self.pairs + 6 * self.K)

    @functools.cache
    def layout(self) -> Mapping[str, tuple[int, int]]:
        """Offset and length, in 4-byte words, of every region of the one
        buffer a call allocates besides ``W``: the outputs ``S``, ``rhs``,
        ``Hll_inv``, ``b_l`` and the scratch (every region 16-byte aligned,
        ``flags`` int32)."""
        K, L = self.K, self.L
        sizes = [("part", self.nc * 36 * self.pairs), ("rhs_part", self.nc * 6 * K),
                 ("hrec", 12 * L), ("pp_part", self.nlt * K * 27),
                 ("hl_part", self.nks * 9 * L), ("flags", self.nlt * K),
                 ("S", 36 * K * K), ("rhs", 6 * K), ("Hll_inv", 9 * L), ("b_l", 3 * L)]
        out, at = {}, 0
        for name, n in sizes:
            out[name] = (at, n)
            at += -(-n // 4) * 4
        out["total"] = (0, at)
        return MappingProxyType(out)


@functools.lru_cache(maxsize=256)
def schur_tiling(K: int, L: int, sms: int = H100_SMS) -> SchurTiling:
    """The tiling of a ``[K, L]`` window on a card of ``sms`` SMs.

    Groups of 8 keyframes up to K = 8, of 16 beyond (the two instances of
    the product kernel: 64 threads, four blocks per SM; 256 threads, two).
    The assembly splits the keyframe axis, in splits of at least two
    keyframes per warp, until the grid has about eight blocks of four warps
    per SM, so that the W planes' stores have warps enough in flight. The
    product's chunk is the number of slabs ``sc`` that minimises waves x
    slabs per block, or the largest within 10 % of that (fewer partials to
    add); there are at most ``MAX_CHUNKS`` chunks, and with more than one
    the partials may not exceed the W planes (one chunk's partial already
    does when L < K + 2).
    """
    if K < 1 or L < 1:
        raise ValueError(f"an empty window: K = {K}, L = {L}")
    g = 8 if K <= 8 else 16
    nlt = -(-L // LANDMARK_TILE)
    nks = min(-(-K // (2 * ASSEMBLY_WARPS)), max(1, -(-8 * sms // nlt)))
    ks = -(-(-(-K // nks)) // ASSEMBLY_WARPS) * ASSEMBLY_WARPS
    n = -(-K // g)
    tiles = n * (n + 1) // 2
    slots = sms * (4 if g == 8 else 2)
    per_chunk = 18 * K * (K + 1) + 6 * K
    n_slabs = -(-L // PRODUCT_SLAB)
    cost = {}
    for sc in range(1, min(n_slabs, MAX_CHUNK_SLABS) + 1):
        nc = -(-n_slabs // sc)
        if nc == 1 or (nc <= MAX_CHUNKS and nc * per_chunk <= 18 * K * L):
            cost[sc] = -(-tiles * nc // slots) * sc
    least = min(cost.values())
    sc = max(c for c, v in cost.items() if v <= 1.1 * least)
    return SchurTiling(K=K, L=L, g=g, ks=ks, sc=sc)


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


def launch_schur_system(T, X, obs, ow, lam, cam_scalars, point_damping, *,
                        tiled: bool):
    """Allocate and launch the three kernels on checked, contiguous CUDA
    inputs and count the launch under K5 (``tiled``) or K4. Returns
    ``(S, rhs, Hll_inv, b_l, W)``; ``cam_scalars`` is ``(fx, fy, cx, cy,
    bq, kernel_px2)``."""
    K, L = ow.shape
    dev = T.device
    tiling = schur_tiling(K, L, _sm_count(dev.index))
    lay = tiling.layout()
    W = torch.empty((3, 6 * K, L), dtype=torch.float32, device=dev)
    buf = torch.empty(lay["total"][1], dtype=torch.float32, device=dev)
    base = buf.data_ptr()
    ptr = {name: base + 4 * at for name, (at, _) in lay.items()}
    damping = float(np.float32(float(lam)) + np.float32(point_damping))
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.svi_schur_system(
            T.data_ptr(), X.data_ptr(), obs.data_ptr(), ow.data_ptr(), ptr["S"],
            ptr["rhs"], ptr["Hll_inv"], ptr["b_l"], W.data_ptr(), ptr["pp_part"],
            ptr["hl_part"], ptr["flags"], ptr["hrec"], ptr["part"], ptr["rhs_part"],
            _counters(dev, stream, tiling.nlt).data_ptr(), K, L,
            tiling.ks, tiling.sc, tiling.g, *[float(v) for v in cam_scalars],
            damping, stream)
    cuda_build.check_launch(err, "svi_schur_system")
    if tiled:
        paths.count_launch(__name__, "schur_assemble_tiled")
    else:
        paths.count_launch(__name__, "schur_assemble")
    view = lambda name, *shape: buf.narrow(0, lay[name][0], lay[name][1]).view(shape)  # noqa: E731
    return (view("S", K, 6, K, 6), view("rhs", K, 6), view("Hll_inv", L, 3, 3),
            view("b_l", L, 3), W)


def schur_assemble(T_wc, points_w, obs_uv, obs_w, lam, *,
                   fx, fy, cx, cy, bq, kernel_px2=10.0, point_damping=1e-6):
    """Fused Schur assembly for ``K <= 32`` keyframes. Returns
    ``(S [K,6,K,6], rhs [K,6], Hll_inv [L,3,3], b_l [L,3], W [3,6K,L])``.

    ``obs_w`` is the observation mask (times any information scale) as
    float; ``lam`` a Python float or a 0-d tensor. CUDA tensors go through
    the hand-written kernels (or raise); only CPU tensors take
    :func:`schur_assemble_plain`.
    """
    if not T_wc.is_cuda:
        return schur_assemble_plain(
            T_wc, points_w, obs_uv, obs_w, lam, fx=fx, fy=fy, cx=cx, cy=cy,
            bq=bq, kernel_px2=kernel_px2, point_damping=point_damping)
    K = obs_w.shape[0]
    if K > KT:
        raise ValueError(f"schur_assemble takes K <= {KT} keyframes, got {K}")
    return launch_schur_system(
        *_cuda_inputs(T_wc, points_w, obs_uv, obs_w, "schur_assemble"), lam,
        (fx, fy, cx, cy, bq, kernel_px2), point_damping, tiled=False)


def schur_assemble_tiled(T_wc, points_w, obs_uv, obs_w, lam, *,
                         fx, fy, cx, cy, bq, kernel_px2=10.0,
                         point_damping=1e-6):
    """Fused Schur assembly for ``K % 32 == 0`` keyframes. Same
    return contract as :func:`schur_assemble`, and on the card the same
    kernels; its plain version goes through per-tile partial sums of 32
    keyframes, as the TPU kernel did."""
    _check_tiled(obs_w.shape[0])
    if not T_wc.is_cuda:
        return schur_assemble_tiled_plain(
            T_wc, points_w, obs_uv, obs_w, lam, fx=fx, fy=fy, cx=cx, cy=cy,
            bq=bq, kernel_px2=kernel_px2, point_damping=point_damping)
    return launch_schur_system(
        *_cuda_inputs(T_wc, points_w, obs_uv, obs_w, "schur_assemble_tiled"), lam,
        (fx, fy, cx, cy, bq, kernel_px2), point_damping, tiled=True)
