"""Bundle adjustment: batched Schur-complement Levenberg-Marquardt.

Replacement for the full-graph stage of ``Cg2oOptimizer``
(Cg2oOptimizer.cpp:232-522: BlockSolverX + CHOLMOD + Levenberg over pose and
landmark vertices with Cauchy-robust stereo measurement edges, iterated
until <1 % chi^2 improvement, :954-980). The Schur trick keeps everything
block-dense and batched:

  * residuals/Jacobians for ALL (keyframe, landmark) observations at once
    from a dense ``[K, L, 4]`` observation tensor + mask;
  * the reduced camera system ``S = H_pp - W H_ll^-1 W^T`` is a small dense
    ``[6K, 6K]`` matrix solved by Cholesky;
  * Levenberg damping with accept/reject on chi^2, a fixed iteration cap and
    the reference's <1 % relative-improvement stop.

Gauge freedom is fixed by masking updates of designated poses
(``fix_mask``), the analog of g2o's setFixed (Cg2oOptimizer.cpp:342-360).

Three routes to the Schur system, each a class of buffer sets, of which
:func:`schur_route` picks one a solve: the materialised Jacobians
(:class:`_MaterialisedBuffers`, the CPU's default), the fused assembly of
``ops.ba_kernel`` (K4 / K5 on the card, :class:`_CardKernelBuffers`; their
plain versions elsewhere, :class:`_KernelBuffers`) and, for windows past
the kernels' largest, the observation-list route (:class:`_ObsBuffers`).

The LM loop is a Python loop. One iteration reads two flags (accept, done)
from the device in ONE transfer; the damping ``lam`` lives on the host as a
float32, so the kernels get it by value.

The loop's state and operands live in one set of buffers per window shape,
route and setting (the last :data:`LM_BUFFER_SETS` sets are kept, across
threads): a solve copies its inputs in and returns copies of its results.
Three stages of an iteration read and write nothing else: ``priors`` (the
pose chain and the gravity terms, added into ``S`` and ``rhs``),
``update`` (back-substitution and the pose update, into the proposal) and
``total_chi2`` (of the proposal); the card's kernel route adds
``order_landmarks``, once a solve. On a CUDA device each is captured once
per set as a CUDA graph and replayed from then on, so that the host issues
one launch for each where it issued tens to hundreds; on the CPU, under
the sharded BA's collective hook (``_landmark_sum``) and under a
``TorchDispatchMode`` (which a replay would bypass) the same functions run
directly. Two stages stay eager: the Schur assembly (K4 / K5 take ``lam``
by value) and the linear solve (cuSOLVER). :func:`graph_counts`,
:func:`obs_route_counts` and :func:`schur_schedule_counts` read one store
of counters.

Spans (``eval.timing.span``; nothing unless a profiler runs or a timer
records) mark the call's stages, all with the call's request id:
``svi.ba.solve`` the call; ``svi.ba.obs_list`` the observation-list
route's lists (once a solve); ``svi.ba.chi2`` each ``total_chi2``;
``svi.ba.iteration`` one LM iteration, holding in order ``svi.ba.assemble``
(the Schur system and its damping; on the observation-list route its
child ``svi.ba.pair_product`` sums ``S`` over the co-visible pairs),
``svi.ba.priors`` (the pose chain and
the gravity terms), ``svi.ba.linear_solve`` (gauge fixing and the
Cholesky), ``svi.ba.update`` (back-substitution and the pose update),
``svi.ba.chi2`` (the proposal's) and ``svi.ba.flag_read`` (the one host
read). A replayed stage runs inside its span.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from svi_mapper_tpu_torch.eval.timing import next_request, span
from svi_mapper_tpu_torch.geometry import se3
from svi_mapper_tpu_torch.geometry.camera import StereoCamera
from svi_mapper_tpu_torch.geometry.linalg import cholesky_solve_or_nan
from svi_mapper_tpu_torch.geometry.linalg import inv3x3 as _inv3x3
from svi_mapper_tpu_torch.ops import ba_kernel
from svi_mapper_tpu_torch.solvers.pose_graph import adjoint as _adjoint
from svi_mapper_tpu_torch.utils.device import require_fp32_matmul, resolve_device

# largest keyframe window the single-pass fused kernel
# (ops.ba_kernel.schur_assemble) takes, and the K-tiled kernel
# (schur_assemble_tiled, 32 keyframes per tile); see schur_route
SCHUR_KERNEL_MAX_K = 32
SCHUR_KERNEL_TILED_MAX_K = 128

# buffer sets kept, the least recently used dropped first
LM_BUFFER_SETS = 4


def schur_kernel_auto(K: int, dtype=torch.float32, device=None) -> bool:
    """The ``use_schur_kernel=None`` gate of :func:`bundle_adjust`: float32
    problems on a CUDA device whose window a kernel takes. By shape only."""
    device = torch.device("cuda" if device is None else device)
    return (device.type == "cuda" and dtype == torch.float32
            and (K <= SCHUR_KERNEL_MAX_K
                 or (K % 32 == 0 and K <= SCHUR_KERNEL_TILED_MAX_K)))


@dataclasses.dataclass(frozen=True)
class BAResult:
    T_wc: torch.Tensor        # [K,4,4] optimized poses
    points_w: torch.Tensor    # [L,3] optimized landmarks
    chi2_initial: torch.Tensor
    chi2_final: torch.Tensor
    iterations: torch.Tensor


def _project(p_c, obs_uv, fx, fy, cx, cy, bq):
    """The stereo residuals ``[u_l, v_l, u_r, v_l] - obs`` of camera-frame
    points ``p_c [..., 3]``."""
    x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / safe_z
    u_l = fx * x * iz + cx
    v_l = fy * y * iz + cy
    u_r = (fx * x + bq) * iz + cx
    pred = torch.stack([u_l, v_l, u_r, v_l], dim=-1)
    return pred - obs_uv


def _residuals(T_wc, X, obs_uv, fx, fy, cx, cy, bq):
    """r [K,L,4], p_cam [K,L,3] for all observation pairs."""
    p_c = torch.einsum("kij,lj->kli", T_wc[:, :3, :3], X) + T_wc[:, None, :3, 3]
    return _project(p_c, obs_uv, fx, fy, cx, cy, bq), p_c


def _jacobians(p_c, T_wc, fx, fy, bq):
    """J_pose [K,L,4,6] (left-mult se3 of T_k), J_point [K,L,4,3] (world X)."""
    J_uv = _uv_jacobian(p_c, fx, fy, bq)
    eye = torch.eye(3, dtype=p_c.dtype, device=p_c.device).expand(
        p_c.shape[:-1] + (3, 3))
    J_pc = torch.cat([eye, -se3.hat(p_c)], dim=-1)                # [K,L,3,6]
    J_pose = J_uv @ J_pc
    # d p_c / d X_world = R_k
    J_point = torch.einsum("klri,kij->klrj", J_uv, T_wc[:, :3, :3])
    return J_pose, J_point


def _uv_jacobian(p_c, fx, fy, bq):
    """d r / d p_c ``[..., 4, 3]`` at camera-frame points ``p_c [..., 3]``."""
    x, y, z = p_c[..., 0], p_c[..., 1], p_c[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    iz = 1.0 / safe_z
    iz2 = iz * iz
    zr = torch.zeros_like(x)
    J_ul = torch.stack([fx * iz, zr, -fx * x * iz2], dim=-1)
    J_vl = torch.stack([zr, fy * iz, -fy * y * iz2], dim=-1)
    J_ur = torch.stack([fx * iz, zr, -(fx * x + bq) * iz2], dim=-1)
    return torch.stack([J_ul, J_vl, J_ur, J_vl], dim=-2)          # [K,L,4,3]


def _chi2(r, w_mask):
    return torch.sum(w_mask * torch.sum(r * r, dim=-1))


def _intrinsics(cam: StereoCamera):
    return cam.left.fx, cam.left.fy, cam.left.cx, cam.left.cy, cam.right.p03


def _on(t, dev, dtype=None):
    return None if t is None else torch.as_tensor(t, device=dev, dtype=dtype)


# ---------------------------------------------------------------------------
# the LM loop's buffers and stages: a core every route shares, a subclass
# per route, and the counters
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_buffer_sets: collections.OrderedDict = collections.OrderedDict()
# every counter below by name (one not counted since its reset reads 0), and
# under "last_ordered" a weak reference to the last ordered solve's buffer set
_counts: collections.Counter = collections.Counter()


def _count(last_ordered=None, **adds: int) -> None:
    """Add ``adds`` to the named counters; ``last_ordered``, a buffer set,
    becomes the one :func:`schur_schedule_counts` reads."""
    with _lock:
        for name, n in adds.items():
            _counts[name] += n
        if last_ordered is not None:
            _counts["last_ordered"] = weakref.ref(last_ordered)


def _read(*names: str) -> dict[str, int]:
    with _lock:
        return {name: _counts[name] for name in names}


def _reset(*names: str) -> None:
    with _lock:
        for name in names:
            del _counts[name]


def graph_counts() -> dict[str, int]:
    """CUDA-graph captures (one per buffer set, its stages) and replays (one
    per stage run) of the LM loop since the last
    :func:`reset_graph_counts`, over every thread."""
    return _read("graph_capture", "graph_replay")


def reset_graph_counts() -> None:
    _reset("graph_capture", "graph_replay")


def obs_route_counts() -> dict[str, int]:
    """The observation-list route since the last
    :func:`reset_obs_route_counts`, over every thread: solves, the
    observations and co-visible pairs (one per landmark and pair of its
    keyframes, itself with itself included) they listed, and the buffer
    sets made for it."""
    return _read("solves", "observations", "pairs", "buffer_sets")


def reset_obs_route_counts() -> None:
    _reset("solves", "observations", "pairs", "buffer_sets")


def schur_schedule_counts() -> dict[str, int]:
    """The kernel route's landmark order since the last
    :func:`reset_schur_schedule_counts`, over every thread: the solves
    whose landmarks were ordered, each of which made its product's
    schedule, and the live and total (keyframe-group pair, slab) products
    of the last one's schedule (its live count read from the device here;
    0 and 0 once its buffer set is gone)."""
    with _lock:
        solves, ref = _counts["solves_ordered"], _counts.get("last_ordered")
    lm = None if ref is None else ref()
    schedule = None if lm is None else lm.schedule
    return dict(solves_ordered=solves,
                live_products=0 if schedule is None else int(schedule.live),
                total_products=(0 if schedule is None
                                else schedule.tiling.n_tiles * schedule.tiling.n_slabs))


def reset_schur_schedule_counts() -> None:
    _reset("solves_ordered", "last_ordered")


class _LMBuffers:
    """One window shape's LM state and operands at fixed addresses, and the
    stages of an iteration, which read and write only these: what every
    route shares. ``T`` / ``X`` / ``chi2`` hold the accepted state,
    ``T_new`` / ``X_new`` / ``chi2_new`` the proposal (the graphs' outputs
    once captured), ``dp`` the pose step. A route's subclass holds the
    observations and the Schur system (``S``, ``rhs``, ``Hll_inv``, ``b_l``,
    ``W``) and owns what touches them."""

    # the stages captured on the card, in the order a solve runs them
    STAGES = ("priors", "update", "total_chi2")

    def __init__(self, dev, dtype, K, L, intrinsics, kernel_px2, use_odo, use_grav):
        z = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)  # noqa: E731
        self.dev, self.K, self.L = dev, K, L
        self.intrinsics, self.kernel_px2 = intrinsics, kernel_px2
        self.use_odo, self.use_grav = use_odo, use_grav
        self.T, self.T_new = z(K, 4, 4), z(K, 4, 4)
        self.X, self.X_new = z(L, 3), z(L, 3)
        self.chi2, self.chi2_new = z(), z()
        self.free, self.dp = z(K), z(K, 6)
        self.odo_Minv, self.wo = z(max(K - 1, 0), 4, 4), z(max(K - 1, 0))
        self.grav_d, self.grav_w = z(K, 3), z(K)
        self.kk = torch.arange(K, device=dev)
        self.eye6 = torch.eye(6, dtype=dtype, device=dev)
        self.landmark_sum = None
        self.request = None                           # the solve's, for its spans
        self.graphs: dict[str, torch.cuda.CUDAGraph] = {}

    # -- a solve's set, its inputs and the accepted state ---------------------
    @classmethod
    def take(cls, key, obs_mask, request, *args) -> tuple[_LMBuffers, object]:
        """The buffer set of ``key`` (a new one is ``cls(*args)``) and what
        a solve of ``obs_mask`` passes to ``load``: nothing here."""
        return _buffers(key, lambda _: cls(*args)), None

    def load(self, T_wc, points_w, obs_uv, obs_mask, obs_w, fix_mask, odo_Minv, wo, grav_d,
             grav_w, prepared) -> None:
        """Copy a solve's inputs in; the start is the proposal to score."""
        points_w = self._load_observations(points_w, obs_uv, obs_mask, obs_w, prepared)
        self.T_new.copy_(T_wc)
        self.X_new.copy_(points_w)
        self.free.copy_(~fix_mask)
        if self.use_odo:
            self.odo_Minv.copy_(odo_Minv)
            self.wo.copy_(wo)
        if self.use_grav:
            self.grav_d.copy_(grav_d)
            self.grav_w.copy_(grav_w)

    def accept(self) -> None:
        self.T.copy_(self.T_new)
        self.X.copy_(self.X_new)
        self.chi2.copy_(self.chi2_new)

    def points(self) -> torch.Tensor:
        """A copy of the accepted landmarks, in the caller's order."""
        return self.X.clone()

    def _keep(self, *system) -> None:
        """``(S, rhs, H_ll_inv, b_l, W)`` into the set's buffers."""
        for dst, src in zip((self.S, self.rhs, self.Hll_inv, self.b_l, self.W), system):
            dst.copy_(src)

    # -- the terms ------------------------------------------------------------
    def robust_w(self, r):
        err2 = torch.sum(r * r, dim=-1)
        w = torch.where(err2 > self.kernel_px2,
                        self.kernel_px2 / torch.clamp(err2, min=1e-12),
                        torch.ones_like(err2))
        return w * self.maskf

    # pose-pose odometry chain (ref EdgeSE3 full-graph edges,
    # Cg2oOptimizer.cpp:1258-1266): keeps weakly-observed keyframes anchored
    # to the trajectory while reprojection terms refine
    def odo_residuals(self, T):
        Dk = T[1:] @ se3.inv_T(T[:-1])
        return Dk, se3.log_se3(Dk @ self.odo_Minv)                    # [K-1,6]

    def odo_chi2(self, T):
        if not self.use_odo:
            return torch.zeros((), dtype=T.dtype, device=T.device)
        _, r_o = self.odo_residuals(T)
        return torch.sum(self.wo * torch.sum(r_o * r_o, dim=-1))

    # gravity-direction unary (ref error = R_n2w a_hat - (0,0,-1),
    # edge_se3_linear_acceleration.cpp:106-116; the world down here is
    # (0,-1,0)): residual r_g = R_wc g_down - d_measured,
    # J = [0 | -hat(R g_down)] under the left-multiplicative update
    def grav_residuals(self, T):
        Rg = -T[:, :3, 1]                     # R_wc @ (0,-1,0)
        return Rg, Rg - self.grav_d           # [K,3], [K,3]

    def grav_chi2(self, T):
        if not self.use_grav:
            return torch.zeros((), dtype=T.dtype, device=T.device)
        _, r_g = self.grav_residuals(T)
        return torch.sum(self.grav_w * torch.sum(r_g * r_g, dim=-1))

    # -- the stages -------------------------------------------------------------
    def priors(self) -> None:
        """The pose chain's and the gravity unaries' terms of the accepted
        state, added into ``S`` and ``rhs``."""
        T, S, rhs, kk, eye6 = self.T, self.S, self.rhs, self.kk, self.eye6
        if self.use_odo:
            # J_{k+1} = I, J_k = -Adj(D_k) (left-multiplicative updates)
            K, wo = self.K, self.wo
            Dk, r_o = self.odo_residuals(T)
            Adj = _adjoint(Dk)                                    # [K-1,6,6]
            AdjT = Adj.transpose(1, 2)
            ks = kk[: K - 1]
            wk = wo[:, None, None]
            S[ks + 1, :, ks + 1, :] += wk * eye6
            S[ks, :, ks, :] += wk * (AdjT @ Adj)
            S[ks, :, ks + 1, :] += -wk * AdjT
            S[ks + 1, :, ks, :] += -wk * Adj
            # ks and ks + 1 hold no index twice: the in-place adds are exact
            rhs[ks + 1] += wo[:, None] * r_o
            rhs[ks] += -wo[:, None] * torch.einsum("kji,kj->ki", Adj, r_o)

        if self.use_grav:
            grav_w = self.grav_w
            Rg, r_g = self.grav_residuals(T)
            Ag = -se3.hat(Rg)                                     # [K,3,3] = J_phi
            S[kk, 3:, kk, 3:] += grav_w[:, None, None] * (Ag.transpose(1, 2) @ Ag)
            rhs[:, 3:] += grav_w[:, None] * torch.einsum("kji,kj->ki", Ag, r_g)

    def linear_solve(self) -> None:
        """Gauge fixing and the Cholesky solve, into ``dp`` (eager)."""
        K, kk, free = self.K, self.kk, self.free
        # gauge fixing: zero out rows/cols of fixed poses, identity diagonal
        Sm = self.S * free[:, None, None, None] * free[None, None, :, None]
        Sm[kk, :, kk, :] += (1.0 - free)[:, None, None] * self.eye6
        rhs = self.rhs * free[:, None]
        dp = -cholesky_solve_or_nan(Sm.reshape(K * 6, K * 6), rhs.reshape(K * 6))
        torch.mul(dp.reshape(K, 6), free[:, None], out=self.dp)

    def total_chi2(self) -> None:
        """The proposal's chi^2, into ``chi2_new``."""
        T, X = self.T_new, self.X_new
        r = self.residuals(T, X)
        chi2_l = _chi2(r, self.robust_w(r))
        if self.landmark_sum is not None:
            (chi2_l,) = self.landmark_sum(chi2_l)
        self.chi2_new = chi2_l + self.odo_chi2(T) + self.grav_chi2(T)

    # -- direct or replayed ------------------------------------------------------
    def capture(self) -> None:
        """Capture the stages as CUDA graphs that share one memory pool,
        after one warm-up run of each on the capturing stream. Their
        outputs (``T_new``, ``X_new``, ``chi2_new``) are the graphs' from
        then on. ``thread_local``: another thread's launches cannot break
        the capture."""
        stream = torch.cuda.Stream(self.dev)
        stream.wait_stream(torch.cuda.current_stream(self.dev))
        pool = torch.cuda.graph_pool_handle()
        graphs = {}
        # a window without the pose chain and the gravity terms has no
        # priors: an empty graph, run directly instead (it does nothing)
        stages = [s for s in self.STAGES if s != "priors" or self.use_odo or self.use_grav]
        with torch.cuda.device(self.dev), torch.cuda.stream(stream):
            for stage in stages:
                getattr(self, stage)()
            for stage in stages:
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    getattr(self, stage)()
                finally:
                    graph.capture_end()
                graphs[stage] = graph
        torch.cuda.current_stream(self.dev).wait_stream(stream)
        self.graphs = graphs
        _count(graph_capture=1)

    def run(self, stage: str) -> None:
        graph = self.graphs.get(stage)
        if graph is None:
            getattr(self, stage)()
        else:
            graph.replay()
            _count(graph_replay=1)


class _MaterialisedBuffers(_LMBuffers):
    """The materialised route: the observations as ``obs_uv [K, L, 4]`` and
    ``maskf [K, L]``, the residuals and Jacobians of every pair
    materialised, ``W`` the ``B [6K, 3L]`` of the Schur complement."""

    def __init__(self, dev, dtype, K, L, *settings):
        super().__init__(dev, dtype, K, L, *settings)
        z = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)  # noqa: E731
        self.obs_uv, self.maskf = z(K, L, 4), z(K, L)
        self.S, self.rhs, self.Hll_inv, self.b_l, self.W = self._schur_system(z)

    def _schur_system(self, z):
        K, L = self.K, self.L
        return z(K, 6, K, 6), z(K, 6), z(L, 3, 3), z(L, 3), z(6 * K, 3 * L)

    @staticmethod
    def path(K: int) -> str:
        """The route's name in ``ops.paths.kernel_paths``."""
        return "torch:materialised"

    def _load_observations(self, points_w, obs_uv, obs_mask, obs_w, prepared):
        """A solve's observations in; its landmarks in the set's order out."""
        self.maskf.copy_(obs_mask)
        if obs_w is not None:
            self.maskf.mul_(obs_w)
        self.obs_uv.copy_(obs_uv)
        return points_w

    def residuals(self, T, X):
        return _residuals(T, X, self.obs_uv, *self.intrinsics)[0]

    def assemble(self, lam: float, point_damping: float) -> None:
        """The damped Schur system of the accepted state, into ``S``,
        ``rhs``, ``Hll_inv``, ``b_l`` and ``W`` (eager)."""
        T, X, K, L = self.T, self.X, self.K, self.L
        fx, fy, cx, cy, bq = self.intrinsics
        dtype = X.dtype
        r, p_c = _residuals(T, X, self.obs_uv, fx, fy, cx, cy, bq)
        w = self.robust_w(r)                                     # [K,L]
        # in-front mask (behind-camera obs excluded)
        w = w * (p_c[..., 2] > 0.05).to(dtype)
        J_pose, J_point = _jacobians(p_c, T, fx, fy, bq)

        Jpw4 = J_pose * w[..., None, None]                       # [K,L,4,6]
        Jp = J_pose.reshape(K, L * 4, 6)
        Jpw = Jpw4.reshape(K, L * 4, 6)
        Jl = J_point.permute(1, 0, 2, 3).reshape(L, K * 4, 3)
        Jlw = (J_point * w[..., None, None]).permute(1, 0, 2, 3).reshape(L, K * 4, 3)
        rk = r.reshape(K, L * 4, 1)
        rl = r.permute(1, 0, 2).reshape(L, K * 4, 1)

        H_pp = Jpw.transpose(1, 2) @ Jp                          # [K,6,6]
        H_ll = Jlw.transpose(1, 2) @ Jl                          # [L,3,3]
        H_pl = Jpw4.transpose(-1, -2) @ J_point                  # [K,L,6,3]
        b_p = (Jpw.transpose(1, 2) @ rk)[..., 0]                 # [K,6]
        b_l = (Jlw.transpose(1, 2) @ rl)[..., 0]                 # [L,3]

        # Levenberg damping (of H_pp: below, after the landmark sum)
        H_ll = H_ll + (lam + point_damping) * torch.eye(3, dtype=dtype, device=X.device)
        H_ll_inv = _inv3x3(H_ll)                                 # [L,3,3]

        # Schur complement S = H_pp_diag - W Hll^-1 W^T as ONE
        # [K6, L3] x [L3, K6] product
        W_Hinv = H_pl @ H_ll_inv[None]                           # [K,L,6,3]
        A = W_Hinv.permute(0, 2, 1, 3).reshape(K * 6, L * 3)
        W = H_pl.permute(0, 2, 1, 3).reshape(K * 6, L * 3)
        S = (-(A @ W.T)).reshape(K, 6, K, 6)
        rhs = b_p - (A @ b_l.reshape(L * 3)).reshape(K, 6)
        if self.landmark_sum is not None:
            S, H_pp, rhs = self.landmark_sum(S, H_pp, rhs)
        S[self.kk, :, self.kk, :] += H_pp + lam * self.eye6
        self._keep(S, rhs, H_ll_inv, b_l, W)

    def update(self) -> None:
        """The proposal ``(T_new, X_new)`` of the step ``dp``."""
        dx = -(self.Hll_inv @ (self.b_l + self._Wt_dp())[..., None])[..., 0]
        self.T_new, self.X_new = se3.apply_left_update(self.dp, self.T), self.X + dx

    def _Wt_dp(self):
        """``W^T dp``, ``[L, 3]``."""
        return (self.W.T @ self.dp.reshape(self.K * 6)).reshape(self.L, 3)


class _KernelBuffers(_MaterialisedBuffers):
    """The kernel route off the card: the plain versions of K4 / K5
    (``ops.ba_kernel``) in the caller's landmark order; ``W`` as planes
    ``[3, 6K, L]``."""

    schur_out = schedule = None          # the plain versions allocate their outputs

    @staticmethod
    def assembler(K: int):
        """K4 where the single-pass kernel takes the window, else K5."""
        return (ba_kernel.schur_assemble if K <= SCHUR_KERNEL_MAX_K
                else ba_kernel.schur_assemble_tiled)

    @classmethod
    def path(cls, K: int) -> str:
        return f"torch:{cls.assembler(K).__name__}_plain"

    def _schur_system(self, z):
        K, L = self.K, self.L
        return z(K, 6, K, 6), z(K, 6), z(L, 3, 3), z(L, 3), z(3, 6 * K, L)

    def assemble(self, lam: float, point_damping: float) -> None:
        # K4 / K5 never materialise residuals, weights or Jacobians, and
        # return the UNdamped S and the back-substitution operands
        fx, fy, cx, cy, bq = self.intrinsics
        S, rhs, H_ll_inv, b_l, W = self.assembler(self.K)(
            self.T, self.X, self.obs_uv, self.maskf, lam, fx=fx, fy=fy, cx=cx, cy=cy, bq=bq,
            kernel_px2=self.kernel_px2, point_damping=point_damping, out=self.schur_out,
            schedule=self.schedule)
        if self.landmark_sum is not None:
            for dst, src in zip((S, rhs), self.landmark_sum(S, rhs)):
                dst.copy_(src)
        S[self.kk, :, self.kk, :] += lam * self.eye6
        self._keep(S, rhs, H_ll_inv, b_l, W)

    def _Wt_dp(self):
        return torch.einsum("bql,q->lb", self.W, self.dp.reshape(self.K * 6))


class _CardKernelBuffers(_KernelBuffers):
    """The kernel route on the card: K4 / K5 write into ``schur_out``'s
    buffers (``S`` .. ``W`` are views of them); a solve's landmarks are held
    in ``ba_kernel.landmark_order``'s order and the product's schedule is
    made of it, once a solve (``order_landmarks``)."""

    STAGES = ("order_landmarks",) + _LMBuffers.STAGES

    @classmethod
    def path(cls, K: int) -> str:
        return f"cuda:{cls.assembler(K).__name__}"

    def _schur_system(self, z):
        self.schur_out = ba_kernel.schur_out(self.K, self.L, self.dev)
        return ba_kernel.schur_views(self.schur_out)

    def _load_observations(self, points_w, obs_uv, obs_mask, obs_w, prepared):
        self.maskf.copy_(obs_mask)
        if obs_w is not None:
            self.maskf.mul_(obs_w)
        self.run("order_landmarks")
        torch.index_select(obs_uv, 1, self.perm, out=self.obs_uv)
        points_w = points_w.index_select(0, self.perm)
        _count(solves_ordered=1, last_ordered=self)
        return points_w

    def order_landmarks(self) -> None:
        """``maskf`` put in the order of ``ba_kernel.landmark_order``
        (``perm``; ``order`` maps it back) and the product's schedule of it
        (``schedule``)."""
        self.perm, self.order = ba_kernel.landmark_order(self.maskf)
        self.maskf.copy_(self.maskf.index_select(1, self.perm))
        self.schedule = ba_kernel.schur_schedule(self.maskf)

    def points(self) -> torch.Tensor:
        return self.X.index_select(0, self.order)

    def _keep(self, *system) -> None:
        """Nothing: the kernels wrote the system into the set's buffers."""


# ---------------------------------------------------------------------------
# the observation-list route
# ---------------------------------------------------------------------------

# co-visible pairs are summed into S in chunks of this many, each run of one
# keyframe pair padded to whole chunks
PAIR_CHUNK = 32


def _capacity(n: int) -> int:
    """A capacity strictly above ``n``, on a grid of 8 to 16 steps per power
    of two: problems of one shape whose counts differ by a little share it,
    and one padding slot always exists."""
    e = max(int(n).bit_length() - 4, 0)
    return ((int(n) >> e) + 1) << e


@dataclasses.dataclass
class _ObsLists:
    """A ``[K, L]`` mask as lists (``-1`` pads the tables).

    ``k`` / ``l``: the observations, by landmark, then keyframe.
    ``lm_slots [L, n]``, ``kf_slots [K, m]``: each landmark's and each
    keyframe's observations. ``pair_a`` / ``pair_b``: the co-visible pairs
    (observations ``a <= b`` of one landmark), sorted by keyframe pair and
    each keyframe pair's run padded to whole chunks of :data:`PAIR_CHUNK`.
    ``seg_chunks [S, c]``: each keyframe pair's chunks; ``seg_rows`` its
    row ``k_a K + k_b`` of the flat block grid, ``seg_rows_t`` that of its
    transpose (``-1`` on the diagonal)."""
    k: torch.Tensor
    l: torch.Tensor
    lm_slots: torch.Tensor
    kf_slots: torch.Tensor
    pair_a: torch.Tensor
    pair_b: torch.Tensor
    seg_chunks: torch.Tensor
    seg_rows: torch.Tensor
    seg_rows_t: torch.Tensor
    pairs: int

    @property
    def capacities(self) -> tuple[int, ...]:
        """What a buffer set holding these lists is sized by."""
        return (_capacity(self.k.numel()), _capacity(self.lm_slots.shape[1]),
                _capacity(self.kf_slots.shape[1]),
                _capacity(self.pair_a.numel() // PAIR_CHUNK),
                _capacity(self.seg_rows.numel()), _capacity(self.seg_chunks.shape[1]))


def _slot_table(rows: int, row: torch.Tensor, col: torch.Tensor, value: torch.Tensor,
                width: int) -> torch.Tensor:
    table = torch.full((rows, max(width, 1)), -1, dtype=torch.int64, device=row.device)
    table[row, col] = value
    return table


def _observation_lists(obs_mask: torch.Tensor) -> _ObsLists:
    """The lists of one solve, made on the mask's device (a few host reads
    of their lengths). Every order here is fixed by the mask alone."""
    K, L = obs_mask.shape
    dev = obs_mask.device
    lk = torch.nonzero(obs_mask.t() != 0)              # by landmark, then keyframe
    l, k = lk[:, 0].contiguous(), lk[:, 1].contiguous()
    N = l.numel()
    ar = torch.arange(N, device=dev)
    n_l = torch.bincount(l, minlength=L)
    pos_l = ar - (torch.cumsum(n_l, 0) - n_l)[l]
    by_k = torch.argsort(k, stable=True)
    m_k = torch.bincount(k, minlength=K)
    pos_k = ar - (torch.cumsum(m_k, 0) - m_k)[k[by_k]]
    partners = n_l[l] - pos_l                        # b = a .. the landmark's last
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    n_max, m_max, P = torch.stack([torch.cat([n_l, zero]).max(), torch.cat([m_k, zero]).max(),
                                   partners.sum()]).tolist()

    a = torch.repeat_interleave(ar, partners, output_size=P)
    b = a + torch.arange(P, device=dev) - (torch.cumsum(partners, 0) - partners)[a]
    key, order = torch.sort(k[a] * K + k[b], stable=True)
    a, b = a[order], b[order]
    rows, run = torch.unique_consecutive(key, return_counts=True)
    S = rows.numel()
    chunks = (run + PAIR_CHUNK - 1) // PAIR_CHUNK
    chunk0 = torch.cumsum(chunks, 0) - chunks
    seg = torch.repeat_interleave(torch.arange(S, device=dev), run, output_size=P)
    within = torch.arange(P, device=dev) - (torch.cumsum(run, 0) - run)[seg]
    slot = chunk0[seg] * PAIR_CHUNK + within
    n_chunks, c_max = torch.stack([chunks.sum(), torch.cat([chunks, zero]).max()]).tolist()
    pair_a = torch.full((n_chunks * PAIR_CHUNK,), -1, dtype=torch.int64, device=dev)
    pair_b = pair_a.clone()
    pair_a[slot], pair_b[slot] = a, b
    j = torch.arange(max(c_max, 1), device=dev)
    seg_chunks = torch.where(j < chunks[:, None], chunk0[:, None] + j, -1)
    ka, kb = rows // K, rows % K
    return _ObsLists(
        k=k, l=l, lm_slots=_slot_table(L, l, pos_l, ar, n_max),
        kf_slots=_slot_table(K, k[by_k], pos_k, by_k, m_max),
        pair_a=pair_a, pair_b=pair_b, seg_chunks=seg_chunks, seg_rows=rows,
        seg_rows_t=torch.where(ka != kb, kb * K + ka, -1), pairs=P)


class _ObsBuffers(_LMBuffers):
    """The buffer set of the observation-list route: the observations as a
    list padded to a capacity (padding at weight 0), the reduced camera
    system summed over co-visible pairs. No ``[K, L]`` tensor is held; one
    set serves every problem of its shape whose lists fit its capacities,
    and a problem whose lists do not fit replaces it with a set that holds
    both, so a ring of problems settles on one set.

    Per landmark and per keyframe, sums run over slot tables (a fixed
    order); ``S`` is summed over each keyframe pair's chunks of pair
    blocks, then over its chunks: the same mask gives the same bits."""

    def __init__(self, dev, dtype, K, L, intrinsics, kernel_px2, use_odo, use_grav,
                 capacities):
        super().__init__(dev, dtype, K, L, intrinsics, kernel_px2, use_odo, use_grav)
        n, n_l, n_k, n_chunks, n_seg, n_c = capacities
        z = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)  # noqa: E731
        i = lambda *shape: torch.zeros(shape, dtype=torch.int64, device=dev)  # noqa: E731
        self.capacities = capacities
        self.k_idx, self.l_idx = i(n), i(n)
        self.obs_uv, self.maskf = z(n, 4), z(n)
        self.lm_slots, self.kf_slots = i(L, n_l), i(K, n_k)
        self.pair_a, self.pair_b = i(n_chunks * PAIR_CHUNK), i(n_chunks * PAIR_CHUNK)
        self.seg_chunks, self.seg_rows, self.seg_rows_t = i(n_seg, n_c), i(n_seg), i(n_seg)
        self.S_rows = z(K * K + 1, 36)                 # the flat block grid and a spare row
        self.S, self.rhs = z(K, 6, K, 6), z(K, 6)
        self.Hll_inv, self.b_l = z(L, 3, 3), z(L, 3)
        self.W = z(n, 6, 3)
        _count(buffer_sets=1)

    @staticmethod
    def path(K: int) -> str:
        return "torch:observation_list"

    @classmethod
    def take(cls, key, obs_mask, request, *args) -> tuple[_LMBuffers, _ObsLists]:
        """The solve's lists and a set whose capacities hold them (where the
        set of ``key`` does not, one that holds both replaces it)."""
        with span("svi.ba.obs_list", request):
            lists = _observation_lists(obs_mask)
        _count(solves=1, observations=lists.k.numel(), pairs=lists.pairs)
        need = lists.capacities
        return _buffers(
            key, lambda old: cls(*args, need if old is None
                                 else tuple(map(max, need, old.capacities))),
            fits=lambda lm: all(map(int.__ge__, lm.capacities, need))), lists

    def _load_observations(self, points_w, obs_uv, obs_mask, obs_w, lists: _ObsLists):
        n = lists.k.numel()
        spare_obs = self.k_idx.numel() - 1             # a padding observation
        spare_chunk = self.pair_a.numel() // PAIR_CHUNK - 1
        spare_row = self.S_rows.shape[0] - 1

        def put(dst, src, spare):
            dst.fill_(spare)
            dst[tuple(slice(0, s) for s in src.shape)] = torch.where(src < 0, spare, src)

        for dst, src in ((self.k_idx, lists.k), (self.l_idx, lists.l)):
            put(dst, src, 0)
        for dst, src in ((self.lm_slots, lists.lm_slots), (self.kf_slots, lists.kf_slots),
                         (self.pair_a, lists.pair_a), (self.pair_b, lists.pair_b)):
            put(dst, src, spare_obs)
        put(self.seg_chunks, lists.seg_chunks, spare_chunk)
        put(self.seg_rows, lists.seg_rows, spare_row)
        put(self.seg_rows_t, lists.seg_rows_t, spare_row)
        self.obs_uv.zero_()
        self.obs_uv[:n] = obs_uv[lists.k, lists.l]
        self.maskf.zero_()
        self.maskf[:n] = obs_mask[lists.k, lists.l]
        if obs_w is not None:
            self.maskf[:n] *= obs_w[lists.k, lists.l]
        self.S_rows.zero_()
        return points_w

    def _camera_points(self, T, X):
        """Each listed observation's rotation ``[N, 3, 3]`` and point in its
        camera ``[N, 3]``."""
        R = T[self.k_idx, :3, :3]
        return R, (R * X[self.l_idx][:, None, :]).sum(-1) + T[self.k_idx, :3, 3]

    def assemble(self, lam: float, point_damping: float) -> None:
        # the products per observation are a few elements wide, so they are
        # written out as broadcast products and sums, not batched matmuls
        T, X, K, L = self.T, self.X, self.K, self.L
        fx, fy, cx, cy, bq = self.intrinsics
        dtype = X.dtype
        R, p_c = self._camera_points(T, X)
        r = _project(p_c, self.obs_uv, fx, fy, cx, cy, bq)             # [N,4]
        w = self.robust_w(r) * (p_c[:, 2] > 0.05).to(dtype)
        J_uv = _uv_jacobian(p_c, fx, fy, bq)
        # J_pose = J_uv [I | -hat(p_c)] = [J_uv | p_c x J_uv], J_point = J_uv R
        G = torch.cat([J_uv, torch.linalg.cross(p_c[:, None, :].expand_as(J_uv), J_uv, dim=-1),
                       (J_uv[:, :, :, None] * R[:, None, :, :]).sum(2), r[..., None]], -1)
        # rows pose (6) and point (3) of sum_r w G_r G_r^T: [H_pp H_pl b_p; . H_ll b_l]
        M = ((G[:, :, :9] * w[:, None, None])[..., None] * G[:, :, None, :]).sum(1)
        H_pl = M[:, :6, 6:9]                                           # [N,6,3]

        per_l = M[:, 6:9, 6:].reshape(-1, 12)[self.lm_slots].sum(1).reshape(L, 3, 4)
        H_ll = per_l[..., :3] + (lam + point_damping) * torch.eye(3, dtype=dtype, device=X.device)
        b_l = per_l[..., 3]
        H_ll_inv = _inv3x3(H_ll)                                       # [L,3,3]
        C = (H_pl[:, :, :, None] * H_ll_inv[self.l_idx][:, None, :, :]).sum(2)  # W Hll^-1
        rhs_i = M[:, :6, 9] - (C * b_l[self.l_idx][:, None, :]).sum(-1)
        per_k = torch.cat([M[:, :6, :6].reshape(-1, 36), rhs_i], 1)[self.kf_slots].sum(1)
        H_pp, rhs = per_k[:, :36].reshape(K, 6, 6), per_k[:, 36:]

        with span("svi.ba.pair_product", self.request):
            # S_ab = -sum over the landmarks a and b share of C_a W_b^T: one
            # [6, 3 PAIR_CHUNK] x [3 PAIR_CHUNK, 6] product a chunk, then the
            # sum of each keyframe pair's chunks
            n = self.pair_a.numel() // PAIR_CHUNK
            Ct = C.transpose(1, 2).contiguous()[self.pair_a].view(n, 3 * PAIR_CHUNK, 6)
            Wt = H_pl.transpose(1, 2).contiguous()[self.pair_b].view(n, 3 * PAIR_CHUNK, 6)
            chunks = torch.bmm(Ct.transpose(1, 2), Wt).reshape(n, 36)
            runs = chunks[self.seg_chunks].sum(1)                      # [pairs of keyframes,36]
            self.S_rows[self.seg_rows] = -runs
            self.S_rows[self.seg_rows_t] = -runs.reshape(-1, 6, 6).transpose(1, 2).reshape(-1, 36)
            S = self.S_rows[: K * K].reshape(K, K, 6, 6).permute(0, 2, 1, 3)
        if self.landmark_sum is not None:
            S, H_pp, rhs = self.landmark_sum(S, H_pp, rhs)
        self.S.copy_(S)
        self.S[self.kk, :, self.kk, :] += H_pp + lam * self.eye6
        for dst, src in ((self.rhs, rhs), (self.Hll_inv, H_ll_inv), (self.b_l, b_l),
                         (self.W, H_pl)):
            dst.copy_(src)

    def update(self) -> None:
        dp = self.dp
        Wdp = (self.W * dp[self.k_idx][:, :, None]).sum(1)             # W^T dp [N,3]
        dx = -(self.Hll_inv * (self.b_l + Wdp[self.lm_slots].sum(1))[:, None, :]).sum(-1)
        self.T_new, self.X_new = se3.apply_left_update(dp, self.T), self.X + dx

    def residuals(self, T, X):
        return _project(self._camera_points(T, X)[1], self.obs_uv, *self.intrinsics)


def _buffers(key, make, fits=None) -> _LMBuffers:
    """The buffer set of ``key``, made by ``make(old)`` the first time or
    where the set there does not ``fit`` (``old`` is that set, or ``None``;
    the new set replaces it); the least recently used set beyond
    :data:`LM_BUFFER_SETS` is dropped."""
    with _lock:
        lm = _buffer_sets.get(key)
        if lm is not None and (fits is None or fits(lm)):
            _buffer_sets.move_to_end(key)
            return lm
    lm = make(lm)
    with _lock:
        _buffer_sets[key] = lm
        while len(_buffer_sets) > LM_BUFFER_SETS:
            _buffer_sets.popitem(last=False)
    return lm


def schur_route(K: int, dtype, device, use_schur_kernel: bool | None) -> type[_LMBuffers]:
    """The route of a solve to its Schur system, as the buffer class that
    holds it. ``use_schur_kernel=None``: the kernel route where
    :func:`schur_kernel_auto` takes the window, the observation-list route
    for ``K > SCHUR_KERNEL_TILED_MAX_K`` otherwise, the materialised route
    for the rest; ``True``: the kernel route; ``False``: the materialised
    route at any K. The kernel route is K4 / K5 on a CUDA device and their
    plain versions elsewhere."""
    device = torch.device(device)
    kernel = _CardKernelBuffers if device.type == "cuda" else _KernelBuffers
    if use_schur_kernel is None:
        if schur_kernel_auto(K, dtype, device):
            return kernel
        return _ObsBuffers if K > SCHUR_KERNEL_TILED_MAX_K else _MaterialisedBuffers
    return kernel if use_schur_kernel else _MaterialisedBuffers


def bundle_adjust(
    T_wc: torch.Tensor,          # [K,4,4]
    points_w: torch.Tensor,      # [L,3]
    obs_uv: torch.Tensor,        # [K,L,4]
    obs_mask: torch.Tensor,      # [K,L] bool
    cam: StereoCamera,
    fix_mask: torch.Tensor,      # [K] bool — poses held fixed (gauge)
    *,
    kernel_px2: float = 10.0,
    max_iterations: int = 10,
    lm_lambda0: float = 1e-4,
    point_damping: float = 1e-6,
    min_rel_improvement: float = 0.01,   # ref <1% chi2 stop (Cg2o:966-977)
    odo_M: torch.Tensor | None = None,   # [K,4,4] pose-pose chain measurements
                                         # (entry k: T_{k+1} <- k; the
                                         # reference's EdgeSE3 chain,
                                         # Cg2o:1258-1266)
    odo_w: torch.Tensor | None = None,   # [K] edge weights (0 disables; last
                                         # entry unused)
    grav_d: torch.Tensor | None = None,  # [K,3] measured camera-frame down
                                         # directions — per-keyframe gravity
                                         # unary (ref
                                         # EdgeSE3LinearAcceleration,
                                         # Cg2oOptimizer.cpp:982-997)
    grav_w: torch.Tensor | None = None,  # [K] gravity weights (0 disables)
    obs_w: torch.Tensor | None = None,   # [K,L] per-observation information
                                         # scale (depth-tiered weighting, ref
                                         # dInformationFactor = 1/z,
                                         # Cg2oOptimizer.cpp:1403-1466);
                                         # multiplies into the mask/robust
                                         # weight on every route
    use_schur_kernel: bool | None = None,  # the route (schur_route)
    device=None,
    _landmark_sum=None,
) -> BAResult:
    """Windowed bundle adjustment. ``device=None`` means CUDA (raises
    without one); inputs are moved there and taken in the landmarks' dtype.
    :func:`schur_route` gives the route of ``use_schur_kernel`` at the
    window's K, dtype and device. A kernel that fails to build or launch
    raises; nothing gives way to another route. The results are the
    caller's own tensors: a later call does not write into them.

    ``_landmark_sum`` is the hook of ``parallel.sharded_ba``: a function
    that takes tensors summed over this call's landmarks and returns their
    sums over every shard of the landmark axis (the reprojection chi^2, and
    the undamped Schur system ``S``, ``H_pp`` and ``rhs`` of each LM
    iteration). Damping, the odometry and gravity terms, gauge fixing and
    the solve follow it, so they run once on the summed system. ``None``
    (the default) leaves every sum as this call computed it."""
    rid = next_request()
    with span("svi.ba.solve", rid):
        dev = resolve_device(device)
        T_wc = _on(T_wc, dev)
        points_w = _on(points_w, dev)
        dtype = points_w.dtype
        obs_uv = _on(obs_uv, dev, dtype)
        obs_mask = _on(obs_mask, dev)
        fix_mask = _on(fix_mask, dev)
        require_fp32_matmul(points_w)
        K = T_wc.shape[0]
        L = points_w.shape[0]
        use_odo = odo_M is not None
        use_grav = grav_d is not None
        odo_Minv = wo = None
        if use_odo:
            odo_Minv = se3.inv_T(_on(odo_M, dev, dtype)[: K - 1])
            wo = _on(odo_w, dev, dtype)[: K - 1]
        route = schur_route(K, dtype, dev, use_schur_kernel)
        # a replay runs no operator in Python: not under the collective
        # hook, nor under a dispatch mode (the flop counter) that counts them
        replay = (dev.type == "cuda" and _landmark_sum is None
                  and _get_current_dispatch_mode() is None)
        intrinsics = _intrinsics(cam)
        # everything the stages take from the call: direct and replayed
        # sets are kept apart, since a direct run rebinds the outputs
        key = (dev, threading.get_ident(), K, L, dtype, route, use_odo, use_grav, intrinsics,
               kernel_px2, replay)
        lm, prepared = route.take(key, obs_mask, rid, dev, dtype, K, L, intrinsics, kernel_px2,
                                  use_odo, use_grav)
        lm.request = rid
        if replay and not lm.graphs:
            lm.capture()
        lm.load(T_wc, points_w, obs_uv, obs_mask, _on(obs_w, dev, dtype),
                fix_mask, odo_Minv, wo, _on(grav_d, dev, dtype), _on(grav_w, dev, dtype),
                prepared)
        lm.landmark_sum = _landmark_sum

        with span("svi.ba.chi2", rid):
            lm.run("total_chi2")
        lm.accept()
        chi2_init = lm.chi2.clone()

        lam = np.float32(lm_lambda0)
        iters = 0
        while iters < max_iterations:
            with span("svi.ba.iteration", rid):
                with span("svi.ba.assemble", rid):
                    lm.assemble(float(lam), point_damping)
                with span("svi.ba.priors", rid):
                    lm.run("priors")
                with span("svi.ba.linear_solve", rid):
                    lm.linear_solve()
                with span("svi.ba.update", rid):
                    lm.run("update")
                with span("svi.ba.chi2", rid):
                    lm.run("total_chi2")
                accept_t = lm.chi2_new < lm.chi2
                rel_gain = (lm.chi2 - lm.chi2_new) / torch.clamp(lm.chi2, min=1e-12)
                done_t = accept_t & (rel_gain < min_rel_improvement)
                # the iteration's one host read
                with span("svi.ba.flag_read", rid):
                    accept, done = torch.stack([accept_t, done_t]).tolist()
            if accept:
                lm.accept()
            lam = lam * np.float32(0.3) if accept else lam * np.float32(8.0)
            iters += 1
            if done:
                break

        return BAResult(
            T_wc=lm.T.clone(), points_w=lm.points(), chi2_initial=chi2_init,
            chi2_final=lm.chi2.clone(),
            iterations=torch.tensor(iters, dtype=torch.int32, device=dev),
        )


def reprojection_stats(
    T_wc: torch.Tensor,          # [K,4,4]
    points_w: torch.Tensor,      # [L,3]
    obs_uv: torch.Tensor,        # [K,L,4]
    obs_mask: torch.Tensor,      # [K,L] bool
    cam: StereoCamera,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-landmark post-BA health: (mean squared reprojection error [L],
    minimum observing-camera depth [L]) — the excision criteria of the
    reference's _applyOptimizationToLandmarks (Cg2oOptimizer.cpp:1486-1504)."""
    dev = resolve_device(device)
    T_wc, points_w, obs_uv, obs_mask = (_on(t, dev) for t in
                                        (T_wc, points_w, obs_uv, obs_mask))
    r, p_c = _residuals(T_wc, points_w, obs_uv, *_intrinsics(cam))
    m = obs_mask.to(r.dtype)
    n = torch.clamp(torch.sum(m, dim=0), min=1.0)                 # [L]
    err2 = torch.sum(m * torch.sum(r * r, dim=-1), dim=0) / n
    depth = torch.amin(
        torch.where(obs_mask, p_c[..., 2], torch.full_like(p_c[..., 2], float("inf"))),
        dim=0)
    return err2, depth
