"""Which kernel each hot operation of the port goes through, and how often
it did.

On a CUDA device there is one path per operation: the hand-written kernel,
or an error. On the CPU each wrapper takes its plain PyTorch version. So
this report names the call sites that are real in the port and reads the
wrappers' launch counters, which count where a kernel is launched and
nowhere else; a run that claims a kernel ran shows it by a counter above
zero.

Call sites:
  * ``models.frame.process_frame`` -> ``ops.descriptors.brief_dense_fused``
    (K3), twice per frame;
  * ``frontend.tracking.track_landmarks`` -> ``ops.track_kernel.track_scores``
    (K1);
  * ``frontend.stereo.match_stereo`` -> ``ops.stereo_kernel.stereo_match``
    (K2, the fused match entry; ``ops.stereo_kernel.stereo_profiles``, the
    profile entry, has no caller on a path);
  * ``solvers.ba.bundle_adjust`` -> ``ops.ba_kernel.schur_assemble`` (K4,
    K <= 32) or ``schur_assemble_tiled`` (K5, K % 32 == 0 up to 128), once
    per LM iteration, where ``solvers.ba.schur_route`` picks the kernel
    route; windows past 128 keyframes take the observation-list route and
    the others the materialised Jacobians, and launch neither;
  * on the card's kernel route, the LM loop's ``total_chi2`` and ``update``
    -> ``ops.observed_walk.observed_chi2`` / ``observed_update`` (the
    observed walk), inside the stages' CUDA graphs;
  * ``mapping.closure._pool_nn_counts`` -> ``ops.hamming.pool_nn_counts``
    (K6, the fused pool-count entry);
  * the exact branch of ``mapping.closure.match_pools`` ->
    ``ops.hamming.hamming_distance_matrix`` (K6, the matrix entry); so do
    ``ops.hamming.match_nearest`` / ``match_mutual`` / ``count_matches``.
    The probabilistic branch of ``match_pools`` is two float32 matrix
    products and launches no kernel of the port.

A wrapper counts a launch through :func:`count_launch`, which adds one
under a lock: the closure worker and the back-end worker launch K4-K6 from
their own threads while the tracker thread launches K1-K3, and a bare
``+= 1`` on a module global can lose a count between two threads. The same
call keeps a tally per thread (:func:`launch_counts_by_thread`), which
shows which kernels a worker thread launched.

Beside the count, a wrapper reports the work of the function it launched:
the bytes it must move (each input read once, each output written once)
and the operations it does, by the ``*_work`` formulas below, counted on
the launch's own inputs where the work depends on the data. The report is
read only inside :func:`recording_work` (``eval.utilization`` and
``chip_smoke.py``'s bounds call the same formulas), so a run outside it
pays nothing for it.
"""

from __future__ import annotations

import contextlib
import sys
import threading

import torch
from torch.utils._python_dispatch import _disable_current_modes

_count_lock = threading.Lock()
_by_thread: dict[str, dict[str, int]] = {}
_work: dict[str, list[float]] | None = None


def count_launch(module: str, entry: str, work=None) -> None:
    """Add one to the launch counter ``<entry>_launches`` of the wrapper
    module named ``module`` and to the calling thread's tally, under one
    lock. Inside :func:`recording_work`, also add ``work()`` — the launch's
    ``(bytes, operations)`` — to that entry's tally."""
    thread = threading.current_thread().name
    mod = sys.modules[module]
    attr = f"{entry}_launches"
    with _count_lock:
        setattr(mod, attr, getattr(mod, attr) + 1)
        tally = _by_thread.setdefault(thread, {})
        tally[entry] = tally.get(entry, 0) + 1
    recorder = _work
    if recorder is not None and work is not None:
        # the count's own tensor ops are not the stage's work
        with _disable_current_modes():
            moved, ops = work()
        with _count_lock:
            acc = recorder.setdefault(entry, [0.0, 0.0])
            acc[0] += moved
            acc[1] += ops


@contextlib.contextmanager
def recording_work():
    """Within the block, every kernel launch adds its function's bytes and
    operations to the yielded dict, ``entry -> [bytes, operations]``."""
    global _work
    outer, _work = _work, {}
    try:
        yield _work
    finally:
        _work = outer


# --- the work of each kernel's function (each input read once, each output
#     written once; operations at the rate of their type) -----------------

# float operations per (keyframe, landmark) of the Schur assembly's shared
# body, counted from csrc/schur_assemble.cu: point 18, projection and
# residuals 31, weight 8, Jacobian rows 24 + 36 + 60, H_ll/b_l 63, W rows
# 126, H_pp/b_p 189
SCHUR_FLOPS_PER_OBSERVATION = 555


def unique_pixels(h: int, w: int, ys: torch.Tensor, xs: torch.Tensor) -> int:
    """Number of distinct pixels of an ``h x w`` field a set of gathers
    touches."""
    mask = torch.zeros((h, w), dtype=torch.bool, device=ys.device)
    mask[ys.reshape(-1).long(), xs.reshape(-1).long()] = True
    return int(mask.sum())


def brief_dense_work(h: int, w: int) -> tuple[int, int]:
    """K3: the float image in, the packed field out, the pattern; 256
    comparisons and ~20 blur operations per pixel."""
    px = h * w
    return px * 4 + px * 32 + 256 * 16, px * (256 + 20)


def track_scores_work(n: int, touched: int, scored: int) -> tuple[int, int]:
    """K1: the field pixels the tiers can accept (``touched``), 2 floats +
    5 ints + 2 descriptors in and 4 ints out per landmark; 16 xor + 16
    popcount + 14 add + ~20 for the tiers and the key per scored pixel."""
    return touched * 32 + n * (2 * 4 + 5 * 4 + 2 * 32 + 4 * 4), scored * 66


def stereo_profiles_work(n: int, De: int, touched: int) -> tuple[int, int]:
    """K2's profile entry: the span pixels touched, keypoint + descriptor
    in, profile + origin out; 8 xor + 8 popcount + 7 add per candidate."""
    return touched * 32 + n * (2 * 4 + 32) + n * (De + 2) * 4, n * De * 23


def stereo_match_work(n: int, De: int, touched: int) -> tuple[int, int]:
    """K2's fused match: the span read once, keypoint, descriptor, centre
    and range in, six ints out; the profile's operations and a compare, a
    mask and a min per candidate."""
    return touched * 32 + n * (2 * 4 + 32 + 2 * 4) + n * 6 * 4, n * De * 30


def schur_work(mask, K: int, L: int) -> dict:
    """K4 / K5 on one window: each input read once and each output written
    once; the assembly's operations per observation, and C = W Hll^-1 (90
    per observed keyframe-landmark pair), the rhs column (36) and the
    product (216 per 6x6 block and landmark) only where an observation is,
    the product over the upper block triangle: n (n + 1) / 2 blocks for a
    landmark that n keyframes observe."""
    n_l = (torch.as_tensor(mask) > 0).sum(0).to(torch.int64)
    n_obs = int(n_l.sum())
    pairs = int((n_l * (n_l + 1) // 2).sum())
    moved_in = 4 * (16 * K + 3 * L + 5 * K * L)
    moved_out = 4 * (36 * K * K + 6 * K + 12 * L + 18 * K * L)
    return dict(bytes=moved_in + moved_out,
                flops=n_obs * (SCHUR_FLOPS_PER_OBSERVATION + 90 + 36) + 216 * pairs,
                product_flops_upper=216 * pairs,
                product_flops_dense_upper=216 * (K * (K + 1) // 2) * L,
                observations=n_obs)


# float operations per observed (keyframe, landmark) slot of the observed
# walk (csrc/observed_walk.cu): chi^2's point 18, projection 12, residuals
# and err^2 11, robust weight and term 6; the update's W^T dp 36, and 21 a
# landmark for X - Hll_inv (b_l + W^T dp)
OBSERVED_CHI2_FLOPS = 47
OBSERVED_UPDATE_FLOPS = 36


def _observations(mask) -> int:
    return int(torch.count_nonzero(torch.as_tensor(mask)))


def observed_chi2_work(mask, K: int, L: int) -> tuple[int, int]:
    """The observed walk's chi^2 on one window: the ``[K, L]`` weights read
    whole, an observation's 16 bytes only where it is observed, the poses,
    the landmarks and the sum; its operations per observation."""
    n = _observations(mask)
    return 4 * K * L + 16 * n + 64 * K + 12 * L + 4, OBSERVED_CHI2_FLOPS * n


def observed_update_work(mask, K: int, L: int) -> tuple[int, int]:
    """The observed walk's back-substitution: the weights read whole, the
    18 W entries of each observation, the pose step, ``Hll_inv``, ``b_l``
    and the landmarks in, the new landmarks out."""
    n = _observations(mask)
    return (4 * K * L + 72 * n + 24 * K + (36 + 12 + 12 + 12) * L,
            OBSERVED_UPDATE_FLOPS * n + 21 * L)


def hamming_matrix_work(B: int, N: int, M: int) -> tuple[int, int]:
    """K6's matrix: each descriptor read once, the matrix written once; the
    identity's operations (an AND or multiply and an add per pair and
    bit)."""
    return B * ((N + M) * 32 + N * M * 4), B * 2 * N * M * 256


def pool_nn_counts_work(nb: int, P: int, C: int, Pr: int) -> tuple[int, int]:
    """K6's pool count: descriptors and masks read once, the counts written
    once; the identity's operations over every query-reference pair."""
    pairs = nb * P * C * Pr
    return nb * (P * 33 + C * Pr * 33 + C * 4), 2 * pairs * 256


def launch_counts_by_thread() -> dict[str, dict[str, int]]:
    """Launches per thread name and entry since the last
    :func:`reset_launch_counts` (threads that launched nothing are
    absent)."""
    with _count_lock:
        return {t: dict(c) for t, c in _by_thread.items()}


def launch_counts() -> dict:
    """The wrappers' launch counters (six kernels, K2 and K6 with two
    entries each, and the observed walk's two entries), by entry name. The
    walk's are its direct launches: its replays in the LM loop's graphs
    run no Python (``solvers.ba.observed_walk_counts`` counts those)."""
    from svi_mapper_tpu_torch.ops import (
        ba_kernel,
        descriptors,
        hamming,
        observed_walk,
        stereo_kernel,
        track_kernel,
    )

    return {"track_scores": track_kernel.track_scores_launches,
            "stereo_profiles": stereo_kernel.stereo_profiles_launches,
            "stereo_match": stereo_kernel.stereo_match_launches,
            "brief_dense_fused": descriptors.brief_dense_fused_launches,
            "schur_assemble": ba_kernel.schur_assemble_launches,
            "schur_assemble_tiled": ba_kernel.schur_assemble_tiled_launches,
            "hamming_matrix": hamming.hamming_matrix_launches,
            "pool_nn_counts": hamming.pool_nn_counts_launches,
            "observed_chi2": observed_walk.observed_chi2_launches,
            "observed_update": observed_walk.observed_update_launches}


def reset_launch_counts() -> None:
    from svi_mapper_tpu_torch.ops import (
        ba_kernel,
        descriptors,
        hamming,
        observed_walk,
        stereo_kernel,
        track_kernel,
    )

    with _count_lock:
        track_kernel.track_scores_launches = 0
        stereo_kernel.stereo_profiles_launches = 0
        stereo_kernel.stereo_match_launches = 0
        descriptors.brief_dense_fused_launches = 0
        ba_kernel.schur_assemble_launches = 0
        ba_kernel.schur_assemble_tiled_launches = 0
        hamming.hamming_matrix_launches = 0
        hamming.pool_nn_counts_launches = 0
        observed_walk.observed_chi2_launches = 0
        observed_walk.observed_update_launches = 0
        _by_thread.clear()


def kernel_paths(ba_window_ks: tuple[int, ...] = (8, 32, 64),
                 device=None) -> dict:
    """The route of every hot operation for tensors on ``device`` (None =
    CUDA), the BA windows ``ba_window_ks`` included, with the launch
    counters as they stand."""
    from svi_mapper_tpu_torch.solvers.ba import schur_route

    dev = torch.device("cuda" if device is None else device)
    on_card = dev.type == "cuda"
    pick = lambda kernel, plain: kernel if on_card else plain  # noqa: E731
    paths = {
        "device": dev.type,
        "dense_brief": pick("cuda:brief_dense_fused", "torch:smooth_brief_dense_plain"),
        "tracking": pick("cuda:track_scores", "torch:window_scores"),
        "stereo": pick("cuda:stereo_match", "torch:stereo_match_plain"),
        "closure_pool_counts": pick("cuda:pool_nn_counts", "torch:pool_nn_counts_plain"),
        "closure_match_exact": pick("cuda:hamming_matrix", "torch:hamming_packed"),
        "closure_match_probabilistic": "torch:matmul",
    }
    for K in ba_window_ks:
        paths[f"ba_schur_K{K}"] = schur_route(K, torch.float32, dev, None).path(K)
    paths["launches"] = launch_counts()
    return paths
