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
    per LM iteration (``solvers.ba.schur_kernel_auto``); other windows take
    the materialised Jacobians and launch neither;
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
"""

from __future__ import annotations

import sys
import threading

import torch

_count_lock = threading.Lock()
_by_thread: dict[str, dict[str, int]] = {}


def count_launch(module: str, entry: str) -> None:
    """Add one to the launch counter ``<entry>_launches`` of the wrapper
    module named ``module`` and to the calling thread's tally, under one
    lock."""
    thread = threading.current_thread().name
    mod = sys.modules[module]
    attr = f"{entry}_launches"
    with _count_lock:
        setattr(mod, attr, getattr(mod, attr) + 1)
        tally = _by_thread.setdefault(thread, {})
        tally[entry] = tally.get(entry, 0) + 1


def launch_counts_by_thread() -> dict[str, dict[str, int]]:
    """Launches per thread name and entry since the last
    :func:`reset_launch_counts` (threads that launched nothing are
    absent)."""
    with _count_lock:
        return {t: dict(c) for t, c in _by_thread.items()}


def launch_counts() -> dict:
    """The wrappers' launch counters (six kernels, K2 and K6 with two
    entries each), by entry name."""
    from svi_mapper_tpu_torch.ops import (
        ba_kernel,
        descriptors,
        hamming,
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
            "pool_nn_counts": hamming.pool_nn_counts_launches}


def reset_launch_counts() -> None:
    from svi_mapper_tpu_torch.ops import (
        ba_kernel,
        descriptors,
        hamming,
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
        _by_thread.clear()


def kernel_paths(ba_window_ks: tuple[int, ...] = (8, 32, 64),
                 device=None) -> dict:
    """The route of every hot operation for tensors on ``device`` (None =
    CUDA), the BA windows ``ba_window_ks`` included, with the launch
    counters as they stand."""
    from svi_mapper_tpu_torch.solvers.ba import SCHUR_KERNEL_MAX_K, schur_kernel_auto

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
        if not schur_kernel_auto(K, torch.float32, dev):
            paths[f"ba_schur_K{K}"] = "torch:materialised"
        elif K <= SCHUR_KERNEL_MAX_K:
            paths[f"ba_schur_K{K}"] = "cuda:schur_assemble"
        else:
            paths[f"ba_schur_K{K}"] = "cuda:schur_assemble_tiled"
    paths["launches"] = launch_counts()
    return paths
