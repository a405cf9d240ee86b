"""The LM loop's CUDA graphs (``solvers/ba.py``): on the card, the replayed
stages against the same stages run directly, bit for bit; the capture and
replay counts; the SE(3) helpers the graphs reach, under capture. The tests
marked ``gpu`` skip without a CUDA device. No JAX here: the comparisons are
within the port (``tests/test_torch_ba.py`` holds the buffer sets to the
loop as it was, on the CPU)."""

import importlib.util
from pathlib import Path

import pytest
import torch

from svi_mapper_tpu_torch.geometry import se3
from svi_mapper_tpu_torch.io.synthetic import default_camera
from svi_mapper_tpu_torch.ops import ba_kernel
from svi_mapper_tpu_torch.solvers import ba

# by its path: ``tests`` is a namespace package, which an installed regular
# package of that name shadows
_spec = importlib.util.spec_from_file_location(
    "torch_parity", Path(__file__).with_name("torch_parity.py"))
tp = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tp)

FIELDS = ("T_wc", "points_w", "chi2_initial", "chi2_final", "iterations")


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _solve(dev, problem, **kw):
    args, fix, extra = problem
    cam = default_camera(640, 480, device=dev)
    return ba.bundle_adjust(*[a.to(dev) for a in args], cam, fix.to(dev), device=dev,
                            **{k: v.to(dev) for k, v in extra.items()}, **kw)


def test_schur_out_takes_the_cards_buffers():
    """``out=`` names the kernels' buffers on the card; the plain versions
    allocate, and refuse it."""
    w = tp.ba_window(K=32, L=64)
    args = (tp.t32(w["T"]), tp.t32(w["X"]), tp.t32(w["obs"]), tp.t32(w["mask"]))
    intr = dict(zip(("fx", "fy", "cx", "cy", "bq"), w["intr"]))
    for fn in (ba_kernel.schur_assemble, ba_kernel.schur_assemble_tiled):
        with pytest.raises(ValueError, match="out="):
            fn(*args, 1e-3, **intr, out=(torch.zeros(1), torch.zeros(1)))


@pytest.mark.gpu
def test_replayed_stages_equal_direct_ones_on_the_card():
    """Three solves of one shape (K4) and one of another (K5), every term
    on: the replayed route returns the direct route's bits (the direct route
    reached through an identity collective hook), with one capture set per
    shape and three replays an iteration plus two a solve (the chi^2 of the
    start, the landmark order)."""
    dev = _card()
    problems = [tp.ba_chain_problem(32, 1024, seed) for seed in (31, 32, 33)]
    problems.append(tp.ba_chain_problem(64, 512, 34))
    ba.reset_graph_counts()
    replayed = [_solve(dev, p) for p in problems]
    counts = ba.graph_counts()
    direct = [_solve(dev, p, _landmark_sum=lambda *t: t) for p in problems]
    assert ba.graph_counts() == counts
    for a, b in zip(replayed, direct):
        assert int(a.iterations) > 1
        for f in FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    iterations = sum(int(r.iterations) for r in replayed)
    assert counts == {"graph_capture": 2,
                      "graph_replay": 3 * iterations + 2 * len(problems)}


@pytest.mark.gpu
def test_se3_helpers_run_under_capture():
    """``make_T`` (its bottom row made on the device), ``inv_T`` and
    ``apply_left_update`` are captured and replay the eager bits; a row made
    during the capture is not kept."""
    dev = _card()
    g = torch.Generator().manual_seed(5)
    xi = (0.1 * torch.randn(16, 6, generator=g)).to(dev)
    T = se3.exp_se3((0.5 * torch.randn(16, 6, generator=g)).to(dev))
    se3._bottom_rows.clear()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = (se3.make_T(T[:, :3, :3], T[:, :3, 3]), se3.inv_T(T),
               se3.apply_left_update(xi, T))
    assert (dev, T.dtype) not in se3._bottom_rows
    graph.replay()
    want = (se3.make_T(T[:, :3, :3], T[:, :3, 3]), se3.inv_T(T), se3.apply_left_update(xi, T))
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    assert torch.equal(out[0], T)
    assert torch.equal(se3._bottom_rows[(dev, T.dtype)].cpu(), torch.tensor([0.0, 0.0, 0.0, 1.0]))


@pytest.mark.gpu
def test_list_route_replays_its_direct_bits_on_the_card():
    """Two 136-keyframe circuits through the observation-list route, solved
    twice in turn: the ring settles on one buffer set (no set made and
    nothing captured in the second round), and the replayed stages give the
    bits of the same stages run directly (through an identity collective
    hook) in a set of the same capacities; three replays an iteration plus
    one a solve."""
    from portbench import manifest
    from portbench.circuit import make_ring

    dev = _card()
    c = manifest.cell(manifest.load(), "kitti00-sv-fullmap.global-ba")
    cfg = {**c["config"], "map": {**c["config"]["map"], "keyframes": 136, "landmarks": 3000}}
    ring = make_ring(c["traffic"], cfg, 2**33 + 5, dev)
    from svi_mapper_tpu_torch.geometry.camera import StereoCamera, pinhole_from_projection

    k = cfg["camera"]
    cam = StereoCamera(*(pinhole_from_projection(k[f"{side}_projection"], k["width"],
                                                 k["height"], device=dev)
                         for side in ("left", "right")))

    def solve(p, **kw):
        return ba.bundle_adjust(p.T, p.X, p.obs, p.mask, cam, p.fix, odo_M=p.odo_M,
                                odo_w=p.odo_w, max_iterations=6, device=dev, **kw)

    def rounds(**kw):
        first = [solve(p, **kw) for p in ring]
        counts = (ba.graph_counts()["graph_capture"], ba.obs_route_counts()["buffer_sets"])
        return first, [solve(p, **kw) for p in ring], counts

    ba._buffer_sets.clear()
    ba.reset_graph_counts()
    ba.reset_obs_route_counts()
    _, replayed, counts = rounds()
    assert counts[0] == counts[1] >= 1
    assert ba.graph_counts()["graph_capture"] == counts[0]
    assert ba.obs_route_counts()["buffer_sets"] == counts[1]
    iterations = sum(int(r.iterations) for r in replayed)
    _, direct, _ = rounds(_landmark_sum=lambda *t: t)
    for a, b in zip(replayed, direct):
        assert int(a.iterations) > 1
        for f in FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert ba.graph_counts()["graph_replay"] == 2 * (3 * iterations + len(ring))


def _segment(dev, landmarks: int, seed: int):
    """A map segment of the benchmark's generator (``portbench.segments``:
    128 keyframes, each landmark seen by a short run of them, the landmarks
    in random order) at ``landmarks`` landmarks, and its camera."""
    from portbench import manifest
    from portbench.segments import make_segment
    from svi_mapper_tpu_torch.geometry.camera import StereoCamera, pinhole_from_projection

    c = manifest.cell(manifest.load(), "kitti00-sv.segment-ba")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    p = make_segment({**c["traffic"], "landmarks": landmarks}, c["config"], gen, dev)
    k = c["config"]["camera"]
    cam = StereoCamera(*(pinhole_from_projection(k[f"{side}_projection"], k["width"],
                                                 k["height"], device=dev)
                         for side in ("left", "right")))
    return p, cam


@pytest.mark.gpu
def test_scheduled_product_equals_the_plain_version_on_a_segment():
    """K5 on a 128 x 4,096 segment, in the caller's (random) order with the
    schedule the wrapper makes, and in ``landmark_order``'s order with a
    schedule made once and kept: each within ``SCHUR_TOL`` of the plain
    version and, as ``chip_smoke.py`` holds K5, ``S``, ``rhs`` and ``W`` no
    further from float64 than the plain float32 version (twice its error,
    or 1e-5); the ordered one's schedule listing under 15 % of the
    products; the same bits twice."""
    dev = _card()
    p, cam = _segment(dev, 4096, 2**33 + 19)
    fx, fy, cx, cy, bq = ba._intrinsics(cam)
    kw = dict(fx=fx, fy=fy, cx=cx, cy=cy, bq=bq, kernel_px2=10.0, point_damping=1e-6)
    perm, _ = ba_kernel.landmark_order(p.mask)
    for order in (None, perm):
        X, obs, ow = p.X, p.obs, p.mask.float()
        schedule = None
        if order is not None:
            X, obs, ow = X[order], obs[:, order], ow[:, order]
            schedule = ba_kernel.schur_schedule(ow)
            live = int(schedule.live)
            total = schedule.tiling.n_tiles * schedule.tiling.n_slabs
            assert 0 < live < 0.15 * total, (live, total)
        got = [t.clone() for t in ba_kernel.schur_assemble_tiled(
            p.T, X, obs, ow, 1e-3, **kw, schedule=schedule)]
        again = ba_kernel.schur_assemble_tiled(p.T, X, obs, ow, 1e-3, **kw, schedule=schedule)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        want32 = ba_kernel.schur_assemble_tiled_plain(p.T, X, obs, ow, 1e-3, **kw)
        want64 = ba_kernel.schur_assemble_tiled_plain(
            *(t.double() for t in (p.T, X, obs, ow)), 1e-3, **kw)
        for nm, err in ba_kernel.schur_errors(got, want32).items():
            assert err < ba_kernel.SCHUR_TOL[nm], (order is not None, nm, err)
        kernel64 = ba_kernel.schur_errors(got, want64)
        plain64 = ba_kernel.schur_errors(want32, want64)
        for nm in ("S", "rhs", "W"):
            assert kernel64[nm] <= max(2 * plain64[nm], 1e-5), (nm, kernel64, plain64)


@pytest.mark.gpu
def test_kernel_route_orders_a_shuffled_segment():
    """``bundle_adjust`` on K5 (the segment cells' route) over a 128 x 4,096
    segment and over the same segment with its landmarks shuffled: one
    ordered solve and one schedule each, under 15 % of the (group pair,
    slab) products live, the landmarks returned in the caller's order, the
    same bits from the same input twice, and the two solves within a tenth
    of the segment cells' limits of each other (the program met those
    limits against float64 with ~100x to spare, ``PERF.md`` section 6)."""
    import numpy as np

    from portbench.reference import compare

    dev = _card()
    p, cam = _segment(dev, 4096, 2**33 + 23)
    shuffle = torch.randperm(4096, generator=torch.Generator().manual_seed(5)).to(dev)
    back = torch.argsort(shuffle)

    def solve(X, obs, mask):
        return ba.bundle_adjust(p.T, X, obs, mask, cam, p.fix, odo_M=p.odo_M,
                                odo_w=p.odo_w, max_iterations=10,
                                min_rel_improvement=0.0, device=dev)

    ba.reset_schur_schedule_counts()
    plain = solve(p.X, p.obs, p.mask)
    counts = ba.schur_schedule_counts()
    shuffled = solve(p.X[shuffle], p.obs[:, shuffle], p.mask[:, shuffle])
    again = solve(p.X[shuffle], p.obs[:, shuffle], p.mask[:, shuffle])
    assert counts["solves_ordered"] == 1
    assert counts["total_products"] == 36 * 256
    assert 0 < counts["live_products"] < 0.15 * counts["total_products"], counts
    assert ba.schur_schedule_counts()["solves_ordered"] == 3
    for f in FIELDS:
        assert torch.equal(getattr(shuffled, f), getattr(again, f)), f

    def answer(r, X):
        return dict(T=r.T_wc.double().cpu().numpy(), X=X.double().cpu().numpy(),
                    chi2=float(r.chi2_final), iterations=int(r.iterations))

    a = answer(plain, plain.points_w)
    b = answer(shuffled, shuffled.points_w[back])
    gaps = compare.numbers(b, a)
    limits = dict(iterations_gap=0, centre_gap_m=0.005, rotation_gap_rad=1e-5,
                  landmark_gap_m=0.02, chi2_gap=1e-5)
    assert all(gaps[n] <= v for n, v in limits.items()), gaps
    # the landmarks are the caller's: close to where the caller's started
    moved = np.linalg.norm(a["X"] - p.X.double().cpu().numpy(), axis=1)
    assert np.median(moved) < 1.0
