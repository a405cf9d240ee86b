"""Package-level rules of the port: it imports no JAX, its entry points do
not carry on on the CPU by themselves, and a kernel wrapper given a CPU
tensor takes its plain version."""

import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import svi_mapper_tpu_torch
from svi_mapper_tpu_torch import config
from svi_mapper_tpu_torch.utils.device import resolve_device
from svi_mapper_tpu_torch.utils.errors import ParameterError

REPO = Path(__file__).resolve().parent.parent
MODULES = sorted(
    m.name for m in pkgutil.walk_packages(svi_mapper_tpu_torch.__path__,
                                          "svi_mapper_tpu_torch."))


def test_module_layout_mirrors_the_jax_package():
    expected = {
        "config", "convert", "geometry.se3", "geometry.linalg", "geometry.camera",
        "ops.image", "ops.descriptors", "ops.corners", "ops.hamming",
        "ops.track_kernel", "ops.stereo_kernel", "mapping.landmarks",
        "frontend.epipolar", "frontend.tracking", "frontend.stereo",
        "frontend.recovery", "solvers.posit", "solvers.landmark_opt",
        "models.frame", "models.tracker", "io.synthetic", "utils.errors",
        "ops.ba_kernel", "solvers.ba", "solvers.ba_prep", "solvers.pose_graph",
        "solvers.icp", "mapping.bitstats", "mapping.vocabulary",
        "mapping.closure", "models.slam", "io.g2o_export", "ops.paths",
        "imu.interpolator", "io.euroc", "io.kitti", "eval.trajectory", "models.svi",
        "tools.run_euroc", "geometry.triangulation", "io.cloud", "io.checkpoint",
        "io.stress", "eval.timing", "eval.stage_bench", "utils.faults", "utils.loggers",
        "native.build", "tools.make_dump", "tools.validate_dataset",
        "tools.republish_stream", "tools.create_cloud", "tools.match_clouds",
        "tools.bench_matching", "tools.run_kitti", "tools.acceptance", "run_demo",
        "tools.evaluate_trajectory", "tools.align_trajectory",
        "tools.interpolate_trajectory", "tools.triangulation_sampling",
        "tools.compute_descriptors", "tools.create_vocabulary", "tools.view_map",
        "tools.validate_kernels", "tools.bench_scaling", "eval.viewer",
        "eval.utilization", "parallel", "parallel.mesh", "parallel.distributed",
        "parallel.sharded_ba",
    }
    have = {m.removeprefix("svi_mapper_tpu_torch.") for m in MODULES}
    assert expected <= have
    # every module of the JAX package has its twin (the kernel validator
    # under the name of what it validates here)
    renamed = {"tools.validate_tpu_kernels": "tools.validate_kernels"}
    jax_modules = {
        ".".join(p.relative_to(REPO / "svi_mapper_tpu").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (REPO / "svi_mapper_tpu").rglob("*.py")} - {"__init__"}
    missing = {renamed.get(m, m) for m in jax_modules} - have
    assert not missing, sorted(missing)
    for name in expected - {"convert", "tools.validate_kernels", "parallel"}:
        assert (REPO / "svi_mapper_tpu" / (name.replace(".", "/") + ".py")).exists(), name
    assert "native" in have                        # the package, as in the JAX one
    native_src = sorted(p.name for p in (REPO / "svi_mapper_tpu_torch" / "native" / "src").iterdir())
    assert native_src == sorted(p.name for p in (REPO / "svi_mapper_tpu" / "native" / "src").iterdir())
    sources = sorted(p.name for p in (REPO / "svi_mapper_tpu_torch" / "csrc").glob("*.cu"))
    assert sources == ["brief_dense.cu", "hamming_matrix.cu", "observed_walk.cu",
                       "schur_assemble.cu", "stereo_profiles.cu", "track_scores.cu"]


def _public_names(root: Path) -> dict:
    """Per module (dotted, relative to ``root``): the public top-level
    ``def`` / ``class`` names, and ``Class.method`` for every public method
    of a public class, read from the source with ``ast``."""
    import ast

    out = {}
    for path in sorted(root.rglob("*.py")):
        mod = ".".join(path.relative_to(root).with_suffix("").parts).removesuffix(".__init__")
        names = out.setdefault(mod, set())
        for node in ast.parse(path.read_text()).body:
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
                    and not node.name.startswith("_")):
                names.add(node.name)
                if isinstance(node, ast.ClassDef):
                    names |= {f"{node.name}.{sub.name}" for sub in node.body
                              if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                              and not sub.name.startswith("_")}
    return out


def test_public_names_mirror_the_jax_package():
    """Every public function, class and method of the JAX package has its
    twin under the same name in the port's twin module, but for the decided
    differences: K6's Pallas entry is ported as ``hamming_distance_matrix``;
    the native build's staleness test is replaced by the source hash (F14);
    ``PinholeCamera``'s intrinsics are float fields in the port, not array
    properties; the port's ``frontend/tracking.py`` imports ``tier_scores``
    and ``window_scores`` from ``ops/track_kernel.py`` instead of defining
    them."""
    decided = {
        "ops.hamming": {"hamming_pallas"},
        "native.build": {"is_stale"},
        "geometry.camera": {f"PinholeCamera.{k}" for k in ("fx", "fy", "cx", "cy")},
        "frontend.tracking": {"tier_scores", "window_scores"},
    }
    renamed = {"tools.validate_tpu_kernels": "tools.validate_kernels"}
    jax_names = _public_names(REPO / "svi_mapper_tpu")
    port_names = _public_names(REPO / "svi_mapper_tpu_torch")
    missing = {mod: sorted(names - port_names.get(renamed.get(mod, mod), set()))
               for mod, names in jax_names.items()}
    missing = {mod: names for mod, names in missing.items() if names}
    assert missing == {mod: sorted(names) for mod, names in decided.items()}
    from svi_mapper_tpu_torch.frontend import tracking
    from svi_mapper_tpu_torch.ops import track_kernel

    assert tracking.tier_scores is track_kernel.tier_scores
    assert tracking.window_scores is track_kernel.window_scores


def test_importing_every_module_leaves_jax_out():
    """In a fresh interpreter: import every module of the port (and
    chip_smoke.py's imports) and look at sys.modules. The dataset readers'
    PyYAML, cv2 and PIL are blocked there: the package imports without
    them (a machine that runs the port on a GPU need not have them)."""
    code = textwrap.dedent(f"""
        import importlib, sys
        for blocked in ("yaml", "cv2", "PIL"):
            sys.modules[blocked] = None        # an import of it raises
        for name in {MODULES!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "svi_mapper_tpu"))
        assert not bad, bad
        assert "triton" not in sys.modules
        print("clean", len({MODULES!r}))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, text=True,
                         capture_output=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("clean")


def test_sources_name_no_jax_import():
    files = (list((REPO / "svi_mapper_tpu_torch").rglob("*.py"))
             + [REPO / "chip_smoke.py", REPO / "mutation_check.py"])
    assert len(files) > 20
    for path in files:
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                head = s.split()[1].split(".")[0]
                assert head not in ("jax", "jaxlib", "flax", "svi_mapper_tpu"), (path, s)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check is about a machine without a CUDA device")


def test_entry_points_raise_without_device():
    """``device=None`` means CUDA: with no CUDA device every entry point
    raises instead of running on the CPU."""
    _no_cuda()
    from svi_mapper_tpu_torch.io.synthetic import default_camera
    from svi_mapper_tpu_torch.mapping.landmarks import make_table
    from svi_mapper_tpu_torch.models import frame
    from svi_mapper_tpu_torch.models.tracker import StereoTracker

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        config.load_stereo_camera("kitti_00_camera_left.txt", "kitti_00_camera_right.txt")
    with pytest.raises(RuntimeError):
        frame.init_state(config.DEFAULT_PARAMS)
    with pytest.raises(RuntimeError):
        make_table(8, 4)
    with pytest.raises(RuntimeError):
        default_camera()
    cam = default_camera(128, 64, device="cpu")
    with pytest.raises(RuntimeError):
        StereoTracker(cam)
    state = frame.init_state(config.DEFAULT_PARAMS, device="cpu")
    img = np.zeros((64, 128), np.float32)
    with pytest.raises(RuntimeError):
        frame.process_frame(state, img, img, cam, config.DEFAULT_PARAMS)
    with pytest.raises(RuntimeError):
        frame.process_chunk(state, img[None], img[None], cam, config.DEFAULT_PARAMS)


def test_svi_entry_points_raise_without_device(tmp_path):
    """The stereo-inertial slice's entry points under the same rule."""
    _no_cuda()
    from svi_mapper_tpu_torch.imu import interpolator as imu
    from svi_mapper_tpu_torch.io import euroc, kitti
    from svi_mapper_tpu_torch.io.synthetic import default_camera
    from svi_mapper_tpu_torch.models import frame
    from svi_mapper_tpu_torch.models.svi import StereoInertialTracker

    cam = default_camera(128, 64, device="cpu")
    calib = imu.ImuCalibration(np.eye(3), np.zeros(3), np.zeros(3), np.zeros(3),
                               np.zeros(3), 1)
    state = frame.init_state(config.DEFAULT_PARAMS, device="cpu")
    img = np.zeros((64, 128), np.float32)
    z3, z = torch.zeros(3), torch.zeros(4)
    calls = [
        lambda: StereoInertialTracker(cam, calib),
        lambda: imu.calibrate(np.zeros((4, 3)), np.ones((4, 3))),
        lambda: imu.synthesize_measurements(np.tile(np.eye(4), (3, 1, 1)), 0.05),
        lambda: frame.process_frame_svi(state, img, img, cam, config.DEFAULT_PARAMS, z,
                                        torch.zeros(4, 3), torch.zeros(4, 3),
                                        z.bool(), z3, torch.eye(3), z3, z3),
        lambda: frame.process_chunk_svi(state, img[None], img[None], cam,
                                        config.DEFAULT_PARAMS, z[None],
                                        torch.zeros(1, 4, 3), torch.zeros(1, 4, 3),
                                        z.bool()[None], z3, torch.eye(3), z3, z3),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    seq_dir = tmp_path / "sequences" / "00" / "image_0"
    seq_dir.mkdir(parents=True)
    (tmp_path / "sequences" / "00" / "image_1").mkdir()
    from PIL import Image

    for d in ("image_0", "image_1"):
        Image.fromarray(np.zeros((8, 8), np.uint8)).save(
            tmp_path / "sequences" / "00" / d / "000000.png")
    with pytest.raises(RuntimeError, match="CUDA"):
        kitti.KittiSequence(tmp_path, "00")
    assert kitti.KittiSequence(tmp_path, "00", device="cpu").cam.device.type == "cpu"
    assert euroc.EurocSequence.__init__.__defaults__[-1] is None


def test_map_optimisation_entry_points_raise_without_device(rng):
    """The same rule for the solvers of the map-optimisation slice and the
    vocabulary: CPU tensors do not make them run on the CPU by themselves."""
    _no_cuda()
    from svi_mapper_tpu_torch import convert
    from svi_mapper_tpu_torch.io.synthetic import default_camera
    from svi_mapper_tpu_torch.mapping import vocabulary
    from svi_mapper_tpu_torch.solvers import ba, ba_prep, icp, pose_graph

    cam = default_camera(128, 64, device="cpu")
    T = torch.eye(4).repeat(3, 1, 1)
    X = torch.rand(5, 3) + torch.tensor([0.0, 0.0, 4.0])
    obs, mask = torch.zeros(3, 5, 4), torch.ones(3, 5, dtype=torch.bool)
    fix = torch.tensor([True, False, False])
    edges_np = dict(i=[0, 1], j=[1, 2], T_ij=np.tile(np.eye(4), (2, 1, 1)),
                    weight=[1.0, 1.0], valid=[True, True])
    edges = convert.pose_graph_edges_from_numpy(edges_np, device="cpu")
    desc = rng.integers(0, 2 ** 32, (64, 8), dtype=np.uint64).astype(np.uint32)
    calls = [
        lambda: ba.bundle_adjust(T, X, obs, mask, cam, fix),
        lambda: ba.reprojection_stats(T, X, obs, mask, cam),
        lambda: ba_prep.prepare_ba_window(T, obs, mask, X, cam),
        lambda: pose_graph.optimize_pose_graph(T, edges, fix),
        lambda: pose_graph.make_edges(4),
        lambda: icp.align_clouds(X, X, torch.ones(5, dtype=torch.bool)),
        lambda: icp.align_clouds_batch(X[None], X[None], torch.ones(1, 5, dtype=torch.bool)),
        lambda: vocabulary.build_vocabulary(desc, k=2, levels=2),
        lambda: vocabulary.load_vocabulary("nowhere.npz"),
        lambda: convert.ba_problem_from_numpy({"T_wc": T.numpy()}),
        lambda: convert.pose_graph_edges_from_numpy(edges_np),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # and with device="cpu" they do run
    res = ba.bundle_adjust(T, X, obs, mask, cam, fix, max_iterations=1, device="cpu")
    assert res.T_wc.device.type == "cpu"


def test_tools_and_parallel_entry_points_raise_without_device(tmp_path, capsys):
    """The command-line tools take ``--device`` (default cuda, ``--cpu``
    the same as ``--device cpu``): with no CUDA device and no ``--cpu``
    each raises through ``resolve_device`` before it reads a file; the
    kernel validator validates nothing and exits non-zero. So do the
    utilization report and the multi-process layer's ``device=None``."""
    _no_cuda()
    import importlib

    from svi_mapper_tpu_torch.eval import utilization
    from svi_mapper_tpu_torch.parallel import distributed, mesh

    for module, argv in (("tools.run_kitti", [str(tmp_path)]),
                         ("tools.acceptance", [str(tmp_path)]),
                         ("run_demo", []),
                         ("tools.triangulation_sampling", []),
                         ("tools.compute_descriptors", [str(tmp_path)]),
                         ("tools.create_vocabulary", [str(tmp_path / "d.npz")]),
                         ("tools.bench_scaling", [])):
        main = importlib.import_module(f"svi_mapper_tpu_torch.{module}").main
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv + ["--device", "cuda"])
    from svi_mapper_tpu_torch.tools import validate_kernels

    assert validate_kernels.main([]) == 1
    capsys.readouterr()
    with pytest.raises(RuntimeError, match="CUDA"):
        utilization.utilization_report(160, 96)
    with pytest.raises(RuntimeError, match="CUDA"):
        utilization.analyze_stage(torch.matmul, (torch.ones(2, 2), torch.ones(2, 2)))
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.initialize("127.0.0.1:1", 1, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_map_mesh(1)


def test_device_mismatch_rejected():
    from svi_mapper_tpu_torch.io.synthetic import default_camera
    from svi_mapper_tpu_torch.models import frame

    assert resolve_device("cpu") == torch.device("cpu")
    cam = default_camera(128, 64, device="cpu")
    state = frame.init_state(config.DEFAULT_PARAMS, device="cpu")
    assert state.device == cam.device == torch.device("cpu")
    assert state.table.device.type == "cpu"


def test_wrappers_take_plain_version_on_cpu(rng):
    from svi_mapper_tpu_torch.ops import descriptors, stereo_kernel, track_kernel

    img = torch.from_numpy(rng.uniform(0, 255, (48, 80)).astype(np.float32))
    n0 = (descriptors.brief_dense_fused_launches, track_kernel.track_scores_launches,
          stereo_kernel.stereo_profiles_launches)
    fused = descriptors.brief_dense_fused(img)
    assert torch.equal(fused, descriptors.smooth_brief_dense_plain(img))
    assert torch.equal(fused, descriptors.smooth_brief_dense(img))
    assert fused.dtype == torch.int32 and fused.shape == (48, 80, 8)
    assert n0 == (descriptors.brief_dense_fused_launches,
                  track_kernel.track_scores_launches,
                  stereo_kernel.stereo_profiles_launches)
    with pytest.raises(ValueError):
        descriptors.brief_dense_fused(img.to(torch.float64))


def test_schur_wrappers_take_plain_version_on_cpu():
    from svi_mapper_tpu_torch.ops import ba_kernel
    from tests import torch_parity as tp

    w = tp.ba_window(K=32, L=40)
    args = (tp.t32(w["T"]), tp.t32(w["X"]), tp.t32(w["obs"]),
            tp.t32(w["mask"].astype(np.float32)))
    kw = dict(zip(("fx", "fy", "cx", "cy", "bq"), w["intr"]))
    n0 = (ba_kernel.schur_assemble_launches, ba_kernel.schur_assemble_tiled_launches)
    for fn, plain in ((ba_kernel.schur_assemble, ba_kernel.schur_assemble_plain),
                      (ba_kernel.schur_assemble_tiled, ba_kernel.schur_assemble_tiled_plain)):
        for a, b in zip(fn(*args, 1e-3, **kw), plain(*args, 1e-3, **kw)):
            assert torch.equal(a, b)
    assert n0 == (ba_kernel.schur_assemble_launches,
                  ba_kernel.schur_assemble_tiled_launches)
    # a 0-d tensor for lam is the same as the float
    for a, b in zip(ba_kernel.schur_assemble(*args, torch.tensor(1e-3), **kw),
                    ba_kernel.schur_assemble(*args, 1e-3, **kw)):
        assert torch.equal(a, b)


def test_closure_entry_points_raise_without_device(rng):
    """The closure slice keeps the rule: ``device=None`` means CUDA."""
    _no_cuda()
    from svi_mapper_tpu_torch import convert
    from svi_mapper_tpu_torch.io.synthetic import SyntheticSequence, default_camera
    from svi_mapper_tpu_torch.mapping.closure import KeyframeDatabase
    from svi_mapper_tpu_torch.models.slam import SLAMSystem

    cam = default_camera(128, 64, device="cpu")
    db = KeyframeDatabase.create(4, 8, device="cpu")
    calls = [
        lambda: KeyframeDatabase.create(4, 8),
        lambda: SLAMSystem(cam),
        lambda: SyntheticSequence(n_frames=2, trajectory="loop"),
        lambda: convert.keyframe_db_from_numpy(convert.keyframe_db_to_numpy(db)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert convert.keyframe_db_from_numpy(convert.keyframe_db_to_numpy(db),
                                          device="cpu").device.type == "cpu"


def test_left_out_options_raise_not_implemented():
    """No constructor option of the system raises NotImplementedError any
    more: each one runs, none is silently ignored (the native index exists
    or construction raises), and the one contradictory combination raises
    ValueError. Without a device the system raises for want of CUDA."""
    from svi_mapper_tpu_torch.io.synthetic import default_camera
    from svi_mapper_tpu_torch.mapping.closure import KeyframeDatabase
    from svi_mapper_tpu_torch.models.slam import SLAMSystem

    cam = default_camera(128, 64, device="cpu")
    for kw, attr in ((dict(async_closure=True), "_closure_pool"),
                     (dict(overlap_backend="force"), "_bk_pool")):
        s = SLAMSystem(cam, device="cpu", **kw)
        assert getattr(s, attr) is not None
        s.close()
        assert getattr(s, attr) is None
    s = SLAMSystem(cam, device="cpu", native_index=True)
    assert s.db.index is not None
    assert KeyframeDatabase.create(4, 8, native_index=True, device="cpu").index is not None
    with pytest.raises(ValueError, match="subsumed"):
        SLAMSystem(cam, device="cpu", async_closure=True, overlap_backend=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SLAMSystem(cam, async_closure=True)


def test_kernel_paths_report():
    """The port's path report names real call sites and reads the launch
    counters of the six kernels' eight entries."""
    from svi_mapper_tpu_torch.ops import hamming, paths

    report = paths.kernel_paths(device="cpu")
    assert report["closure_pool_counts"] == "torch:pool_nn_counts_plain"
    assert report["stereo"] == "torch:stereo_match_plain"
    assert report["ba_schur_K8"] == "torch:materialised"
    on_card = paths.kernel_paths((8, 40, 64, 256), device="cuda")   # by shape only
    assert on_card["closure_match_exact"] == "cuda:hamming_matrix"
    assert on_card["closure_pool_counts"] == "cuda:pool_nn_counts"
    assert on_card["stereo"] == "cuda:stereo_match"
    assert on_card["ba_schur_K8"] == "cuda:schur_assemble"
    assert on_card["ba_schur_K64"] == "cuda:schur_assemble_tiled"
    assert on_card["ba_schur_K40"] == "torch:materialised"
    assert on_card["ba_schur_K256"] == "torch:observation_list"
    assert set(report["launches"]) == {
        "track_scores", "stereo_profiles", "stereo_match", "brief_dense_fused",
        "schur_assemble", "schur_assemble_tiled", "hamming_matrix", "pool_nn_counts",
        "observed_chi2", "observed_update"}
    hamming.hamming_matrix_launches = 3
    assert paths.launch_counts()["hamming_matrix"] == 3
    paths.reset_launch_counts()
    assert sum(paths.launch_counts().values()) == 0


def test_launch_counts_from_two_threads_sum_exactly():
    """The closure and back-end workers launch K4-K6 from their own threads
    while the tracker launches K1-K3: every wrapper counts through
    ``paths.count_launch``, under one lock, so concurrent launches from two
    threads sum exactly, and each thread's tally is kept apart."""
    import inspect
    import threading

    from svi_mapper_tpu_torch.ops import (
        ba_kernel,
        descriptors,
        hamming,
        observed_walk,
        paths,
        stereo_kernel,
        track_kernel,
    )

    for mod in (ba_kernel, descriptors, hamming, observed_walk, stereo_kernel, track_kernel):
        src = inspect.getsource(mod)
        assert "_launches +=" not in src and "paths.count_launch(__name__" in src
    paths.reset_launch_counts()
    n = 20000

    def launch(entries):
        for _ in range(n):
            for mod, entry in entries:
                paths.count_launch(mod.__name__, entry)

    workers = [threading.Thread(target=launch, name=name, args=(entries,))
               for name, entries in (
                   ("tracker", [(track_kernel, "track_scores"),
                                (hamming, "pool_nn_counts")]),
                   ("backend_0", [(ba_kernel, "schur_assemble"),
                                  (hamming, "pool_nn_counts")]))]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    counts = paths.launch_counts()
    assert counts["pool_nn_counts"] == 2 * n
    assert counts["track_scores"] == counts["schur_assemble"] == n
    assert paths.launch_counts_by_thread() == {
        "tracker": {"track_scores": n, "pool_nn_counts": n},
        "backend_0": {"schur_assemble": n, "pool_nn_counts": n}}
    paths.reset_launch_counts()
    assert sum(paths.launch_counts().values()) == 0
    assert paths.launch_counts_by_thread() == {}


def test_fp32_matmul_guard():
    """Nothing flips TF32; the guard only looks at CUDA tensors."""
    from svi_mapper_tpu_torch.utils.device import require_fp32_matmul

    assert torch.backends.cuda.matmul.allow_tf32 is False
    require_fp32_matmul(torch.zeros(2))


def test_kernel_build_needs_a_compiler():
    """Nothing hides a missing toolchain: loading the kernels without nvcc
    raises (and never falls back)."""
    from svi_mapper_tpu_torch.ops import cuda_build

    import shutil
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA compiler is installed here")
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.load_library()
    assert [p.name for p in cuda_build.sources()] == [
        "brief_dense.cu", "hamming_matrix.cu", "observed_walk.cu", "schur_assemble.cu",
        "stereo_profiles.cu", "track_scores.cu"]
    assert set(cuda_build._SIGNATURES) == {
        "svi_track_scores", "svi_stereo_profiles", "svi_stereo_match",
        "svi_brief_dense_fused", "svi_schur_system", "svi_hamming_matrix",
        "svi_pool_nn_counts", "svi_observed_chi2", "svi_observed_update"}
    # each exported name is defined, with as many parameters, in a source
    import re
    text = "".join(p.read_text() for p in cuda_build.sources())
    for name, argtypes in cuda_build._SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes), name


def test_calibration_parser_matches_jax_package():
    from svi_mapper_tpu import config as jconfig

    for stem in ("kitti_00_camera", "kitti_11_12_camera", "vi_sensor_camera"):
        for side in ("left", "right"):
            name = f"{stem}_{side}.txt"
            a = config.load_camera_calibration(name)
            b = jconfig.load_camera_calibration(name)
            assert (a.width, a.height, a.has_imu) == (b.width, b.height, b.has_imu)
            for f in ("K", "dist", "R_rect", "P"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    cam = config.load_stereo_camera("kitti_00_camera_left.txt",
                                    "kitti_00_camera_right.txt", device="cpu")
    jcam = jconfig.load_stereo_camera("kitti_00_camera_left.txt",
                                      "kitti_00_camera_right.txt")
    np.testing.assert_array_equal(cam.right.P.numpy(), np.asarray(jcam.right.P))
    assert (cam.width, cam.height) == (1241, 376)
    assert cam.baseline == pytest.approx(float(jcam.baseline), abs=1e-7)
    assert config.DEFAULT_PARAMS == config.TrackingParams()
    import dataclasses
    assert dataclasses.asdict(config.DEFAULT_PARAMS) == dataclasses.asdict(
        jconfig.DEFAULT_PARAMS)


def test_calibration_errors(tmp_path):
    with pytest.raises(ParameterError):
        config.load_camera_calibration(tmp_path / "missing.txt")
    bad = tmp_path / "bad.txt"
    bad.write_text("uWidthPixels 10\nuHeightPixels 10\n")
    with pytest.raises(ParameterError):
        config.load_camera_calibration(bad)
