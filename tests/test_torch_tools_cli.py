"""The port's command-line tools against the JAX package's: run_kitti,
run_demo, acceptance, compute_descriptors, create_vocabulary, the
trajectory CLIs, triangulation_sampling and validate_kernels, all driven in
process through ``main(argv)`` on the CPU. The JAX tools run in process too
(``sys.argv`` set, their output read from ``capsys``), on the same files.
"""

import ast
import re
import sys

import cv2
import jax
import numpy as np
import pytest
import torch

from svi_mapper_tpu.io import synthetic as jsyn

import torch_parity  # noqa: F401  (thread count for the parallel suite)

FRAMES = 12
STEP = 1.0          # metres a frame: keyframes within FRAMES


def run_jax(capsys, module: str, argv: list[str]) -> tuple[int, str]:
    """A JAX tool's ``main()`` with ``argv``: (exit code, stdout)."""
    import importlib

    main = importlib.import_module(f"svi_mapper_tpu.{module}").main
    old = sys.argv
    sys.argv = [module] + argv
    code = 0
    try:
        ret = main()
        code = ret or 0
    except SystemExit as e:
        code = e.code or 0
    finally:
        sys.argv = old
    return code, capsys.readouterr().out


def run_port(capsys, module: str, argv: list[str]) -> tuple[int, str]:
    """The port's tool ``main(argv)``: (exit code, stdout)."""
    import importlib

    main = importlib.import_module(f"svi_mapper_tpu_torch.{module}").main
    code = 0
    try:
        code = main(argv) or 0
    except SystemExit as e:
        code = e.code or 0
    return code, capsys.readouterr().out


def write_kitti_tree(root, frames, cam_P, poses_wc, times):
    """A KITTI odometry tree: 8-bit PNGs, times.txt, calib.txt, poses/00.txt
    (camera->world)."""
    seq = root / "sequences" / "00"
    for d in ("image_0", "image_1"):
        (seq / d).mkdir(parents=True, exist_ok=True)
    for i, (L, R) in enumerate(frames):
        for d, img in (("image_0", L), ("image_1", R)):
            cv2.imwrite(str(seq / d / f"{i:06d}.png"),
                        np.clip(np.round(np.asarray(img)), 0, 255).astype(np.uint8))
    (seq / "times.txt").write_text("\n".join(f"{t:.6f}" for t in times) + "\n")
    (seq / "calib.txt").write_text("".join(
        f"P{k}: " + " ".join(f"{x:.6f}" for x in np.asarray(P).reshape(-1)) + "\n"
        for k, P in enumerate(cam_P)))
    (root / "poses").mkdir(exist_ok=True)
    (root / "poses" / "00.txt").write_text("".join(
        " ".join(f"{x:.9e}" for x in np.linalg.inv(T)[:3].reshape(-1)) + "\n"
        for T in poses_wc))


@pytest.fixture(scope="module")
def kitti_tree(tmp_path_factory):
    """The corridor at 512 x 256, rendered once by the JAX package."""
    root = tmp_path_factory.mktemp("kitti")
    seq = jsyn.SyntheticSequence(FRAMES, 512, 256, step=STEP)
    frames = [(L, R) for (L, R, _) in seq]
    write_kitti_tree(root, frames, (seq.cam.left.P, seq.cam.right.P),
                     np.asarray(seq.poses_wc, np.float64), 0.1 * np.arange(FRAMES))
    return root


def keyframe_column(log_dir) -> list[int]:
    lines = (log_dir / "odometry_optimization.txt").read_text().splitlines()
    return [int(re.search(r"keyframe=(\d)", ln).group(1)) for ln in lines]


def test_run_kitti_keyframes_match_jax(kitti_tree, tmp_path, capsys):
    """``run_kitti --cpu --gt``: per frame, the same keyframe decisions as
    the JAX tool on the same tree (the port's run in its chunked mode,
    which steps the frames as the per-frame mode does)."""
    argv = [str(kitti_tree), "--cpu", "--gt", "--frames", str(FRAMES)]
    code, jout = run_jax(capsys, "tools.run_kitti", argv + ["--log-dir", str(tmp_path / "j")])
    assert code == 0, jout
    code, tout = run_port(capsys, "tools.run_kitti", argv + [
        "--chunk", "4", "--log-dir", str(tmp_path / "t"), "--save", str(tmp_path / "t.txt")])
    assert code == 0, tout
    kj, kt = keyframe_column(tmp_path / "j"), keyframe_column(tmp_path / "t")
    assert len(kj) == len(kt) == FRAMES
    assert kj == kt and sum(kj) >= 2, (kj, kt)
    assert "ATE RMSE: 0.000 m" in tout and "ATE RMSE: 0.000 m" in jout
    assert np.loadtxt(tmp_path / "t.txt").shape == (FRAMES, 12)


def demo_lines(out: str) -> list[str]:
    return [ln for ln in out.splitlines() if ln.startswith("[")]


def test_run_demo_matches_jax(capsys):
    """``run_demo --cpu --gt --slam``: the same keyframe decisions frame by
    frame and the same SLAM stats (keyframes, closures found and accepted,
    BA and pose-graph runs) as the JAX tool, the systems given the pose as
    ``tests/test_torch_slam.py`` gives it."""
    argv = ["--cpu", "--gt", "--slam", "--frames", str(FRAMES), "--step", str(STEP)]
    code, jout = run_jax(capsys, "run_demo", argv)
    assert code == 0, jout
    code, tout = run_port(capsys, "run_demo", argv)
    assert code == 0, tout
    kf = lambda out: [ln.split("kf=")[1] for ln in demo_lines(out)]  # noqa: E731
    assert len(demo_lines(tout)) == FRAMES
    assert kf(jout) == kf(tout)
    count = lambda out: re.search(r"keyframes: (\d+)", out).group(1)  # noqa: E731
    assert count(jout) == count(tout) and int(count(tout)) >= 2
    stats = lambda out: ast.literal_eval(  # noqa: E731
        re.search(r"SLAM stats: (\{.*\})", out).group(1))
    sj, st = stats(jout), stats(tout)
    for key in ("closures_found", "closures_accepted", "ba_runs", "pose_graph_runs"):
        assert sj[key] == st[key], (key, sj, st)
    assert "OPTIMIZED ATE RMSE" in tout


def acceptance_tree(root):
    """The JAX package's acceptance test tree (``tests/test_tools.py``): 6
    frames of a shifted noise texture at 160 x 64."""
    rng = np.random.default_rng(3)
    seq_dir = root / "sequences" / "00"
    (seq_dir / "image_0").mkdir(parents=True)
    (seq_dir / "image_1").mkdir(parents=True)
    n = 6
    base = (rng.random((64, 160)) * 255).astype(np.uint8)
    for i in range(n):
        img = np.roll(base, -3 * i, axis=1)
        cv2.imwrite(str(seq_dir / "image_0" / f"{i:06d}.png"), img)
        cv2.imwrite(str(seq_dir / "image_1" / f"{i:06d}.png"), np.roll(img, 5, axis=1))
    (seq_dir / "times.txt").write_text("\n".join(str(0.1 * i) for i in range(n)) + "\n")
    (seq_dir / "calib.txt").write_text(
        "P0: 100 0 80 0 0 100 32 0 0 0 1 0\n"
        "P1: 100 0 80 -54 0 100 32 0 0 0 1 0\n")
    poses = root / "poses"
    poses.mkdir()
    lines = []
    for i in range(n):
        T = np.eye(4)
        T[2, 3] = 0.3 * i
        lines.append(" ".join(str(x) for x in T[:3].reshape(-1)))
    (poses / "00.txt").write_text("\n".join(lines) + "\n")


def table_rows(out: str) -> list[tuple[str, str]]:
    """(PASS/FAIL, check name) of each row of the acceptance table."""
    return re.findall(r"^\s+\[(PASS|FAIL)\] (.{14})", out, re.M)


@pytest.mark.parametrize("closures, code, verdict", [("0", 0, "PASSED"), ("99", 1, "FAILED")])
def test_acceptance_gate_sets(tmp_path, capsys, closures, code, verdict):
    """The JAX test's two gate sets: permissive gates pass (exit 0), an
    unreachable closure gate fails (exit 1); the table rows (name and
    verdict) are the JAX tool's on the same tree."""
    acceptance_tree(tmp_path)
    argv = [str(tmp_path), "--cpu", "--min-closures", closures, "--min-fps", "0",
            "--max-ate", "1e9", "--max-rel", "1e9", "--chunk", "3", "--landmarks", "128"]
    tcode, tout = run_port(capsys, "tools.acceptance", argv + ["--save", str(tmp_path / "t.txt")])
    assert tcode == code, tout
    assert f"ACCEPTANCE {verdict}" in tout
    jcode, jout = run_jax(capsys, "tools.acceptance", argv)
    assert jcode == code, jout
    assert table_rows(tout) == table_rows(jout)
    assert [r[1].strip() for r in table_rows(tout)] == [
        "throughput", "loop closures", "ATE RMSE", "rel trans err", "rot err"]
    assert np.loadtxt(tmp_path / "t.txt").shape == (6, 12)


def smooth_images(root, n=2):
    """The JAX test's images: a twice 5x5-box-smoothed noise field at
    96 x 128, scaled to 8 bits, shifted 5 px per image."""
    root.mkdir()
    rng = np.random.default_rng(0)
    base = rng.random((96, 128)).astype(np.float32)
    k = np.ones((5, 5)) / 25.0
    for _ in range(2):
        base = np.pad(base, 2, mode="edge")
        base = sum(base[i:i + 96, j:j + 128] * k[i, j] for i in range(5) for j in range(5))
    base = (255 * (base - base.min()) / (base.max() - base.min())).astype(np.uint8)
    for i in range(n):
        cv2.imwrite(str(root / f"im{i}.png"), np.roll(base, 5 * i, axis=1))


def test_compute_descriptors_and_vocabulary_match_jax(tmp_path, capsys):
    """``compute_descriptors``: bit for bit the JAX functions run op by op
    (``jax.disable_jit()``); against the JAX tool, which compiles them as one
    program, the keypoints agree and the descriptor words differ only in
    the share F13 explains (the fused blur decides BRIEF ties on 8-bit
    images). ``create_vocabulary`` on the port's dump: the JAX tool's words
    and weights."""
    from svi_mapper_tpu.io.kitti import _read_image
    from svi_mapper_tpu.ops.corners import detect_corners
    from svi_mapper_tpu.ops.descriptors import brief_descriptors
    from svi_mapper_tpu.ops.image import gaussian_blur

    imgs = tmp_path / "imgs"
    smooth_images(imgs)
    port_npz, jax_npz = tmp_path / "t.npz", tmp_path / "j.npz"
    code, out = run_port(capsys, "tools.compute_descriptors",
                         [str(imgs), "-o", str(port_npz), "--cpu", "--max-per-image", "64"])
    assert code == 0, out
    t = np.load(port_npz)
    assert t["desc"].dtype == np.uint32 and len(t["desc"]) > 16

    desc, uv, doc = [], [], []
    with jax.disable_jit():
        for i, p in enumerate(sorted(imgs.iterdir())):
            smooth = gaussian_blur(jax.numpy.asarray(_read_image(p), jax.numpy.float32))
            u, _, v = detect_corners(smooth, k=64, quality=0.01)
            d = brief_descriptors(smooth, u)
            v = np.asarray(v)
            desc.append(np.asarray(d)[v])
            uv.append(np.asarray(u)[v])
            doc.append(np.full(int(v.sum()), i, np.int32))
    np.testing.assert_array_equal(t["desc"], np.concatenate(desc))
    np.testing.assert_array_equal(t["uv"], np.concatenate(uv))
    np.testing.assert_array_equal(t["doc_ids"], np.concatenate(doc))
    assert list(t["names"]) == ["im0.png", "im1.png"]

    code, out = run_jax(capsys, "tools.compute_descriptors",
                        [str(imgs), "-o", str(jax_npz), "--cpu", "--max-per-image", "64"])
    assert code == 0, out
    j = np.load(jax_npz)
    np.testing.assert_array_equal(t["uv"], j["uv"])
    share = float((t["desc"] != j["desc"]).mean())
    print(f"compute_descriptors: {share:.4f} of the words differ from the JAX tool's (F13)")
    assert share <= 0.05          # F13: ~5 % of the words of 8-bit frames

    voc_t, voc_j = tmp_path / "vt.npz", tmp_path / "vj.npz"
    vargs = ["--cpu", "--k", "3", "--levels", "2", "--iters", "3"]
    code, out = run_port(capsys, "tools.create_vocabulary",
                         [str(port_npz), "-o", str(voc_t)] + vargs)
    assert code == 0, out
    code, out = run_jax(capsys, "tools.create_vocabulary",
                        [str(port_npz), "-o", str(voc_j)] + vargs)
    assert code == 0, out
    a, b = np.load(voc_t), np.load(voc_j)
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _numbers(out: str) -> list[float]:
    return [float(x) for x in re.findall(r"-?\d+\.\d+(?:e[-+]?\d+)?", out)]


def _arc(n, step=1.0, turn=0.05):
    """World->camera transforms along an arc (``tests/test_tools.py``)."""
    T, P = [], np.eye(4)
    c, s = np.cos(turn), np.sin(turn)
    for _ in range(n):
        P = P @ np.array([[c, -s, 0, step], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1.0]])
        T.append(np.linalg.inv(P))
    return np.stack(T)


def test_trajectory_clis_match_jax(tmp_path, capsys):
    """evaluate / align / interpolate: the JAX tools' printed numbers to
    1e-6 and their written files."""
    from svi_mapper_tpu.eval import trajectory as jev

    gt = _arc(20)
    G = np.eye(4)
    G[:3, :3] = [[np.cos(0.7), -np.sin(0.7), 0], [np.sin(0.7), np.cos(0.7), 0], [0, 0, 1]]
    G[:3, 3] = [5, -3, 2]
    rng = np.random.default_rng(4)
    est = np.einsum("nij,jk->nik", gt, np.linalg.inv(G))
    est[:, :3, 3] += rng.normal(0, 0.05, (20, 3))
    jev.save_kitti_trajectory(tmp_path / "est.txt", est)
    jev.save_kitti_trajectory(tmp_path / "gt.txt", gt)
    np.savetxt(tmp_path / "ts.txt", np.arange(20) * 0.1)
    np.savetxt(tmp_path / "td.txt", np.arange(37) * 0.05 + 0.01)
    files = [str(tmp_path / "est.txt"), str(tmp_path / "gt.txt")]
    cases = [("tools.evaluate_trajectory", files, None),
             ("tools.align_trajectory", files, "-o"),
             ("tools.interpolate_trajectory", [files[0], "--times-src", str(tmp_path / "ts.txt"),
                                               "--times-dst", str(tmp_path / "td.txt")], "-o")]
    for module, argv, out_flag in cases:
        outs = {}
        for who, run in (("j", run_jax), ("t", run_port)):
            extra = [out_flag, str(tmp_path / f"{module}_{who}.txt")] if out_flag else []
            code, outs[who] = run(capsys, module, argv + extra)
            assert code == 0, outs[who]
        nj, nt = _numbers(outs["j"].replace("_j.txt", "")), _numbers(outs["t"].replace("_t.txt", ""))
        assert len(nj) == len(nt) >= (0 if "interpolate" in module else 3), outs
        np.testing.assert_allclose(nt, nj, rtol=0, atol=1e-6, err_msg=module)
        if out_flag:
            np.testing.assert_allclose(np.loadtxt(tmp_path / f"{module}_t.txt"),
                                       np.loadtxt(tmp_path / f"{module}_j.txt"),
                                       rtol=0, atol=1e-9, err_msg=module)


def test_triangulation_sampling_cli_passes(capsys):
    code, out = run_port(capsys, "tools.triangulation_sampling", ["--cpu", "--samples", "200"])
    assert code == 0, out
    assert "invariants hold" in out
    code, out = run_port(capsys, "tools.triangulation_sampling", [
        "--cpu", "--samples", "200", "--calib", "kitti_00_camera_left.txt",
        "kitti_00_camera_right.txt"])
    assert code == 0, out


def test_validate_kernels_needs_a_card_and_reports_a_planted_mismatch(capsys):
    """Without a CUDA device it validates nothing and exits non-zero (it
    never compares a plain version with itself); its comparison reports FAIL
    on a planted mismatch and OK where the tensors agree."""
    from svi_mapper_tpu_torch.tools import validate_kernels

    if not torch.cuda.is_available():
        assert validate_kernels.main([]) == 1
        assert "nothing was validated" in capsys.readouterr().err
    assert validate_kernels.main(["--cpu"]) == 1
    capsys.readouterr()
    a = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    b = a.clone()
    assert validate_kernels.compare("k", (a, a[0]), (b, b[0])) == 0
    assert "k" in (out := capsys.readouterr().out) and "OK" in out
    b[2, 1] += 1
    assert validate_kernels.compare("k", (a, a[0]), (b, b[0])) == 1
    assert "FAIL (1 mismatches" in capsys.readouterr().out
    mask = torch.tensor([True, True, False])
    assert validate_kernels.compare("k", a, b, mask=mask) == 0


def test_validate_kernels_schur_check_reports_a_planted_error():
    """The K4 / K5 line's assembly check: an assembly equal to its plain
    version has no mismatch; one entry of ``S`` off by 1 % of its largest
    entry, or one landmark's ``Hll_inv`` block scaled by 2, is reported by
    name."""
    from svi_mapper_tpu_torch.io.synthetic import default_camera
    from svi_mapper_tpu_torch.ops import ba_kernel
    from svi_mapper_tpu_torch.tools.bench_scaling import make_problem
    from svi_mapper_tpu_torch.tools.validate_kernels import schur_mismatches

    cam = default_camera(width=1241, height=376, device="cpu")
    p = make_problem(4, 96, seed=3)
    window = [torch.from_numpy(p[k]) for k in ("T", "X0", "obs")]
    want = ba_kernel.schur_assemble_plain(
        *window, torch.from_numpy(p["mask"]).float(), 1e-4, fx=cam.left.fx, fy=cam.left.fy,
        cx=cam.left.cx, cy=cam.left.cy, bq=cam.right.p03)
    assert schur_mismatches(want, want) == {}
    got = [t.clone() for t in want]
    got[0][1, 2, 1, 2] += 0.01 * float(want[0].abs().max())
    assert set(schur_mismatches(got, want)) == {"S"}
    got = [t.clone() for t in want]
    seen = int(torch.from_numpy(p["mask"]).any(0).nonzero()[0])
    got[2][seen] *= 2
    assert "Hll_inv_block" in schur_mismatches(got, want)
