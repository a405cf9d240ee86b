"""The port's tools built on the native runtime and the cloud codec:
``make_dump``, ``validate_dataset``, ``republish_stream``, ``create_cloud``,
``match_clouds`` and ``bench_matching`` (``svi_mapper_tpu_torch/tools``),
on the CPU (``--device cpu`` / ``--cpu``), against the JAX package's tools
where both write or print the same thing.

Mirrors ``tests/test_tools.py``'s republish test and runs the five other
tools end to end: the dumps they write read back frame for frame, the
clouds ``create_cloud`` writes are the JAX tool's arrays (and ``.svic``
bytes), and ``match_clouds`` / ``bench_matching`` report the JAX tools'
match counts, ICP inliers and tree votes.
"""

import os
import re
import sys
import threading
import time

import numpy as np
import pytest
from PIL import Image

from svi_mapper_tpu.tools import bench_matching as j_bench
from svi_mapper_tpu.tools import create_cloud as j_create
from svi_mapper_tpu.tools import match_clouds as j_match
from svi_mapper_tpu_torch import native
from svi_mapper_tpu_torch.io.cloud import load_cloud
from svi_mapper_tpu_torch.io import synthetic as tsyn
from svi_mapper_tpu_torch.tools import (
    bench_matching,
    create_cloud,
    make_dump,
    match_clouds,
    republish_stream,
    validate_dataset,
)

from test_torch_euroc import write_kitti


def _jax_main(monkeypatch, mod, argv):
    monkeypatch.setattr(sys, "argv", [mod.__name__, *argv])
    mod.main()


def test_republish_stream_pairs_incoming_frames(tmp_path):
    """republish_stream pairs files as they arrive and writes a readable
    dump (ref republisher_node.cpp role)."""
    watch = tmp_path / "stream"
    (watch / "left").mkdir(parents=True)
    (watch / "right").mkdir(parents=True)
    rng = np.random.default_rng(0)
    frames = [(rng.integers(0, 255, (48, 64), dtype=np.uint8),
               rng.integers(0, 255, (48, 64), dtype=np.uint8)) for _ in range(5)]

    def feeder():
        for i, (L, R) in enumerate(frames):
            # atomic: write to a temp name, then rename (right first: the
            # pairing keys on both sides being present)
            for sub, img in (("right", R), ("left", L)):
                tmp = watch / sub / f".tmp_{i:04d}.png"
                Image.fromarray(img).save(tmp)
                os.replace(tmp, watch / sub / f"{i:04d}.500000.png")
            time.sleep(0.05)

    t = threading.Thread(target=feeder)
    t.start()
    out = tmp_path / "stream.svid"
    n = republish_stream.republish(watch, out, poll_s=0.02, idle_timeout_s=8.0,
                                   log=lambda *a: None)
    t.join()
    assert n == 5
    with native.DumpReader(out) as r:
        assert r.n_frames == 5 and (r.height, r.width) == (48, 64)
        got = list(r)
    assert len(got) == 5
    fid, ts, L, R = got[2]
    assert fid == 2 and ts == 2.5
    np.testing.assert_array_equal(L, frames[2][0])
    np.testing.assert_array_equal(R, frames[2][1])


def test_republish_stream_skips_hidden_files(tmp_path):
    """A producer's temporary (a hidden name, sorting before the frames) is
    not a frame: pairing and numbering follow the visible files alone."""
    watch = tmp_path / "stream"
    rng = np.random.default_rng(1)
    imgs = {}
    for sub in ("left", "right"):
        (watch / sub).mkdir(parents=True)
        for name in (".tmp_0002.png", "0000.500000.png", "0001.500000.png"):
            imgs[sub, name] = rng.integers(0, 255, (48, 64), dtype=np.uint8)
            Image.fromarray(imgs[sub, name]).save(watch / sub / name)
    out = tmp_path / "stream.svid"
    n = republish_stream.republish(watch, out, poll_s=0.01, idle_timeout_s=0.05,
                                   log=lambda *a: None)
    assert n == 2
    with native.DumpReader(out) as r:
        got = list(r)
    assert [(fid, ts) for fid, ts, _, _ in got] == [(0, 0.5), (1, 1.5)]
    np.testing.assert_array_equal(got[1][2], imgs["left", "0001.500000.png"])
    np.testing.assert_array_equal(got[1][3], imgs["right", "0001.500000.png"])


def test_make_dump_and_validate_synthetic(tmp_path, capsys):
    """The synthetic dump holds the port's renders as 8-bit images; the
    validator accepts it and refuses a truncated copy."""
    out = tmp_path / "syn.svid"
    make_dump.main(["synthetic", str(out), "--frames", "3", "--width", "64",
                    "--height", "32", "--device", "cpu"])
    assert "wrote 3 stereo frames" in capsys.readouterr().out
    seq = tsyn.SyntheticSequence(n_frames=3, width=64, height=32, device="cpu")
    with native.DumpReader(out, prefetch=2) as r:
        for i, (fid, ts, L, R) in enumerate(r):
            want = seq.frame(i)
            assert fid == i and ts == pytest.approx(i * 0.05)
            np.testing.assert_array_equal(L, make_dump.to_u8(want[0]))
            np.testing.assert_array_equal(R, make_dump.to_u8(want[1]))
    validate_dataset.main([str(out)])
    assert "3 stereo frames — OK" in capsys.readouterr().out
    bad = tmp_path / "bad.svid"
    bad.write_bytes(out.read_bytes()[:-7])
    with pytest.raises(SystemExit):
        validate_dataset.main([str(bad)])
    assert "PROBLEM" in capsys.readouterr().out


def test_make_dump_and_validate_kitti(tmp_path, capsys):
    """A KITTI folder becomes a dump with its timestamps and images; the
    validator reads the folder itself (camera on the CPU)."""
    write_kitti(tmp_path, 4, times=[0.0, 0.1, 0.25, 0.3])
    out = tmp_path / "k.svid"
    make_dump.main(["kitti", str(tmp_path), str(out), "--device", "cpu"])
    assert native.validate_dump(out) == 4
    seq_dir = tmp_path / "sequences" / "00"
    with native.DumpReader(out) as r:
        got = list(r)
    assert [g[1] for g in got] == pytest.approx([0.0, 0.1, 0.25, 0.3])
    np.testing.assert_array_equal(
        got[3][2], np.asarray(Image.open(seq_dir / "image_0" / "000003.png")))
    capsys.readouterr()
    validate_dataset.main([str(tmp_path), "--device", "cpu"])
    text = capsys.readouterr().out
    assert "4 stereo frames, 60x40" in text and "OK" in text


@pytest.mark.parametrize("svic", [False, True])
def test_create_cloud_writes_the_jax_tools_clouds(tmp_path, monkeypatch, svic):
    args = ["--clouds", "3", "--points", "64", "--overlap", "0.5", "--seed", "4"]
    args += ["--svic"] if svic else []
    create_cloud.main([str(tmp_path / "t"), *args])
    _jax_main(monkeypatch, j_create, [str(tmp_path / "j"), *args])
    ext = "svic" if svic else "npz"
    for k in range(3):
        a, b = tmp_path / "t" / f"cloud_{k:03d}.{ext}", tmp_path / "j" / f"cloud_{k:03d}.{ext}"
        if svic:
            assert a.read_bytes() == b.read_bytes()
        else:
            with np.load(a) as za, np.load(b) as zb:
                assert sorted(za.files) == sorted(zb.files)
                for f in za.files:
                    assert za[f].dtype == zb[f].dtype, f
                    np.testing.assert_array_equal(za[f], zb[f], err_msg=f)


@pytest.fixture
def clouds(tmp_path):
    return create_cloud.create_clouds(tmp_path / "c", clouds=4, points=96,
                                      overlap=0.5, svic=True, seed=2,
                                      log=lambda *a: None)


def _pair_lines(text):
    return re.findall(r"kf\d+ <-> kf\d+: \d+ matches(?:  ICP ok=\w+ inliers=\d+)?", text)


def test_match_clouds_as_the_jax_tool(clouds, monkeypatch, capsys):
    match_clouds.main([*map(str, clouds), "--device", "cpu"])
    t_out = capsys.readouterr().out
    _jax_main(monkeypatch, j_match, [*map(str, clouds), "--cpu"])
    j_out = capsys.readouterr().out
    assert _pair_lines(t_out) == _pair_lines(j_out)
    assert len(_pair_lines(t_out)) == 6
    rows = match_clouds.match_all([load_cloud(p) for p in clouds], device="cpu")
    # consecutive clouds share half their landmarks (4 bits of noise):
    # every shared landmark matches, and ICP finds the 2 m step between them
    for r in rows:
        if r["ref"] == r["query"] + 1:
            assert r["matches"] == 48 and r["icp_ok"] and r["inliers"] == 48
            np.testing.assert_allclose(r["T_qr"][:3, 3], [0.0, 0.0, 2.0], atol=1e-4)


def test_bench_matching_as_the_jax_tool(clouds, monkeypatch, capsys):
    r = bench_matching.bench([load_cloud(p) for p in clouds], device="cpu", reps=1)
    assert r["queries"] == 96 and r["stored"] == 288
    assert r["brute_force_votes"] == [48, 0, 0]
    assert sum(r["tree_votes"]) <= r["brute_force_matches"] == 48
    assert r["probabilistic_matches"] == 48 and r["probabilistic_agreement"] == 1.0
    bench_matching.main([*map(str, clouds), "--cpu", "--reps", "1"])
    t_out = capsys.readouterr().out
    _jax_main(monkeypatch, j_bench, [*map(str, clouds), "--cpu", "--reps", "1"])
    j_out = capsys.readouterr().out
    for pattern in (r"brute-force device:\s+(\d+) matches",
                    r"native tree index:\s+(\d+) votes",
                    r"per-keyframe vote counts: (\[.*?\])",
                    r"probabilistic matmul: (\d+) matches",
                    r"agreement with brute force: ([\d.]+) %"):
        got, want = (re.findall(r"[\d.]+", re.sub(r"np\.int32", "", re.search(pattern, out).group(1)))
                     for out in (t_out, j_out))
        assert got == want, pattern
