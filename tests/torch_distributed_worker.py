"""Worker process of ``tests/test_torch_parallel.py``: one rank of a gloo
process group on the CPU.

Run as:  python tests/torch_distributed_worker.py <address> <n> <rank> <problem.npz> <out_dir>

Joins the group through ``parallel.distributed.initialize``, checks the pod
mesh and the state placements, runs the landmark-sharded Schur BA on each
problem of ``problem.npz``, with its ``obs_w`` where it has one (the Schur
sums then cross the process boundary through gloo's all_reduce), places
each problem with ``shard_ba_inputs`` beside the slices the sharded BA cuts,
then drives the landmark-sharded frame step (``frame_checks``), the
host reads of a sharded state (``host_read_checks``) and the
stereo-inertial tracker on it (``svi_checks``, on the frames and IMU
samples of ``svi.npz`` beside ``problem.npz``), and writes ``rank<r>.npz``
into ``out_dir``, beside the checkpoints it saved there; rank 0 also writes
the single-process ``bundle_adjust`` of the same problems. Prints
``OK <rank>`` on success.
"""

import contextlib
import copy
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402


@contextlib.contextmanager
def recording_calls(module, name):
    """Record the positional arguments of every call of ``module.name``."""
    calls, fn = [], getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append(args)
        return fn(*args, **kwargs)

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def table_fields(state) -> dict:
    """Every field of a state's table with every row: gathered through
    ``LandmarkShards.gather`` for a sharded state (one field also through
    DTensor's own ``full_tensor``, which must agree), as is otherwise."""
    from svi_mapper_tpu_torch.models import frame

    names = [f.name for f in dataclasses.fields(state.table)]
    shards = frame.shards_of(state)
    if shards is None:
        return {k: getattr(state.table, k).numpy() for k in names}
    full = shards.gather(*[getattr(state.table, k).to_local() for k in names])
    assert torch.equal(full[names.index("pos_w")], state.table.pos_w.full_tensor())
    return {k: v.numpy() for k, v in zip(names, full)}


def frame_checks(map_mesh, n: int, out_dir: Path) -> dict:
    """The landmark-sharded frame step: (i) one frame at the JAX test's size
    (``tests/test_parallel.py``), (ii) an 8-frame corridor through
    ``process_chunk`` in two chunks, (iii) ``SLAMSystem.process_many`` +
    ``finalize_backend`` with ``__graft_entry__.dryrun_multichip``'s
    parameters, each also run on the unsharded state in this process, (iv)
    a capacity that does not split over the ranks, (v) the back-end's
    writes into the sharded table, and (vi) the system of (iii) with the
    back-end worker and with the closure worker. (iii) runs with a logger
    attached and its sharded run saves a checkpoint between its chunks;
    ``host_read_checks`` reads both systems after it."""
    from torch.distributed.tensor import Replicate, Shard

    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.io.checkpoint import save_checkpoint
    from svi_mapper_tpu_torch.io.synthetic import SyntheticSequence, default_camera
    from svi_mapper_tpu_torch.models import frame
    from svi_mapper_tpu_torch.models.slam import SLAMSystem
    from svi_mapper_tpu_torch.parallel import mesh
    from svi_mapper_tpu_torch.utils import loggers

    out = {}
    # (iv)
    odd = dataclasses.replace(DEFAULT_PARAMS, max_landmarks=64 * n + 1)
    try:
        mesh.shard_state(frame.init_state(odd, device="cpu"), map_mesh)
        out["odd_capacity_error"] = np.array("")
    except ValueError as e:
        out["odd_capacity_error"] = np.array(f"ValueError: {e}")

    # (i) one frame, both images the seeded random one
    params = dataclasses.replace(DEFAULT_PARAMS, max_landmarks=128, max_detections=128,
                                 max_measurements=4)
    cam = default_camera(256, 128, device="cpu")
    img = torch.from_numpy(
        np.random.default_rng(0).random((128, 256)).astype(np.float32) * 255)
    img_sh = mesh.replicate(img, map_mesh)
    runs = {"sharded": (mesh.shard_state(frame.init_state(params, device="cpu"), map_mesh),
                        img_sh),
            "ref": (frame.init_state(params, device="cpu"), img)}
    for key, (state, im) in runs.items():
        state, o = frame.process_frame(state, im, im, cam, params, device="cpu")
        if key == "sharded":
            assert state.table.pos_w.placements == (Shard(0),)
            assert state.T_wc.placements == (Replicate(),)
        t = table_fields(state)
        out.update({f"one_frame/{key}/n_active": o.n_active.numpy(),
                    f"one_frame/{key}/n_new": o.n_new.numpy(),
                    f"one_frame/{key}/T_wc": o.T_wc.numpy(),
                    f"one_frame/{key}/pos_w": t["pos_w"],
                    f"one_frame/{key}/active": t["active"]})

    # (ii) the corridor through process_chunk, two chunks of four
    seq = SyntheticSequence(n_frames=8, width=256, height=128, step=0.6, device="cpu")
    frames = [seq.frame(i) for i in range(8)]
    Ls = torch.stack([f[0] for f in frames])
    Rs = torch.stack([f[1] for f in frames])
    runs = {"sharded": mesh.shard_state(frame.init_state(params, device="cpu"), map_mesh),
            "ref": frame.init_state(params, device="cpu")}
    for key, state in runs.items():
        outs, kf_uids = [], []
        for s in (0, 4):
            state, stacked, snaps = frame.process_chunk(
                state, Ls[s:s + 4], Rs[s:s + 4], seq.cam, params, emit_snapshots=True,
                device="cpu")
            outs.append(stacked.to_host())
            kf_uids.append(frame.snapshot_rows(snaps, torch.arange(4)).uid.numpy())
        for f in ("posit_ok", "n_tracked", "n_active", "n_optimal", "n_new",
                  "is_keyframe", "inliers", "instability", "T_wc"):
            out[f"chunk/{key}/{f}"] = np.concatenate([getattr(o, f) for o in outs])
        out[f"chunk/{key}/snapshot_uid"] = np.concatenate(kf_uids)
        out.update({f"chunk/{key}/table/{k}": v for k, v in table_fields(state).items()})
        if key == "sharded":
            assert state.table.uid.placements == (Shard(0),)

    # (iii) SLAMSystem with dryrun_multichip's parameters (its capacity
    # rounding for this mesh size)
    cap = -(-max(2 * n, 64) // n) * n
    slam_params = dataclasses.replace(
        DEFAULT_PARAMS, max_landmarks=cap, max_detections=cap, max_measurements=4,
        keyframe_translation_m2=0.25, keyframe_rotation_rad2=0.01,
        keyframe_min_landmarks=8, optimize_every_keyframes=4)
    slams, logs, rank = {}, {}, dist.get_rank()
    for key in ("sharded", "ref"):
        slam = slams[key] = SLAMSystem(seq.cam, slam_params, enable_loop_closure=True,
                          enable_local_ba=True, local_ba_every=2, ba_window=4,
                          consensus_window=4, device="cpu")
        if key == "sharded":
            slam.state = mesh.shard_state(slam.state, map_mesh)
        logs[key] = loggers.attach(
            slam, out_dir / ("logs_sharded" if key == "sharded" else f"logs_ref_rank{rank}"))
        # the sharded run saves a checkpoint between its two chunks (the
        # same chunks as one call); host_read_checks resumes from it
        slam.process_many(Ls[:4], Rs[:4], chunk=4)
        if key == "sharded":
            save_checkpoint(out_dir / "slam_ckpt.npz", slam)
            out["slam_ckpt/at_save"] = np.array(
                [int(x) for x in (slam.frame_count, len(slam.slam_keyframes))])
            out.update({f"slam_ckpt/table/{k}": v for k, v in table_fields(slam.state).items()})
        slam.process_many(Ls[4:], Rs[4:], chunk=4)
        slam.finalize_backend()
        if key == "sharded":
            assert slam.state.table.pos_w.placements == (Shard(0),)
        out.update({f"slam/{key}/frame_count": np.array(slam.frame_count),
                    f"slam/{key}/keyframes": np.array(len(slam.slam_keyframes)),
                    f"slam/{key}/ba_runs": np.array(slam.stats["ba_runs"]),
                    f"slam/{key}/trajectory": slam.trajectory_array,
                    f"slam/{key}/optimized": slam.optimized_trajectory()})
    out.update(host_read_checks(map_mesh, slams, logs, (Ls, Rs), out_dir))

    # (vi) the same system with each worker (dryrun_multichip's overlapped
    # run; "force" keeps the back-end worker with one visible device)
    for key, option in (("overlap", dict(overlap_backend="force")),
                        ("async", dict(async_closure=True))):
        slam = SLAMSystem(seq.cam, slam_params, enable_loop_closure=True,
                          enable_local_ba=True, local_ba_every=2, ba_window=4,
                          consensus_window=4, device="cpu", **option)
        slam.state = mesh.shard_state(slam.state, map_mesh)
        slam.process_many(Ls, Rs, chunk=4)
        slam.finalize_backend()
        assert slam.state.table.pos_w.placements == (Shard(0),)
        out.update({f"workers/{key}/frame_count": np.array(slam.frame_count),
                    f"workers/{key}/keyframes": np.array(len(slam.slam_keyframes)),
                    f"workers/{key}/optimized": slam.optimized_trajectory(),
                    f"workers/{key}/pos_w": table_fields(slam.state)["pos_w"]})
        slam.close()

    # (v) the back-end's writes into the live table: a BA write-back by
    # global slot (rows on both ranks), an identity merge, then a world
    # correction and a world shift
    uid = table_fields(slams["ref"].state)["uid"]
    slots = np.array([0, cap // 2 + 1, cap - 1])
    X = np.arange(9, dtype=np.float32).reshape(3, 3) + 0.5
    for key, slam in slams.items():
        slam._write_back_rows(slots, X, np.array([1, cap // 2]))
        slam._apply_canon_to_live({int(uid[5]): int(uid[3])})
        out.update({f"writes/{key}/{k}": v for k, v in table_fields(slam.state).items()})
        T_old = slam.slam_keyframes[-1].T_wc.astype(np.float64)
        T_new = T_old.copy()
        T_new[:3, 3] += (0.1, -0.2, 0.3)
        slam._apply_world_correction(T_old, T_new)
        slam._world_shift(np.array([1.0, 2.0, 3.0]))
        out.update({f"moved/{key}/{k}": v for k, v in table_fields(slam.state).items()})
        out[f"moved/{key}/T_wc"] = slam._local_state()[0].T_wc.numpy()
    return out


def gathered_copy(system):
    """A shallow copy of ``system`` whose state is its state gathered onto
    this process, unsharded (the host records shared)."""
    from svi_mapper_tpu_torch import convert

    clone = copy.copy(system)
    clone.state = convert.state_from_numpy(convert.state_to_numpy(system.state), "cpu")
    return clone


def host_reads(system, tag: str, out_dir: Path, logger=None) -> dict:
    """What each host read of ``system`` gives: the cloud, the g2o text,
    the viewer's inputs and the end-of-run dumps of ``logger`` (a new one
    under ``logs_<tag>`` if None)."""
    from svi_mapper_tpu_torch.eval.viewer import snapshot_tracker
    from svi_mapper_tpu_torch.io.cloud import cloud_from_slam_state
    from svi_mapper_tpu_torch.io.g2o_export import snapshot_slam
    from svi_mapper_tpu_torch.utils import loggers

    cloud = cloud_from_slam_state(system.state, 3, system.frame_count - 1)
    out = {f"cloud/{f.name}": np.asarray(getattr(cloud, f.name))
           for f in dataclasses.fields(cloud)}
    snapshot_slam(system, out_dir / f"{tag}.g2o")
    out["g2o"] = np.frombuffer((out_dir / f"{tag}.g2o").read_bytes(), np.uint8)
    view = snapshot_tracker(system)
    out.update({f"viewer/{k}": np.asarray(v) for k, v in view.items() if k != "hud"})
    out.update({f"viewer/hud/{k}": np.asarray(v) for k, v in view["hud"].items()})
    logger = logger or loggers.RunLogger(out_dir / f"logs_{tag}")
    loggers.finalize(system, logger)
    for name in ("landmarks_final", "landmarks_final_optimized", "trajectory_kitti",
                 "landmark_creation"):
        f = logger.dir / f"{name}.txt"
        if f.exists():
            out[f"logs/{name}"] = np.frombuffer(f.read_bytes(), np.uint8)
    return out


def host_read_checks(map_mesh, slams: dict, logs: dict, frames, out_dir: Path) -> dict:
    """(vii) Host reads of the sharded state of (iii): the checkpoint its
    run saved between its chunks holds every row and resumes (load ->
    ``shard_state`` -> the second chunk -> ``finalize_backend``) to the
    uninterrupted run's bits; the cloud, the g2o text, the viewer's inputs
    and the logger's dumps of the final system equal those of the same
    state gathered and unsharded (rank 0 wrote the shared files; each rank
    writes the unsharded ones under its own name)."""
    from torch.distributed.tensor import Shard

    from svi_mapper_tpu_torch.io.checkpoint import load_checkpoint
    from svi_mapper_tpu_torch.parallel import mesh

    rank = dist.get_rank()
    Ls, Rs = frames
    out = {}
    with np.load(out_dir / "slam_ckpt.npz") as z:
        out.update({f"slam_ckpt/file/{k.removeprefix('table__')}": z[k]
                    for k in z.files if k.startswith("table__")})
    resumed = load_checkpoint(out_dir / "slam_ckpt.npz", device="cpu")
    resumed.state = mesh.shard_state(resumed.state, map_mesh)
    resumed.process_many(Ls[4:], Rs[4:], chunk=4)
    resumed.finalize_backend()
    assert resumed.state.table.pos_w.placements == (Shard(0),)
    out.update({"slam_ckpt/resumed/trajectory": resumed.trajectory_array,
                "slam_ckpt/resumed/optimized": resumed.optimized_trajectory(),
                "slam_ckpt/resumed/keyframes": np.array(len(resumed.slam_keyframes))})
    out.update({f"slam_ckpt/resumed/table/{k}": v
                for k, v in table_fields(resumed.state).items()})
    system = slams["sharded"]
    out.update({f"slam_ckpt/uninterrupted/table/{k}": v
                for k, v in table_fields(system.state).items()})
    got = host_reads(system, "sharded", out_dir, logs["sharded"])
    want = host_reads(gathered_copy(system), f"gathered_rank{rank}", out_dir)
    ref = host_reads(slams["ref"], f"ref_rank{rank}", out_dir, logs["ref"])
    out.update({f"host/sharded/{k}": v for k, v in got.items()})
    out.update({f"host/gathered/{k}": v for k, v in want.items()})
    # the unsharded run's landmark-creation log (integers only)
    out["host/ref/logs/landmark_creation"] = ref["logs/landmark_creation"]
    return out


SVI_CHUNK = 3     # frames 2-7 in two chunks of three


def svi_checks(map_mesh, path: Path, out_dir: Path) -> dict:
    """(viii) ``StereoInertialTracker`` on the sharded state and on the
    unsharded one, over ``svi.npz``'s frames: frame 0 through
    ``process_imu``, frame 1 through ``process_imu_samples``, frames 2-7
    through ``process_many_imu(chunk=3)``, once as is and once with
    ``equalize=True``. The sharded run as is saves a checkpoint between its
    two chunks (after frame 4) and is resumed from it (load ->
    ``shard_state`` -> frames 5-7). Then a lock step against the JAX
    package: before every frame the sharded tracker starts from the JAX
    tracker's state of ``svi.npz`` (``lock/<i>/...``). One rank runs the
    first variant alone and no lock step (the tests read those of 2)."""
    from torch.distributed.tensor import Shard

    from svi_mapper_tpu_torch import convert
    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from svi_mapper_tpu_torch.models.svi import StereoInertialTracker
    from svi_mapper_tpu_torch.parallel import mesh

    z = np.load(path)
    cam = convert.camera_from_numpy(
        {eye: {**{k: z[f"cam/{eye}/{k}"] for k in ("P", "K", "dist", "R_rect")},
               "width": int(z[f"cam/{eye}/width"]), "height": int(z[f"cam/{eye}/height"])}
         for eye in ("left", "right")}, "cpu")
    calib = convert.imu_calibration_from_numpy(
        {k.removeprefix("calib/"): z[k] for k in z.files if k.startswith("calib/")})
    params = dataclasses.replace(DEFAULT_PARAMS, **{
        k.removeprefix("params/"): z[k].item() for k in z.files if k.startswith("params/")})
    Ls, Rs, nz = torch.from_numpy(z["L"]), torch.from_numpy(z["R"]), z["n"]
    blocks = [(z["dts"][i, :nz[i]], z["omega"][i, :nz[i]], z["accel"][i, :nz[i]])
              for i in range(len(nz))]
    out = {}

    def samples(a, b):
        return [list(x) for x in zip(*blocks[a:b])]

    def record(tr, key, outs, vels):
        o = {f: np.stack([np.asarray(getattr(x, f)) for x in outs])
             for f in ("posit_ok", "n_tracked", "n_active", "n_optimal", "n_new",
                       "is_keyframe", "inliers", "instability", "T_wc")}
        o.update(velocity=np.stack(vels), gravity_obs=np.array(tr.gravity_obs).reshape(-1, 3),
                 keyframe_frames=np.array([k.frame_idx for k in tr.slam_keyframes]))
        out.update({f"{key}/{k}": v for k, v in o.items()})
        out.update({f"{key}/table/{k}": v for k, v in table_fields(tr.state).items()})

    one_rank = dist.get_world_size() == 1
    variants = (("svi", False),) if one_rank else (("svi", False), ("svi_equalize", True))
    for variant, equalize in variants:
        for key in ("sharded", "ref"):
            tr = StereoInertialTracker(cam, calib, params, equalize=equalize,
                                       enable_loop_closure=False, enable_local_ba=False,
                                       device="cpu")
            sharded = key == "sharded"
            if sharded:
                tr.state = mesh.shard_state(tr.state, map_mesh)
            outs, vels = [], []
            outs.append(tr.process_imu(Ls[0], Rs[0], blocks[0][1][0], blocks[0][2][0],
                                       float(blocks[0][0][0])))
            vels.append(tr.velocity.numpy().copy())
            outs.append(tr.process_imu_samples(Ls[1], Rs[1], *blocks[1]))
            vels.append(tr.velocity.numpy().copy())
            if sharded:     # process_imu and process_imu_samples keep the rows split
                assert tr.state.table.pos_w.placements == (Shard(0),)
            for a, b in ((2, 5), (5, 8)):
                outs += tr.process_many_imu(Ls[a:b], Rs[a:b], *samples(a, b), chunk=SVI_CHUNK)
                vels.append(tr.velocity.numpy().copy())
                if sharded:
                    assert tr.state.table.pos_w.placements == (Shard(0),)
                if sharded and not equalize and b == 5:
                    save_checkpoint(out_dir / "svi_ckpt.npz", tr)
                    out.update({f"svi_ckpt/table/{k}": v
                                for k, v in table_fields(tr.state).items()})
            record(tr, f"{variant}/{key}", outs, vels)
    # the lock step: before every frame the tracker takes the JAX package's
    # state (gathered, as numpy) and shards it again
    tr = StereoInertialTracker(cam, calib, params, equalize=False,
                               enable_loop_closure=False, enable_local_ba=False, device="cpu")
    outs = []
    for i in range(0 if one_rank else len(nz)):
        st = {k.split("/")[-1]: z[k] for k in z.files if k.startswith(f"lock/{i}/state/")}
        st["table"] = {k.split("/")[-1]: z[k] for k in z.files
                       if k.startswith(f"lock/{i}/table/")}
        convert.svi_state_from_numpy(tr, {"state": st, **{
            k: z[f"lock/{i}/{k}"] for k in ("velocity", "gravity_obs", "T_cam_imu")}})
        tr.state = mesh.shard_state(tr.state, map_mesh)
        if i == 0:
            outs.append(tr.process_imu(Ls[0], Rs[0], blocks[0][1][0], blocks[0][2][0],
                                       float(blocks[0][0][0])))
        elif i == 1:
            outs.append(tr.process_imu_samples(Ls[1], Rs[1], *blocks[1]))
        else:
            outs += tr.process_many_imu(Ls[i:i + 1], Rs[i:i + 1], *samples(i, i + 1), chunk=1)
        assert tr.state.table.pos_w.placements == (Shard(0),)
    if outs:
        out.update({f"svi_lock/{f}": np.stack([np.asarray(getattr(o, f)) for o in outs])
                    for f in ("posit_ok", "is_keyframe", "n_tracked", "n_active", "n_new",
                              "inliers", "T_wc")})
    resumed = load_checkpoint(out_dir / "svi_ckpt.npz", device="cpu")
    resumed.state = mesh.shard_state(resumed.state, map_mesh)
    outs = resumed.process_many_imu(Ls[5:], Rs[5:], *samples(5, 8), chunk=SVI_CHUNK)
    out["svi_ckpt/resumed/T_wc"] = np.stack([np.asarray(o.T_wc) for o in outs])
    out["svi_ckpt/resumed/velocity"] = resumed.velocity.numpy()
    out.update({f"svi_ckpt/resumed/table/{k}": v
                for k, v in table_fields(resumed.state).items()})
    with np.load(out_dir / "svi_ckpt.npz") as f:
        out.update({f"svi_ckpt/file/{k.removeprefix('table__')}": f[k]
                    for k in f.files if k.startswith("table__")})
    return out


def host_read_bits(map_mesh) -> dict:
    """(ix) ``parallel.mesh.host_arrays`` of a ``Shard(0)`` float32 field
    whose rows hold NaNs of two payloads, -0.0 and +0.0 on every rank:
    every rank's rows, bit for bit, and a replicated field as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from svi_mapper_tpu_torch.parallel import mesh

    rank, n = dist.get_rank(), dist.get_world_size()
    bits = np.array([0x7FC00000, 0x7FC00001 + rank, 0x80000000, 0x00000000,
                     0x3F800000 + rank], np.uint32)
    rows = torch.from_numpy(np.tile(bits.view(np.float32), (2, 1)))
    field = DTensor.from_local(rows, map_mesh, (Shard(0),), run_check=False)
    pose = DTensor.from_local(torch.arange(4.0), map_mesh, (Replicate(),), run_check=False)
    full, rep = mesh.host_arrays(field, pose)
    want = np.concatenate([np.tile(np.array(
        [0x7FC00000, 0x7FC00001 + r, 0x80000000, 0, 0x3F800000 + r], np.uint32), (2, 1))
        for r in range(n)])
    return {"bits/gathered": full.view(np.uint32), "bits/want": want, "bits/replicated": rep}


def main() -> None:
    address, n, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    problems, out_dir = np.load(sys.argv[4]), Path(sys.argv[5])
    torch.set_num_threads(1)

    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.io.synthetic import default_camera
    from svi_mapper_tpu_torch.models import frame
    from svi_mapper_tpu_torch.parallel import distributed, mesh
    from svi_mapper_tpu_torch.parallel.sharded_ba import bundle_adjust_sharded, shard_ba_inputs
    from svi_mapper_tpu_torch.solvers import ba

    assert distributed.initialize(address, n, rank, device="cpu") == (n > 1)
    assert dist.get_backend() == "gloo" and dist.get_world_size() == n

    # pod mesh: one CPU rank per host, rows of consecutive ranks
    pod = distributed.make_pod_mesh(device="cpu")
    assert tuple(pod.mesh.shape) == (n, 1), pod.mesh.shape
    assert distributed.host_local_slice(64, pod) == slice(rank * 64 // n, (rank + 1) * 64 // n)
    assert tuple(distributed.make_pod_mesh(1, device="cpu").mesh.shape) == (1, n)

    # state placements: the table's rows split over ``map``
    from torch.distributed.tensor import DTensor, Replicate, Shard

    map_mesh = mesh.make_map_mesh(device="cpu")
    state = frame.init_state(DEFAULT_PARAMS, device="cpu")
    sharded = mesh.shard_state(state, map_mesh)
    assert isinstance(sharded.table.pos_w, DTensor)
    assert sharded.table.pos_w.placements == (Shard(0),)
    assert sharded.table.pos_w.to_local().shape[0] == DEFAULT_PARAMS.max_landmarks // n
    assert sharded.T_wc.placements == (Replicate(),)
    torch.testing.assert_close(sharded.table.pos_w.full_tensor(), state.table.pos_w)

    cam = default_camera(320, 240, device="cpu")
    out = {}
    names = sorted({k.split("/")[0] for k in problems.files})
    for name in names:
        p = {k.split("/")[1]: torch.from_numpy(problems[k])
             for k in problems.files if k.startswith(name + "/")}
        args = (p["T"], p["X0"], p["obs"], p["mask"], cam, p["fix"])
        kw = dict(max_iterations=5, min_rel_improvement=0.0)
        if "obs_w" in p:
            kw["obs_w"] = p["obs_w"]
        with recording_calls(ba, "bundle_adjust") as cut:
            res = bundle_adjust_sharded(map_mesh, *args, device="cpu", **kw)
        # the same problem placed by shard_ba_inputs (padded as the sharded
        # BA pads it): each local shard is the slice that solve was given
        pad = (-p["X0"].shape[0]) % n
        placed = shard_ba_inputs(
            map_mesh, p["T"], F.pad(p["X0"], (0, 0, 0, pad)),
            F.pad(p["obs"], (0, 0, 0, pad)), F.pad(p["mask"], (0, pad)), p["fix"])
        for got, want in zip(placed, cut[0][:4] + (cut[0][5],)):
            out[f"{name}/placed_equals_cut"] = out.get(f"{name}/placed_equals_cut", True) \
                and torch.equal(got.to_local(), want)
        out[f"{name}/placements"] = np.array(
            [str(t.placements) for t in placed])
        out.update({f"{name}/T_wc": res.T_wc.numpy(), f"{name}/points_w": res.points_w.numpy(),
                    f"{name}/chi2": res.chi2_final.numpy(),
                    f"{name}/chi2_initial": res.chi2_initial.numpy()})
        if rank == 0:
            ref = ba.bundle_adjust(*args, device="cpu", **kw)
            out.update({f"{name}/ref_T_wc": ref.T_wc.numpy(),
                        f"{name}/ref_points_w": ref.points_w.numpy(),
                        f"{name}/ref_chi2": ref.chi2_final.numpy()})
    out.update(frame_checks(map_mesh, n, out_dir))
    out.update(svi_checks(map_mesh, Path(sys.argv[4]).with_name("svi.npz"), out_dir))
    out.update(host_read_bits(map_mesh))
    np.savez(out_dir / f"rank{rank}.npz", **out)
    dist.destroy_process_group()
    print(f"OK {rank}", flush=True)


if __name__ == "__main__":
    main()
