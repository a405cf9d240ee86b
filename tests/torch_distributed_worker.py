"""Worker process of ``tests/test_torch_parallel.py``: one rank of a gloo
process group on the CPU.

Run as:  python tests/torch_distributed_worker.py <address> <n> <rank> <problem.npz> <out_dir>

Joins the group through ``parallel.distributed.initialize``, checks the pod
mesh and the state placements, runs the landmark-sharded Schur BA on each
problem of ``problem.npz``, with its ``obs_w`` where it has one (the Schur
sums then cross the process boundary through gloo's all_reduce), places
each problem with ``shard_ba_inputs`` beside the slices the sharded BA cuts,
then drives the landmark-sharded frame step (``frame_checks``) and writes
``rank<r>.npz`` into ``out_dir``; rank 0 also writes the single-process
``bundle_adjust`` of the same problems. Prints ``OK <rank>`` on success.
"""

import contextlib
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


def frame_checks(map_mesh, n: int) -> dict:
    """The landmark-sharded frame step: (i) one frame at the JAX test's size
    (``tests/test_parallel.py``), (ii) an 8-frame corridor through
    ``process_chunk`` in two chunks, (iii) ``SLAMSystem.process_many`` +
    ``finalize_backend`` with ``__graft_entry__.dryrun_multichip``'s
    parameters, each also run on the unsharded state in this process, (iv)
    a capacity that does not split over the ranks, (v) the back-end's
    writes into the sharded table, and (vi) the system of (iii) with the
    back-end worker and with the closure worker."""
    from torch.distributed.tensor import Replicate, Shard

    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.io.synthetic import SyntheticSequence, default_camera
    from svi_mapper_tpu_torch.models import frame
    from svi_mapper_tpu_torch.models.slam import SLAMSystem
    from svi_mapper_tpu_torch.parallel import mesh

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
    slams = {}
    for key in ("sharded", "ref"):
        slam = slams[key] = SLAMSystem(seq.cam, slam_params, enable_loop_closure=True,
                          enable_local_ba=True, local_ba_every=2, ba_window=4,
                          consensus_window=4, device="cpu")
        if key == "sharded":
            slam.state = mesh.shard_state(slam.state, map_mesh)
        slam.process_many(Ls, Rs, chunk=4)
        slam.finalize_backend()
        if key == "sharded":
            assert slam.state.table.pos_w.placements == (Shard(0),)
        out.update({f"slam/{key}/frame_count": np.array(slam.frame_count),
                    f"slam/{key}/keyframes": np.array(len(slam.slam_keyframes)),
                    f"slam/{key}/ba_runs": np.array(slam.stats["ba_runs"]),
                    f"slam/{key}/trajectory": slam.trajectory_array,
                    f"slam/{key}/optimized": slam.optimized_trajectory()})

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
    out.update(frame_checks(map_mesh, n))
    np.savez(out_dir / f"rank{rank}.npz", **out)
    dist.destroy_process_group()
    print(f"OK {rank}", flush=True)


if __name__ == "__main__":
    main()
