"""Worker process of ``tests/test_torch_parallel.py``: one rank of a gloo
process group on the CPU.

Run as:  python tests/torch_distributed_worker.py <address> <n> <rank> <problem.npz> <out_dir>

Joins the group through ``parallel.distributed.initialize``, checks the pod
mesh and the state placements, runs the landmark-sharded Schur BA on each
problem of ``problem.npz``, with its ``obs_w`` where it has one (the Schur
sums then cross the process boundary through gloo's all_reduce) and writes
``rank<r>.npz`` into ``out_dir``; rank 0 also writes the single-process
``bundle_adjust`` of the same problems. Prints ``OK <rank>`` on success.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402


def main() -> None:
    address, n, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    problems, out_dir = np.load(sys.argv[4]), Path(sys.argv[5])
    torch.set_num_threads(1)

    from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
    from svi_mapper_tpu_torch.io.synthetic import default_camera
    from svi_mapper_tpu_torch.models import frame
    from svi_mapper_tpu_torch.parallel import distributed, mesh
    from svi_mapper_tpu_torch.parallel.sharded_ba import bundle_adjust_sharded
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

    # the eager frame step on the sharded state: record where it stops
    small = DEFAULT_PARAMS.__class__(**{**DEFAULT_PARAMS.__dict__, "max_landmarks": 128,
                                        "max_detections": 128})
    img = mesh.replicate(torch.rand(128, 256) * 255, map_mesh)
    try:
        frame.process_frame(mesh.shard_state(frame.init_state(small, device="cpu"), map_mesh),
                            img, img, default_camera(256, 128, device="cpu"), small,
                            device="cpu")
        stop = ""
    except (NotImplementedError, RuntimeError) as e:
        stop = f"{type(e).__name__}: {e}"

    cam = default_camera(320, 240, device="cpu")
    out = {"frame_step_error": np.array(stop)}
    names = sorted({k.split("/")[0] for k in problems.files})
    for name in names:
        p = {k.split("/")[1]: torch.from_numpy(problems[k])
             for k in problems.files if k.startswith(name + "/")}
        args = (p["T"], p["X0"], p["obs"], p["mask"], cam, p["fix"])
        kw = dict(max_iterations=5, min_rel_improvement=0.0)
        if "obs_w" in p:
            kw["obs_w"] = p["obs_w"]
        res = bundle_adjust_sharded(map_mesh, *args, device="cpu", **kw)
        out.update({f"{name}/T_wc": res.T_wc.numpy(), f"{name}/points_w": res.points_w.numpy(),
                    f"{name}/chi2": res.chi2_final.numpy(),
                    f"{name}/chi2_initial": res.chi2_initial.numpy()})
        if rank == 0:
            ref = ba.bundle_adjust(*args, device="cpu", **kw)
            out.update({f"{name}/ref_T_wc": ref.T_wc.numpy(),
                        f"{name}/ref_points_w": ref.points_w.numpy(),
                        f"{name}/ref_chi2": ref.chi2_final.numpy()})
    np.savez(out_dir / f"rank{rank}.npz", **out)
    dist.destroy_process_group()
    print(f"OK {rank}", flush=True)


if __name__ == "__main__":
    main()
