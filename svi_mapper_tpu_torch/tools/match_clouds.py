"""Descriptor-matching benchmark over saved keyframe clouds — the
``match_clouds`` / ``test_cloud_matching`` runnables
(match_clouds.cpp, test_cloud_matching.cpp:17-180).

Loads keyframe clouds (``.npz`` or ``.svic``, io.cloud format), runs
all-pairs pool matching + ICP closure validation offline on ``--device``
(default cuda; ``--cpu`` is ``--device cpu``), and reports match counts and
timing — exercising the loop-closure subsystem without running SLAM. The
matching is ``mapping.closure.match_pools``' exact branch, whose distance
matrix is kernel K6's matrix entry on the card.

Usage: python -m svi_mapper_tpu_torch.tools.match_clouds CLOUD1.npz CLOUD2.npz ...
"""

from __future__ import annotations

import argparse
import time


def match_all(clouds: list, cutoff: int = 25, device="cuda") -> list[dict]:
    """Every pair ``i < j`` of ``clouds``: mutual matches and, from 25 on,
    the ICP result. One dict per pair, in order."""
    import numpy as np
    import torch

    from svi_mapper_tpu_torch.mapping.closure import match_pools
    from svi_mapper_tpu_torch.ops.descriptors import words_from_numpy, words_u32
    from svi_mapper_tpu_torch.solvers.icp import align_clouds

    dev = torch.device(device)
    P = max(len(c.uids) for c in clouds)

    def pad_pool(c):
        n = len(c.uids)
        d = np.zeros((P, 8), np.uint32)
        d[:n] = words_u32(c.descriptors)
        p = np.zeros((P, 3), np.float32)
        p[:n] = c.points_cam
        v = np.zeros(P, bool)
        v[:n] = True
        return (words_from_numpy(d, dev), torch.from_numpy(p).to(dev),
                torch.from_numpy(v).to(dev))

    pools = [pad_pool(c) for c in clouds]
    rows = []
    for i in range(len(clouds)):
        for j in range(i + 1, len(clouds)):
            dq, pq, vq = pools[i]
            dr, pr, vr = pools[j]
            a, b, ok, _ = match_pools(dq, pq, vq, dr, pr, vr, cutoff=cutoff)
            row = {"query": clouds[i].keyframe_id, "ref": clouds[j].keyframe_id,
                   "matches": int(ok.sum())}
            if row["matches"] >= 25:
                res = align_clouds(a, b, ok, device=dev)
                row.update(icp_ok=bool(res.ok), inliers=int(res.inliers),
                           avg_error=float(res.avg_error),
                           T_qr=res.T_qr.cpu().numpy())
            rows.append(row)
    return rows


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("clouds", nargs="+")
    ap.add_argument("--cutoff", type=int, default=25)
    ap.add_argument("--cpu", action="store_true", help="same as --device cpu")
    ap.add_argument("--device", default="cuda",
                    help="torch device to match on (default: cuda)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    from svi_mapper_tpu_torch.io.cloud import load_cloud

    clouds = [load_cloud(p) for p in args.clouds]
    print(f"loaded {len(clouds)} clouds: " +
          ", ".join(f"kf{c.keyframe_id}({len(c.uids)} pts)" for c in clouds))
    t0 = time.perf_counter()
    for r in match_all(clouds, args.cutoff, device):
        line = f"kf{r['query']} <-> kf{r['ref']}: {r['matches']} matches"
        if "icp_ok" in r:
            line += (f"  ICP ok={r['icp_ok']} inliers={r['inliers']} "
                     f"err={r['avg_error']:.3f}")
        print(line)
    print(f"total matching+ICP time: {time.perf_counter() - t0:.3f} s")


if __name__ == "__main__":
    main()
