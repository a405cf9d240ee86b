"""Synthetic keyframe-cloud generator — the ``create_cloud`` runnable
(create_cloud.cpp: synthetic probability-cloud generation for matcher
benchmarks).

Generates N keyframe clouds with a controllable fraction of shared
landmarks between consecutive clouds (so the matching/closure tools have
known ground truth), written in ``.npz`` or native ``.svic`` format. The
same arguments and seed give the JAX package's files: the generator draws
from one numpy stream in the same order. Host only.

Usage:
    python -m svi_mapper_tpu_torch.tools.create_cloud OUTDIR \
        [--clouds 4] [--points 256] [--overlap 0.5] [--noise-bits 4] [--svic]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def create_clouds(outdir, clouds: int = 4, points: int = 256,
                  overlap: float = 0.5, noise_bits: int = 4,
                  svic: bool = False, seed: int = 0, log=print) -> list[Path]:
    """Write the clouds; returns their paths in order."""
    from svi_mapper_tpu_torch.io.cloud import KeyframeCloud, save_cloud
    from svi_mapper_tpu_torch.utils.faults import flip_descriptor_bits

    rng = np.random.default_rng(seed)
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    n = points

    def fresh(count, uid0):
        return {
            "uids": np.arange(uid0, uid0 + count, dtype=np.int64),
            "p": rng.normal(0, 10, size=(count, 3)).astype(np.float32)
                 + np.asarray([0, 0, 20], np.float32),
            "d": rng.integers(0, 2 ** 32, size=(count, 8), dtype=np.uint64
                              ).astype(np.uint32),
        }

    prev = fresh(n, 0)
    next_uid = n
    ext = "svic" if svic else "npz"
    paths = []
    for k in range(clouds):
        n_shared = int(overlap * n) if k > 0 else 0
        keep = rng.permutation(n)[:n_shared]
        new = fresh(n - n_shared, next_uid)
        next_uid += n - n_shared
        uids = np.concatenate([prev["uids"][keep], new["uids"]])
        p_w = np.concatenate([prev["p"][keep], new["p"]])
        desc = np.concatenate([
            flip_descriptor_bits(prev["d"][keep], noise_bits, rng),
            new["d"],
        ])
        T_wc = np.eye(4, dtype=np.float32)
        T_wc[2, 3] = -2.0 * k          # camera walks forward 2 m per cloud
        p_cam = p_w @ T_wc[:3, :3].T + T_wc[:3, 3]
        uv = rng.uniform(30, 300, size=(n, 2)).astype(np.float32)
        cloud = KeyframeCloud(
            keyframe_id=k, frame_idx=10 * k, T_wc=T_wc, uids=uids,
            points_w=p_w, points_cam=p_cam, uv_left=uv,
            uv_right=uv - np.asarray([8.0, 0.0], np.float32),
            descriptors=desc,
        )
        path = out / f"cloud_{k:03d}.{ext}"
        save_cloud(path, cloud)
        paths.append(path)
        prev = {"uids": uids, "p": p_w, "d": desc}
        log(f"wrote {path} ({n} pts, {n_shared} shared with previous)")
    return paths


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--clouds", type=int, default=4)
    ap.add_argument("--points", type=int, default=256)
    ap.add_argument("--overlap", type=float, default=0.5,
                    help="fraction of landmarks shared with the previous cloud")
    ap.add_argument("--noise-bits", type=int, default=4,
                    help="descriptor bits flipped on re-observation (the "
                         "reference's disabled bit-noise generator, "
                         "CLandmark.cpp:648-710)")
    ap.add_argument("--svic", action="store_true", help="native binary format")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    create_clouds(args.outdir, args.clouds, args.points, args.overlap,
                  args.noise_bits, args.svic, args.seed)


if __name__ == "__main__":
    main()
