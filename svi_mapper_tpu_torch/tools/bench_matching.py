"""Descriptor-matching benchmark — the ``match_clouds_holidays`` /
``compute_descriptors_holidays`` harness family (match_clouds_holidays.cpp,
compute_descriptors_holidays.cpp: BTree vs BoW vs brute-force comparison).

Compares the matching backends on saved keyframe clouds (or synthetic ones
via ``tools.create_cloud``), the first cloud querying the others:
  * the all-pairs Hamming matrix alone (``ops.hamming.hamming_distance_matrix``,
    kernel K6's matrix entry on the card);
  * device brute force (``ops.hamming.match_nearest``: the matrix, the
    nearest neighbour and the cutoff) — exact, the recall reference;
  * the native C++ descriptor search tree
    (``svi_mapper_tpu_torch.native.DescriptorIndex``, on the host);
  * probabilistic expected-Hamming (``mapping.bitstats``) on binary pools,
reporting per-backend query throughput and agreement with brute force.
Device times end in a synchronisation.

Usage: python -m svi_mapper_tpu_torch.tools.bench_matching CLOUD1 CLOUD2 ...
           [--cpu | --device cuda]
"""

from __future__ import annotations

import argparse
import time


def _timed(fn, reps: int, sync) -> tuple[float, object]:
    """Seconds per call of ``fn`` over ``reps`` calls after one warm-up, and
    the last result."""
    out = fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    sync()
    return (time.perf_counter() - t0) / reps, out


def bench(clouds: list, cutoff: int = 25, reps: int = 3, device="cuda") -> dict:
    """The four backends on ``clouds[0]`` against ``clouds[1:]``: seconds
    per query batch and what each found."""
    import numpy as np
    import torch

    from svi_mapper_tpu_torch import native
    from svi_mapper_tpu_torch.mapping.bitstats import match_probabilistic
    from svi_mapper_tpu_torch.ops.descriptors import (
        unpack_bits,
        words_from_numpy,
        words_u32,
    )
    from svi_mapper_tpu_torch.ops.hamming import hamming_distance_matrix, match_nearest

    if len(clouds) < 2:
        raise SystemExit("need at least 2 clouds (query + references)")
    dev = torch.device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    query, refs = clouds[0], clouds[1:]
    q_np = words_u32(query.descriptors)
    train_np = np.concatenate([words_u32(c.descriptors) for c in refs], axis=0)
    q = words_from_numpy(q_np, dev)
    train = words_from_numpy(train_np, dev)
    out = {"queries": len(q_np), "stored": len(train_np), "clouds": len(refs)}

    dt, _ = _timed(lambda: hamming_distance_matrix(q, train), reps, sync)
    out["matrix_s"] = dt

    dt, (idx, _dist, ok) = _timed(lambda: match_nearest(q, train, cutoff), reps, sync)
    idx, ok = idx.cpu().numpy(), ok.cpu().numpy()
    out.update(brute_force_s=dt, brute_force_matches=int(ok.sum()))

    index = native.DescriptorIndex()
    for k, c in enumerate(refs):
        index.add(c.descriptors, k)
    dt, votes = _timed(lambda: index.query(q_np, cutoff=cutoff), reps, lambda: None)
    out.update(tree_s=dt, tree_votes=[int(v) for v in votes[:len(refs)]])
    # the brute-force reference's votes: the cloud of each query's match
    owner = np.concatenate([np.full(len(c.uids), k) for k, c in enumerate(refs)])
    out["brute_force_votes"] = [int(v) for v in
                                np.bincount(owner[idx[ok]], minlength=len(refs))]

    mean_bits = unpack_bits(train).to(torch.float32)
    valid = torch.ones(len(train_np), dtype=torch.bool, device=dev)
    dt, (pidx, _pd, pok) = _timed(
        lambda: match_probabilistic(q, mean_bits, valid, cutoff=float(cutoff)),
        reps, sync)
    pidx, pok = pidx.cpu().numpy(), pok.cpu().numpy()
    both = ok & pok
    out.update(probabilistic_s=dt, probabilistic_matches=int(pok.sum()),
               probabilistic_agreement=(float((pidx[both] == idx[both]).mean())
                                        if both.any() else 1.0))
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("clouds", nargs="+")
    ap.add_argument("--cutoff", type=int, default=25)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true", help="same as --device cpu")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the device backends (default: cuda)")
    args = ap.parse_args(argv)

    from svi_mapper_tpu_torch.io.cloud import load_cloud

    r = bench([load_cloud(p) for p in args.clouds], args.cutoff, args.reps,
              "cpu" if args.cpu else args.device)
    n = r["queries"]
    print(f"{n} query descriptors vs {r['stored']} stored ({r['clouds']} clouds)")
    print(f"hamming matrix:       {n / r['matrix_s']:,.0f} queries/s")
    print(f"brute-force device:   {r['brute_force_matches']} matches   "
          f"{n / r['brute_force_s']:,.0f} queries/s")
    print(f"native tree index:    {sum(r['tree_votes'])} votes      "
          f"{n / r['tree_s']:,.0f} queries/s "
          f"(per-keyframe vote counts: {r['tree_votes']})")
    print(f"probabilistic matmul: {r['probabilistic_matches']} matches   "
          f"{n / r['probabilistic_s']:,.0f} queries/s   "
          f"agreement with brute force: {r['probabilistic_agreement'] * 100:.1f} %")


if __name__ == "__main__":
    main()
