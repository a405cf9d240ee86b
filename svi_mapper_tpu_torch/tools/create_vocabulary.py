"""Train a binary BoW vocabulary from descriptor dumps or keyframe clouds —
the ``create_vocabulary_dbow2`` runnable (create_vocabulary_dbow2.cpp, which
builds the ``brief_k10L6.voc.gz`` vocabulary loaded at CTrackerGT.cpp:39).

Inputs: any mix of
  * ``.npz`` descriptor dumps from ``tools.compute_descriptors``
    (keys ``desc`` [+ ``doc_ids``]), or
  * keyframe cloud files (``.npz``/``.svic`` io.cloud format) — each cloud
    is one document.

The k-medians run on ``--device`` (default cuda; ``--cpu`` is ``--device
cpu``); the file is the JAX package's format.

Usage:
  python -m svi_mapper_tpu_torch.tools.create_vocabulary INPUTS... -o vocab.npz \\
      [--k 8] [--levels 4] [--iters 8]
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("inputs", nargs="+")
    ap.add_argument("-o", "--out", default="vocab.npz")
    ap.add_argument("--k", type=int, default=8, help="branching factor")
    ap.add_argument("--levels", type=int, default=4, help="tree depth")
    ap.add_argument("--iters", type=int, default=8, help="k-medians iterations")
    ap.add_argument("--seed", type=int, default=0)
    from svi_mapper_tpu_torch.utils.device import add_device_arguments, device_argument

    add_device_arguments(ap)
    args = ap.parse_args(argv)
    dev = device_argument(args)

    import numpy as np

    from svi_mapper_tpu_torch.io.cloud import load_cloud
    from svi_mapper_tpu_torch.mapping.vocabulary import build_vocabulary, save_vocabulary

    descs, docs = [], []
    next_doc = 0
    for path in args.inputs:
        if path.endswith(".svic"):
            c = load_cloud(path)
            d, ids = c.descriptors, np.full(len(c.descriptors), next_doc, np.int32)
            next_doc += 1
        else:
            z = np.load(path)
            if "desc" in z:          # compute_descriptors dump
                d = z["desc"]
                ids = (z["doc_ids"].astype(np.int32) + next_doc
                       if "doc_ids" in z
                       else np.full(len(d), next_doc, np.int32))
                next_doc = int(ids.max()) + 1 if len(ids) else next_doc
            elif "descriptors" in z:  # keyframe cloud
                d = z["descriptors"]
                ids = np.full(len(d), next_doc, np.int32)
                next_doc += 1
            else:
                raise SystemExit(f"{path}: no 'desc' or 'descriptors' array")
        descs.append(np.asarray(d, np.uint32))
        docs.append(ids)

    desc = np.concatenate(descs)
    doc_ids = np.concatenate(docs)
    print(f"training on {len(desc)} descriptors from {next_doc} documents: "
          f"k={args.k} levels={args.levels} ({args.k ** args.levels} words)")
    vocab = build_vocabulary(
        desc, k=args.k, levels=args.levels, iters=args.iters,
        seed=args.seed, doc_ids=doc_ids, device=dev,
    )
    save_vocabulary(args.out, vocab)
    w = vocab.weights.cpu().numpy()
    print(f"wrote {args.out}: {int((w > 0).sum())}/{vocab.num_words} words used, "
          f"idf range [{w[w > 0].min():.3f}, {w.max():.3f}]"
          if (w > 0).any() else f"wrote {args.out}")


if __name__ == "__main__":
    main()
