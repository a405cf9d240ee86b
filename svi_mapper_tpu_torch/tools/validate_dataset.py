"""Dataset sanity checker CLI — the ``validate_dataset`` runnable
(validate_dataset.cpp:73-111).

Usage:
  python -m svi_mapper_tpu_torch.tools.validate_dataset KITTI_ROOT [--sequence 00] [--device cuda]
  python -m svi_mapper_tpu_torch.tools.validate_dataset DUMP.svid

A ``.svid`` dump is checked by the native runtime on the host; a KITTI
folder's camera is built on ``--device`` (default cuda).
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", help="KITTI root directory or .svid dump file")
    ap.add_argument("--sequence", default="00")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the KITTI camera (default: cuda)")
    args = ap.parse_args(argv)

    if args.root.endswith(".svid"):
        from svi_mapper_tpu_torch import native

        try:
            n = native.validate_dump(args.root)
        except ValueError as e:
            print(f"  PROBLEM: {e}")
            raise SystemExit(1)
        print(f"dump {args.root}: {n} stereo frames — OK")
        return

    from svi_mapper_tpu_torch.io.kitti import KittiSequence, validate_sequence

    seq = KittiSequence(args.root, args.sequence, device=args.device)
    problems = validate_sequence(seq)
    print(f"sequence {args.sequence}: {seq.n_frames} stereo frames, "
          f"{seq.cam.width}x{seq.cam.height}, "
          f"ground truth: {'yes' if seq.poses_wc is not None else 'no'}")
    if problems:
        for p in problems:
            print(f"  PROBLEM: {p}")
        raise SystemExit(1)
    print("  OK — streams paired, timestamps monotonic")


if __name__ == "__main__":
    main()
