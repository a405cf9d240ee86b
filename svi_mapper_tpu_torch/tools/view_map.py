"""Map viewer CLI — the GUI runnable analog (TrackingContextViewer,
gt_tracking_context_viewer.h:7-37, driven from tracker_gt.cpp:177-179).

Renders a checkpoint (io.checkpoint) or a KITTI trajectory file to a static
PNG (needs matplotlib) and/or an interactive single-file HTML viewer. A
checkpoint is loaded onto the CPU: drawing needs no card.

Usage:
    python -m svi_mapper_tpu_torch.tools.view_map CKPT.npz --png map.png --html map.html
    python -m svi_mapper_tpu_torch.tools.view_map TRAJ.txt --gt GT.txt --png map.png
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("input", help="checkpoint .npz or KITTI trajectory .txt")
    ap.add_argument("--gt", help="ground-truth KITTI trajectory")
    ap.add_argument("--png")
    ap.add_argument("--html")
    ap.add_argument("--title", default="svi_mapper_tpu map")
    args = ap.parse_args(argv)
    if not (args.png or args.html):
        raise SystemExit("pass --png and/or --html")

    from svi_mapper_tpu_torch.eval import trajectory as ev
    from svi_mapper_tpu_torch.eval import viewer

    gt = ev.load_kitti_trajectory(args.gt) if args.gt else None

    if args.input.endswith(".npz"):
        from svi_mapper_tpu_torch.io.checkpoint import load_checkpoint

        tracker = load_checkpoint(args.input, device="cpu")
        snap = viewer.snapshot_tracker(tracker)
        snap["ground_truth"] = gt
    else:
        snap = {"trajectory": ev.load_kitti_trajectory(args.input),
                "ground_truth": gt}

    if args.png:
        viewer.render_map(args.png, title=args.title, **snap)
        print(f"wrote {args.png}")
    if args.html:
        viewer.export_html(args.html, title=args.title, **snap)
        print(f"wrote {args.html}")


if __name__ == "__main__":
    main()
