"""Republish a live stereo image stream into a message dump — the
``republisher_node`` runnable (republisher_node.cpp: live ROS topics ->
txt_io dump; the ROS transport is replaced by a watched drop-directory pair,
the headless equivalent for sensors that write frames to disk).

Watches ``WATCH/left`` and ``WATCH/right`` for incoming image files, pairs
them by sorted filename (hidden files, a producer's in-flight temporaries,
are left out), and appends each pair to a native ``.svid`` dump
(svi_mapper_tpu_torch/native/src/dump_io.hpp) as they arrive. Timestamps come
from a float-parseable file stem (e.g. ``0001.250000.png``) or file mtime.
Stops after ``--idle-timeout`` seconds without new frames, or after
``--max-frames``. Host only: no device is touched.

Usage:
  python -m svi_mapper_tpu_torch.tools.republish_stream WATCH_DIR OUT.svid \\
      [--left left --right right] [--poll 0.2] [--idle-timeout 10]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".pgm", ".bmp"}


def _stamp(path: Path) -> float:
    try:
        return float(path.stem)
    except ValueError:
        return path.stat().st_mtime


def _ready(d: Path) -> list[Path]:
    # a hidden name is a producer's file still being written (the usual
    # write-then-rename idiom): it sorts first and would shift the pairing
    return sorted(p for p in d.iterdir()
                  if p.suffix.lower() in IMAGE_EXTS and not p.name.startswith("."))


def republish(
    watch_dir: str | Path,
    out_path: str | Path,
    *,
    left: str = "left",
    right: str = "right",
    poll_s: float = 0.2,
    idle_timeout_s: float = 10.0,
    max_frames: int | None = None,
    log=print,
) -> int:
    """Run the watch/pair/append loop; returns the number of frames written."""
    from svi_mapper_tpu_torch import native
    from svi_mapper_tpu_torch.io.kitti import _read_image

    ldir = Path(watch_dir) / left
    rdir = Path(watch_dir) / right
    ldir.mkdir(parents=True, exist_ok=True)
    rdir.mkdir(parents=True, exist_ok=True)

    writer = None
    n = 0
    last_new = time.monotonic()
    try:
        while True:
            ls, rs = _ready(ldir), _ready(rdir)
            pairs = min(len(ls), len(rs))
            while n < pairs:
                try:
                    L = _read_image(ls[n])
                    R = _read_image(rs[n])
                except Exception:
                    # a file may still be mid-write by the producer — leave
                    # it for the next poll (the reference's republisher_node
                    # reads complete sensor messages, so never hits this)
                    break
                if writer is None:
                    writer = native.DumpWriter(
                        str(out_path), L.shape[0], L.shape[1])
                writer.append(
                    n, _stamp(ls[n]),
                    np.clip(L, 0, 255).astype(np.uint8),
                    np.clip(R, 0, 255).astype(np.uint8),
                )
                log(f"[{n}] {ls[n].name} <-> {rs[n].name}")
                n += 1
                last_new = time.monotonic()
            if max_frames is not None and n >= max_frames:
                break
            if time.monotonic() - last_new > idle_timeout_s:
                break
            time.sleep(poll_s)
    finally:
        if writer is not None:
            writer.close()
    return n


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("watch_dir")
    ap.add_argument("out")
    ap.add_argument("--left", default="left")
    ap.add_argument("--right", default="right")
    ap.add_argument("--poll", type=float, default=0.2)
    ap.add_argument("--idle-timeout", type=float, default=10.0)
    ap.add_argument("--max-frames", type=int, default=None)
    args = ap.parse_args(argv)
    n = republish(
        args.watch_dir, args.out, left=args.left, right=args.right,
        poll_s=args.poll, idle_timeout_s=args.idle_timeout,
        max_frames=args.max_frames,
    )
    print(f"republished {n} stereo frames -> {args.out}")


if __name__ == "__main__":
    main()
