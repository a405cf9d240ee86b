"""Convert a dataset into a binary stereo message dump — the
``republisher_kitti`` runnable (republisher_kitti.cpp:28-100: times.txt +
image_0/ + image_1/ -> txt_io message dump), written in the native
``.svid`` format (``svi_mapper_tpu_torch/native/src/dump_io.hpp``) whose
reader prefetches frames on a background thread.

Usage:
  python -m svi_mapper_tpu_torch.tools.make_dump kitti KITTI_ROOT out.svid [--sequence 00]
  python -m svi_mapper_tpu_torch.tools.make_dump synthetic out.svid [--frames 40]
      [--device cuda]

The synthetic frames are rendered on ``--device`` (default cuda) and cross
to the host once each; the dump holds 8-bit images.
"""

from __future__ import annotations

import argparse

import numpy as np


def to_u8(img) -> np.ndarray:
    """A rendered or loaded image (tensor or array) as the dump's uint8."""
    a = img.detach().cpu().numpy() if hasattr(img, "detach") else np.asarray(img)
    return np.clip(a, 0, 255).astype(np.uint8)


def dump_sequence(seq, out, n_frames: int, times=None) -> int:
    """Write frames ``0..n_frames-1`` of ``seq`` (anything with
    ``frame(i) -> (left, right, ...)``) to the dump ``out``; timestamps from
    ``times`` or 0.05 s apart. Returns the frame count validated."""
    from svi_mapper_tpu_torch import native

    L0 = to_u8(seq.frame(0)[0])
    with native.DumpWriter(out, L0.shape[0], L0.shape[1]) as w:
        for i in range(n_frames):
            L, R = seq.frame(i)[:2]
            w.append(i, float(times[i]) if times is not None else i * 0.05,
                     to_u8(L), to_u8(R))
    return native.validate_dump(out)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="source", required=True)
    k = sub.add_parser("kitti")
    k.add_argument("root")
    k.add_argument("out")
    k.add_argument("--sequence", default="00")
    s = sub.add_parser("synthetic")
    s.add_argument("out")
    s.add_argument("--frames", type=int, default=40)
    s.add_argument("--width", type=int, default=640)
    s.add_argument("--height", type=int, default=320)
    for p in (k, s):
        p.add_argument("--device", default="cuda",
                       help="torch device to render / load on (default: cuda)")
    args = ap.parse_args(argv)

    if args.source == "kitti":
        from svi_mapper_tpu_torch.io.kitti import KittiSequence

        seq = KittiSequence(args.root, args.sequence, device=args.device)
        n = seq.n_frames
        valid = dump_sequence(seq, args.out, n, seq.times)
    else:
        from svi_mapper_tpu_torch.io.synthetic import SyntheticSequence

        seq = SyntheticSequence(n_frames=args.frames, width=args.width,
                                height=args.height, device=args.device)
        n = args.frames
        valid = dump_sequence(seq, args.out, n)
    print(f"wrote {n} stereo frames -> {args.out} ({valid} validated)")


if __name__ == "__main__":
    main()
