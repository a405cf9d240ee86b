"""Extract BRIEF descriptor sets from a directory of images — the
``compute_descriptors_holidays`` runnable (compute_descriptors_holidays.cpp):
detect corners, extract binary descriptors, and save them per image for
offline matching benchmarks and vocabulary training.

Output ``.npz`` layout: ``desc`` [N, 8] uint32 packed descriptors,
``uv`` [N, 2] float32 keypoints, ``doc_ids`` [N] int32 image index,
``names`` [D] str image file names.

The blur, corners and descriptors run op by op on ``--device`` (default
cuda; ``--cpu`` is ``--device cpu``), in the order the JAX package writes
them. Its tool compiles them as one XLA program, whose fused blur rounds
otherwise on 8-bit images and so decides some BRIEF ties the other way
(ROADMAP queue 3, F13). Reading images needs cv2 or PIL.

Usage:
  python -m svi_mapper_tpu_torch.tools.compute_descriptors IMAGE_DIR -o OUT.npz
"""

from __future__ import annotations

import argparse
from pathlib import Path

IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".pgm", ".bmp", ".tif", ".tiff"}


def extract(img, max_per_image: int, quality: float):
    """``(uv [k, 2], desc [k, 8] int32, valid [k])`` of one float32 image:
    Gaussian blur, grid-spread corners, BRIEF at the corners."""
    from svi_mapper_tpu_torch.ops.corners import detect_corners
    from svi_mapper_tpu_torch.ops.descriptors import brief_descriptors
    from svi_mapper_tpu_torch.ops.image import gaussian_blur

    smooth = gaussian_blur(img)
    uv, _, valid = detect_corners(smooth, k=max_per_image, quality=quality)
    return uv, brief_descriptors(smooth, uv), valid


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("image_dir")
    ap.add_argument("-o", "--out", default="descriptors.npz")
    ap.add_argument("--max-per-image", type=int, default=512)
    ap.add_argument("--quality", type=float, default=0.01)
    from svi_mapper_tpu_torch.utils.device import add_device_arguments, device_argument

    add_device_arguments(ap)
    args = ap.parse_args(argv)
    dev = device_argument(args)

    import numpy as np
    import torch

    from svi_mapper_tpu_torch.io.kitti import _read_image
    from svi_mapper_tpu_torch.ops.descriptors import words_to_numpy

    paths = sorted(p for p in Path(args.image_dir).iterdir()
                   if p.suffix.lower() in IMAGE_EXTS)
    if not paths:
        raise SystemExit(f"no images in {args.image_dir}")

    all_desc, all_uv, all_doc = [], [], []
    for i, p in enumerate(paths):
        img = torch.from_numpy(_read_image(p)).to(dev)
        uv, desc, valid = extract(img, args.max_per_image, args.quality)
        v = valid.cpu().numpy()
        all_desc.append(words_to_numpy(desc)[v])
        all_uv.append(uv.cpu().numpy()[v])
        all_doc.append(np.full(int(v.sum()), i, np.int32))
        print(f"[{i + 1}/{len(paths)}] {p.name}: {int(v.sum())} descriptors")

    np.savez_compressed(
        args.out,
        desc=np.concatenate(all_desc).astype(np.uint32),
        uv=np.concatenate(all_uv).astype(np.float32),
        doc_ids=np.concatenate(all_doc),
        names=np.array([p.name for p in paths]),
    )
    print(f"wrote {sum(len(d) for d in all_desc)} descriptors "
          f"from {len(paths)} images -> {args.out}")


if __name__ == "__main__":
    main()
