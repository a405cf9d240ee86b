"""Small cells for the benchmark's CPU tests: the cell's own traffic with
fewer keyframes and landmarks."""

from __future__ import annotations

from portbench import manifest

CELLS = ("kitti00-sv.segment-ba", "kitti00-svi.segment-ba")
BIG_SEED = 2**33 + 12345        # wider than 32 signed bits, as the driver's are


def small_traffic(cell: str, keyframes: int = 4, landmarks: int = 64, ring: int = 2) -> dict:
    tr = dict(manifest.cell(manifest.load(), cell)["traffic"])
    tr.update(keyframes=keyframes, landmarks=landmarks, ring=ring)
    return tr


def limits(cell: str) -> dict:
    return manifest.cell(manifest.load(), cell)["limits"]
