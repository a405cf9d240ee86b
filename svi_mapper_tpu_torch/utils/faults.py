"""Fault injection for robustness testing.

The reference ships a *disabled* descriptor bit-noise generator inside
``CLandmark`` (CLandmark.cpp:648-710, ``#define NUMBER_OF_NOISY_BITS``
CLandmark.cpp:8) — the only fault-injection hook it has. Here the hooks are
test utilities: descriptor bit flips, measurement dropout and pose
perturbation, all deterministic under a caller-provided
``np.random.Generator``. They draw from it in the JAX package's order, so
one seed plants the same faults in both packages.
"""

from __future__ import annotations

import numpy as np

from svi_mapper_tpu_torch.ops.descriptors import DESCRIPTOR_BITS, words_u32


def flip_descriptor_bits(
    desc: np.ndarray, n_bits: int, rng: np.random.Generator
) -> np.ndarray:
    """Flip ``n_bits`` random bits per descriptor (ref noisy-descriptor
    generator, CLandmark.cpp:648-710). ``desc``: [..., 8] packed words,
    uint32 or int32 bit patterns; the result has ``desc``'s dtype."""
    desc = np.asarray(desc)
    if n_bits <= 0:
        return desc.copy()
    out = words_u32(desc).copy()
    flat = out.reshape(-1, out.shape[-1])
    for row in flat:
        bits = rng.choice(DESCRIPTOR_BITS, size=n_bits, replace=False)
        for b in bits:
            row[b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return out.view(np.int32) if desc.dtype == np.int32 else out


def drop_measurements(
    mask: np.ndarray, drop_fraction: float, rng: np.random.Generator
) -> np.ndarray:
    """Randomly clear a fraction of True entries in a validity mask
    (simulates tracking losses feeding the failure-counter path,
    ref uFailedSubsequentTrackings cap CFundamentalMatcher.h:83)."""
    mask = np.asarray(mask, bool).copy()
    idx = np.flatnonzero(mask)
    n_drop = int(drop_fraction * len(idx))
    if n_drop:
        mask[rng.choice(idx, size=n_drop, replace=False)] = False
    return mask


def perturb_pose(
    T_wc: np.ndarray, sigma_t: float, sigma_r: float, rng: np.random.Generator
) -> np.ndarray:
    """Left-multiply a small random SE(3) perturbation (exercises the
    prior-consistency RISK rejection, CSolverStereoPosit.cpp:144-150)."""
    w = rng.normal(0, sigma_r, 3)
    t = rng.normal(0, sigma_t, 3)
    theta = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if theta < 1e-12:
        R = np.eye(3)
    else:
        K = K / theta
        R = (np.eye(3) + np.sin(theta) * K
             + (1 - np.cos(theta)) * (K @ K))
    D = np.eye(4)
    D[:3, :3] = R
    D[:3, 3] = t
    return (D @ np.asarray(T_wc)).astype(np.float32)
