"""g2o-format pose-graph snapshots.

The reference persists its graphs as ``g2o/local/keyframes_<a>-<b>.g2o``
before and after every back-end optimization (Cg2oOptimizer.cpp:493-514),
which makes runs inspectable with standard g2o tooling. This module writes
the same text format (``VERTEX_SE3:QUAT`` / ``EDGE_SE3:QUAT`` /
``VERTEX_TRACKXYZ``) from the framework's keyframe/closure state, and reads
it back for round-trip tests and offline relaxation experiments. Numpy
only; the live landmark table is read from its device once per snapshot.

Conventions: vertex id = keyframe index; landmark vertex ids are shifted by
``LANDMARK_ID_SHIFT`` (the reference separates the id spaces by 10^6,
Cg2oOptimizer.h:83). Poses are camera->world (g2o convention), stored
internally as world->camera.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

LANDMARK_ID_SHIFT = 1_000_000   # ref Cg2oOptimizer.h:83


def _quat_from_R(R: np.ndarray) -> np.ndarray:
    """One rotation matrix -> (qx, qy, qz, qw), g2o order."""
    w = np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 0.0)) / 2.0
    if w > 1e-6:
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:
        k = int(np.argmax(np.diagonal(R)))
        a, b, c = k, (k + 1) % 3, (k + 2) % 3
        s = np.sqrt(max(1.0 + R[a, a] - R[b, b] - R[c, c], 1e-12)) * 2
        v = np.zeros(3)
        v[a] = 0.25 * s
        v[b] = (R[b, a] + R[a, b]) / s
        v[c] = (R[c, a] + R[a, c]) / s
        w = (R[c, b] - R[b, c]) / s
        x, y, z = v
    q = np.array([x, y, z, w])
    return q / np.linalg.norm(q)


def _R_from_quat(x, y, z, w):
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def save_g2o(
    path: str | Path,
    T_wc: np.ndarray,                    # [N,4,4] keyframe world->camera
    edges: list[tuple[int, int, np.ndarray]] | None = None,
    # each edge is (i, j, M_ij) with M_ij = T_wc_j @ inv(T_wc_i) — the
    # framework's relative-pose convention (models.slam sequential/closure
    # edges); written to g2o as Z_ij = inv(P_i) P_j = inv(M_ij)
    edge_information: float = 1e5,       # ref EdgeSE3 info 1e5*I, :1258-1266
    fixed: int | None = 0,
    landmarks: np.ndarray | None = None,     # [L,3] world points
    landmark_ids: np.ndarray | None = None,  # [L] uids
) -> None:
    """Write a pose graph (+ optional landmark vertices) in g2o text format."""
    lines = []
    P = np.linalg.inv(np.asarray(T_wc))  # camera->world poses
    for i, T in enumerate(P):
        q = _quat_from_R(T[:3, :3])
        t = T[:3, 3]
        lines.append(
            f"VERTEX_SE3:QUAT {i} "
            f"{t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
            f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}")
    if fixed is not None and len(P):
        lines.append(f"FIX {fixed}")
    if landmarks is not None:
        ids = (landmark_ids if landmark_ids is not None
               else np.arange(len(landmarks)))
        for uid, p in zip(ids, np.asarray(landmarks)):
            lines.append(
                f"VERTEX_TRACKXYZ {int(uid) + LANDMARK_ID_SHIFT} "
                f"{p[0]:.9f} {p[1]:.9f} {p[2]:.9f}")
    # information matrix upper triangle (6x6), isotropic
    info = np.eye(6) * edge_information
    triu = " ".join(f"{info[r, c]:.6g}"
                    for r in range(6) for c in range(r, 6))
    for (i, j, M_ij) in (edges or []):
        Z = np.linalg.inv(np.asarray(M_ij))   # pose of j in i's frame
        q = _quat_from_R(Z[:3, :3])
        t = Z[:3, 3]
        lines.append(
            f"EDGE_SE3:QUAT {i} {j} "
            f"{t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
            f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {triu}")
    Path(path).write_text("\n".join(lines) + "\n")


def load_g2o(path: str | Path):
    """Read back a g2o file -> (T_wc [N,4,4], edges [(i, j, M_ij)],
    landmarks {uid: xyz}) in the framework's conventions."""
    poses = {}
    edges = []
    landmarks = {}
    for line in Path(path).read_text().splitlines():
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "VERTEX_SE3:QUAT":
            i = int(tok[1])
            t = np.array([float(v) for v in tok[2:5]])
            x, y, z, w = (float(v) for v in tok[5:9])
            T = np.eye(4)
            T[:3, :3] = _R_from_quat(x, y, z, w)
            T[:3, 3] = t
            poses[i] = np.linalg.inv(T)      # back to world->camera
        elif tok[0] == "VERTEX_TRACKXYZ":
            landmarks[int(tok[1]) - LANDMARK_ID_SHIFT] = np.array(
                [float(v) for v in tok[2:5]])
        elif tok[0] == "EDGE_SE3:QUAT":
            i, j = int(tok[1]), int(tok[2])
            t = np.array([float(v) for v in tok[3:6]])
            x, y, z, w = (float(v) for v in tok[6:10])
            M = np.eye(4)
            M[:3, :3] = _R_from_quat(x, y, z, w)
            M[:3, 3] = t
            edges.append((i, j, np.linalg.inv(M)))
    N = max(poses) + 1 if poses else 0
    T_wc = np.stack([poses[i] for i in range(N)]) if N else np.zeros((0, 4, 4))
    return T_wc.astype(np.float32), edges, landmarks


def snapshot_slam(slam, path: str | Path, include_landmarks: bool = True) -> None:
    """Write the live SLAM graph (keyframe chain + accepted closures +
    active landmarks) — the role of the reference's per-optimization
    ``keyframes_*-*.g2o`` snapshots. On a sharded state every rank must
    call it: the landmarks are gathered, rank 0 writes, and the ranks
    return together."""
    kfs = slam.slam_keyframes
    if not kfs:
        return
    from svi_mapper_tpu_torch import convert

    T = np.stack([k.T_wc for k in kfs])
    edges = []
    for k in range(1, len(kfs)):
        edges.append((k - 1, k, (T[k] @ np.linalg.inv(T[k - 1]))))
    for c in slam.accepted_closures:
        edges.append((c.ref_kf, c.query_kf, c.T_qr))
    lm = uid = None
    if include_landmarks:
        t = slam.state.table
        sel, pos_w, uids = convert.host_arrays(t.active, t.pos_w, t.uid)
        lm, uid = pos_w[sel], uids[sel]
    convert.write_on_rank0(slam.state, lambda: save_g2o(
        path, T, edges, landmarks=lm, landmark_ids=uid))
