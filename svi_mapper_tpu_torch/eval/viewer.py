"""Map / trajectory visualization — the GUI layer analog (the port's own
copy; numpy, with ``matplotlib`` imported inside :func:`render_map` only).

Replaces the reference's Qt4/QGLViewer stack (``TrackingContextViewer``:
live 3D view of keyframes, trajectory and landmarks with follow-robot mode,
gt_tracking_context_viewer.h:7-37; HUD info box CTrackerGT.cpp:723-758;
legacy CViewerScene/CViewerCloud) with two headless outputs:

* :func:`render_map` — a static PNG (matplotlib Agg): top-down map with
  trajectory / ground truth / keyframes / loop closures over the landmark
  cloud, plus an altitude profile and the per-frame tracking HUD series.
* :func:`export_html` — a single self-contained HTML file with a pan/zoom
  canvas and a frame scrubber (the "live viewer" replacement: open in any
  browser, no server, no Qt). The same inputs give the JAX package's file
  byte for byte.

Colors follow a fixed categorical order (estimate=blue, ground truth=
orange, keyframes=aqua, closures=red); the landmark cloud is muted gray
(context, not a series).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

# fixed categorical assignment (validated palette order; landmarks are
# context and wear muted ink, not a series hue)
COLORS = {
    "estimate": "#2a78d6",
    "ground_truth": "#eb6834",
    "keyframes": "#1baf7a",
    "closures": "#e34948",
    "landmarks": "#b3b1a5",
    "text": "#333333",
    "grid": "#e5e4dd",
}


def _centers(T_wc: np.ndarray) -> np.ndarray:
    R = T_wc[:, :3, :3]
    t = T_wc[:, :3, 3]
    return -np.einsum("nji,nj->ni", R, t)


def render_map(
    path: str | Path,
    trajectory: np.ndarray,                  # [N,4,4] world->camera
    landmarks: np.ndarray | None = None,     # [L,3] world points
    keyframe_indices: list[int] | None = None,
    closures: list[tuple[int, int]] | None = None,   # (frame_i, frame_j)
    ground_truth: np.ndarray | None = None,  # [N,4,4]
    hud: dict[str, np.ndarray] | None = None,  # per-frame series (tracked, ...)
    title: str = "svi_mapper_tpu map",
) -> None:
    """Render the map + HUD to a PNG file."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    p = _centers(np.asarray(trajectory))
    n_rows = 3 if hud else 2
    fig = plt.figure(figsize=(10, 11 if hud else 9), dpi=110)
    gs = fig.add_gridspec(n_rows, 1, height_ratios=[4, 1] + ([1] if hud else []),
                          hspace=0.32)

    # --- top-down (x–z ground plane; y is down in camera convention) ---
    ax = fig.add_subplot(gs[0])
    if landmarks is not None and len(landmarks):
        lm = np.asarray(landmarks)
        ax.scatter(lm[:, 0], lm[:, 2], s=2.5, c=COLORS["landmarks"],
                   linewidths=0, label=f"landmarks ({len(lm)})", zorder=1)
    if ground_truth is not None:
        g = _centers(np.asarray(ground_truth))
        ax.plot(g[:, 0], g[:, 2], color=COLORS["ground_truth"], lw=2,
                label="ground truth", zorder=2)
    ax.plot(p[:, 0], p[:, 2], color=COLORS["estimate"], lw=2,
            label="estimate", zorder=3)
    if keyframe_indices:
        k = np.asarray(keyframe_indices, int)
        k = k[k < len(p)]
        ax.scatter(p[k, 0], p[k, 2], s=26, facecolors="none",
                   edgecolors=COLORS["keyframes"], linewidths=1.4,
                   label=f"keyframes ({len(k)})", zorder=4)
    if closures:
        for (i, j) in closures:
            if i < len(p) and j < len(p):
                ax.plot([p[i, 0], p[j, 0]], [p[i, 2], p[j, 2]],
                        color=COLORS["closures"], lw=1.2, alpha=0.9, zorder=5)
        ax.plot([], [], color=COLORS["closures"], lw=1.2,
                label=f"loop closures ({len(closures)})")
    ax.set_title(title, color=COLORS["text"])
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal", adjustable="datalim")
    ax.legend(loc="best", frameon=False, fontsize=9)

    # --- altitude profile ---
    ax2 = fig.add_subplot(gs[1])
    ax2.plot(np.arange(len(p)), -p[:, 1], color=COLORS["estimate"], lw=1.6)
    if ground_truth is not None:
        g = _centers(np.asarray(ground_truth))
        ax2.plot(np.arange(len(g)), -g[:, 1], color=COLORS["ground_truth"],
                 lw=1.6)
    ax2.set_ylabel("height [m]")
    ax2.set_xlabel("frame")

    # --- HUD series (the on-screen info box, CTrackerGT.cpp:723-758) ---
    if hud:
        ax3 = fig.add_subplot(gs[2])
        for name, series in hud.items():
            ax3.plot(np.arange(len(series)), series, lw=1.4, label=name)
        ax3.set_xlabel("frame")
        ax3.legend(loc="best", frameon=False, fontsize=8, ncols=min(4, len(hud)))

    for a in fig.axes:
        a.grid(True, color=COLORS["grid"], lw=0.6)
        a.set_axisbelow(True)
        for s in ("top", "right"):
            a.spines[s].set_visible(False)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title><style>
body {{ font: 13px system-ui, sans-serif; margin: 0; background: #faf9f5;
       color: #333; }}
#bar {{ padding: 8px 12px; display: flex; gap: 16px; align-items: center; }}
#bar b {{ font-weight: 600; }}
canvas {{ display: block; cursor: grab; }}
input[type=range] {{ width: 320px; }}
.sw {{ display:inline-block; width:10px; height:10px; border-radius:2px;
      margin-right:4px; vertical-align:-1px; }}
</style></head><body>
<div id="bar">
  <b>{title}</b>
  <span><span class="sw" style="background:#2a78d6"></span>estimate</span>
  <span id="gtlab" style="display:none"><span class="sw"
    style="background:#eb6834"></span>ground truth</span>
  <span><span class="sw" style="background:#b3b1a5"></span>landmarks</span>
  <span><span class="sw" style="background:#e34948"></span>closures</span>
  <label>frame <input id="scrub" type="range" min="1" value="0"></label>
  <span id="info"></span>
</div>
<canvas id="c"></canvas>
<script>
const DATA = {data};
const canvas = document.getElementById("c");
const scrub = document.getElementById("scrub");
const info = document.getElementById("info");
const ctx = canvas.getContext("2d");
let scale = 1, ox = 0, oy = 0, drag = null, frame = DATA.traj.length;
scrub.max = DATA.traj.length; scrub.value = frame;
if (DATA.gt.length) document.getElementById("gtlab").style.display = "";
function fit() {{
  canvas.width = innerWidth; canvas.height = innerHeight - 44;
  const xs = DATA.traj.map(p => p[0]), zs = DATA.traj.map(p => p[1]);
  const w = Math.max(...xs) - Math.min(...xs) || 1;
  const h = Math.max(...zs) - Math.min(...zs) || 1;
  scale = 0.85 * Math.min(canvas.width / w, canvas.height / h);
  ox = canvas.width / 2 - scale * (Math.min(...xs) + w / 2);
  oy = canvas.height / 2 + scale * (Math.min(...zs) + h / 2);
  draw();
}}
const X = p => ox + scale * p[0], Y = p => oy - scale * p[1];
function draw() {{
  ctx.fillStyle = "#faf9f5"; ctx.fillRect(0, 0, canvas.width, canvas.height);
  ctx.fillStyle = "#b3b1a5";
  for (const p of DATA.lm) ctx.fillRect(X(p) - 1, Y(p) - 1, 2, 2);
  function path(pts, color, lw) {{
    if (pts.length < 2) return;
    ctx.strokeStyle = color; ctx.lineWidth = lw; ctx.beginPath();
    ctx.moveTo(X(pts[0]), Y(pts[0]));
    for (const p of pts.slice(1)) ctx.lineTo(X(p), Y(p));
    ctx.stroke();
  }}
  path(DATA.gt.slice(0, frame), "#eb6834", 2);
  path(DATA.traj.slice(0, frame), "#2a78d6", 2);
  ctx.strokeStyle = "#1baf7a"; ctx.lineWidth = 1.4;
  for (const k of DATA.kf) if (k < frame) {{
    ctx.beginPath();
    ctx.arc(X(DATA.traj[k]), Y(DATA.traj[k]), 5, 0, 6.3); ctx.stroke();
  }}
  ctx.strokeStyle = "#e34948"; ctx.lineWidth = 1.2;
  for (const [i, j] of DATA.cl) if (i < frame && j < frame) {{
    ctx.beginPath(); ctx.moveTo(X(DATA.traj[i]), Y(DATA.traj[i]));
    ctx.lineTo(X(DATA.traj[j]), Y(DATA.traj[j])); ctx.stroke();
  }}
  const cur = DATA.traj[Math.min(frame, DATA.traj.length) - 1];
  if (cur) {{
    ctx.fillStyle = "#2a78d6"; ctx.beginPath();
    ctx.arc(X(cur), Y(cur), 5, 0, 6.3); ctx.fill();
  }}
  info.textContent = `frame ${{frame}}/${{DATA.traj.length}}` +
    (DATA.hud.tracked ? `  tracked ${{DATA.hud.tracked[frame - 1] ?? ""}}` : "");
}}
scrub.oninput = () => {{ frame = +scrub.value; draw(); }};
canvas.onmousedown = e => {{ drag = [e.clientX, e.clientY]; }};
onmousemove = e => {{ if (!drag) return;
  ox += e.clientX - drag[0]; oy += e.clientY - drag[1];
  drag = [e.clientX, e.clientY]; draw(); }};
onmouseup = () => drag = null;
canvas.onwheel = e => {{ e.preventDefault();
  const f = e.deltaY < 0 ? 1.15 : 1 / 1.15;
  ox = e.clientX - f * (e.clientX - ox); oy = e.clientY - f * (e.clientY - oy);
  scale *= f; draw(); }};
onresize = fit; fit();
</script></body></html>
"""


def export_html(
    path: str | Path,
    trajectory: np.ndarray,
    landmarks: np.ndarray | None = None,
    keyframe_indices: list[int] | None = None,
    closures: list[tuple[int, int]] | None = None,
    ground_truth: np.ndarray | None = None,
    hud: dict[str, list] | None = None,
    title: str = "svi_mapper_tpu viewer",
    max_landmarks: int = 20000,
) -> None:
    """Write a self-contained interactive HTML viewer (pan/zoom/scrub)."""
    p = _centers(np.asarray(trajectory))
    lm = np.asarray(landmarks)[:max_landmarks] if landmarks is not None else np.zeros((0, 3))
    gt = _centers(np.asarray(ground_truth)) if ground_truth is not None else np.zeros((0, 3))
    data = {
        "traj": np.round(p[:, [0, 2]], 4).tolist(),
        "gt": np.round(gt[:, [0, 2]], 4).tolist() if len(gt) else [],
        "lm": np.round(lm[:, [0, 2]], 3).tolist() if len(lm) else [],
        "kf": [int(k) for k in (keyframe_indices or [])],
        "cl": [[int(i), int(j)] for (i, j) in (closures or [])],
        "hud": {k: [int(x) for x in v] for k, v in (hud or {}).items()},
    }
    Path(path).write_text(
        _HTML_TEMPLATE.format(title=title, data=json.dumps(data)))


def snapshot_tracker(tracker) -> dict:
    """Collect viewer inputs from a live tracker/SLAM system of the port
    (its tensors are read to the host, every row of a sharded table: then
    every rank must call it, a gather)."""
    from svi_mapper_tpu_torch.convert import host_arrays

    t = tracker.state.table
    active, pos_w = host_arrays(t.active, t.pos_w)
    out = {
        "trajectory": (tracker.optimized_trajectory()
                       if hasattr(tracker, "optimized_trajectory")
                       else tracker.trajectory_array),
        "landmarks": pos_w[active],
    }
    if tracker.outputs:   # not carried through checkpoints
        out["hud"] = {
            "tracked": [int(o.n_tracked) for o in tracker.outputs],
            "active": [int(o.n_active) for o in tracker.outputs],
        }
    kfs = getattr(tracker, "slam_keyframes", None) or tracker.keyframes
    out["keyframe_indices"] = [k.frame_idx for k in kfs]
    closures = getattr(tracker, "accepted_closures", [])
    frame_of = {k.index: k.frame_idx for k in kfs}
    out["closures"] = [
        (frame_of.get(c.ref_kf, 0), frame_of.get(c.query_kf, 0))
        for c in closures
    ]
    return out
