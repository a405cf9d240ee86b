"""Traffic driver ``global_ba``: a closed loop of whole-map bundle
adjustments through the program's entry, as the mapper runs one after a
loop has closed, and the check of every answer against the reference.

* set-up: the camera as the program takes it, a ring of ``ring`` maps made
  on the device from the seed (``portbench.circuit``, sizes from the
  configuration's ``map`` group), one warm solve of each;
* the window: solve the ring's maps in turn, each solve timed from its call
  to its result on the host, the next started when the last has returned
  (``portbench.drivers.segment_ba``'s loop);
* the check: the reference (``portbench/reference/map_ba.py``, float64)
  solves each map once the window has closed, and every answer of the
  window is held to its map's solution by the numbers the cell's limits
  file names.

The program's entry is ``svi_mapper_tpu_torch.solvers.ba.bundle_adjust``
with ``use_schur_kernel=None`` and the pose chain. Where the program counts
its LM loop's graphs and its observation-list route, the counts over the
window close standard error.
"""

from __future__ import annotations

import sys

import torch

from portbench.circuit import make_ring
from portbench.drivers import segment_ba
from portbench.reference import map_ba
from portbench.work.obs_schur import obs_schur_work


def _program_counts() -> dict:
    from svi_mapper_tpu_torch.solvers import ba as program_ba

    counts = {}
    for name in ("graph_counts", "obs_route_counts"):
        fn = getattr(program_ba, name, None)
        if fn is not None:
            counts.update(fn())
    return counts


class Driver(segment_ba.Driver):
    def __init__(self, run, device: torch.device):
        from svi_mapper_tpu_torch.geometry.camera import StereoCamera, pinhole_from_projection

        cfg, tr = run.config, run.traffic
        if cfg["ba"].get("depth_weighting"):
            raise ValueError("global_ba drives the BA without depth weighting")
        if cfg.get("max_iterations", tr["max_iterations"]) != tr["max_iterations"]:
            raise ValueError("the traffic's max_iterations is not the configuration's")
        self.device = device
        c = cfg["camera"]
        self.cam = StereoCamera(
            left=pinhole_from_projection(c["left_projection"], c["width"], c["height"],
                                         device=device),
            right=pinhole_from_projection(c["right_projection"], c["width"], c["height"],
                                          device=device))
        self.settings = segment_ba.settings(cfg, tr)
        self.ring = make_ring(tr, cfg, run.seed, device)
        K, L = cfg["map"]["keyframes"], cfg["map"]["landmarks"]
        run.work["obs_schur"] = [obs_schur_work(p.mask, K, L) for p in self.ring]
        self.answers: list[tuple[int, dict]] = []
        self.window_counts = None

    def solve(self, i: int) -> tuple[int, int]:
        if i == 0:
            self.window_counts = _program_counts()
        return super().solve(i)

    def reference(self, seg: int, precision: str = "float64") -> dict:
        sol = map_ba.solve(self.ring[seg], self.settings, precision)
        return dict(T=sol.T.double().cpu().numpy(), X=sol.X.double().cpu().numpy(),
                    chi2=sol.chi2_final, iterations=sol.iterations)

    def check(self, names) -> tuple[dict, list]:
        if self.window_counts is not None:
            now = _program_counts()
            grown = {k: now[k] - self.window_counts.get(k, 0) for k in now}
            print(f"window program counts {grown}", file=sys.stderr)
        return super().check(names)
