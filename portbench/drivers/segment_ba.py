"""Traffic driver ``segment_ba``: a closed loop of map-segment bundle
adjustments through the program's entry, as the back-end calls it when a
loop closes, and the check of every answer against the reference.

* set-up: the camera as the program takes it, a ring of ``ring`` segments
  made on the device from the seed (``portbench.segments``), one warm solve
  of each;
* the window: solve the ring's segments in turn, each solve timed from its
  call to its result on the host (poses, landmarks, chi^2, iteration count
  in one copy), the next solve started when the last has returned;
* the check: the reference (``portbench/reference/lm_ba.py``, float64) solves
  each segment once the window has closed, and every answer of the window
  is held to its segment's solution by the numbers the cell's limits file
  names.

The program's entry is ``svi_mapper_tpu_torch.solvers.ba.bundle_adjust``,
looked up at each call, with ``use_schur_kernel=None`` (K5 at K = 128 on
the card, by shape, as the back-end routes it), the pose chain and, for a
configuration with gravity, the gravity unaries.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import compare, lm_ba
from portbench.segments import camera_numbers, make_ring
from portbench.work.schur import schur_work


def settings(config: dict, traffic: dict) -> lm_ba.Settings:
    cam, ba = camera_numbers(config), config["ba"]
    return lm_ba.Settings(
        fx=cam["fx"], fy=cam["fy"], cx=cam["cx"], cy=cam["cy"], bq=cam["bq"],
        kernel_px2=float(ba["kernel_px2"]), lm_lambda0=float(ba["lm_lambda0"]),
        point_damping=float(ba["point_damping"]),
        max_iterations=int(traffic["max_iterations"]),
        min_rel_improvement=float(traffic["min_rel_improvement"]))


class Driver:
    def __init__(self, run, device: torch.device):
        from svi_mapper_tpu_torch.geometry.camera import StereoCamera, pinhole_from_projection

        if run.config["ba"].get("depth_weighting"):
            raise ValueError("segment_ba drives the BA without depth weighting")
        self.device = device
        c = run.config["camera"]
        self.cam = StereoCamera(
            left=pinhole_from_projection(c["left_projection"], c["width"], c["height"],
                                         device=device),
            right=pinhole_from_projection(c["right_projection"], c["width"], c["height"],
                                          device=device))
        self.settings = settings(run.config, run.traffic)
        self.ring = make_ring(run.traffic, run.config, run.seed, device)
        K, L = run.traffic["keyframes"], run.traffic["landmarks"]
        run.work["schur"] = [schur_work(p.mask.cpu(), K, L) for p in self.ring]
        self.answers: list[tuple[int, dict]] = []

    def warm_up(self) -> None:
        for p in self.ring:
            self.answer(p)

    def solve(self, i: int) -> tuple[int, int]:
        """Solve input ``i`` of the window; keep the answer; return its
        segment and iteration count."""
        seg = i % len(self.ring)
        ans = self.answer(self.ring[seg])
        self.answers.append((seg, ans))
        return seg, int(ans["iterations"])

    def answer(self, p: lm_ba.Problem) -> dict:
        """One solve of ``p`` through the program's entry, its result read
        to the host in one copy."""
        from svi_mapper_tpu_torch.solvers import ba as program_ba

        s = self.settings
        res = program_ba.bundle_adjust(
            p.T, p.X, p.obs, p.mask, self.cam, p.fix, kernel_px2=s.kernel_px2,
            max_iterations=s.max_iterations, lm_lambda0=s.lm_lambda0,
            point_damping=s.point_damping, min_rel_improvement=s.min_rel_improvement,
            odo_M=p.odo_M, odo_w=p.odo_w, grav_d=p.grav_d, grav_w=p.grav_w,
            use_schur_kernel=None, device=self.device)
        K, L = p.mask.shape
        flat = torch.cat([res.T_wc.reshape(-1), res.points_w.reshape(-1),
                          res.chi2_final.reshape(1).to(torch.float32),
                          res.iterations.reshape(1).to(torch.float32)]).cpu().numpy()
        return dict(T=flat[: 16 * K].reshape(K, 4, 4),
                    X=flat[16 * K: 16 * K + 3 * L].reshape(L, 3),
                    chi2=float(flat[-2]), iterations=int(flat[-1]))

    def drop_program_state(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, seg: int, precision: str = "float64") -> dict:
        sol = lm_ba.solve(self.ring[seg], self.settings, precision)
        return dict(T=sol.T.double().cpu().numpy(), X=sol.X.double().cpu().numpy(),
                    chi2=sol.chi2_final, iterations=sol.iterations)

    def check(self, names) -> tuple[dict, list]:
        """The worst of each named number over every answer of the window,
        and each answer's numbers (for the count of failed answers)."""
        refs = {seg: self.reference(seg) for seg in sorted({s for s, _ in self.answers})}
        worst = {n: 0.0 for n in names}
        per_answer = []
        for seg, ans in self.answers:
            got = compare.numbers(ans, refs[seg])
            nums = {n: got[n] if np.isfinite(got[n]) else float("inf") for n in names}
            per_answer.append(nums)
            for n in names:
                worst[n] = max(worst[n], nums[n])
        return worst, per_answer
