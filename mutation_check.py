"""Does ``chip_smoke.py`` catch a wrong Schur-assembly kernel? And what do
the kernel's small-window instances buy?

    python3 mutation_check.py [fault ...]
    python3 mutation_check.py --instances

A developer's check, run from the repository root; needs one CUDA card and
``nvcc``. For each named fault the package and ``chip_smoke.py`` are copied to
a temporary directory, the fault is planted in the copy's
``csrc/schur_assemble.cu``, and the copy's ``chip_smoke.check_backend_kernels``
(build + every shape of the ``kernels_backend`` phase) runs in a process of
its own. A fault is *caught* when that process fails. The unchanged copy
runs first and must pass. Prints one JSON line per fault and exits non-zero
if the control fails or a fault that changes the result goes uncaught.

Two of the faults are listed as ``equivalent`` — no input can tell them from
the unchanged kernel — each beside a fault of the same kind that does change
the result and must be caught:

* ``>=`` for ``>`` at the robust kernel: at ``err2 == kernel_px2`` both
  branches give the weight 1 (beside it: the robust branch never taken);
* a keyframe tile that starts one tile further on (cyclically): a block
  labels everything it reads and writes with the same global keyframe index,
  so the blocks merely swap their work (beside it: the tile offset dropped
  where the pose is read).

The two ``hll_inv_written_*`` faults change only the ``Hll_inv`` the kernel
writes out (and through it ``rhs``), not the inverse it uses for ``S``. The
message names every output that failed: the 3 % one is small enough to pass
``rhs`` and shows what the per-landmark comparison of ``Hll_inv`` adds.

``--instances`` times K4 (the launch alone over 50 calls, and the traced
device time of its two kernels over 20, 4096 landmarks) at 8, 16 and 32
keyframes in the unchanged copy and in a copy whose dispatch sends
every window to the 12-strip instance: what the 3- and 6-strip instances
are worth.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent
SOURCE = Path("svi_mapper_tpu_torch") / "csrc" / "schur_assemble.cu"

# name -> (text in the source, its replacement, changes the result?)
FAULTS = {
    "control": (None, None, False),
    "dropped_in_front_test": (
        "w = w * ow * (zc > 0.05f ? 1.0f : 0.0f);", "w = w * ow;", True),
    "robust_kernel_ge_for_gt": (
        "err2 > cam.kernel_px2 ?", "err2 >= cam.kernel_px2 ?", False),
    "robust_branch_never_taken": (
        "err2 > cam.kernel_px2 ?", "err2 > 1e30f ?", True),
    "w_rows_swapped": (
        "W[b * plane + (size_t)(6 * k + a) * L + l] = wv;",
        "W[b * plane + (size_t)(6 * k + (a ^ 1)) * L + l] = wv;", True),
    "w_shared_transposed": (
        "Ws[b * PLANE + lane * PITCH + 6 * kk + a] = wv;",
        "Ws[b * PLANE + lane * PITCH + 6 * kk + (5 - a)] = wv;", True),
    "tile_offset_off_by_one_tile": (
        "K, L, tile * KT, KT, l0, cam);",
        "K, L, ((tile + 1) % gridDim.y) * KT, KT, l0, cam);", False),
    "tile_offset_dropped_for_poses": (
        "const float* Tk = T + 16 * k;", "const float* Tk = T + 16 * kk;", True),
    "partials_summed_one_short": (
        "for (int b = 0; b < nb; ++b) s += ww_part[(size_t)b * n + idx];",
        "for (int b = 0; b + 1 < nb; ++b) s += ww_part[(size_t)b * n + idx];", True),
    "cofactor_wrong_sign": (
        "const float c01 = a02 * a12 - a01 * a22;",
        "const float c01 = a01 * a22 - a02 * a12;", True),
    "hll_inv_written_with_wrong_sign": (
        "Hll_inv[(size_t)l * 9 + i] = hi[i];",
        "Hll_inv[(size_t)l * 9 + i] = (i == 1 || i == 3) ? -hi[i] : hi[i];", True),
    "hll_inv_written_3_percent_off": (
        "Hll_inv[(size_t)l * 9 + i] = hi[i];",
        "Hll_inv[(size_t)l * 9 + i] = (i == 1 || i == 3) ? 1.03f * hi[i] : hi[i];", True),
}

# sends every window to the 12-strip instance of K4
ONE_INSTANCE = (("if (K <= 8)", "if (false)"), ("else if (K <= 16)", "else if (false)"))

CHECK = ("import torch, chip_smoke as c; "
         "torch.backends.cuda.matmul.allow_tf32 = False; "
         "c.check_backend_kernels(torch.device('cuda', 0)); print('PASSED')")

TIME_K4 = """
import json, torch, chip_smoke as c
from torch.profiler import ProfilerActivity, profile
from svi_mapper_tpu_torch.ops import ba_kernel
dev = torch.device('cuda', 0)
out = {}
for K in (8, 16, 32):
    p = c.ba_problem(K, c.BA_LANDMARKS, seed=3)
    args = [torch.from_numpy(a).to(dev) for a in
            (p['T'], p['X0'], p['obs'], p['mask'].astype('float32'))]
    launch = lambda: ba_kernel.launch_schur_assemble(
        *args, 1e-3, (*p['intr'], 10.0), 1e-6)
    row = {'launch_only_ms': c.time_ms(launch, 50)}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            launch()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        for name in ('schur_assemble_kernel', 'schur_reduce_kernel'):
            if name in e.key and e.device_time_total > 0:
                row[name + '_device_ms'] = e.device_time_total / 1e3 / e.count
    out[K] = row
print('K4_MS ' + json.dumps(out))
"""


def run_in_copy(code: str, patches) -> subprocess.CompletedProcess:
    """Run ``code`` in a copy of the package and ``chip_smoke.py`` whose
    ``csrc/schur_assemble.cu`` has each ``(old, new)`` of ``patches``
    replaced; every ``old`` must occur exactly once."""
    with tempfile.TemporaryDirectory() as tmp:
        copy = Path(tmp) / "repo"
        shutil.copytree(REPO / "svi_mapper_tpu_torch", copy / "svi_mapper_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy(REPO / "chip_smoke.py", copy / "chip_smoke.py")
        text = (copy / SOURCE).read_text()
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"the text to replace, {old!r}, occurs "
                                   f"{text.count(old)} times in {SOURCE}")
            text = text.replace(old, new)
        (copy / SOURCE).write_text(text)
        return subprocess.run([sys.executable, "-c", code], cwd=copy, text=True,
                              capture_output=True, timeout=600)


def run_fault(name: str) -> dict:
    old, new, changes = FAULTS[name]
    proc = run_in_copy(CHECK, [] if old is None else [(old, new)])
    passed = proc.returncode == 0 and "PASSED" in proc.stdout
    last = (proc.stderr.strip().splitlines() or [""])[-1]
    return {"fault": name, "changes_result": changes, "caught": not passed,
            "equivalent": old is not None and not changes,
            "message": "" if passed else last[:300]}


def time_instances() -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    row = {"phase": "k4_instances", "nvidia_smi": smi, "L": 4096}
    # by-K, one-instance, one-instance, by-K: drift shows as a difference
    # between the two runs of one variant
    for name, patches in (("by_K", ()), ("all_12_strips", ONE_INSTANCE),
                          ("all_12_strips_again", ONE_INSTANCE), ("by_K_again", ())):
        proc = run_in_copy(TIME_K4, patches)
        line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("K4_MS ")), None)
        if proc.returncode != 0 or line is None:
            print(proc.stderr[-2000:], file=sys.stderr)
            return 1
        row[name] = json.loads(line[6:])
    print(json.dumps(row), flush=True)
    return 0


def main() -> int:
    if sys.argv[1:] == ["--instances"]:
        return time_instances()
    ok = True
    for name in sys.argv[1:] or FAULTS:
        row = run_fault(name)
        print(json.dumps(row), flush=True)
        if name == "control":
            ok &= not row["caught"]
        elif row["changes_result"]:
            ok &= row["caught"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
