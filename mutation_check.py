"""Does ``chip_smoke.py`` catch a wrong kernel? What do the Schur kernel's
small-window instances buy? And how do K1 and K3 compare with the parent
commit's?

    python3 mutation_check.py [fault ...]
    python3 mutation_check.py --instances
    python3 mutation_check.py --versus-parent
    python3 mutation_check.py --natural-order

A developer's check, run from the repository root; needs one CUDA card and
``nvcc``. For each named fault the package and ``chip_smoke.py`` are copied to
a temporary directory, the fault is planted in the copy's source, and a
check of ``chip_smoke`` runs in a process of its own: for
``csrc/schur_assemble.cu`` ``check_backend_kernels`` (every shape of the
``kernels_backend`` phase), for ``csrc/hamming_matrix.cu`` (the
``hamming_*`` faults) ``check_closure_kernel``, for ``csrc/brief_dense.cu``
and its ``csrc/brief_pattern.cuh`` (``brief_*``) and ``csrc/track_scores.cu``
(``track_*``) ``check_kernels`` at the three shapes of the ``kernels_*``
phases. A fault is *caught* when that process fails. The unchanged copies
(``control``, ``hamming_control``, ``front_control``) must pass. Prints one
JSON line per fault and exits non-zero if a control fails or a fault that
changes the result goes uncaught.

Some faults are listed as ``equivalent`` — no input can tell them from the
unchanged kernel — each beside a fault of the same kind that does change
the result and must be caught:

* ``>=`` for ``>`` at the robust kernel: at ``err2 == kernel_px2`` both
  branches give the weight 1 (beside it: the robust branch never taken);
* a keyframe tile that starts one tile further on (cyclically): a block
  labels everything it reads and writes with the same global keyframe index,
  so the blocks merely swap their work (beside it: the tile offset dropped
  where the pose is read);
* in the Hamming kernel, b-rows past the ragged edge staged as ones instead
  of zeros: their columns are never written (beside it: the edge test off
  by one where the column is written);
* in K1, floor and ceiling division truncating toward zero instead: that
  only ever moves an interval's end outward, by one column, and a pixel
  listed in excess is scored and rejected by the tiers as the plain version
  rejects it (beside it: the band interval one column short at either end;
  ``tests/test_torch_track_intervals.py`` holds the Python restatement to
  the exact union);
* in K1, the prediction clamped after the cast to int instead of before:
  the card's float-to-int conversion saturates, so both give the same pixel
  (beside it: the clamp removed). On the CPU a wrapping cast would differ;
  that is why the plain version clamps in float.

K1 folds window position 0 (key ``4096 * 4096``) into its reduction rather
than the first position its listing leaves out: when nothing is accepted,
every pixel's key is ``4096 * 4096 + position`` and the plain version
returns position 0 whatever the listing, so taking position 0 for the
first unlisted one is the kernel's own rule, not a fault. Planted beside
it: the fold dropped, and the fold at position 1.

The Hamming faults (``hamming_*``): one word dropped from the sum, OR for
XOR, the matrix written transposed, the ragged edge off by one on either
axis, a shift that loses the sign bit before the popcount, and the batch
offset dropped. The K3 faults (``brief_*``): one pattern entry off by one
in the header, an FMA in the blur, two bits of a word swapped, one of a
thread's stacked pixels reading its neighbour's row. The K1 faults
(``track_*``): the band interval one column short at either end, the box
as ``|dx| <= 7``, the fold dropped or at position 1, round half up in the
kernel's rounding, the float clamp removed.

The two ``hll_inv_written_*`` faults change only the ``Hll_inv`` the kernel
writes out (and through it ``rhs``), not the inverse it uses for ``S``. The
message names every output that failed: the 3 % one is small enough to pass
``rhs`` and shows what the per-landmark comparison of ``Hll_inv`` adds.

``--instances`` times K4 (the launch alone over 50 calls, and the traced
device time of its two kernels over 20, 4096 landmarks) at 8, 16 and 32
keyframes in the unchanged copy and in a copy whose dispatch sends
every window to the 12-strip instance: what the 3- and 6-strip instances
are worth.

``--versus-parent`` times K1 and K3 (``chip_smoke.check_kernels`` at
376 x 1241, 1024 landmarks, timed: wrapper ``ms``, ``launch_only_ms``,
``device_ms``) in another commit's tree and in this one, in turns
(parent, this, this, parent), each in a process of its own, and prints the
card's name and power limit beside them. The other tree is unpacked first
into the ignored ``_parent/`` (HEAD is the parent of uncommitted work):

    rm -rf _parent && mkdir _parent && git archive HEAD | tar -x -C _parent

``--natural-order`` builds K3 with its comparisons in the natural order
(entry ``k`` of the table's ``ORDER`` taken as ``k``: bit by bit, the
thread's pixels within a bit) and with the generated order, in turns
(generated, natural, natural, generated), each in a copy of its own, and
prints per build the wrapper ``ms``, the traced ``device_ms``, ``ptxas``'s
registers and spills and the shared loads in the SASS. Both builds are held
to the plain version first.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent
PARENT = REPO / "_parent"
CSRC = Path("svi_mapper_tpu_torch") / "csrc"
SOURCE = CSRC / "schur_assemble.cu"
HAMMING_SOURCE = CSRC / "hamming_matrix.cu"
BRIEF_SOURCE = CSRC / "brief_dense.cu"
PATTERN_HEADER = CSRC / "brief_pattern.cuh"
TRACK_SOURCE = CSRC / "track_scores.cu"

# name -> (text in the source, its replacement, changes the result?); the
# source and the check follow from the name's prefix (SOURCES)
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
    "hamming_control": (None, None, False),
    "hamming_word_dropped": (
        "for (int w = 0; w < WORDS; ++w)\n                d += __popc(",
        "for (int w = 0; w < WORDS - 1; ++w)\n                d += __popc(", True),
    "hamming_or_for_xor": (
        "d += __popc((unsigned)(ra[w] ^ rb[j][w]));",
        "d += __popc((unsigned)(ra[w] | rb[j][w]));", True),
    "hamming_written_transposed": (
        "if (m < M) out[(size_t)n * M + m] = d;",
        "if (m < M) out[(size_t)m * N + n] = d;", True),
    "hamming_column_edge_off_by_one": (
        "if (m < M) out[(size_t)n * M + m] = d;",
        "if (m < M - 1) out[(size_t)n * M + m] = d;", True),
    "hamming_row_edge_off_by_one": (
        "if (n >= N) break;", "if (n >= N - 1) break;", True),
    "hamming_sign_bit_shifted_out": (
        "d += __popc((unsigned)(ra[w] ^ rb[j][w]));",
        "d += __popc((unsigned)(ra[w] ^ rb[j][w]) << 1);", True),
    "hamming_batch_offset_dropped": (
        "b += (size_t)z * M * WORDS;", "b += 0;", True),
    "hamming_edge_rows_staged_as_ones": (
        "b[(size_t)(m0 + col) * WORDS + w] : 0;",
        "b[(size_t)(m0 + col) * WORDS + w] : -1;", False),
    "front_control": (None, None, False),
    "brief_pattern_entry_off_by_one": (
        "{  2,   7,   4,   6},  // 0\n", "{  3,   7,   4,   6},  // 0\n", True),
    "brief_fma_in_blur": (
        "acc = __fadd_rn(acc, __fmul_rn(raw[(ic - 2 + t) * RAW_W + j], k));",
        "acc = fmaf(raw[(ic - 2 + t) * RAW_W + j], k, acc);", True),
    "brief_two_bits_swapped": (
        "w[j][bit >> 5] |= 1u << (bit & 31);",
        "w[j][bit >> 5] |= 1u << ((bit == 40 ? 41 : bit == 41 ? 40 : bit) & 31);", True),
    "brief_stacked_pixel_reads_neighbour_row": (
        "constexpr int oa = (brief::pattern(bit, 0) + j) * BL_W",
        "constexpr int oa = (brief::pattern(bit, 0) + (j == 2 ? 1 : j)) * BL_W", True),
    "track_band_short_at_low_end": (
        "lo1 = max(lo1, -rul);", "lo1 = max(lo1, -rul) + 1;", True),
    "track_band_short_at_high_end": (
        "hi1 = min(hi1, rul);", "hi1 = min(hi1, rul) - 1;", True),
    "track_floor_division_truncates": (
        "return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;", "return q;", False),
    "track_box_7": (
        "if (abs(dy) <= BOX) { lo0 = -BOX; hi0 = BOX; }",
        "if (abs(dy) <= BOX) { lo0 = -7; hi0 = 7; }", True),
    "track_fold_dropped": (
        "int best = BIG_K * BIG_K;", "int best = 0x7fffffff;", True),
    "track_fold_at_position_1": (
        "int best = BIG_K * BIG_K;", "int best = BIG_K * BIG_K + 1;", True),
    "track_round_half_up": (
        "a = fminf(fmaxf(rintf(a), 0.0f), (float)hi);",
        "a = fminf(fmaxf(floorf(a + 0.5f), 0.0f), (float)hi);", True),
    "track_float_clamp_removed": (
        "a = fminf(fmaxf(rintf(a), 0.0f), (float)hi);\n    return (int)a;",
        "return (int)rintf(a);", True),
    "track_clamp_after_cast": (
        "a = fminf(fmaxf(rintf(a), 0.0f), (float)hi);\n    return (int)a;",
        "return min(max((int)rintf(a), 0), hi);", False),
}

# sends every window to the 12-strip instance of K4
ONE_INSTANCE = (("if (K <= 8)", "if (false)"), ("else if (K <= 16)", "else if (false)"))

CHECK = ("import torch, chip_smoke as c; "
         "torch.backends.cuda.matmul.allow_tf32 = False; "
         "c.check_backend_kernels(torch.device('cuda', 0)); print('PASSED')")
HAMMING_CHECK = ("import torch, chip_smoke as c; "
                 "c.check_closure_kernel(torch.device('cuda', 0)); print('PASSED')")
FRONT_CHECK = ("import torch, chip_smoke as c; d = torch.device('cuda', 0)\n"
               "for h, w, n, De in ((75, 203, 37, 48), (64, 96, 16, 128), "
               "(c.H, c.W_RAW, c.N_LANDMARKS, c.MAX_DISPARITY)):\n"
               "    c.check_kernels(d, h, w, n, De, timed=False)\n"
               "print('PASSED')")

# fault-name prefix -> (the source it is planted in, the check that must fail)
SOURCES = [("hamming_", HAMMING_SOURCE, HAMMING_CHECK),
           ("brief_pattern_", PATTERN_HEADER, FRONT_CHECK),
           ("brief_", BRIEF_SOURCE, FRONT_CHECK),
           ("track_", TRACK_SOURCE, FRONT_CHECK),
           ("front_", BRIEF_SOURCE, FRONT_CHECK),
           ("", SOURCE, CHECK)]

TIME_FRONT = """
import json, torch, chip_smoke as c
rows = c.check_kernels(torch.device('cuda', 0), c.H, c.W_RAW, c.N_LANDMARKS,
                       c.MAX_DISPARITY, timed=True)
print('FRONT_MS ' + json.dumps({r['name']: {k: r.get(k) for k in (
    'ms', 'launch_only_ms', 'device_ms')} for r in rows}))
"""

TIME_K3 = """
import json, torch, chip_smoke as c
k3 = c.check_kernels(torch.device('cuda', 0), c.H, c.W_RAW, c.N_LANDMARKS,
                     c.MAX_DISPARITY, timed=True)[0]
print('K3_MS ' + json.dumps({'ms': k3['ms'], 'device_ms': k3['device_ms'],
                             'build': c.ptxas_report('brief_dense.cu', 'kernel'),
                             'sass_shared_loads': c.sass_count('brief_dense_kernel', 'LDS')}))
"""

# K3's comparisons in the natural order instead of the generated one
NATURAL_ORDER = (("constexpr int order(int k) { return ORDER[k]; }",
                  "constexpr int order(int k) { return k; }"),)

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


def run_in_copy(code: str, patches, source: Path = SOURCE) -> subprocess.CompletedProcess:
    """Run ``code`` in a copy of the package and ``chip_smoke.py`` whose
    ``source`` has each ``(old, new)`` of ``patches`` replaced; every
    ``old`` must occur exactly once."""
    with tempfile.TemporaryDirectory() as tmp:
        copy = Path(tmp) / "repo"
        shutil.copytree(REPO / "svi_mapper_tpu_torch", copy / "svi_mapper_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy(REPO / "chip_smoke.py", copy / "chip_smoke.py")
        text = (copy / source).read_text()
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"the text to replace, {old!r}, occurs "
                                   f"{text.count(old)} times in {source}")
            text = text.replace(old, new)
        (copy / source).write_text(text)
        return subprocess.run([sys.executable, "-c", code], cwd=copy, text=True,
                              capture_output=True, timeout=600)


def run_fault(name: str) -> dict:
    old, new, changes = FAULTS[name]
    source, check = next((src, chk) for prefix, src, chk in SOURCES
                         if name.startswith(prefix))
    proc = run_in_copy(check, [] if old is None else [(old, new)], source)
    passed = proc.returncode == 0 and "PASSED" in proc.stdout
    last = (proc.stderr.strip().splitlines() or [""])[-1]
    return {"fault": name, "changes_result": changes, "caught": not passed,
            "equivalent": old is not None and not changes,
            "message": "" if passed else last[:300]}


def time_instances() -> int:
    row = {"phase": "k4_instances", "nvidia_smi": nvidia_smi(), "L": 4096}
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


def time_natural_order() -> int:
    row = {"phase": "k3_comparison_order", "nvidia_smi": nvidia_smi()}
    for name, patches in (("generated", ()), ("natural", NATURAL_ORDER),
                          ("natural_again", NATURAL_ORDER), ("generated_again", ())):
        proc = run_in_copy(TIME_K3, patches, PATTERN_HEADER)
        line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("K3_MS ")), None)
        if proc.returncode != 0 or line is None:
            print(proc.stderr[-2000:], file=sys.stderr)
            return 1
        row[name] = json.loads(line[6:])
    print(json.dumps(row), flush=True)
    return 0


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def versus_parent() -> int:
    """K1 and K3 of the parent's tree and of this one, in turns."""
    if not (PARENT / "chip_smoke.py").exists():
        print(f"no parent tree in {PARENT} (see the module's docstring)", file=sys.stderr)
        return 1
    row = {"phase": "versus_parent", "nvidia_smi": nvidia_smi()}
    for name, tree in (("parent", PARENT), ("this", REPO), ("this_again", REPO),
                       ("parent_again", PARENT)):
        proc = subprocess.run([sys.executable, "-c", TIME_FRONT], cwd=tree, text=True,
                              capture_output=True, timeout=900)
        line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("FRONT_MS ")), None)
        if proc.returncode != 0 or line is None:
            print(proc.stderr[-2000:], file=sys.stderr)
            return 1
        row[name] = json.loads(line[9:])
    print(json.dumps(row), flush=True)
    return 0


def main() -> int:
    if sys.argv[1:] == ["--instances"]:
        return time_instances()
    if sys.argv[1:] == ["--versus-parent"]:
        return versus_parent()
    if sys.argv[1:] == ["--natural-order"]:
        return time_natural_order()
    ok = True
    for name in sys.argv[1:] or FAULTS:
        row = run_fault(name)
        print(json.dumps(row), flush=True)
        if name.endswith("control"):
            ok &= not row["caught"]
        elif row["changes_result"]:
            ok &= row["caught"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
