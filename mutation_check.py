"""Does ``chip_smoke.py`` catch a wrong kernel? What does the Schur product
kernel's 8-keyframe instance buy, and where does its time go? How do K1,
K2, K3 and K6 and their callers compare with the parent commit's?

    python3 mutation_check.py [fault ...]
    python3 mutation_check.py --instances
    python3 mutation_check.py --versus-parent
    python3 mutation_check.py --natural-order
    python3 mutation_check.py --product-phases
    python3 mutation_check.py --loop-routes

A developer's check, run from the repository root; needs one CUDA card and
``nvcc``. For each named fault the package and ``chip_smoke.py`` are copied to
a temporary directory, the fault is planted in the copy's source, and a
check of ``chip_smoke`` runs in a process of its own: for
``csrc/schur_assemble.cu`` ``check_backend_kernels`` (every shape of the
``kernels_backend`` phase), for ``csrc/hamming_matrix.cu`` (the ``pool_*``
faults) ``check_closure_kernel``, for ``csrc/brief_dense.cu`` and its
``csrc/brief_pattern.cuh`` (``brief_*``), ``csrc/track_scores.cu``
(``track_*``), ``csrc/stereo_profiles.cu`` (``stereo_*``) and the shared
``csrc/round_pixel.cuh`` (``round_*``) ``check_kernels`` at the three
shapes of the ``kernels_*`` phases. A fault is *caught* when that process
fails. The unchanged copies (``control``, ``pool_control``,
``stereo_control``, ``front_control``) must pass. Prints one
JSON line per fault and exits non-zero if a control fails or a fault that
changes the result goes uncaught.

Some faults are listed as ``equivalent`` — no input can tell them from the
unchanged kernel — each beside a fault of the same kind that does change
the result and must be caught:

* ``>=`` for ``>`` at the robust kernel: at ``err2 == kernel_px2`` both
  branches give the weight 1 (beside it: the robust branch never taken);
* an assembly split that starts one split further on (cyclically): a block
  labels everything it reads and writes with the same global keyframe index,
  so the blocks merely swap their work and the splits' partial H_ll are
  added in another order, within the tolerance (beside it: the split offset
  dropped where the pose is read);
* in K1, floor and ceiling division truncating toward zero instead: that
  only ever moves an interval's end outward, by one column, and a pixel
  listed in excess is scored and rejected by the tiers as the plain version
  rejects it (beside it: the band interval one column short at either end;
  ``tests/test_torch_track_intervals.py`` holds the Python restatement to
  the exact union);
* in the rounding (K1 and K2), the coordinate clamped after the cast to
  int instead of before: the card's float-to-int conversion saturates, so
  both give the same pixel (beside it: the clamp removed). On the CPU a
  wrapping cast would differ; that is why the plain version clamps in
  float.

K1 folds window position 0 (key ``4096 * 4096``) into its reduction rather
than the first position its listing leaves out: when nothing is accepted,
every pixel's key is ``4096 * 4096 + position`` and the plain version
returns position 0 whatever the listing, so taking position 0 for the
first unlisted one is the kernel's own rule, not a fault. Planted beside
it: the fold dropped, and the fold at position 1.

The K6 faults (``pool_*``): a norm dropped, a wrong sign in the identity,
the minimum taken over the wrong pool, the references' or the queries'
valid mask ignored, the last ragged tile dropped in the pool count and in
the matrix, a column's norm taken from its neighbour's lane (matrix) or
slot (pool count). The K2 faults (``stereo_*``): a tie to the higher index,
the range mask dropped, ``dm`` and ``dp`` swapped, the span origin off by
one; and in the shared rounding (``round_*``) the map of non-finite
coordinates dropped (NaN still reads 0, since ``fmaxf`` drops it; +-inf
then reads the edge), round half up, the float clamp removed. The K3 faults
(``brief_*``): one pattern entry off by one in the header, an FMA in the
blur, two bits of a word swapped, one of a thread's stacked pixels reading
its neighbour's row. The K1 faults (``track_*``): the band interval one
column short at either end, the box as ``|dx| <= 7``, the fold dropped or
at position 1.

The Schur faults: the in-front test dropped, the robust branch never
taken, two W rows swapped, the C operand's rows reversed, the split offset
dropped for the poses, a tile's last item partial left out or its first
added twice, a landmark tile's H_pp / b_p left out of an item, the lower
triangle not mirrored (zeros) or its blocks not transposed, the rhs
column dropped or shifted by one landmark, the schedule's last item or the
ragged landmarks past the last full tile dropped, an item's listed slabs
read as one run from its first (only a map segment's visibility, ordered,
gives a list with gaps), a cofactor's sign. The two ``hll_inv_written_*`` faults
change only the ``Hll_inv`` the designated block writes out, not the
inverse the product uses for ``S`` and ``rhs``: the 3 % one shows what the
per-landmark comparison of ``Hll_inv`` adds.

``--instances`` times K4 (the launch alone over 50 calls, and the traced
device time of each of its three kernels over 20, 4096 landmarks) at 5, 8
and 16 keyframes in the unchanged copy and in a copy whose tiling
(``ops/ba_kernel.py``) sends every window to the 16-keyframe instance of
the product kernel: what the 8-keyframe instance is worth.

``--versus-parent`` times K1, K2 and K3 (``chip_smoke.check_kernels`` at
376 x 1241, 1024 landmarks, timed: wrapper ``ms``, ``launch_only_ms``,
``device_ms``), and K2 and K6 as their callers meet them (``ms``, the
host's time per call without a synchronisation, and the device time and
count of every kernel the call launches, PyTorch's included):
``stereo_profiles`` and ``match_stereo`` with and without a search range
at 1024 keypoints, the Hamming matrix at 256 x 4096, the closure's pool
scoring at ``[8, 256, 16 x 256]``; and the closure batch of
``closure_query`` (five runs, host reads) and the N = 680 pose graph
(three runs), in another commit's tree and in this one, in turns (parent,
this, this, parent), each in a process of its own, and prints the card's
name and power limit beside them. The other tree is unpacked first
into the ignored ``_parent/`` (HEAD is the parent of uncommitted work):

    rm -rf _parent && mkdir _parent && git archive HEAD | tar -x -C _parent

``--product-phases`` times the three Schur kernels (traced device time,
30 launches, windows of 128 and 32 keyframes x 4096 landmarks) in the
unchanged copy and in copies of the product kernel with a phase patched
out: the multiply-adds alone (no staging, no C transform: the results are
wrong, the time is the FFMA loop's with its barriers), and staging and
transform alone; in turns (whole, FMA alone, staging alone, whole).

``--natural-order`` builds K3 with its comparisons in the natural order
(entry ``k`` of the table's ``ORDER`` taken as ``k``: bit by bit, the
thread's pixels within a bit) and with the generated order, in turns
(generated, natural, natural, generated), each in a copy of its own, and
prints per build the wrapper ``ms``, the traced ``device_ms``, ``ptxas``'s
registers and spills and the shared loads in the SASS. Both builds are held
to the plain version first.

``--loop-routes`` runs ``chip_smoke.run_slam_loop`` three times, each in a
process of its own: in the parent's tree (if unpacked into ``_parent/``),
in this tree with K4 / K5, where every call of either wrapper is also held
against the plain version in float32 and in float64 (the largest error of
each over the run, per window shape), and in this tree with every BA window
on the materialised route. It prints the keyframes, closures, BA runs and
aligned ATE of each run: which of them the new kernels' loop resembles.
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
STEREO_SOURCE = CSRC / "stereo_profiles.cu"
ROUND_HEADER = CSRC / "round_pixel.cuh"
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
    "c_operand_transposed": (
        "cv[c][a] = w0 * h[c] + w1 * h[3 + c] + w2 * h[6 + c];",
        "cv[c][5 - a] = w0 * h[c] + w1 * h[3 + c] + w2 * h[6 + c];", True),
    "split_offset_off_by_one_split": (
        "const int k0 = blockIdx.y * ks;",
        "const int k0 = ((blockIdx.y + 1) % gridDim.y) * ks;", False),
    "split_offset_dropped_for_poses": (
        "const float* Tk = T + 16 * k;", "const float* Tk = T + 16 * kk;", True),
    "partials_summed_one_short": (
        "n < n1; ++n)\n            s += part[",
        "n + 1 < n1; ++n)\n            s += part[", True),
    "item_partial_added_twice": (
        "s += part[((size_t)n * g * g + local) * 36 + q];",
        "s += part[((size_t)n * g * g + local) * 36 + q] * (n == __ldg(tile_items + t) ? 2.0f"
        " : 1.0f);", True),
    "lower_triangle_not_mirrored": (
        "if (i != j) S[(size_t)(6 * j + q / 6) * K6 + 6 * i + q % 6] =",
        "if (i != j) S[(size_t)(6 * j + q / 6) * K6 + 6 * i + q % 6] = 0.0f * ", True),
    "lower_blocks_not_transposed": (
        "= v[u - q + (q % 6) * 6 + q / 6];", "= v[u];", True),
    "hpp_tile_left_out": (
        "for (int e = 0; e < count; ++e) {", "for (int e = 2; e < count; ++e) {", True),
    "rhs_column_dropped": (
        "const float bl = cp[l * SLOT + 8 * c + 6];", "const float bl = 0.0f;", True),
    "rhs_column_shifted_by_one_landmark": (
        "const float bl = cp[l * SLOT + 8 * c + 6];",
        "const float bl = cp[((l + 1) % LS) * SLOT + 8 * c + 6];", True),
    "last_item_dropped": (
        "for (int item = blockIdx.x; item < n_items; item += gridDim.x) {",
        "for (int item = blockIdx.x; item + 1 < n_items; item += gridDim.x) {", True),
    "ragged_landmarks_dropped": (
        "const bool ok = row < 6 * K && l0 + l < L;",
        "const bool ok = row < 6 * K && l0 + l < (L & ~31);", True),
    "slab_list_read_as_a_range": (
        "stage(__ldg(listed + s + 1));", "stage(__ldg(listed) + s + 1);", True),
    "cofactor_wrong_sign": (
        "const float c01 = a02 * a12 - a01 * a22;",
        "const float c01 = a01 * a22 - a02 * a12;", True),
    "hll_inv_written_with_wrong_sign": (
        "Hll_inv[(size_t)l * 9 + i] = h[i];",
        "Hll_inv[(size_t)l * 9 + i] = (i == 1 || i == 3) ? -h[i] : h[i];", True),
    "hll_inv_written_3_percent_off": (
        "Hll_inv[(size_t)l * 9 + i] = h[i];",
        "Hll_inv[(size_t)l * 9 + i] = (i == 1 || i == 3) ? 1.03f * h[i] : h[i];", True),
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
    "round_half_up": (
        "a = fminf(fmaxf(rintf(a), 0.0f), (float)hi);",
        "a = fminf(fmaxf(floorf(a + 0.5f), 0.0f), (float)hi);", True),
    "round_float_clamp_removed": (
        "a = fminf(fmaxf(rintf(a), 0.0f), (float)hi);\n    return (int)a;",
        "return (int)rintf(a);", True),
    "round_clamp_after_cast": (
        "a = fminf(fmaxf(rintf(a), 0.0f), (float)hi);\n    return (int)a;",
        "return min(max((int)rintf(a), 0), hi);", False),
    "round_no_nan_map": (
        "a = isfinite(a) ? a : 0.0f;\n", "", True),
    "stereo_control": (None, None, False),
    "stereo_tie_to_higher_index": (
        ("((unsigned)min(v, KEY_BIG) << 16) | (unsigned)i);",
         "const int best = (int)(best_key & 0xffffu);"),
        ("((unsigned)min(v, KEY_BIG) << 16) | (unsigned)(0xffff - i));",
         "const int best = 0xffff - (int)(best_key & 0xffffu);"), True),
    "stereo_range_mask_dropped": (
        "(!ranged || fabsf(d - c) <= r);", "true;", True),
    "stereo_dm_dp_swapped": (
        ("out[2 * K + k] = m[max(best - 1, 0)];", "out[3 * K + k] = m[min(best + 1, De - 1)];"),
        ("out[3 * K + k] = m[max(best - 1, 0)];", "out[2 * K + k] = m[min(best + 1, De - 1)];"),
        True),
    "stereo_origin_off_by_one": (
        "s.x0 = min(max(s.u_r - (De - 1), 0), W - De);",
        "s.x0 = min(max(s.u_r - De, 0), W - De);", True),
    "pool_control": (None, None, False),
    "pool_norm_dropped": (
        "d[j][0] = q.norm0 + nb[j][0] - 2 * acc[j][0];",
        "d[j][0] = q.norm0 - 2 * acc[j][0];", True),
    "pool_identity_sign": (
        "d[j][3] = q.norm1 + nb[j][1] - 2 * acc[j][3];",
        "d[j][3] = q.norm1 + nb[j][1] + 2 * acc[j][3];", True),
    "pool_min_over_wrong_pool": (
        "r_desc += pool * Pr * 2;", "r_desc += ((size_t)z * C + (c + 1) % C) * Pr * 2;", True),
    "pool_reference_valid_ignored": (
        "st.valid[r] = r0 + r < Pr && r_valid[r0 + r] != 0;", "st.valid[r] = r0 + r < Pr;",
        True),
    "pool_query_valid_ignored": (
        "const bool hit0 = quad_lead && p0 < P && q_valid[p0] && min0 <= cutoff;",
        "const bool hit0 = quad_lead && p0 < P && min0 <= cutoff;", True),
    "pool_last_ragged_tile_dropped": (
        "for (int n0 = 0; n0 < width; n0 += 8 * NT) {",
        "for (int n0 = 0; n0 + 8 * NT <= width; n0 += 8 * NT) {", True),
    "pool_matrix_last_ragged_tile_dropped": (
        "const dim3 grid((M + 8 * NT - 1) / (8 * NT),", "const dim3 grid(M / (8 * NT),", True),
    "pool_matrix_column_norm_from_wrong_lane": (
        "nb[j][1] = __shfl_sync(FULL, f.norm, 8 * t + 4);",
        "nb[j][1] = __shfl_sync(FULL, f.norm, 8 * t);", True),
    "pool_column_norm_of_neighbour": (
        "nb[j][1] = st.norm[n0 + 8 * j + 2 * t + 1];", "nb[j][1] = st.norm[n0 + 8 * j + 2 * t];",
        True),
}

# the product kernel with a phase patched out: the multiply-adds alone
# (staging and the C transform skipped; the shared operands are whatever
# they hold), and staging and transform alone (no multiply-add)
NO_STAGING = ("        auto stage = [&](int slab) {\n",
              "        auto stage = [&](int slab) {\n            if (K > 0) return;\n")
NO_TRANSFORM = ("            for (int e = tid; e < G * LS; e += PT) {\n"
                "                const int l = e % LS;",
                "            for (int e = tid; e < G * LS && K < 0; e += PT) {\n"
                "                const int l = e % LS;")
NO_FMA = ("            if (pair_on) {\n                const float* cp = cs + li * KPITCH;",
          "            if (pair_on && K < 0) {\n                const float* cp = cs + li * KPITCH;")
PRODUCT_PHASES = (("whole", ()), ("fma_alone", (NO_STAGING, NO_TRANSFORM)),
                  ("staging_and_transform_alone", (NO_FMA,)), ("whole_again", ()))

# sends every window to the 16-keyframe instance of the product kernel
ONE_INSTANCE = (("    g = 8 if K <= 8 else 16\n", "    g = 16\n"),)
BA_KERNEL_PY = Path("svi_mapper_tpu_torch") / "ops" / "ba_kernel.py"

CHECK = ("import torch, chip_smoke as c; "
         "torch.backends.cuda.matmul.allow_tf32 = False; "
         "c.check_backend_kernels(torch.device('cuda', 0), timed=False); print('PASSED')")
HAMMING_CHECK = ("import torch, chip_smoke as c; "
                 "c.check_closure_kernel(torch.device('cuda', 0)); print('PASSED')")
FRONT_CHECK = ("import torch, chip_smoke as c; d = torch.device('cuda', 0)\n"
               "for h, w, n, De in ((75, 203, 37, 48), (64, 96, 16, 128), "
               "(c.H, c.W_RAW, c.N_LANDMARKS, c.MAX_DISPARITY)):\n"
               "    c.check_kernels(d, h, w, n, De, timed=False)\n"
               "print('PASSED')")

# fault-name prefix -> (the source it is planted in, the check that must fail)
SOURCES = [("pool_", HAMMING_SOURCE, HAMMING_CHECK),
           ("stereo_", STEREO_SOURCE, FRONT_CHECK),
           ("round_", ROUND_HEADER, FRONT_CHECK),
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
from svi_mapper_tpu_torch.ops import ba_kernel
dev = torch.device('cuda', 0)
out = {}
for K in (5, 8, 16):
    p = c.ba_problem(K, c.BA_LANDMARKS, seed=3)
    args = [torch.from_numpy(a).to(dev) for a in
            (p['T'], p['X0'], p['obs'], p['mask'].astype('float32'))]
    launch = lambda: ba_kernel.launch_schur_system(
        *args, 1e-3, (*p['intr'], 10.0), 1e-6, tiled=False)
    row = {'g': ba_kernel.schur_tiling(K, c.BA_LANDMARKS).g,
           'launch_only_ms': c.time_ms(launch, 50),
           'device_ms': c.traced_device_ms_by_kernel(launch, c.SCHUR_KERNELS, 20)}
    out[K] = row
print('K4_MS ' + json.dumps(out))
"""

TIME_PRODUCT = """
import json, torch, chip_smoke as c
from svi_mapper_tpu_torch.ops import ba_kernel
dev = torch.device('cuda', 0)
out = {}
for K, L in ((128, 4096), (32, 4096)):
    p = c.ba_problem(K, L, seed=3)
    args = [torch.from_numpy(a).to(dev) for a in
            (p['T'], p['X0'], p['obs'], p['mask'].astype('float32'))]
    launch = lambda: ba_kernel.launch_schur_system(
        *args, 1e-3, (*p['intr'], 10.0), 1e-6, tiled=False)
    out[f'{K}x{L}'] = c.traced_device_ms_by_kernel(launch, c.SCHUR_KERNELS, 30)
print('PRODUCT_MS ' + json.dumps(out))
"""

# K2 and K6 as their callers meet them, and the paths around them: the
# wrapper's time, the host's time per call (enqueue, no synchronisation) and
# the device time of every kernel the call launches, PyTorch's included, at
# the main path's shapes; the closure batch of chip_smoke's closure_query
# and the N = 680 pose graph. Runs in any tree whose chip_smoke.py has
# kernel_inputs, hamming_inputs, closure_keyframes, fill_closure_database,
# count_host_syncs, run_pose_graph and time_ms.
TIME_CALLERS = """
import json, time, numpy as np, torch, chip_smoke as c
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile
from svi_mapper_tpu_torch.config import DEFAULT_PARAMS
from svi_mapper_tpu_torch.frontend.stereo import match_stereo
from svi_mapper_tpu_torch.io import synthetic
from svi_mapper_tpu_torch.mapping import closure
from svi_mapper_tpu_torch.models.slam import closure_kwargs
from svi_mapper_tpu_torch.ops import descriptors, hamming, stereo_kernel
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device('cuda', 0)


def measure(call, n=50):
    row = {'ms': c.time_ms(call, n)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    row['host_ms'] = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_time_total > 0
          and e.device_type == torch.autograd.DeviceType.CUDA]
    row['device_ms'] = sum(e.device_time_total for e in ev) / 1e3 / 20
    row['kernels_per_call'] = sum(e.count for e in ev) / 20
    return row


out = {}
inp = c.kernel_inputs(17, c.H, c.W_RAW, c.N_LANDMARKS, dev)
wp = -(-c.W_RAW // 16) * 16
ext = lambda im: F.pad(im[None, None], (0, wp - c.W_RAW, 0, 0), mode='replicate')[0, 0].contiguous()
field_l = descriptors.brief_dense_fused(ext(inp['img_l']))
field_r = descriptors.brief_dense_fused(ext(inp['img_r']))
desc = descriptors.brief_at(field_l, inp['uv_near'])
uv = inp['uv']
cam = synthetic.default_camera(c.W_RAW, c.H, device=dev)
valid = torch.ones(c.N_LANDMARKS, dtype=torch.bool, device=dev)
rng = np.random.default_rng(5)
center = torch.from_numpy(rng.uniform(0, 128, c.N_LANDMARKS).astype(np.float32)).to(dev)
search = torch.from_numpy(rng.uniform(0, 40, c.N_LANDMARKS).astype(np.float32)).to(dev)
out['stereo_profiles'] = measure(lambda: stereo_kernel.stereo_profiles(
    field_r, uv, desc, max_disparity=c.MAX_DISPARITY))
out['match_stereo'] = measure(lambda: match_stereo(field_r, uv, desc, valid, cam))
out['match_stereo_ranged'] = measure(lambda: match_stereo(
    field_r, uv, desc, valid, cam, disparity_center=center, search_range=search))

a, b, _ = c.hamming_inputs(297, 256, 4096, dev)
out['hamming_matrix'] = measure(lambda: hamming.hamming_distance_matrix(a, b), 200)
# the closure batch's pool scoring: 8 query pools against 16 pools of 256
q = torch.from_numpy(rng.integers(0, 2 ** 32, (8, 256, 8), dtype=np.uint64)
                     .astype(np.uint32).view(np.int32)).to(dev)
r = torch.from_numpy(rng.integers(0, 2 ** 32, (8, 16, 256, 8), dtype=np.uint64)
                     .astype(np.uint32).view(np.int32)).to(dev)
vq = torch.from_numpy(rng.random((8, 256)) > 0.1).to(dev)
vr = torch.from_numpy(rng.random((8, 16, 256)) > 0.1).to(dev)
out['pool_scoring'] = measure(lambda: closure._pool_nn_counts(q, vq, r, vr, 25), 200)

keyframes, _ = c.closure_keyframes(seed=13)
db = c.fill_closure_database(keyframes, dev)
kw = closure_kwargs(DEFAULT_PARAMS)
closure.find_closures_batch(db, c.CLOSURE_QUERIES, **kw)
batch_ms = []
for _ in range(5):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    closure.find_closures_batch(db, c.CLOSURE_QUERIES, **kw)      # ends in a read
    batch_ms.append((time.perf_counter() - t0) * 1e3)
out['closure_batch'] = {'ms': batch_ms, 'host_syncs': c.count_host_syncs(
    lambda: closure.find_closures_batch(db, c.CLOSURE_QUERIES, **kw))}
out['pose_graph'] = {'ms': [c.run_pose_graph(dev)['ms'] for _ in range(3)]}
print('CALLERS_MS ' + json.dumps(out))
"""


LOOP_ROUTE = """
import json, sys, torch, chip_smoke as c
from svi_mapper_tpu_torch.ops import ba_kernel
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device('cuda', 0)
route = sys.argv[1]
errs = {}


def witnessed(name):
    # the wrapper's result, unchanged; beside it, how far it and the plain
    # float32 version are from the plain version in float64 on every call
    fn, plain = getattr(ba_kernel, name), getattr(ba_kernel, name + '_plain')

    def call(*args, **kw):
        got = fn(*args, **kw)
        want32 = plain(*args, **kw)
        want64 = plain(*[a.double() if torch.is_tensor(a) else a for a in args], **kw)
        K, L = args[3].shape
        row = errs.setdefault(f'{name} {K}x{L}', {'calls': 0, 'kernel': {}, 'plain': {}})
        row['calls'] += 1
        for side, e in (('kernel', ba_kernel.schur_errors(got, want64)),
                        ('plain', ba_kernel.schur_errors(want32, want64))):
            for k, v in e.items():
                row[side][k] = max(row[side].get(k, 0.0), v)
        return got
    return call


if route == 'kernels_vs_float64':
    for name in ('schur_assemble', 'schur_assemble_tiled'):
        setattr(ba_kernel, name, witnessed(name))
    loop, _ = c.run_slam_loop(dev)
elif route == 'materialised':
    loop, _ = c.run_slam_loop(dev, schur_kernels=False)
else:
    loop, _ = c.run_slam_loop(dev)
print('LOOP ' + json.dumps({
    'keyframes': loop['keyframes'], 'stats': loop['stats'],
    'accepted_closures': loop['accepted_closures'],
    'ate_recorded_m': loop['ate_recorded_m'], 'ate_optimised_m': loop['ate_optimised_m'],
    'launches': {k: loop['launches'][k] for k in ('schur_assemble', 'schur_assemble_tiled')},
    'rel_err_vs_float64': errs}))
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
    patches = ([] if old is None else list(zip(old, new)) if isinstance(old, tuple)
               else [(old, new)])
    proc = run_in_copy(check, patches, source)
    passed = proc.returncode == 0 and "PASSED" in proc.stdout
    last = (proc.stderr.strip().splitlines() or [""])[-1]
    return {"fault": name, "changes_result": changes, "caught": not passed,
            "equivalent": old is not None and not changes,
            "message": "" if passed else last[:300]}


def time_instances() -> int:
    row = {"phase": "k4_instances", "nvidia_smi": nvidia_smi(), "L": 4096}
    # by-K, one-instance, one-instance, by-K: drift shows as a difference
    # between the two runs of one variant
    for name, patches in (("by_K", ()), ("all_16", ONE_INSTANCE),
                          ("all_16_again", ONE_INSTANCE), ("by_K_again", ())):
        proc = run_in_copy(TIME_K4, patches, BA_KERNEL_PY)
        line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("K4_MS ")), None)
        if proc.returncode != 0 or line is None:
            print(proc.stderr[-2000:], file=sys.stderr)
            return 1
        row[name] = json.loads(line[6:])
    print(json.dumps(row), flush=True)
    return 0


def time_product_phases() -> int:
    row = {"phase": "product_phases", "nvidia_smi": nvidia_smi()}
    for name, patches in PRODUCT_PHASES:
        proc = run_in_copy(TIME_PRODUCT, patches)
        line = next((ln for ln in proc.stdout.splitlines()
                     if ln.startswith("PRODUCT_MS ")), None)
        if proc.returncode != 0 or line is None:
            print(proc.stderr[-2000:], file=sys.stderr)
            return 1
        row[name] = json.loads(line[11:])
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
    """K1, K2 and K3, K2 and K6 as their callers meet them, the closure
    batch and the pose graph, of the parent's tree and of this one, in
    turns."""
    if not (PARENT / "chip_smoke.py").exists():
        print(f"no parent tree in {PARENT} (see the module's docstring)", file=sys.stderr)
        return 1
    row = {"phase": "versus_parent", "nvidia_smi": nvidia_smi()}
    for name, tree in (("parent", PARENT), ("this", REPO), ("this_again", REPO),
                       ("parent_again", PARENT)):
        proc = subprocess.run([sys.executable, "-c", TIME_FRONT + TIME_CALLERS],
                              cwd=tree, text=True, capture_output=True, timeout=900)
        lines = {ln.split(" ", 1)[0]: json.loads(ln.split(" ", 1)[1])
                 for ln in proc.stdout.splitlines()
                 if ln.startswith(("FRONT_MS ", "CALLERS_MS "))}
        if proc.returncode != 0 or len(lines) != 2:
            print(proc.stderr[-2000:], file=sys.stderr)
            return 1
        row[name] = {"front": lines["FRONT_MS"], "callers": lines["CALLERS_MS"]}
    print(json.dumps(row), flush=True)
    return 0


def loop_routes() -> int:
    """The whole system's loop, once each: with the parent's K4 / K5 (where
    a parent tree is unpacked), with this tree's and their distance from
    float64 on every call, and with the materialised route instead of
    either kernel."""
    row = {"phase": "loop_routes", "nvidia_smi": nvidia_smi()}
    runs = [("this_kernels", REPO, "kernels_vs_float64"),
            ("this_materialised", REPO, "materialised")]
    if (PARENT / "chip_smoke.py").exists():
        runs.insert(0, ("parent_kernels", PARENT, "kernels"))
    for name, tree, route in runs:
        proc = subprocess.run([sys.executable, "-c", LOOP_ROUTE, route], cwd=tree,
                              text=True, capture_output=True, timeout=600)
        line = next((ln for ln in proc.stdout.splitlines() if ln.startswith("LOOP ")), None)
        if proc.returncode != 0 or line is None:
            print(proc.stderr[-2000:], file=sys.stderr)
            return 1
        row[name] = json.loads(line[5:])
    print(json.dumps(row), flush=True)
    return 0


def main() -> int:
    if sys.argv[1:] == ["--instances"]:
        return time_instances()
    if sys.argv[1:] == ["--versus-parent"]:
        return versus_parent()
    if sys.argv[1:] == ["--natural-order"]:
        return time_natural_order()
    if sys.argv[1:] == ["--product-phases"]:
        return time_product_phases()
    if sys.argv[1:] == ["--loop-routes"]:
        return loop_routes()
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
