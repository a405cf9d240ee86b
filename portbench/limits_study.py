"""The readings that a cell's limits are set from, for a cell of any
driver, in one process on the card: for each seed, the program's answer on
every input of the ring and the control's (the cell's reference in TF32),
each held to the float64 reference by every number
``portbench/reference/compare.py`` knows. (``portbench/study.py`` does the
same for the ``segment_ba`` driver alone.)

    python3 -m portbench.limits_study --workload <cell> --seeds 1 2 3 ... [--control-seeds 1 2 3] [--out FILE]

Prints one JSON line per seed, input and side; ``--out`` also writes them
to a file. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import manifest
from portbench.record import Run
from portbench.reference import compare


def readings(cell: str, seed: int, device, control: bool, traffic=None,
             config=None) -> list[dict]:
    c = manifest.cell(manifest.load(), cell)
    run = Run(config=config or c["config"], traffic=traffic or c["traffic"], seed=seed)
    drv = manifest.driver(run.traffic)(run, device)
    drv.warm_up()
    out = []
    for seg in range(len(drv.ring)):
        t0 = time.perf_counter()
        ref = drv.reference(seg)
        t1 = time.perf_counter()
        ans = drv.answer(drv.ring[seg])
        sides = [("program", ans)]
        if control:
            sides.append(("control", drv.reference(seg, "tf32")))
        for side, a in sides:
            nums = compare.numbers(a, ref)
            out.append(dict(cell=cell, seed=seed, segment=seg, side=side,
                            reference_s=t1 - t0, **nums))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.limits_study")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.limits_study: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    control = set(args.seeds if args.control_seeds is None else args.control_seeds)
    lines = []
    for seed in args.seeds:
        for row in readings(args.workload, seed, torch.device("cuda", 0), seed in control):
            print(json.dumps(row), flush=True)
            lines.append(row)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
