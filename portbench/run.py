"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``svi_mapper_tpu_torch``).
Set-up makes the cell's inputs on the card from ``--seed`` and warms every
shape up; the window then drives the cell's traffic for ``--seconds``; once
it has closed, the reference checks every answer. ``--trace 0`` reports
the cell's end-to-end metrics, ``--trace 1`` runs the same window under
``torch.profiler`` and reports its per-layer metrics, the device's busy
time and a breakdown. The last line of standard output is one JSON object;
the numbers that decided ``correct`` close standard error, each beside its
limit.

Exits with 2 and prints no result without a CUDA device (or with fewer than
the cell asks for), with 3 if JAX or the JAX package was loaded, and with 1
on any other failure.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "svi_mapper_tpu")


def _fixed_caches() -> None:
    """Kernel caches at fixed paths inside the checkout, so that only the
    first run there builds (the port's nvcc library builds into its own
    ``_build`` directory inside the checkout)."""
    cache = CHECKOUT / "portbench" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "1")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(name: str, seed: int, seconds: float, traced: bool, device,
             bench: dict | None = None, traffic: dict | None = None):
    """Set up, run the window, check. Returns ``(result, checks)``: the
    result line's object and the compared numbers with their limits.
    ``traffic`` replaces the cell's traffic file (tests run small cells on
    the CPU through this)."""
    import torch

    from portbench import manifest
    from portbench.record import Run, Solve
    from portbench.reference.compare import over_limits

    bench = bench or manifest.load()
    c = manifest.cell(bench, name)
    run = Run(config=c["config"], traffic=traffic or c["traffic"], seed=seed)
    on_card = device.type == "cuda"
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    drv = manifest.driver(run.traffic)(run, device)
    drv.warm_up()
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    sync()

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.start()
    from portbench.trace import SOLVE, WINDOW
    mark = torch.profiler.record_function if traced else (lambda _: contextlib.nullcontext())

    start = time.perf_counter()
    run.setup_s = start - PROCESS_START
    with mark(WINDOW):
        i = 0
        while True:
            t0 = time.perf_counter()
            with mark(SOLVE):
                seg, iters = drv.solve(i)
            t1 = time.perf_counter()
            run.solves.append(Solve(segment=seg, latency_s=t1 - t0, iterations=iters))
            i += 1
            if t1 - start >= seconds:
                break
    run.window_s = t1 - start
    sync()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if prof is not None:
        from portbench.trace import Trace

        prof.stop()
        run.trace = Trace(prof)
        del prof

    drv.drop_program_state()
    limits = c["limits"]
    worst, per_answer = drv.check(list(limits))
    failed = sum(1 for nums in per_answer if over_limits(nums, limits))
    checks = {n: {"value": worst[n], "limit": limits[n]} for n in limits}
    correct = bool(per_answer) and failed == 0

    metrics = {}
    for m in manifest.metrics(bench, name, traced):
        value = manifest.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(per_answer), "failed": failed,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                               "idle_gaps": run.trace.top_idle_gaps()}
    result["checks"] = checks
    return result, checks


def main(argv=None) -> int:
    args = parse(argv)
    _fixed_caches()
    import torch

    from portbench import manifest

    bench = manifest.load()
    chips = manifest.cell(bench, args.workload)["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), bench=bench)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for n, c in checks.items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
