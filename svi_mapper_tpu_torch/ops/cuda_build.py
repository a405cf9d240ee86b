"""Build and load the port's hand-written CUDA kernels.

The sources under ``svi_mapper_tpu_torch/csrc/*.cu`` (and the ``*.cuh``
headers they include) expose a plain C interface. At first use each source
is compiled by its own ``nvcc`` process (all started together) for
``sm_90a``, the objects are linked into one shared library under
``svi_mapper_tpu_torch/_build/`` and the library is loaded with ``ctypes``.
The library's name carries a hash of the sources and headers, so an edited
one is rebuilt and a built one is reused. A build failure raises; nothing
gives way to the plain PyTorch versions.

Every exported function takes device pointers and the CUDA stream as
``void*``, launches on that stream, allocates nothing, does not synchronise
and returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: name -> argtypes (every function returns int)
_SIGNATURES = {
    # field, uv, band, desc_last, desc_ref, out, L, H, W, cut1, cut2,
    # cut_ref, stream
    "svi_track_scores": [_P] * 6 + [_I] * 6 + [_P],
    # field, uv, desc, profile, u_r, x0, K, De, H, W, stream
    "svi_stereo_profiles": [_P] * 6 + [_I] * 4 + [_P],
    # field, uv, desc, center, range, out, K, De, H, W, min_disparity, stream
    "svi_stereo_match": [_P] * 6 + [_I] * 4 + [_F, _P],
    # img, out, H, W, stream
    "svi_brief_dense_fused": [_P] * 2 + [_I] * 2 + [_P],
    # T, X, obs, obs_w, S, rhs, Hll_inv, b_l, W, pp_part, hl_part, hrec,
    # part, rhs_part, count, schedule, K, L, ks, g, max_items, blocks, fx,
    # fy, cx, cy, bq, kernel_px2, damping, stream
    "svi_schur_system": [_P] * 16 + [_I] * 6 + [_F] * 7 + [_P],
    # a, b, out, B, N, M, stream
    "svi_hamming_matrix": [_P] * 3 + [_I] * 3 + [_P],
    # q_desc, q_valid, r_desc, r_valid, counts, B, P, C, Pr, cutoff, stream
    "svi_pool_nn_counts": [_P] * 5 + [_I] * 5 + [_P],
}

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None   # wall time of this process's build
build_log: dict[str, str] = {}       # source name -> what ptxas said (-v)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of "
        "svi_mapper_tpu_torch cannot be built")


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def _build(lib_path: Path, verbose: bool) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib_path.stem}.{os.getpid()}"
    extra = ["-Xptxas", "-v"]       # registers, shared memory and spills
    procs = []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        build_log[src.name] = out or ""
        if verbose and out:
            print(out, flush=True)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    tmp = BUILD_DIR / f"{tag}.so"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib_path)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)


def load_library(verbose: bool = False) -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        srcs = sources()
        if not srcs:
            raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
        digest = hashlib.sha256()
        for s in srcs + headers():
            digest.update(s.name.encode())
            digest.update(s.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        lib_path = BUILD_DIR / f"libsvi_kernels_{digest.hexdigest()[:16]}.so"
        if not lib_path.exists():
            t0 = time.perf_counter()
            _build(lib_path, verbose)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def check_launch(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")


def require_int32_contiguous(t, name: str, shape_tail: tuple = ()) -> None:
    import torch

    if t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 tensor")
    if shape_tail and tuple(t.shape[-len(shape_tail):]) != shape_tail:
        raise ValueError(f"{name} must end in shape {shape_tail}, got {tuple(t.shape)}")
