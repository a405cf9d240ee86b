"""Build the port's native host runtime with g++.

The library is compiled from ``svi_mapper_tpu_torch/native/src/`` alone
(``svi_native.cpp`` and the ``*.hpp`` headers it includes) into
``svi_mapper_tpu_torch/_build/``. Its file name carries a hash of the
sources and the flags, so a library built from older sources is never
loaded: the first use after a source changes rebuilds it. A build writes
a temporary file and renames it into place, so concurrent processes that
build at once each end with a whole library; within one process a lock
lets one thread build.

    python3 -m svi_mapper_tpu_torch.native.build      # build, print the path
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = _PKG / "_build"
SOURCES = [SRC_DIR / "svi_native.cpp"]
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-Wall", "-Wextra"]

_lock = threading.Lock()


def headers() -> list[Path]:
    return sorted(SRC_DIR.glob("*.hpp"))


def library_path() -> Path:
    """Where the library built from the current sources lives."""
    digest = hashlib.sha256()
    for p in SOURCES + headers():
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libsvi_native_torch_{digest.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile the library if it is missing (or ``force``); return its
    path. A failed compile raises ``RuntimeError`` with g++'s output."""
    with _lock:
        path = library_path()
        if path.exists() and not force:
            return path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{path.stem}.{os.getpid()}.{threading.get_ident()}.so"
        cmd = ["g++", *FLAGS, *[str(s) for s in SOURCES], "-o", str(tmp)]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:            # no g++ on this machine
            raise RuntimeError(f"cannot run g++: {e}") from e
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({r.returncode}):\n{r.stdout}{r.stderr}")
        os.replace(tmp, path)
        return path


if __name__ == "__main__":
    print(build(force=True))
