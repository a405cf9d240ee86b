"""Native (C++) host runtime: descriptor index, cloud codec, dump loader.

The device runs the dense math (``ops``, ``solvers``); this package is the
host-side runtime the reference implements in C++:

* :class:`DescriptorIndex` — incremental binary descriptor search tree for
  loop-closure candidate shortlisting (role of CBTree/CBITree + the DBoW2
  BriefDatabase query, ref CBNode.h:64-201, CTrackerGT.cpp:411);
* :func:`write_cloud_native` / :func:`read_cloud_native` — binary keyframe
  cloud codec behind the ``.svic`` suffix (role of
  CKeyFrame::saveCloudToFile, CKeyFrame.cpp:138-185);
* :class:`DumpWriter` / :class:`DumpReader` — paired-stereo message dump
  (``.svid``) with a background prefetch thread (role of txt_io playback +
  republisher_kitti, tracker_gt.cpp:182-268);
* :func:`validate_dump` — dump integrity check (validate_dataset parity).

The sources under ``native/src/`` are this package's own; the shared
library is built from them with g++ at first use into
``svi_mapper_tpu_torch/_build/`` (:mod:`.build`) and loaded with
``ctypes``. The file formats are the JAX package's, byte for byte, so a
file written by either package reads in the other.

Everything here takes and returns numpy arrays on the host; tensors cross
at the callers. Import never fails: :func:`available` says whether the
library could be built, :func:`load_error` why not; every entry point
raises ``RuntimeError`` with that reason when it cannot be.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_lib = None
_load_error: str | None = None
_load_lock = threading.Lock()


def _load():
    global _lib, _load_error
    with _load_lock:
        if _lib is not None or _load_error is not None:
            return _lib
        try:
            from svi_mapper_tpu_torch.native import build

            lib = ctypes.CDLL(str(build.build()))
        except Exception as e:  # toolchain missing / compile failure
            _load_error = str(e)
            return None

        c = ctypes
        u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

        lib.svi_index_create.restype = c.c_void_p
        lib.svi_index_create.argtypes = [c.c_int, c.c_int]
        lib.svi_index_destroy.argtypes = [c.c_void_p]
        lib.svi_index_add.argtypes = [c.c_void_p, u64p, c.c_int, c.c_int64]
        lib.svi_index_size.restype = c.c_int64
        lib.svi_index_size.argtypes = [c.c_void_p]
        lib.svi_index_n_keyframes.restype = c.c_int64
        lib.svi_index_n_keyframes.argtypes = [c.c_void_p]
        lib.svi_index_query.argtypes = [c.c_void_p, u64p, c.c_int, c.c_int,
                                        c.c_int64, i32p]

        lib.svi_cloud_write.restype = c.c_int
        lib.svi_cloud_write.argtypes = [
            c.c_char_p, c.c_int64, c.c_int64, f32p, c.c_uint32,
            i64p, f32p, f32p, f32p, f32p, u64p,
        ]
        lib.svi_cloud_read_header.restype = c.c_int64
        lib.svi_cloud_read_header.argtypes = [
            c.c_char_p, c.POINTER(c.c_int64), c.POINTER(c.c_int64), f32p,
        ]
        lib.svi_cloud_read.restype = c.c_int
        lib.svi_cloud_read.argtypes = [c.c_char_p, i64p, f32p, f32p, f32p, f32p,
                                       u64p]

        lib.svi_dump_writer_open.restype = c.c_void_p
        lib.svi_dump_writer_open.argtypes = [c.c_char_p, c.c_uint32, c.c_uint32]
        lib.svi_dump_writer_append.restype = c.c_int
        lib.svi_dump_writer_append.argtypes = [c.c_void_p, c.c_int64, c.c_double,
                                               u8p, u8p]
        lib.svi_dump_writer_close.argtypes = [c.c_void_p]

        lib.svi_dump_reader_open.restype = c.c_void_p
        lib.svi_dump_reader_open.argtypes = [
            c.c_char_p, c.c_int,
            c.POINTER(c.c_uint32), c.POINTER(c.c_uint32), c.POINTER(c.c_uint32),
        ]
        lib.svi_dump_reader_next.restype = c.c_int
        lib.svi_dump_reader_next.argtypes = [
            c.c_void_p, c.POINTER(c.c_int64), c.POINTER(c.c_double), u8p, u8p,
        ]
        lib.svi_dump_reader_close.argtypes = [c.c_void_p]
        lib.svi_dump_validate.restype = c.c_int
        lib.svi_dump_validate.argtypes = [c.c_char_p, c.c_char_p, c.c_int]

        _lib = lib
        return _lib


def available() -> bool:
    """True if the native library is built or buildable on this machine."""
    return _load() is not None


def load_error() -> str | None:
    """Why the library could not be built or loaded (None if it was)."""
    _load()
    return _load_error


def library():
    """The loaded library; raises ``RuntimeError`` with :func:`load_error`
    when it cannot be built."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_load_error}")
    return lib


def _to_words(desc: np.ndarray) -> np.ndarray:
    """[n, 8] packed descriptors (uint32, or int32 with the same bits) ->
    [n, 4] uint64 (bit order kept)."""
    d = np.ascontiguousarray(desc)
    if d.dtype == np.int32:
        d = d.view(np.uint32)
    d = np.ascontiguousarray(d, np.uint32)
    if d.ndim != 2 or d.shape[1] != 8:
        raise ValueError(f"expected [n, 8] uint32 descriptors, got {d.shape}")
    return d.view(np.uint64) if d.size else d.reshape(-1, 4).astype(np.uint64)


# ---------------------------------------------------------------------------
# descriptor index
# ---------------------------------------------------------------------------

class DescriptorIndex:
    """Incremental host-side descriptor-to-keyframe vote index.

    ``add(desc, kf_id)`` inserts one keyframe's [n, 8] packed pool;
    ``query(desc, cutoff)`` returns per-keyframe match-vote counts — the
    score of :func:`svi_mapper_tpu_torch.mapping.closure.score_pools` with
    tree descent in place of brute force: each query descriptor votes for
    the keyframe of its best match in the leaf it descends to. ``add`` and
    ``query`` may come from different threads (a closure search on a worker
    while the tracker adds keyframes): one lock serialises them.
    """

    def __init__(self, max_depth: int = 64, max_leaf_size: int = 128):
        lib = library()
        self._lib = lib
        self._h = lib.svi_index_create(max_depth, max_leaf_size)
        self._lock = threading.Lock()

    def add(self, desc: np.ndarray, keyframe_id: int) -> None:
        w = _to_words(desc)
        with self._lock:
            self._lib.svi_index_add(self._h, w, len(w), keyframe_id)

    def query(self, desc: np.ndarray, cutoff: int = 25,
              max_keyframe: int = -1) -> np.ndarray:
        """[n_keyframes] int32 vote counts. ``max_keyframe >= 0`` restricts
        votes to keyframes with id < max_keyframe (temporal exclusion at
        vote time — recent duplicates cannot shadow older keyframes)."""
        w = _to_words(desc)
        with self._lock:
            nk = self._lib.svi_index_n_keyframes(self._h)
            votes = np.zeros(max(int(nk), 1), np.int32)
            if len(w) and nk:
                self._lib.svi_index_query(self._h, w, len(w), cutoff,
                                          max_keyframe, votes)
        return votes[:nk]

    @property
    def size(self) -> int:
        """Descriptors stored."""
        with self._lock:
            return int(self._lib.svi_index_size(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.svi_index_destroy(self._h)
            self._h = None


# ---------------------------------------------------------------------------
# cloud codec
# ---------------------------------------------------------------------------

def write_cloud_native(path, cloud) -> None:
    """Write a :class:`svi_mapper_tpu_torch.io.cloud.KeyframeCloud` as
    binary."""
    lib = library()
    n = len(cloud.uids)
    ok = lib.svi_cloud_write(
        str(path).encode(), int(cloud.keyframe_id), int(cloud.frame_idx),
        np.ascontiguousarray(cloud.T_wc, np.float32).reshape(16), n,
        np.ascontiguousarray(cloud.uids, np.int64),
        np.ascontiguousarray(cloud.points_w, np.float32),
        np.ascontiguousarray(cloud.points_cam, np.float32),
        np.ascontiguousarray(cloud.uv_left, np.float32),
        np.ascontiguousarray(cloud.uv_right, np.float32),
        _to_words(cloud.descriptors),
    )
    if not ok:
        raise IOError(f"failed to write cloud file {path}")


def read_cloud_native(path):
    """Read a binary cloud file -> ``KeyframeCloud`` (descriptors uint32)."""
    from svi_mapper_tpu_torch.io.cloud import KeyframeCloud

    lib = library()
    kf = ctypes.c_int64()
    fi = ctypes.c_int64()
    T = np.zeros(16, np.float32)
    n = lib.svi_cloud_read_header(str(path).encode(), ctypes.byref(kf),
                                  ctypes.byref(fi), T)
    if n < 0:
        raise IOError(f"bad cloud file {path}")
    n = int(n)
    uids = np.zeros(n, np.int64)
    pw = np.zeros((n, 3), np.float32)
    pc = np.zeros((n, 3), np.float32)
    uvl = np.zeros((n, 2), np.float32)
    uvr = np.zeros((n, 2), np.float32)
    desc = np.zeros((n, 4), np.uint64)
    if not lib.svi_cloud_read(str(path).encode(), uids, pw, pc, uvl, uvr, desc):
        raise IOError(f"failed to read cloud file {path}")
    return KeyframeCloud(
        keyframe_id=int(kf.value), frame_idx=int(fi.value),
        T_wc=T.reshape(4, 4), uids=uids, points_w=pw, points_cam=pc,
        uv_left=uvl, uv_right=uvr, descriptors=desc.view(np.uint32),
    )


# ---------------------------------------------------------------------------
# stereo dump loader
# ---------------------------------------------------------------------------

class DumpWriter:
    """Write a paired-stereo message dump (republisher_kitti role)."""

    def __init__(self, path, height: int, width: int):
        lib = library()
        self._lib = lib
        self.height, self.width = height, width
        self._h = lib.svi_dump_writer_open(str(path).encode(), height, width)
        if not self._h:
            raise IOError(f"cannot open dump file {path} for writing")

    def append(self, frame_id: int, timestamp: float,
               left: np.ndarray, right: np.ndarray) -> None:
        lt = np.ascontiguousarray(left, np.uint8)
        rt = np.ascontiguousarray(right, np.uint8)
        if lt.shape != (self.height, self.width) or rt.shape != lt.shape:
            raise ValueError(f"frame shape {lt.shape}/{rt.shape} != "
                             f"({self.height}, {self.width})")
        if not self._lib.svi_dump_writer_append(self._h, frame_id, timestamp, lt, rt):
            raise IOError("dump append failed")

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.svi_dump_writer_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


class DumpReader:
    """Iterate ``(frame_id, timestamp, left, right)`` (uint8 host images)
    while a background thread reads up to ``prefetch`` frames ahead."""

    def __init__(self, path, prefetch: int = 4):
        lib = library()
        self._lib = lib
        n = ctypes.c_uint32()
        h = ctypes.c_uint32()
        w = ctypes.c_uint32()
        self._h = lib.svi_dump_reader_open(
            str(path).encode(), prefetch,
            ctypes.byref(n), ctypes.byref(h), ctypes.byref(w))
        if not self._h:
            raise IOError(f"cannot open dump file {path}")
        self.n_frames, self.height, self.width = int(n.value), int(h.value), int(w.value)

    def __iter__(self):
        return self

    def __next__(self):
        if not self._h:
            raise StopIteration
        fid = ctypes.c_int64()
        ts = ctypes.c_double()
        left = np.empty((self.height, self.width), np.uint8)
        right = np.empty((self.height, self.width), np.uint8)
        if not self._lib.svi_dump_reader_next(
                self._h, ctypes.byref(fid), ctypes.byref(ts), left, right):
            self.close()
            raise StopIteration
        return int(fid.value), float(ts.value), left, right

    def close(self) -> None:
        """Stop the prefetch thread (also mid-stream) and close the file."""
        if getattr(self, "_h", None):
            self._lib.svi_dump_reader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def validate_dump(path) -> int:
    """Check dump integrity; return the frame count or raise ValueError."""
    lib = library()
    err = ctypes.create_string_buffer(256)
    n = lib.svi_dump_validate(str(path).encode(), err, 256)
    if n == 0:
        raise ValueError(f"invalid dump {path}: {err.value.decode()}")
    return n
