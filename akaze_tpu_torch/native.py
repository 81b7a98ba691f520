"""ctypes bindings for the native host runtime (``csrc/host/akaze_native.cpp``).

Port of ``akaze_tpu/native.py``: the FED time-step planner, PGM decoding, a
threaded prefetching frame loader and a host Hamming matcher, in C++ with a
plain C interface.  The port keeps its own copy of the source and builds
it with g++ on first use into ``_build/`` beside this file (the kernels'
build directory), named by a hash of the source and the flags and written
through a temporary file, so that concurrent builders never see half a
library.  Nothing builds at import time.

Every entry point has a fallback when g++ or the build is missing:
``get_lib`` returns None, the functions then return None (callers fall back
to ``fed.py``, ``io.load_pgm`` and ``match``), and ``FrameLoader`` decodes
synchronously in Python.  This is host code; no device path depends on it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "csrc" / "host" / \
    "akaze_native.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# the loader's frame buffer: the largest frame it hands over
FRAME_CAP = 32 * 1024 * 1024


def library_path() -> Path:
    """Where the library of the current source and flags goes."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libakaze_native_{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    """Compile the library unless it exists; None if g++ fails or is
    missing."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / lib.name
        cmd = ["g++", *GXX_FLAGS, "-o", str(out), str(SOURCE), "-lpthread"]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (subprocess.SubprocessError, FileNotFoundError):
            return None
        os.replace(out, lib)   # atomic: concurrent builders never see half
    return lib


_P = ctypes.POINTER
_I = ctypes.c_int
# (restype, argtypes) of every C entry point
SIGNATURES = {
    "fed_tau_by_process_time": (_I, [ctypes.c_float, ctypes.c_float, _I,
                                     _P(ctypes.c_float), _I]),
    "pgm_query": (_I, [ctypes.c_char_p, _P(_I), _P(_I)]),
    "pgm_decode": (_I, [ctypes.c_char_p, _P(ctypes.c_uint8), _I]),
    "loader_create": (ctypes.c_void_p, [ctypes.c_char_p, _I, _I]),
    "loader_num_frames": (_I, [ctypes.c_void_p]),
    "loader_next": (_I, [ctypes.c_void_p, _P(ctypes.c_uint8), _I, _P(_I),
                         _P(_I)]),
    "loader_destroy": (None, [ctypes.c_void_p]),
    "hamming_match_cpu": (None, [_P(ctypes.c_uint32), _I,
                                 _P(ctypes.c_uint32), _I, _I,
                                 _P(ctypes.c_int32), _P(ctypes.c_int32)]),
}


@lru_cache(maxsize=None)
def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, built on first call; None if unavailable."""
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def fed_tau_native(t: float, tau_max: float, reorder: bool
                   ) -> Optional[np.ndarray]:
    """FED tau table from the native planner; None if the library is
    unavailable (callers fall back to ``fed.py``)."""
    lib = get_lib()
    if lib is None:
        return None
    cap = 4096
    buf = (ctypes.c_float * cap)()
    n = lib.fed_tau_by_process_time(t, tau_max, int(reorder), buf, cap)
    if n < 0:
        raise RuntimeError(f"FED needs {-n} steps > cap {cap}")
    return np.asarray(buf[:n], np.float32)


def load_pgm_native(path: str) -> Optional[np.ndarray]:
    """A binary PGM as uint8 [H, W]; None if the library is unavailable
    (callers fall back to ``io.load_pgm``)."""
    lib = get_lib()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    if lib.pgm_query(path.encode(), ctypes.byref(w), ctypes.byref(h)) != 0:
        raise IOError(f"cannot read PGM header: {path}")
    out = np.empty((h.value, w.value), np.uint8)
    rc = lib.pgm_decode(path.encode(),
                        out.ctypes.data_as(_P(ctypes.c_uint8)), out.size)
    if rc != 0:
        raise IOError(f"PGM decode failed ({rc}): {path}")
    return out


class FrameLoader:
    """Threaded prefetching frame loader over a list of PGM paths.

    Decoding runs on native worker threads; ``__next__`` yields frames
    strictly in order as uint8 [H, W] arrays.  Without the native library
    it decodes synchronously in Python (``io.load_pgm``).
    """

    def __init__(self, paths: List[str], n_threads: int = 2,
                 prefetch: int = 4):
        self._paths = list(paths)
        self._lib = get_lib()
        self._handle = None
        self._pos = 0
        self._buf = None
        if self._lib is not None:
            self._handle = self._lib.loader_create(
                "\n".join(self._paths).encode(), n_threads, prefetch)
            self._buf = np.empty(FRAME_CAP, np.uint8)

    def __len__(self):
        return len(self._paths)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._pos >= len(self._paths):
            raise StopIteration
        self._pos += 1
        if self._handle is None:
            from .io.image import load_pgm
            return load_pgm(self._paths[self._pos - 1])
        w = ctypes.c_int()
        h = ctypes.c_int()
        rc = self._lib.loader_next(
            self._handle, self._buf.ctypes.data_as(_P(ctypes.c_uint8)),
            FRAME_CAP, ctypes.byref(w), ctypes.byref(h))
        if rc == -1:
            raise StopIteration
        if rc != 0:
            raise IOError(f"frame decode failed ({rc})")
        return self._buf[:w.value * h.value].reshape(h.value, w.value).copy()

    def close(self):
        """Stop and join the worker threads."""
        if getattr(self, "_handle", None) is not None:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def hamming_match_native(q: np.ndarray, t: np.ndarray, max_dist: int = 96
                         ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Host 1-NN Hamming match of uint32 [N, 16] words (the uniqueness
    rule of ``match``); None if the library is unavailable.  The port's
    int32 words go through ``descriptor.words_to_numpy`` first.  Returns
    (index, distance), int32, -1 where rejected."""
    lib = get_lib()
    if lib is None:
        return None
    q = np.ascontiguousarray(q)
    t = np.ascontiguousarray(t)
    for name, a in (("q", q), ("t", t)):
        if a.dtype != np.uint32 or a.ndim != 2 or a.shape[1] != 16:
            raise ValueError(f"{name} must be uint32 [N, 16], got "
                             f"{a.dtype} {a.shape}")
    nq, nt = q.shape[0], t.shape[0]
    index = np.empty(nq, np.int32)
    dist = np.empty(nq, np.int32)
    lib.hamming_match_cpu(
        q.ctypes.data_as(_P(ctypes.c_uint32)), nq,
        t.ctypes.data_as(_P(ctypes.c_uint32)), nt, max_dist,
        index.ctypes.data_as(_P(ctypes.c_int32)),
        dist.ctypes.data_as(_P(ctypes.c_int32)))
    return index, dist
