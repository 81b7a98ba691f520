"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` compiles with its own ``nvcc``, all started
together, and the objects link into ONE shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  The library goes to ``_build/`` beside this file, named by a
hash of the sources and flags, and is rebuilt when that hash changes.
Nothing builds at import time: the first kernel launch calls
``library()``.

Every C entry point returns the ``cudaError_t`` of its launch; wrappers
pass it to ``check``, which raises on anything but ``cudaSuccess``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# sm_90a: Hopper with its architecture-specific features.  --fmad=false
# keeps every float multiply and add separately rounded, as the PyTorch
# plain versions evaluate them, so a kernel and its plain version can agree
# bit for bit (the descriptor's sample positions truncate to integers).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# argument types of every C entry point (csrc/*.cu, extern "C")
SIGNATURES = {
    "akaze_sublevel": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                       _I, _VP],
    "akaze_octave": [_VP, _VP, _LL, _VP, _LL, _VP, _VP, _VP, _I, _I, _VP],
    "akaze_describe": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                       _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _I, _VP],
    "akaze_hamming_top2": [_VP, _I, _VP, _VP, _VP, _I, _VP, _VP, _VP, _VP,
                           _VP],
    "akaze_hamming_match": [_I, _VP, _VP, _I, _VP, _VP, _I, _VP, _VP, _I,
                            _VP, _VP, _VP, _VP, _VP],
    "akaze_extrema_nms": [_VP, _I, _VP, _I, _I, _VP, _VP, _VP, _VP, _VP],
    "akaze_pgo_scratch": [_I, _I, _VP],
    "akaze_pgo_solve": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I,
                        _I, _I, _I, _F, _VP, _VP, _VP, _VP, _LL, _VP, _VP],
}


class KernelError(RuntimeError):
    """A kernel failed to build or launch."""


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``, the ``PATH`` or the default toolkit."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile the library if the current sources have none yet.

    Returns ``{"path", "seconds", "log", "cached"}``; ``log`` holds what
    nvcc printed (registers and shared memory per kernel, from
    ``-Xptxas -v``).  Raises ``KernelError`` when nvcc fails.
    """
    lib = BUILD_DIR / f"libakaze_kernels_{source_hash()}.so"
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "log": "", "cached": True}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = str(Path(tmp) / (src.stem + ".o"))
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        for cmd, proc in procs:
            text = proc.communicate()[0]
            log.append(text)
            if proc.returncode != 0:
                for _, other in procs:
                    other.kill()
                    other.wait()
                raise KernelError(f"nvcc failed ({proc.returncode}):\n"
                                  f"{' '.join(cmd)}\n{text}")
        out = Path(tmp) / lib.name
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(out), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelError(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(out, lib)   # atomic: concurrent builders never see half
    return {"path": str(lib), "seconds": time.perf_counter() - t0,
            "log": "".join(log), "cached": False}


@lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.akaze_error_string.argtypes = [ctypes.c_int]
    lib.akaze_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise ``KernelError`` for a non-zero ``cudaError_t``."""
    if err != 0:
        text = library().akaze_error_string(err).decode(errors="replace")
        raise KernelError(f"{name}: CUDA error {err}: {text}")


def check_tensor(name: str, t, dtype, shape, device,
                 contiguous: bool = True) -> None:
    """Raise unless ``t`` is a ``dtype`` tensor of ``shape`` on ``device``,
    and contiguous (what a kernel's raw pointer arithmetic assumes) unless
    ``contiguous`` is false."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t) -> int:
    """Device pointer of a tensor as a Python int (0 for None)."""
    return 0 if t is None else t.data_ptr()


def stream_of(t) -> int:
    """The current PyTorch stream of ``t``'s device, for a launch: the raw
    handle, without building a ``torch.cuda.Stream`` (which costs several
    microseconds of host time per launch)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.device.index)
