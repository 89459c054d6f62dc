"""Build, load and launch bookkeeping for the hand-written CUDA kernels.

All kernels live in `csrc/*.cu` (with the headers `csrc/*.cuh`) with a
plain C interface.  At first use on a CUDA tensor they are compiled by
`nvcc` into one shared library under `build/custrings_tpu_torch/` and
loaded with ctypes.  The library's file name carries a hash of the
sources and headers, the nvcc flags and the nvcc path, so a change to any
of them builds a new library instead of loading a stale one.  Nothing is
built or loaded when this module is imported, so the CPU tests (which
have no nvcc) import every module freely.

Every C entry point takes raw device pointers, ints and the current
stream, launches, and returns `cudaGetLastError()`; `check()` raises on
a nonzero code.  `LAUNCHES` counts each kernel's launches: a wrapper
launches its kernel inside `launched(name)`, which adds one and opens the
span `kernel.<name>` (`utils.tracing`), and nowhere else.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

from .utils import tracing

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "custrings_tpu_torch")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

LAUNCHES = {
    "scan_sum": 0,
    "scan_max": 0,
    "window_bytes": 0,
    "window_words": 0,
    "nfa_bits": 0,
    "route_compact": 0,
    "route_expand": 0,
    "span_all": 0,
    "nfa_words": 0,
    "hash": 0,
    "compact_bytes": 0,
}
#: scan_sum's launches by input size, counted beside LAUNCHES: over a
#: capacity-sized input (at least 2^24 elements) or a smaller one
SCAN_SUM_SIZES = {"capacity": 0, "rows": 0}

_lib = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int

_SIGNATURES = {
    # scan.cu
    "cs_scan_scratch_words": ([_I64], _I64),
    "cs_scan": ([_P, _I32, _P, _I64, _I32, _I32, _I32, _I32, _I32, _P, _P], _I32),
    # window.cu
    "cs_window_bytes": ([_P, _I64, _P, _P, _I64, _I64, _I32, _P, _P], _I32),
    "cs_window_words": ([_P, _I64, _P, _I64, _I64, _P, _P], _I32),
    # nfa_bits.cu
    "cs_nfa_bits": ([_P, _P, _P, _I32, _P, _I32, _P, _I64, _I64, _I32, _P, _P], _I32),
    # route.cu
    "cs_compact_scratch_words": ([_I64], _I64),
    "cs_compact": ([_P, _P, _I64, _I32, _P, _P, _P, _P, _P, _P], _I32),
    "cs_expand_scratch_words": ([_I64], _I64),
    "cs_expand": ([_P, _P, _I64, _I64, _I32, _P, _P, _P, _P, _P, _P], _I32),
    # spans.cu
    "cs_span_all": (
        [_P, _I64, _P, _P, _P, _P, _I32, _P, _I32, _P, _I64, _I32, _I32, _P, _P, _P, _P, _P],
        _I32,
    ),
    # nfa_words.cu
    "cs_nfa_words": ([_P, _P, _P, _I32, _P, _I32, _P, _I64, _I64, _I32, _I32, _P, _P], _I32),
    # hash.cu
    "cs_hash": ([_P, _I64, _P, _I64, _P, _P], _I32),
    # compact.cu
    "cs_compact_bytes_scratch_words": ([_I64], _I64),
    "cs_compact_bytes": ([_P, _P, _I64, _I64, _P, _P, _P], _I32),
    "cs_error_string": ([_I32], ctypes.c_char_p),
}


class _Counted:
    """Adds one to LAUNCHES[name] when its block ends without raising."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, typ, *exc):
        if typ is None:
            LAUNCHES[self.name] += 1
        return False


_COUNTED: dict = {}


@contextlib.contextmanager
def _counted_span(name: str):
    with tracing.op("kernel." + name):
        yield
    LAUNCHES[name] += 1


def launched(name: str):
    """`with launched(name):` around the launch of kernel `name`: one more
    in LAUNCHES[name] when the block ends without raising, inside span
    `kernel.<name>` while spans are on.  Off, one check and a cached
    counter."""
    if tracing.on():
        return _counted_span(name)
    return _COUNTED.get(name) or _COUNTED.setdefault(name, _Counted(name))


def reset_launches() -> None:
    for counts in (LAUNCHES, SCAN_SUM_SIZES):
        for k in counts:
            counts[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(nvcc: str | None = None) -> str:
    """The library's path for the current sources, headers, flags and
    nvcc."""
    h = hashlib.sha256()
    for part in [nvcc or _nvcc(), *NVCC_FLAGS]:
        h.update(part.encode() + b"\0")
    files = glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh"))
    for src in sorted(files):
        h.update(os.path.basename(src).encode() + b"\0")
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libcustrings_kernels-{h.hexdigest()[:16]}.so")


def _run_all(cmds) -> None:
    """Run the commands at once; raise with the first failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate(timeout=900)
        if p.returncode != 0:
            failed.append(" ".join(cmd) + "\n" + out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build(force: bool = False) -> str:
    """Compile csrc/*.cu into lib_path() unless that library exists: one
    nvcc per source, all started together, then one link."""
    nvcc = _nvcc()
    path = lib_path(nvcc)
    if not force and os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in sources]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(sources, objs)])
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
    for o in objs:
        os.remove(o)
    os.replace(tmp, path)
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = handle
    return _lib


def stream_ptr(t) -> int:
    """The current CUDA stream of t's device, as a raw pointer."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check(err: int, what: str) -> None:
    if err != 0:
        msg = lib().cs_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def require_cuda(t, what: str) -> None:
    """Raise unless `t` is a contiguous tensor on the current CUDA device
    (the C entry points launch there)."""
    import torch

    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.get_device() != torch.cuda.current_device():
        raise ValueError(f"{what}: tensor on {t.device}, current device is another")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
