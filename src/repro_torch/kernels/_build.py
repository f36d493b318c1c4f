"""Build and load the hand-written Hopper kernels.

Each source under ``csrc/`` has a plain C interface. It is compiled by hand
with ``nvcc`` for ``sm_90a`` into a shared library and loaded with
``ctypes``: no PyTorch headers, so a build takes seconds. Libraries go to
``build/repro_torch_kernels/`` at the root of the checkout, named by a hash
of their source, and are built at first use. Importing this module
compiles nothing.

The launch plumbing every kernel wrapper shares lives here too: ``entry``
binds a C entry point, ``launch`` calls it on PyTorch's current stream,
raises if the launch failed and adds one to ``LAUNCHES[name]``, so a run
can show that its path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = {"flash_fwd": "flash_fwd.cu", "paged_decode": "paged_decode.cu",
           "flash_bwd": "flash_bwd.cu", "matmul_epilogue": "matmul_epilogue.cu",
           "outer_update": "outer_update.cu"}
# C entry point -> the library that holds it (default: the library of its name)
ENTRY_LIB = {"flash_dq": "flash_bwd", "flash_dkv": "flash_bwd", "nesterov": "outer_update"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict[str, tuple] = {}

LAUNCHES: dict[str, int] = {name: 0 for name in (
    "flash_fwd", "paged_decode", "flash_dq", "flash_dkv", "matmul_epilogue", "nesterov")}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the Hopper kernels need the CUDA toolkit")


def lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str, verbose: bool) -> tuple[subprocess.Popen, Path, Path]:
    out = lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names=None, verbose: bool = False) -> dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source, all started together. Returns ``{name: {"path",
    "seconds", "log"}}``; raises with nvcc's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    names = list(SOURCES) if names is None else list(names)
    t0 = time.perf_counter()
    running = {n: _start(n, verbose) for n in names if verbose or not lib_path(n).exists()}
    report = {n: {"path": str(lib_path(n)), "seconds": 0.0, "log": ""} for n in names}
    failed = []
    for n, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        report[n].update(seconds=time.perf_counter() - t0, log=log)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use."""
    if name not in _LIBS:
        path = lib_path(name)
        if not path.exists():
            build([name])
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]


def entry(name: str, argtypes: list):
    """``(fn, err)``: the C entry point ``name`` with its argument types, and
    its library's error-string function; built and bound on first use."""
    if name not in _ENTRIES:
        lib_name = ENTRY_LIB.get(name, name)
        lib = load(lib_name)
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        err = getattr(lib, f"{lib_name}_error")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        _ENTRIES[name] = (fn, err)
    return _ENTRIES[name]


def launch(name: str, argtypes: list, device, *args) -> None:
    """Launch ``name`` on ``device``'s current stream (the stream is passed
    as the last argument); raise if the launch failed, else count it."""
    import torch

    fn, err = entry(name, argtypes)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {err(rc).decode()} (cudaError {rc})")
    LAUNCHES[name] += 1
