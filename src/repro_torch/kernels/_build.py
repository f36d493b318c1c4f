"""Build and load the hand-written Hopper kernels.

Each source under ``csrc/`` has a plain C interface. It is compiled by hand
with ``nvcc`` for ``sm_90a`` into a shared library and loaded with
``ctypes``: no PyTorch headers, so a build takes seconds. Libraries go to
``build/repro_torch_kernels/`` at the root of the checkout, named by a hash
of their source and the shared headers (``csrc/*.cuh``), and are built at
first use. Importing this module compiles nothing.

The launch plumbing every kernel wrapper shares lives here too: ``entry``
binds a C entry point, ``launch`` calls it on PyTorch's current stream,
raises if the launch failed and adds one to ``LAUNCHES[name]``, so a run
can show that its path went through the kernels. A launch made while a CUDA
graph is being captured executes nothing then; the engine takes back what
a capture counted and adds it once per replay (:func:`capture_graph`,
:func:`add_launch_counts`), so the counts stay kernel executions. Before a library's first
launch, ``launch`` reads the tile sizes its ``<lib>_tiles`` function
reports and raises if they differ from those the launching module
registered in ``TILES`` (its Python mirrors of the schedules assume them).
"""
from __future__ import annotations

import ctypes
import gc
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = {"flash_fwd": "flash_fwd.cu", "paged_decode": "paged_decode.cu",
           "flash_bwd": "flash_bwd.cu", "matmul_epilogue": "matmul_epilogue.cu",
           "outer_update": "outer_update.cu", "quantize": "quantize.cu"}
# C entry point -> the library that holds it (default: the library of its name)
ENTRY_LIB = {"flash_dq": "flash_bwd", "flash_dkv": "flash_bwd", "nesterov": "outer_update",
             "dequantize": "quantize"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict[str, tuple] = {}
# library -> (the count of ints its C function <lib>_tiles reports, the
# leading ones: the tile sizes the module that launches it assumes)
TILES: dict[str, tuple[int, tuple[int, ...]]] = {}
_TILES_CHECKED: set[str] = set()

LAUNCHES: dict[str, int] = {name: 0 for name in (
    "flash_fwd", "paged_decode", "flash_dq", "flash_dkv", "matmul_epilogue", "nesterov",
    "quantize", "dequantize")}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add ``counts`` to ``LAUNCHES`` (a captured graph's launches, once
    per replay)."""
    for name, n in counts.items():
        LAUNCHES[name] += n


def capture_graph(fn: Callable, device, generators: tuple = ()) -> tuple:
    """Capture ``fn()`` in one ``torch.cuda.CUDAGraph`` on ``device``.

    Returns ``(graph, fn's result, the launches the capture recorded,
    seconds)``. A capture executes nothing, so what it counted in
    ``LAUNCHES`` is taken back: add it once per replay with
    :func:`add_launch_counts`. ``generators`` (CUDA ``torch.Generator``s that
    ``fn`` draws from) are registered with the graph, so each replay draws
    fresh numbers. No garbage collection runs during the capture: destroying
    an unreachable graph there would end it. A capture that fails raises.
    """
    import torch

    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    gc_was_on = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.device(device):
            graph = torch.cuda.CUDAGraph()
            for gen in generators:
                graph.register_generator_state(gen)
            with torch.cuda.graph(graph):
                result = fn()
    finally:
        if gc_was_on:
            gc.enable()
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    launches = {k: LAUNCHES[k] - n for k, n in before.items()}
    LAUNCHES.update(before)
    return graph, result, launches, seconds


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the Hopper kernels need the CUDA toolkit")


def lib_path(name: str) -> Path:
    """Where the library is built, named by a hash of its source, every
    header under ``csrc/`` (a source may include any of them) and the flags."""
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
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


def kernel_tiles(lib_name: str) -> tuple[int, ...]:
    """What the built library reports from its ``<lib>_tiles`` function."""
    out = [ctypes.c_int() for _ in range(TILES[lib_name][0])]
    fn = getattr(load(lib_name), f"{lib_name}_tiles")
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)] * len(out), ctypes.c_int
    fn(*map(ctypes.byref, out))
    return tuple(o.value for o in out)


def check_tiles(name: str) -> None:
    """Raise if the library of entry point ``name`` reports other tile sizes
    than ``TILES`` holds (read once per library)."""
    lib_name = ENTRY_LIB.get(name, name)
    if lib_name in TILES and lib_name not in _TILES_CHECKED:
        want = TILES[lib_name][1]
        got = kernel_tiles(lib_name)[:len(want)]
        if got != want:
            raise RuntimeError(f"{SOURCES[lib_name]} tiles {got} != {want}, the sizes the "
                               "launching module assumes")
        _TILES_CHECKED.add(lib_name)


def launch(name: str, argtypes: list, device, *args) -> None:
    """Launch ``name`` on ``device``'s current stream (the stream is passed
    as the last argument) after :func:`check_tiles`; raise if the launch
    failed, else count it."""
    import torch

    check_tiles(name)
    fn, err = entry(name, argtypes)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {err(rc).decode()} (cudaError {rc})")
    LAUNCHES[name] += 1
