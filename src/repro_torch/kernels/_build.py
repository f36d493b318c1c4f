"""Build and load the hand-written Hopper kernels.

Each source under ``csrc/`` has a plain C interface. It is compiled by hand
with ``nvcc`` for ``sm_90a`` into a shared library and loaded with
``ctypes``: no PyTorch headers, so a build takes seconds. Libraries go to
``build/repro_torch_kernels/`` at the root of the checkout, named by a hash
of their source and the shared headers (``csrc/*.cuh``), and are built at
first use, each under a file lock beside it, so ranks that start together
compile a library once. Importing this module compiles nothing.

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

Variants. A library can be built several times from its one source with
its tile constants overridden by ``-D`` defines (the ``#ifndef`` defaults in
the ``.cu``): ``VARIANTS[lib][variant]`` holds a variant's defines, which the
module that launches the library registers (``matmul.py``, ``quantize.py``;
the autotune sweep's candidates). Everything is keyed by a string: a
library or entry point by its name for the default variant, which compiles
with no define and so keeps the source's own constants, and by
``name@variant`` otherwise (:func:`variant_key`). A variant's defines enter
its library's hash, so each variant has its own file. ``LAUNCHES`` counts by
entry name whatever the variant; ``VARIANT_LAUNCHES`` counts by key. A
library is built and loaded at its first launch, which must not come inside
a CUDA-graph capture (:func:`load` raises there): the engine's eager warm-up
reaches every variant its captured program launches.
"""
from __future__ import annotations

import ctypes
import fcntl
import gc
import hashlib
import os
import shutil
import subprocess
import threading
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

# library -> variant name -> {macro: value}: the -D defines of each variant
VARIANTS: dict[str, dict[str, dict[str, int]]] = {}

_LIBS: dict[str, ctypes.CDLL] = {}
_ENTRIES: dict[str, tuple] = {}
# library key (variant_key) -> (the count of ints its C function <lib>_tiles
# reports, the leading ones: the tile sizes the module that launches it assumes)
TILES: dict[str, tuple[int, tuple[int, ...]]] = {}
_TILES_CHECKED: set[str] = set()

LAUNCHES: dict[str, int] = {name: 0 for name in (
    "flash_fwd", "paged_decode", "flash_dq", "flash_dkv", "matmul_epilogue", "nesterov",
    "quantize", "dequantize")}
# entry key (variant_key) -> launches; a key appears at its first launch
VARIANT_LAUNCHES: dict[str, int] = {}


def variant_key(name: str, variant: str | None = None) -> str:
    """The key of a library or entry point ``name`` built as ``variant``
    (None: the default variant, keyed by the name alone)."""
    return name if variant is None else f"{name}@{variant}"


def split_key(key: str) -> tuple[str, str | None]:
    """Inverse of :func:`variant_key`: ``(name, variant or None)``."""
    name, _, variant = key.partition("@")
    return name, variant or None


class LaunchCounts(dict):
    """Launches by entry name (a plain dict's equality), with the same
    launches by entry key in ``variants``."""

    def __init__(self, counts: dict, variants: dict | None = None):
        super().__init__(counts)
        self.variants = dict(variants or {})


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    VARIANT_LAUNCHES.clear()


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add ``counts`` to ``LAUNCHES`` (a captured graph's launches, once
    per replay), and its ``variants`` (a :class:`LaunchCounts`) to
    ``VARIANT_LAUNCHES``."""
    for name, n in counts.items():
        LAUNCHES[name] += n
    for key, n in getattr(counts, "variants", {}).items():
        VARIANT_LAUNCHES[key] = VARIANT_LAUNCHES.get(key, 0) + n


def capture_graph(fn: Callable, device, generators: tuple = ()) -> tuple:
    """Capture ``fn()`` in one ``torch.cuda.CUDAGraph`` on ``device``.

    Returns ``(graph, fn's result, the launches the capture recorded (a
    :class:`LaunchCounts`), seconds)``. A capture executes nothing, so what it counted in
    ``LAUNCHES`` is taken back: add it once per replay with
    :func:`add_launch_counts`. ``generators`` (CUDA ``torch.Generator``s that
    ``fn`` draws from) are registered with the graph, so each replay draws
    fresh numbers. No garbage collection runs during the capture: destroying
    an unreachable graph there would end it. A capture that fails raises.
    """
    import torch

    before, before_v = dict(LAUNCHES), dict(VARIANT_LAUNCHES)
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
    launches = LaunchCounts({k: LAUNCHES[k] - n for k, n in before.items()},
                            {k: n - before_v.get(k, 0) for k, n in VARIANT_LAUNCHES.items()
                             if n != before_v.get(k, 0)})
    LAUNCHES.update(before)
    VARIANT_LAUNCHES.clear()
    VARIANT_LAUNCHES.update(before_v)
    return graph, result, launches, seconds


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the Hopper kernels need the CUDA toolkit")


def defines(key: str) -> dict[str, int]:
    """The ``-D`` defines of library key ``key`` (none for a default variant);
    raises for a variant its module did not register."""
    lib, variant = split_key(key)
    if variant is None:
        return {}
    try:
        return VARIANTS[lib][variant]
    except KeyError:
        raise KeyError(f"{lib}: no variant {variant!r} registered (known: "
                       f"{sorted(VARIANTS.get(lib, {}))})") from None


def lib_path(key: str) -> Path:
    """Where library key ``key`` (a library's name, or ``lib@variant``) is
    built, named by a hash of its source, every header under ``csrc/`` (a
    source may include any of them), the flags and the variant's defines."""
    lib, variant = split_key(key)
    h = hashlib.sha256((CSRC / SOURCES[lib]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    flags = [f"-D{k}={v}" for k, v in sorted(defines(key).items())]
    if flags:
        h.update(" ".join(flags).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / (f"{lib}-{digest}.so" if variant is None else
                        f"{lib}-{variant}-{digest}.so")


def _start(key: str, verbose: bool, nice: int = 0) -> tuple[subprocess.Popen, Path, Path]:
    """Start nvcc for ``key`` (``nice``: its scheduling niceness, above the
    caller's); its output goes to a log file beside the library (a pipe
    could fill while the caller waits on other builds)."""
    out = lib_path(key)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")  # builds may overlap
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{k}={v}" for k, v in sorted(defines(key).items())),
           *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC / SOURCES[split_key(key)[0]])]
    with open(tmp.with_suffix(".log"), "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, text=True,
                                preexec_fn=(lambda: os.nice(nice)) if nice else None)
    return proc, tmp, out


def _lock(key: str, wait: bool):
    """The open lock file of library key ``key``, held exclusively
    (``flock``), or None when ``wait`` is False and another build holds it.
    Every process and thread that builds ``key`` takes it first, so a
    library is compiled once however many ranks start together."""
    f = open(lib_path(key).with_suffix(".lock"), "w")
    try:
        fcntl.flock(f, fcntl.LOCK_EX | (0 if wait else fcntl.LOCK_NB))
    except BlockingIOError:
        f.close()
        return None
    return f


def build(names=None, verbose: bool = False, jobs: int | None = None,
          nice: int = 0) -> dict[str, dict]:
    """Compile the named library keys (default: every library's default
    variant) that are not built yet, one ``nvcc`` per key, at most ``jobs``
    at a time (default: all started together), each at niceness ``nice``
    (a build behind other work). Each build holds its key's file lock
    (:func:`_lock`): a key another process or thread is building is waited
    for, then taken as built. Returns ``{key: {"path", "seconds", "log"}}``
    (``seconds`` from the call's start to the build's end, or to the end of
    the wait); raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    names = list(SOURCES) if names is None else list(names)
    t0 = time.perf_counter()
    todo = [n for n in names if verbose or not lib_path(n).exists()]
    report = {n: {"path": str(lib_path(n)), "seconds": 0.0, "log": ""} for n in names}
    failed, running, waiting, locks = [], {}, [], {}
    jobs = jobs or max(len(todo), 1)

    def begin(n: str, lock) -> None:
        if lib_path(n).exists() and not verbose:  # built while this call waited
            lock.close()
            report[n]["seconds"] = time.perf_counter() - t0
            return
        locks[n] = lock
        running[n] = _start(n, verbose, nice)

    while todo or running or waiting:
        while todo and len(running) < jobs:
            n = todo.pop(0)
            lock = _lock(n, wait=False)
            if lock is None:  # another build holds it
                waiting.append(n)
            else:
                begin(n, lock)
        if not running and not todo and waiting:
            n = waiting.pop(0)
            begin(n, _lock(n, wait=True))
            continue
        n = next((k for k, (p, _, _) in running.items() if p.poll() is not None), None)
        if n is None:
            time.sleep(0.05)
            continue
        proc, tmp, out = running.pop(n)
        log_path = tmp.with_suffix(".log")
        log = log_path.read_text()
        log_path.unlink()
        report[n].update(seconds=time.perf_counter() - t0, log=log)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
        locks.pop(n).close()
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(key: str) -> ctypes.CDLL:
    """Library key ``key``'s shared library, built on first use; then its
    ``<lib>_init`` runs where it has one (a kernel's one-time set-up, such as
    its shared-memory opt-in). Raises if the first use comes while the
    current stream is capturing a CUDA graph: the build and the set-up would
    run inside the capture."""
    if key not in _LIBS:
        import torch

        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{key}: first loaded inside a CUDA-graph capture; launch it "
                               "once eagerly (the warm-up) before capturing")
        path = lib_path(key)
        if not path.exists():
            build([key])
        lib = ctypes.CDLL(str(path))
        init = getattr(lib, f"{split_key(key)[0]}_init", None)
        if init is not None:
            init.restype = ctypes.c_int
            rc = init()
            if rc != 0:
                raise RuntimeError(f"{key}: {split_key(key)[0]}_init failed (cudaError {rc})")
        _LIBS[key] = lib
    return _LIBS[key]


def entry(key: str, argtypes: list):
    """``(fn, err)``: the C entry point of key ``key`` (``name`` or
    ``name@variant``) with its argument types, and its library's error-string
    function; built and bound on first use."""
    if key not in _ENTRIES:
        name, variant = split_key(key)
        lib_name = ENTRY_LIB.get(name, name)
        lib = load(variant_key(lib_name, variant))
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        err = getattr(lib, f"{lib_name}_error")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        _ENTRIES[key] = (fn, err)
    return _ENTRIES[key]


def kernel_tiles(lib_key: str) -> tuple[int, ...]:
    """What library key ``lib_key``'s built library reports from its
    ``<lib>_tiles`` function."""
    lib_name = split_key(lib_key)[0]
    out = [ctypes.c_int() for _ in range(TILES[lib_key][0])]
    fn = getattr(load(lib_key), f"{lib_name}_tiles")
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int)] * len(out), ctypes.c_int
    fn(*map(ctypes.byref, out))
    return tuple(o.value for o in out)


def check_tiles(key: str) -> None:
    """Raise if the library of entry key ``key`` reports other tile sizes
    than ``TILES`` holds for it (read once per library key)."""
    name, variant = split_key(key)
    lib_name = ENTRY_LIB.get(name, name)
    lib_key = variant_key(lib_name, variant)
    if lib_key in TILES and lib_key not in _TILES_CHECKED:
        want = TILES[lib_key][1]
        got = kernel_tiles(lib_key)[:len(want)]
        if got != want:
            raise RuntimeError(f"{SOURCES[lib_name]} tiles {got} != {want}, the sizes the "
                               f"launching module assumes ({lib_key})")
        _TILES_CHECKED.add(lib_key)


def launch(name: str, argtypes: list, device, *args, variant: str | None = None) -> None:
    """Launch entry point ``name`` of ``variant`` (None: the default) on
    ``device``'s current stream (the stream is passed as the last argument)
    after :func:`check_tiles`; raise if the launch failed, else count it."""
    import torch

    key = variant_key(name, variant)
    check_tiles(key)
    fn, err = entry(key, argtypes)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{key} launch failed: {err(rc).decode()} (cudaError {rc})")
    LAUNCHES[name] += 1
    VARIANT_LAUNCHES[key] = VARIANT_LAUNCHES.get(key, 0) + 1
