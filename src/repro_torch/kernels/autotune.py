"""Kernel autotune tables (port of ``repro/kernels/autotune.py``): best-known
tile configs per (kernel, shape, dtype, backend).

A committed JSON table maps ``kernel/shape/dtype/backend`` keys to the
best-known config, a sweep harness refreshes it, and the call sites
(:func:`tuned_model_config` for the ModelConfig attention knobs,
:mod:`repro_torch.kernels.ops` and ``core/wire.py`` for the per-call kernel
knobs) consult it by default: a missing table, a missing entry, or
``configure(enabled=False)`` (the train CLI's ``--autotune off``) give the
default config, exactly as before the table.

**The bitwise-inert contract.** A candidate is eligible only if its output
is bit for bit the default config's on the swept shape (:func:`_sweep`), so
the table changes scheduling, never arithmetic.

**Backends.** The backend is the device a call runs on, passed explicitly
(:func:`_backend`): ``"cpu"`` or ``"cuda"``; a lookup given none is the
CPU's. The ``cpu`` entries are the reference's own, with its key layout and
configs (``attention``: ``attn_block_q`` / ``attn_block_kv`` /
``blockwise_threshold`` of the plain blockwise attention; ``quantize``:
``block_rows``; ``ns``: ``block``): the committed table carries the config of
each of the reference's 14 CPU entries unchanged, so the CPU lookups equal
the reference's (the port's plain CPU versions of the two kernels take no
tile, so only the attention knobs act there). The ``cuda`` entries name the
Hopper kernels' own build knobs, each config a candidate of the kernel's
fixed grid, built as its own library (``kernels/_build.py`` variants):

* ``ns/LxMxN/<dtype>/cuda``: the momentum stack ``[L, m, n]`` one
  Newton–Schulz launch covers (the grid's fill of the card's 132 SMs
  depends on L), config ``{"tile", "bk", "ty", "tx"}`` of
  ``matmul.TILE_CANDIDATES`` (block tile, K step, thread grid), used by all
  three products of each iteration;
* ``quantize/RxCxB/<dtype>/cuda``: ``(rows, cols, bits)``, config
  ``{"threads", "unroll", "long_blocks"}`` of ``quantize.TILE_CANDIDATES``,
  used by the full and the codes-only launches and, under the reference's
  wire key (bits 4), by ``dequantize``.

The ``cuda`` suite holds no attention shapes: the flash kernels ignore
``attn_block_q`` / ``attn_block_kv`` (their bf16 sweeps tile by ``wgmma``'s
64 rows), and their kv tile fixes the online softmax's order, so no kv
candidate could pass the gate. :func:`sweep_attention` and
:func:`tuned_model_config` keep the reference's semantics for the CPU and for
``attn_impl='xla'``.

Refresh the card's entries with::

    PYTHONPATH=src python -m repro_torch.kernels.autotune --suite h100 \\
        --out src/repro_torch/kernels/autotune_table.json
"""
from __future__ import annotations

import json
import os
from contextlib import contextmanager
from contextvars import ContextVar
from functools import lru_cache

DEFAULT_TABLE_PATH = os.path.join(os.path.dirname(__file__), "autotune_table.json")

# The reference's candidate grids for the CPU sweeps (clamped to the shape
# where needed); the card's are matmul.TILE_CANDIDATES and
# quantize.TILE_CANDIDATES.
ATTN_BLOCK_Q_CANDIDATES = (32, 64, 128, 256, 512)
ATTN_BLOCK_KV_CANDIDATES = (64, 128, 256, 512, 1024)
QUANTIZE_BLOCK_ROWS_CANDIDATES = (4, 8, 16, 32, 64)
NS_BLOCK_CANDIDATES = (32, 64, 128, 256)


def autotune_key(kernel: str, shape: tuple, dtype: str, backend: str) -> str:
    """Canonical table key: ``kernel/shape/dtype/backend``, the shape's
    integer dims joined by 'x' (numpy ints as Python ints)."""
    dims = "x".join(str(int(d)) for d in shape)
    return f"{kernel}/{dims}/{dtype}/{backend}"


def _backend(device=None) -> str:
    """``"cuda"`` for a CUDA device, ``"cpu"`` for anything else or None."""
    if device is None:
        return "cpu"
    import torch

    return "cuda" if torch.device(device).type == "cuda" else "cpu"


def dtype_name(dtype) -> str:
    """``torch.float32`` or ``"float32"`` -> ``"float32"`` (the key's dtype)."""
    return str(dtype).removeprefix("torch.")


class AutotuneTable:
    """In-memory view of one autotune JSON table."""

    def __init__(self, entries: dict[str, dict] | None = None, path: str | None = None):
        self.entries = dict(entries or {})
        self.path = path

    @classmethod
    def load(cls, path: str | None = None) -> "AutotuneTable":
        path = path or DEFAULT_TABLE_PATH
        entries: dict[str, dict] = {}
        if os.path.exists(path):
            with open(path) as f:
                entries = json.load(f)
        return cls(entries, path=path)

    def lookup(self, kernel: str, shape: tuple, dtype: str,
               backend: str | None = None) -> dict | None:
        """Best-known config dict for the key, or None (caller's default)."""
        ent = self.entries.get(autotune_key(kernel, shape, dtype, backend or _backend()))
        return None if ent is None else dict(ent["config"])

    def record(self, kernel: str, shape: tuple, dtype: str, backend: str,
               config: dict, evidence: dict | None = None) -> str:
        key = autotune_key(kernel, shape, dtype, backend)
        self.entries[key] = {"config": config, "evidence": evidence or {}}
        return key

    def save(self, path: str | None = None) -> str:
        path = path or self.path or DEFAULT_TABLE_PATH
        with open(path, "w") as f:
            json.dump(self.entries, f, indent=1, sort_keys=True)
            f.write("\n")
        return path


@lru_cache(maxsize=8)
def _cached_table(path: str) -> AutotuneTable:
    return AutotuneTable.load(path)


# (enabled, table_path): the process default consults the committed table;
# a ContextVar so tests and the sweep itself can scope overrides
_active: ContextVar[tuple[bool, str | None]] = ContextVar("autotune_active",
                                                          default=(True, None))


def configure(enabled: bool = True, table_path: str | None = None) -> None:
    """Set the process-wide autotune routing (the CLI --autotune flags)."""
    _active.set((enabled, table_path))
    active_table.cache_clear()


@contextmanager
def autotune_scope(enabled: bool = True, table_path: str | None = None):
    """Scoped override of the active table (tests / sweep verification)."""
    tok = _active.set((enabled, table_path))
    active_table.cache_clear()
    try:
        yield
    finally:
        _active.reset(tok)
        active_table.cache_clear()


@lru_cache(maxsize=1)
def _active_cached(enabled: bool, path: str | None) -> AutotuneTable | None:
    if not enabled:
        return None
    return _cached_table(path or DEFAULT_TABLE_PATH)


def active_table() -> AutotuneTable | None:
    """The table the call sites consult, or None when autotune is off."""
    enabled, path = _active.get()
    return _active_cached(enabled, path)


active_table.cache_clear = _active_cached.cache_clear  # type: ignore[attr-defined]


# ---------------------------------------------------------------------------
# Call-site lookups (each returns the caller's default on any miss)
# ---------------------------------------------------------------------------


def attention_config(seq_len: int, n_heads: int, n_kv_heads: int, head_dim: int,
                     dtype: str, backend: str | None = None) -> dict:
    """Tuned ModelConfig attention knobs for one shape, or {} on miss."""
    table = active_table()
    if table is None or not seq_len:
        return {}
    cfg = table.lookup("attention", (seq_len, n_heads, n_kv_heads, head_dim), dtype, backend)
    return cfg or {}


def _knob(cfg: dict | None, name: str):
    """An entry's config as its call site takes it: the reference's int knob
    ``name`` for a reference-layout entry, else the kernel's build knobs."""
    if cfg is None:
        return None
    return int(cfg[name]) if name in cfg else cfg


def quantize_block_rows(m: int, n: int, bits: int, dtype: str,
                        backend: str | None = None) -> int | dict | None:
    """The ``quantize`` entry of ``(m, n, bits)``: ``block_rows`` (an int)
    for a ``cpu`` entry, the kernel's ``{"threads", "unroll",
    "long_blocks"}`` for a ``cuda`` one; None on a miss or when off."""
    table = active_table()
    if table is None:
        return None
    return _knob(table.lookup("quantize", (m, n, bits), dtype, backend), "block_rows")


def ns_block(m: int, n: int, dtype: str, backend: str | None = None, *,
             stack: int | None = None) -> int | dict | None:
    """The ``ns`` entry of one momentum shape: ``block`` (an int) for a
    ``cpu`` entry, keyed ``(m, n)`` as the reference keys it; the kernel's
    ``{"tile", "bk", "ty", "tx"}`` for a ``cuda`` one, keyed by the whole
    stack ``(stack, m, n)`` that one launch covers. None on a miss or when
    off."""
    table = active_table()
    if table is None:
        return None
    shape = (m, n) if stack is None else (stack, m, n)
    return _knob(table.lookup("ns", shape, dtype, backend), "block")


_ATTN_KNOBS = ("attn_block_q", "attn_block_kv", "blockwise_threshold")


def tuned_model_config(cfg, seq_len: int | None = None, backend: str | None = None):
    """ModelConfig with the table's attention knobs applied (fallback: cfg).

    The committed constants (``attn_block_q=512`` etc.) remain the defaults;
    only knobs present in the matching table entry are replaced. Entries are
    recorded under the (seq_len, n_heads, n_kv_heads, head_dim) shape key in
    the model's compute dtype."""
    S = int(seq_len or cfg.max_seq_len or 0)
    tuned = attention_config(S, cfg.n_heads, cfg.n_kv_heads or cfg.n_heads, cfg.hd,
                             dtype_name(cfg.compute_dtype), backend)
    tuned = {k: v for k, v in tuned.items() if k in _ATTN_KNOBS}
    return cfg.replace(**tuned) if tuned else cfg


def autotune_evidence(cfg, seq_len: int | None = None, backend: str | None = None) -> dict:
    """Evidence block for a run's records: what the table resolved."""
    enabled, path = _active.get()
    table = active_table()
    tuned = tuned_model_config(cfg, seq_len, backend) if table is not None else cfg
    hits = {k: getattr(tuned, k) for k in _ATTN_KNOBS if getattr(tuned, k) != getattr(cfg, k)}
    return {
        "enabled": enabled,
        "table": (path or "builtin") if enabled else None,
        "entries": 0 if table is None else len(table.entries),
        "tuned": hits,  # {} = every knob fell back to the committed constants
    }


# ---------------------------------------------------------------------------
# Sweep harness
# ---------------------------------------------------------------------------


def _time_best(fn, reps: int = 3, device=None, warmup: bool = True) -> float:
    """Best-of-reps seconds of ``fn()`` (one warm-up run first unless
    ``warmup=False``). On the card each run is bracketed by CUDA events after
    a synchronize; on the CPU, by the wall clock."""
    import time

    import torch

    cuda = _backend(device) == "cuda"
    if warmup:
        fn()
    best = float("inf")
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize(device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
    return best


def _leaves(x) -> list:
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


def _bitwise_equal(a, b) -> bool:
    """Every tensor of ``a`` equals ``b``'s bit for bit: the same dtype,
    shape and values (``torch.equal``)."""
    import torch

    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def _sweep(run, default_config: dict, candidates: list[dict], reps: int = 3,
           device=None) -> tuple[dict, dict]:
    """Generic sweep: time every candidate, keep the fastest whose output is
    BITWISE identical to the default config's output. Returns
    ``(best_config, evidence)`` — best_config == default_config when nothing
    inert beats it. The default is warmed up once more before its timing (the
    first calls of a process pay set-up); a candidate's checked run is its
    warm-up."""
    ref = run(**default_config)
    t_default = _time_best(lambda: run(**default_config), reps=reps, device=device)
    best, t_best = dict(default_config), t_default
    rejected = 0
    for cand in candidates:
        if cand == default_config:
            continue
        out = run(**cand)
        if not _bitwise_equal(ref, out):
            rejected += 1  # not tiling-pure on this shape: ineligible
            continue
        del out
        t = _time_best(lambda: run(**cand), reps=reps, device=device, warmup=False)
        if t < t_best:
            best, t_best = dict(cand), t
    evidence = {
        "default_s": t_default, "best_s": t_best,
        "speedup": (t_default / t_best) if t_best > 0 else 1.0,
        "candidates": len(candidates), "rejected_not_bitwise": rejected,
        "verified_bitwise": True,
    }
    return best, evidence


def card_evidence(device) -> dict:
    """The card a ``cuda`` entry was swept on: its name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit`` gives them."""
    import torch

    index = torch.device(device).index or 0
    name, limit = _smi_card(index)
    return {"device": name or torch.cuda.get_device_name(index),
            "power_limit": limit or "not read"}


@lru_cache(maxsize=None)
def _smi_card(index: int) -> tuple[str, str]:
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    name, _, limit = (smi[index] if index < len(smi) else ",").partition(",")
    return name.strip(), limit.strip()


def build_candidates(*libs: str) -> None:
    """Build every candidate variant of the named kernel libraries that is
    not built yet, one nvcc a CPU core at a time (the sweep's first use)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import matmul, quantize  # noqa: F401 (they register the variants)

    keys = [_build.variant_key(lib, v) for lib in libs for v in sorted(_build.VARIANTS[lib])]
    _build.build([k for k in keys if not _build.lib_path(k).exists()], jobs=os.cpu_count())


def _record(table: AutotuneTable, kernel: str, shape: tuple, dtype: str, device,
            best: dict, ev: dict, extra: dict | None = None) -> str:
    """Record a sweep's result; a ``cuda`` entry's evidence adds the card,
    its power limit and ``extra`` (the sweep's own measures)."""
    if _backend(device) == "cuda":
        ev = {**ev, **card_evidence(device), **(extra or {})}
    return table.record(kernel, shape, dtype, _backend(device), best, ev)


def sweep_attention(table: AutotuneTable, seq_len: int, n_heads: int, n_kv_heads: int,
                    head_dim: int, *, batch: int = 2, attn_impl: str = "xla",
                    dtype: str = "float32", reps: int = 3, seed: int = 0,
                    device="cpu") -> str:
    """Sweep the ModelConfig attention knobs for one (S, H, KV, hd) shape
    (the plain path's blockwise attention; the flash kernels take none)."""
    import torch

    from repro_torch.kernels.flash_attention import clamp_block
    from repro_torch.models.attention import attend, init_attention
    from repro_torch.models.common import ModelConfig

    base = ModelConfig(name=f"autotune-s{seq_len}", vocab=64, d_model=n_heads * head_dim,
                       n_layers=1, n_heads=n_heads, n_kv_heads=n_kv_heads,
                       max_seq_len=seq_len, attn_impl=attn_impl, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    p = init_attention(gen, base, device)
    x = torch.randn((batch, seq_len, base.d_model), generator=gen, device=device,
                    dtype=getattr(torch, dtype))
    positions = torch.arange(seq_len, device=device)

    def run(attn_block_q, attn_block_kv, blockwise_threshold):
        cfg = base.replace(attn_block_q=clamp_block(attn_block_q, seq_len),
                           attn_block_kv=clamp_block(attn_block_kv, seq_len),
                           blockwise_threshold=blockwise_threshold)
        with torch.no_grad():
            return attend(p, cfg, x, positions)

    default = {"attn_block_q": clamp_block(512, seq_len),
               "attn_block_kv": clamp_block(1024, seq_len), "blockwise_threshold": 4096}
    cands = [{"attn_block_q": clamp_block(bq, seq_len),
              "attn_block_kv": clamp_block(bkv, seq_len), "blockwise_threshold": 4096}
             for bq in ATTN_BLOCK_Q_CANDIDATES for bkv in ATTN_BLOCK_KV_CANDIDATES]
    best, ev = _sweep(run, default, cands, reps=reps, device=device)
    return _record(table, "attention", (seq_len, n_heads, n_kv_heads, head_dim), dtype,
                   device, best, ev)


def sweep_quantize(table: AutotuneTable, m: int, n: int, *, bits: int = 4,
                   dtype: str = "float32", reps: int = 3, seed: int = 0,
                   device="cpu") -> str:
    """Sweep the row-wise quantizer for one [m, n] wire shape: on the card
    the kernel's build variants (the full function, whose deq, codes, lo and
    scale the gate compares), on the CPU the reference's ``block_rows``."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import quantize as q

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, n), generator=gen, device=device, dtype=getattr(torch, dtype))

    def run(**knobs):
        block_rows = knobs.get("block_rows", knobs or None)
        return ops.quantize_rowwise(x, bits=bits, block_rows=block_rows)

    if _backend(device) == "cuda":
        build_candidates("quantize")
        default, cands = dict(q.DEFAULT_TILE), [dict(c) for c in q.TILE_CANDIDATES]
    else:
        default = {"block_rows": 8}
        cands = [{"block_rows": b} for b in QUANTIZE_BLOCK_ROWS_CANDIDATES if b <= m]
    best, ev = _sweep(run, default, cands, reps=reps, device=device)
    return _record(table, "quantize", (m, n, bits), dtype, device, best, ev, {"reps": reps})


def ns_bound_s(L: int, m: int, n: int, iters: int = 5) -> float:
    """The least seconds one Newton–Schulz of an ``[L, m, n]`` stack could
    take on one H100: its products' distinct entries (the two symmetric
    ones count one triangle) at 2 flops each over the fp32 peak."""
    from repro_torch.roofline.analysis import PEAK_FP32_FLOPS

    m, n = min(m, n), max(m, n)
    tri = m * (m + 1) // 2
    flops = iters * 2.0 * L * (tri * n + tri * m + m * m * n)
    return flops / PEAK_FP32_FLOPS


def ns_library(g, iters: int = 5, eps: float = 1e-7):
    """Newton–Schulz in fp32 through ``torch.baddbmm`` (the library yardstick:
    the same iteration, each product one library call)."""
    import torch

    from repro_torch.optim.muon import NS_COEFFS

    a, b, c = NS_COEFFS
    *batch, m, n = g.shape
    x = g.reshape((-1, m, n)).float()
    if m > n:
        x = x.mT
    x = x / (torch.sqrt(torch.sum(x * x, dim=(-2, -1), keepdim=True)) + eps)
    for _ in range(iters):
        A = torch.bmm(x, x.mT)
        B = torch.baddbmm(A, A, A, beta=b, alpha=c)
        x = torch.baddbmm(x, B, x, beta=a)
    if m > n:
        x = x.mT
    return x.reshape(g.shape).to(g.dtype)


def sweep_ns(table: AutotuneTable, *shape: int, dtype: str = "float32", reps: int = 3,
             seed: int = 0, device="cpu", iters: int = 5) -> str:
    """Sweep the Newton–Schulz matmul for one momentum shape: on the card
    the key is the stack ``(L, m, n)`` (a 2-D ``(m, n)`` is a stack of 1)
    and the candidates the kernel's build variants, timed over one
    ``ns_orthogonalize`` of ``iters`` iterations (the evidence adds its
    bound and ``torch.baddbmm``'s time); on the CPU ``shape`` is the
    reference's ``(m, n)`` and the candidates its ``block``."""
    import torch

    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops

    gen = torch.Generator(device=device).manual_seed(seed)
    g = torch.randn(shape, generator=gen, device=device, dtype=getattr(torch, dtype))

    def run(**knobs):
        return ops.ns_orthogonalize(g, iters=iters, block=knobs.get("block", knobs or None))

    extra = {"iters": iters, "reps": reps}
    if _backend(device) == "cuda":
        shape = shape if len(shape) == 3 else (1, *shape)
        g = g.reshape(shape)
        build_candidates("matmul_epilogue")
        default, cands = dict(mm.DEFAULT_TILE), [dict(c) for c in mm.TILE_CANDIDATES]
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            extra.update(bound_s=ns_bound_s(*shape, iters=iters), baddbmm_s=_time_best(
                lambda: ns_library(g, iters=iters), reps=reps, device=device))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
    else:
        default, cands = {"block": 128}, [{"block": b} for b in NS_BLOCK_CANDIDATES]
    best, ev = _sweep(run, default, cands, reps=reps, device=device)
    return _record(table, "ns", shape, dtype, device, best, ev, extra)


# Shapes per suite. 'reduced' and 'extended' are the reference's (the CPU
# parity path and mid-size shapes; their ns shapes (m, n)). 'h100' holds the
# main-path shapes chip_smoke.py runs on the card: every Muon leaf stack
# (L, m, n) of smollm-135m, paper-416m, deepseek-moe-16b at depth 1,
# mamba2-370m, zamba2-2.7b at one superblock and whisper-large-v3, and the
# compressed path's quantize calls (global Q1 of smollm's embed at 2 bits,
# row-wise Q1 of its w_in at 4 bits and of its embed at 2 bits); no
# attention shapes (module docstring).
SWEEP_SUITES: dict[str, dict[str, list[tuple]]] = {
    "reduced": {
        "attention": [(64, 4, 1, 64), (128, 4, 1, 64), (128, 4, 4, 64)],
        "quantize": [(512, 64, 4), (512, 256, 4), (512, 512, 4),
                     (1024, 64, 4), (1024, 256, 4), (1024, 512, 4),
                     (2048, 256, 4)],
        "ns": [(256, 64), (256, 256), (256, 512), (512, 256)],
    },
    "extended": {
        "attention": [(256, 4, 4, 64), (256, 8, 8, 32)],
        "quantize": [(1024, 1024, 4), (4096, 512, 4)],
        "ns": [(1024, 256), (1024, 1024)],
    },
    "h100": {
        "attention": [],
        "quantize": [(2, 28311552, 2), (34560, 1536, 4), (98304, 576, 2)],
        "ns": [
            # smollm-135m
            (30, 576, 192), (30, 576, 576), (30, 576, 1536), (30, 1536, 576),
            # paper-416m
            (12, 1024, 1024), (12, 1024, 2816), (12, 2816, 1024),
            # deepseek-moe-16b at depth 1: attention, the expert bank, the
            # router, the shared expert
            (1, 2048, 2048), (64, 2048, 1408), (64, 1408, 2048), (1, 2048, 64),
            (1, 2048, 2816), (1, 2816, 2048),
            # mamba2-370m
            (48, 1024, 4384), (48, 2048, 1024),
            # zamba2-2.7b at one superblock, and its shared block
            (6, 2560, 10448), (6, 5120, 2560), (1, 2560, 2560), (1, 2560, 10240),
            (1, 10240, 2560),
            # whisper-large-v3
            (32, 1280, 1280), (32, 1280, 5120), (32, 5120, 1280), (1, 1280, 1280),
        ],
    },
}


def _print_entry(table: AutotuneTable, key: str) -> None:
    ent = table.entries[key]
    ev = ent["evidence"]
    line = (f"{key}: {ent['config']} default {ev['default_s'] * 1e3:.4f} ms, best "
            f"{ev['best_s'] * 1e3:.4f} ms (x{ev['speedup']:.3f})")
    if "bound_s" in ev:
        line += f", bound {ev['bound_s'] * 1e3:.4f} ms, baddbmm {ev['baddbmm_s'] * 1e3:.4f} ms"
    print(line, flush=True)


def run_sweeps(suite: str = "reduced", out: str | None = None, reps: int = 3,
               verbose: bool = True, device="cuda", ns_iters: int = 5) -> AutotuneTable:
    """Run every sweep in a suite on ``device`` and merge the results into
    the table at ``out`` (``ns_iters``: the Newton–Schulz iterations a
    timed run of the ns sweep; the call sites run 5)."""
    shapes = SWEEP_SUITES[suite]
    table = AutotuneTable.load(out)
    if _backend(device) == "cuda":
        build_candidates("matmul_epilogue", "quantize")
    sweeps = [lambda s: sweep_attention(table, *s, reps=reps, device=device),
              lambda s: sweep_quantize(table, s[0], s[1], bits=s[2], reps=reps, device=device),
              lambda s: sweep_ns(table, *s, reps=reps, device=device, iters=ns_iters)]
    with autotune_scope(enabled=False):  # sweeps must measure raw defaults
        for kernel, sweep in zip(("attention", "quantize", "ns"), sweeps):
            for s in shapes[kernel]:
                key = sweep(s)
                if verbose:
                    _print_entry(table, key)
    table.save(out)
    return table


def build_parser():
    import argparse

    ap = argparse.ArgumentParser(
        description="sweep the kernels' tile knobs and refresh the committed autotune table")
    ap.add_argument("--suite", default="reduced", choices=list(SWEEP_SUITES),
                    help="which shape set to sweep ('h100': the card's)")
    ap.add_argument("--out", default=DEFAULT_TABLE_PATH,
                    help="table JSON to merge results into")
    ap.add_argument("--reps", type=int, default=3,
                    help="timing repetitions per candidate (best-of)")
    ap.add_argument("--device", default="cuda", help="'cuda' (the card) or 'cpu'")
    return ap


def main() -> None:
    args = build_parser().parse_args()
    table = run_sweeps(args.suite, out=args.out, reps=args.reps, device=args.device)
    print(f"wrote {len(table.entries)} entries to {args.out}")


if __name__ == "__main__":
    main()
