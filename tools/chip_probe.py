#!/usr/bin/env python3
"""Diagnostics on the card beside ``chip_smoke.py``.

    python3 tools/chip_probe.py [--parent DIR] [--fp64] [--faults]

Runs ``chip_smoke.py``'s phases 1 and 2 (the card, every kernel built with
ptxas's report), then each diagnostic asked for; each runs even when an
earlier one failed, and the probe exits nonzero if any did. Needs one card.
To run groups of the script's own phases alone, use
``python3 chip_smoke.py --only 17,19``.

``--parent DIR`` (the parent commit unpacked with ``git archive`` into a
directory that ``.gitignore`` lists, e.g. ``build/parent``) also builds the
parent's flash and paged-decode libraries and compares, kernel by kernel,
ptxas's registers, shared memory and spills at hd 64, 80 and 128 (the fp32
sweeps' template now names their positions a block), then times the bf16
sweeps at hd 64, 80 and 128 and paged_decode at hd 64 and 128 in turns
(parent, tree, tree, parent). It does the same for the default variants of
``matmul_epilogue`` and ``quantize`` (``TILED_LIBS``: ptxas of every
kernel function, then the timed calls of PERF.md section 6 tables a and b:
X Xᵀ and B X + a·X at smollm-135m's and paper-416m's w_in stacks, quantize
full and codes-only at the global and row-wise Q1 shapes).

``--fp64`` holds the fp32 backward sweeps against a float64 recomputation
from the same inputs (``FP64_CASES``: two rows of kv heads at each case's S
and G) under 1e-5 of the largest float64 entry, with their plain versions'
errors beside them. A dk entry sums S x G rows, so this reads how the error
of the two fp32 summation orders grows with S G. Then it reads the same
against float64 with a fault planted in the kernel's dk, to
show where 1e-5 stands between sound summation orders and a fault.

``--faults`` reads 18f's gradients again with a fault planted in the flash
backward (``planted``), against the same plain-path gradients, to show
where ``chip_smoke.VLM_ATTN_TOL`` stands between a sound run and a faulty
one. It only reads: 18f's own bound on the attention leaves is lifted.
"""
from __future__ import annotations

import math
import re
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (adds src/ to the path)

# the bf16 training shapes of the parent comparison: (B x KV, S, G) per hd
PARENT_SHAPES = {64: (24, 1024, 3), 80: (32, 2048, 1), 128: (32, 2048, 1)}
# the paged decode shapes of the parent comparison: (KV, G) per hd
PARENT_PAGED = {64: (3, 3), 128: (8, 1)}
# the fp32 sweeps' positions a block at G <= 8, which the tree's kernels
# take as a template argument: the parent's name -> the tree's
FP32_RENAMES = {"flash_fwd_kernel<64>": "flash_fwd_kernel<64,32>",
                "flash_fwd_kernel<80>": "flash_fwd_kernel<80,16>",
                "flash_fwd_kernel<128>": "flash_fwd_kernel<128,16>",
                "flash_dq_fp32_kernel<64>": "flash_dq_fp32_kernel<64,16>",
                "flash_dq_fp32_kernel<80>": "flash_dq_fp32_kernel<80,16>",
                "flash_dq_fp32_kernel<128>": "flash_dq_fp32_kernel<128,8>"}
LIBS = ["flash_fwd", "flash_bwd", "paged_decode"]
# the libraries whose tiles are build variants: their default variants
TILED_LIBS = ["matmul_epilogue", "quantize"]
# --parent: (name, stack of X, symmetric X X^T first then B X + a X) of
# PERF.md section 6 tables a and b; quantize's (rows, cols, bits)
PARENT_MATMUL = [("smollm-135m w_in", (30, 576, 1536)), ("paper-416m w_in", (12, 1024, 2816))]
PARENT_QUANT = [("global Q1 of embed", 2, 28_311_552, 2), ("row-wise Q1 of w_in", 34_560, 1536, 4)]
# --fp64: (hd, S, G) of the fp32 backward cases read against float64
FP64_CASES = [(64, 1024, 3), (112, 2048, 8), (128, 1024, 12), (128, 2048, 12)]


def use_csrc(_build, csrc: Path, check_tiles: bool) -> None:
    """Point the build at ``csrc`` and forget what was built and bound; a
    parent's libraries report the parent's tiles, so their check is skipped."""
    _build.CSRC = csrc
    _build._LIBS.clear()
    _build._ENTRIES.clear()
    _build._TILES_CHECKED.clear()
    if not check_tiles:
        _build._TILES_CHECKED.update(LIBS + TILED_LIBS)


def ptxas_of(_build, libs: list = LIBS) -> dict:
    report = _build.build(names=libs, verbose=True)
    out = {}
    for r in report.values():
        out.update(cs.ptxas_report(r["log"]))
    return out


def paged_inputs(torch, hd: int, KV: int, G: int, gen):
    """chip_smoke's 3b main-path case: 16 slots, lengths 512..584, 37-page table."""
    rng = torch.Generator().manual_seed(2)
    B, ps, table_w, n_pages = 16, 16, 37, 1024
    lengths = torch.randint(512, 585, (B,), generator=rng, dtype=torch.int32)
    table = torch.zeros((B, table_w), dtype=torch.int32)
    free = (torch.randperm(n_pages - 1, generator=rng) + 1).tolist()
    for b in range(B):
        n = -(-int(lengths[b]) // ps)
        table[b, :n] = torch.tensor([free.pop() for _ in range(n)], dtype=torch.int32)
    q = torch.randn((B, KV, G, hd), generator=gen, device="cuda").bfloat16()
    kp = torch.randn((n_pages, ps, KV, hd), generator=gen, device="cuda").bfloat16()
    vp = torch.randn((n_pages, ps, KV, hd), generator=gen, device="cuda").bfloat16()
    return q, kp, vp, table.cuda(), lengths.cuda()


def compare_parent(torch, fa, _build, parent: Path) -> None:
    """ptxas of the parent's flash and paged-decode kernels beside this
    tree's at hd 64, 80 and 128, then their times in turns."""
    tree_csrc = _build.CSRC
    sides = {"tree": tree_csrc, "parent": parent / "src" / "repro_torch" / "kernels" / "csrc"}
    reports = {}
    for side, csrc in sides.items():
        use_csrc(_build, csrc, side == "tree")
        reports[side] = ptxas_of(_build)
    bad = []
    for fn in sorted(reports["parent"]):
        mine = FP32_RENAMES.get(fn, fn)
        a, b = reports["parent"][fn], reports["tree"].get(mine)
        # the regs / smem / spills figures, without ptxas's wording around them
        same = re.findall(r"\d+", a or "") == re.findall(r"\d+", b or "")
        print(f"  {fn}: parent {a}; tree ({mine}) {b}{'' if same else '  <-- differs'}")
        if not same:
            bad.append(fn)
    new = sorted(set(reports["tree"]) - {FP32_RENAMES.get(f, f) for f in reports["parent"]})
    print(f"  new in the tree: {new}")
    gen = torch.Generator(device="cuda").manual_seed(41)
    times = {}
    for hd, (BKV, S, G) in PARENT_SHAPES.items():
        q, do = (torch.randn((BKV, S, G, hd), generator=gen, device="cuda").bfloat16()
                 for _ in "qd")
        k, v = (torch.randn((BKV, S, hd), generator=gen, device="cuda").bfloat16() for _ in "kv")
        kw = dict(causal=True, window=0, scale=1.0 / math.sqrt(hd))
        for side in ("parent", "tree", "tree", "parent"):
            use_csrc(_build, sides[side], side == "tree")
            o, lse = fa._fwd_cuda(q, k, v, **kw)
            dl = torch.sum(do.float() * o.float(), dim=-1)
            args = (q, k, v, do, lse, dl)
            for name, fn in (("flash_fwd", lambda: fa._fwd_cuda(q, k, v, **kw)),
                             ("flash_dq", lambda: fa._dq_cuda(*args, **kw)),
                             ("flash_dkv", lambda: fa._dkv_cuda(*args, **kw))):
                times.setdefault((hd, name, side), []).append(cs.time_ms(torch, fn))
    for hd, (KV, G) in PARENT_PAGED.items():
        q, kp, vp, table, lengths = paged_inputs(torch, hd, KV, G, gen)
        for side in ("parent", "tree", "tree", "parent"):
            use_csrc(_build, sides[side], side == "tree")
            times.setdefault((hd, "paged_decode", side), []).append(cs.time_ms(
                torch, lambda: fa._paged_decode_cuda(q, kp, vp, table, lengths, window=0)))
    use_csrc(_build, tree_csrc, True)
    for hd, name, side in sorted(times):
        if side != "tree":
            continue
        p, t = times[(hd, name, "parent")], times[(hd, name, "tree")]
        print(f"  hd {hd} {name}: parent {[round(x, 4) for x in p]} ms, tree "
              f"{[round(x, 4) for x in t]} ms: tree / parent "
              f"{statistics.mean(t) / statistics.mean(p):.4f}")
    assert not bad, f"ptxas differs from the parent's: {bad}"


def compare_parent_tiled(torch, _build, parent: Path) -> None:
    """ptxas of the parent's matmul_epilogue and quantize beside this tree's
    default variants, function by function (the same names), then their
    times in turns at ``PARENT_MATMUL`` and ``PARENT_QUANT``."""
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import quantize as q
    from repro_torch.optim.muon import NS_COEFFS

    tree_csrc = _build.CSRC
    sides = {"tree": tree_csrc, "parent": parent / "src" / "repro_torch" / "kernels" / "csrc"}
    reports = {}
    for side, csrc in sides.items():
        use_csrc(_build, csrc, side == "tree")
        reports[side] = ptxas_of(_build, TILED_LIBS)
    bad = []
    for fn in sorted(set(reports["parent"]) | set(reports["tree"])):
        a, b = reports["parent"].get(fn), reports["tree"].get(fn)
        same = a is not None and re.findall(r"\d+", a) == re.findall(r"\d+", b or "")
        print(f"  {fn}: parent {a}; tree {b}{'' if same else '  <-- differs'}")
        if not same:
            bad.append(fn)
    na, nb, nc = NS_COEFFS
    gen = torch.Generator(device="cuda").manual_seed(12)
    calls = {}
    for tag, shape in PARENT_MATMUL:
        x = cs.normed(torch.randn(shape, generator=gen, device="cuda"))
        A = mm._matmul_plain(x, x.mT, None, alpha=1.0, beta=0.0, out_dtype=x.dtype)
        Bm = mm._matmul_plain((A + A.mT) / 2, A, A, alpha=nc, beta=nb, out_dtype=x.dtype)
        calls[f"X X^T {tag} {list(shape)} (symmetric)"] = (
            lambda x=x: mm._matmul_cuda(x, x.mT, None, alpha=1.0, beta=0.0, out_dtype=x.dtype,
                                        symmetric=True))
        calls[f"B X + a X {tag}"] = (
            lambda x=x, Bm=Bm: mm._matmul_cuda(Bm, x, x, alpha=1.0, beta=na, out_dtype=x.dtype))
    for tag, rows, cols, bits in PARENT_QUANT:
        xq = torch.randn((rows, cols), generator=gen, device="cuda")
        for form, deq in (("full", True), ("codes-only", False)):
            calls[f"quantize {form}, {tag} [{rows}, {cols}] {bits}-bit"] = (
                lambda xq=xq, bits=bits, deq=deq: q._quantize_cuda(xq, bits, with_deq=deq))
    times = {}
    for side in ("parent", "tree", "tree", "parent"):
        use_csrc(_build, sides[side], side == "tree")
        for name, fn in calls.items():
            times.setdefault((name, side), []).append(cs.time_ms(torch, fn))
    use_csrc(_build, tree_csrc, True)
    for name in calls:
        p, t = times[(name, "parent")], times[(name, "tree")]
        print(f"  {name}: parent {[round(v, 4) for v in p]} ms, tree {[round(v, 4) for v in t]} "
              f"ms: tree / parent {statistics.mean(t) / statistics.mean(p):.4f}")
    assert not bad, f"ptxas differs from the parent's: {bad}"


TILE = 64  # the flash kernels' key tile


def _drop_last_head(q, k, v, do, lse, dl):
    """The inputs with query head G - 1's do and dl zeroed: its share of dk,
    dv (and of dq) is then exactly zero, as if the G loop stopped at G - 1."""
    do, dl = do.clone(), dl.clone()
    do[:, :, -1] = 0
    dl[:, :, -1] = 0
    return q, k, v, do, lse, dl


def planted(fa) -> dict:
    """name -> (wrapper name in ``flash_attention``, its replacement)."""
    dkv, dq = fa._dkv_cuda, fa._dq_cuda

    def dkv_head(*args, **kw):
        return dkv(*_drop_last_head(*args), **kw)

    def dkv_last_tile(*args, **kw):
        dk, dv = dkv(*args, **kw)
        dk[:, -TILE:] = 0
        dv[:, -TILE:] = 0
        return dk, dv

    def dq_head(*args, **kw):
        dq_ = dq(*args, **kw)
        dq_[:, :, -1] = 0
        return dq_

    return {
        "dkv without query head G - 1": ("_dkv_cuda", dkv_head),
        "dk, dv zero on the last 64-key tile": ("_dkv_cuda", dkv_last_tile),
        "dq zero for query head G - 1": ("_dq_cuda", dq_head),
        # not a fault: the bf16 plain version in the kernel's place, the spread
        # of another sound implementation
        "flash_dkv swapped for its bf16 plain version": ("_dkv_cuda", fa._dkv_plain),
    }


def fault_readings(torch, fa):
    """18f's ``after_grads``: each planted fault's gradients against the
    plain path's, the attention leaves one by one and the whole tree."""
    def after_grads(model, params, batch, grads_p):
        print(f"[18f faults] the attention leaves' relative error against the plain path, "
              f"tol {cs.VLM_ATTN_TOL}")
        for name, (attr, fn) in planted(fa).items():
            orig = getattr(fa, attr)
            setattr(fa, attr, fn)
            try:
                loss, grads = cs.vlm_grads(torch, model, params, batch)
            finally:
                setattr(fa, attr, orig)
            rel, per_leaf = cs.grad_errors(grads, grads_p)
            del grads
            print(f"  {name}: " + ", ".join(f"{p.rsplit('/', 1)[1]} {per_leaf[p]:.3e}"
                                            for p in cs.VLM_ATTN_LEAVES)
                  + f"; whole tree {rel:.3e}; loss {loss.item():.5f}", flush=True)
            torch.cuda.empty_cache()

    return after_grads


def fp64_readings(torch, fa) -> None:
    """``FP64_CASES`` against float64, then the last one with the first key
    tile's dk (its largest entries, which every query row feeds) scaled by
    1 + 1e-4: a fault ten times the check's 1e-5, which must fail it."""
    cs.phase_fp32_bwd_fp64(torch, fa, FP64_CASES, "fp64")
    bwd = fa._bwd_cuda

    def planted_bwd(*args, **kw):
        dq, dk, dv = bwd(*args, **kw)
        dk[:, :TILE] *= 1 + 1e-4
        return dq, dk, dv

    fa._bwd_cuda = planted_bwd
    try:
        cs.phase_fp32_bwd_fp64(torch, fa, FP64_CASES[-1:], "fp64, planted")
    except AssertionError as e:  # the planted fault must fail the check
        print(f"  the planted fault fails the check: {e}")
    else:
        raise AssertionError("a planted dk fault passed the float64 check")
    finally:
        fa._bwd_cuda = bwd


def main() -> int:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul, outer_update, quantize  # noqa: F401 (their tiles)
    from repro_torch.models import build_model

    if not torch.cuda.is_available():
        raise SystemExit("chip_probe: needs a CUDA card")
    parent = Path(sys.argv[sys.argv.index("--parent") + 1]) if "--parent" in sys.argv else None
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card (nvidia-smi name, power.limit): {smi}")
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phases = [("2", lambda: cs.phase_build(_build))]
    if parent is not None:
        phases.append(("parent", lambda: compare_parent(torch, fa, _build, parent)))
        phases.append(("parent, tiled", lambda: compare_parent_tiled(torch, _build, parent)))
    if "--fp64" in sys.argv:
        phases.append(("fp64", lambda: fp64_readings(torch, fa)))
    if "--faults" in sys.argv:
        cs.VLM_ATTN_TOL = float("inf")
        phases.append(("faults", lambda: cs.phase_vlm(torch, get_config, build_model,
                                                      after_grads=fault_readings(torch, fa))))
    failed = []
    for name, run in phases:
        t = time.perf_counter()
        try:
            run()
        except Exception:  # report every phase, then fail
            traceback.print_exc()
            failed.append(name)
        print(f"-- phase {name}: {time.perf_counter() - t:.1f} s, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    print(f"chip_probe: {time.perf_counter() - t0:.1f} s; "
          + ("all phases passed" if not failed else f"FAILED phases: {failed}"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
