#!/usr/bin/env python3
"""A short first call on the card for the flash forward kernel.

    python3 tools/flash_fwd_probe.py [CSRC_DIR ...]

Builds ``csrc/flash_fwd.cu`` with ptxas's report, prints each kernel's
registers and spills and the count of tensor-core instructions in its SASS,
checks the bf16 sweep against its plain version (phase 3a's tolerances: o
2e-2, lse 1e-3) and run to run (bitwise) at ragged, G = 1 to 4, windowed and
non-causal shapes and at the serving and training shapes, checks the fp32
sweep (1e-5), then times the bf16 sweep at the serving shape [48, 512, 3,
64] and the training shape [24, 1024, 3, 64] (``chip_smoke.time_ms``)
beside SDPA's forward. Each further argument is a copy of ``csrc/`` (a
kernel variant) whose flash_fwd library is built, checked at the two shapes
and timed in turns with the tree's. Exits nonzero on a failed check. Needs
one card; ``chip_smoke.py`` is the full check.
"""
from __future__ import annotations

import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import ptxas_report, sass_counts, time_ms  # noqa: E402  (adds src/ to the path)

SHAPES = {"serving": (48, 512, 3), "training": (24, 1024, 3)}


def use_csrc(_build, csrc: Path) -> None:
    """Point the build at ``csrc`` and forget what was built and bound."""
    _build.CSRC = csrc
    _build._LIBS.clear()
    _build._ENTRIES.clear()
    _build._TILES_CHECKED.clear()


def inputs(torch, gen, BKV, S, G, dt=None):
    dt = dt or torch.bfloat16
    q = torch.randn((BKV, S, G, 64), generator=gen, device="cuda").to(dt)
    k, v = (torch.randn((BKV, S, 64), generator=gen, device="cuda").to(dt) for _ in "kv")
    return q, k, v


def check_case(torch, fa, q, k, v, causal, window) -> bool:
    kw = dict(causal=causal, window=window, scale=1.0 / math.sqrt(64))
    (o, lse), (o2, lse2) = fa._fwd_cuda(q, k, v, **kw), fa._fwd_cuda(q, k, v, **kw)
    po, plse = fa._fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    fp32 = q.dtype == torch.float32
    same = torch.equal(o, o2) and torch.equal(lse, lse2)
    eo = (o.float() - po.float()).abs().max().item()
    el = (lse - plse).abs().max().item()
    tol_o, tol_l = (1e-5, 1e-5) if fp32 else (2e-2, 1e-3)
    ok = same and eo <= tol_o and el <= tol_l
    print(f"  {str(q.dtype)[6:]} q{list(q.shape)} causal={causal} window={window}: o err "
          f"{eo:.3e} ({eo / tol_o:.3f} of tol), lse err {el:.3e} ({el / tol_l:.3f}), "
          f"bitwise={same}{'' if ok else '  FAILED'}", flush=True)
    return ok


def main() -> int:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_probe: needs a CUDA card")
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    trees = [("tree", _build.CSRC)] + [(Path(a).name, Path(a).resolve()) for a in sys.argv[1:]]
    gen = torch.Generator(device="cuda").manual_seed(1)
    ok = True
    for tag, csrc in trees:
        use_csrc(_build, csrc)
        report = _build.build(["flash_fwd"], verbose=True)["flash_fwd"]
        print(f"[{tag}] {csrc}")
        for fn, line in ptxas_report(report["log"]).items():
            print(f"  {fn}: {line}")
        for fn, ops in sass_counts(report["path"]).items():
            print(f"  {fn}: tensor-core instructions in SASS {ops}")
        print("  tiles (bq, bkv, rows, keys, smem):", _build.kernel_tiles("flash_fwd"), flush=True)
        cases = [(BKV, S, G, True, 0) for BKV, S, G in SHAPES.values()]
        if tag == "tree":
            cases = [(1, 64, 1, False, 0), (1, 64, 1, True, 0), (6, 77, 3, True, 0),
                     (4, 130, 1, True, 0), (2, 96, 4, False, 0), (6, 300, 3, True, 100),
                     (4, 77, 2, False, 20), (2, 130, 4, True, 37), (2, 1, 3, True, 0)] + cases
        for BKV, S, G, causal, window in cases:
            ok &= check_case(torch, fa, *inputs(torch, gen, BKV, S, G), causal, window)
        if tag == "tree":
            ok &= check_case(torch, fa, *inputs(torch, gen, 6, 130, 3, torch.float32), True, 0)
    kw = dict(causal=True, window=0, scale=1.0 / math.sqrt(64))
    for name, (BKV, S, G) in SHAPES.items():
        q, k, v = inputs(torch, gen, BKV, S, G)
        qs = q.permute(0, 2, 1, 3).contiguous()
        ks, vs = (t[:, None].expand(BKV, G, S, 64).contiguous() for t in (k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        times = {}
        for tag, csrc in trees + trees[::-1]:  # in turns: A, B, ..., B, A
            use_csrc(_build, csrc)
            times.setdefault(tag, []).append(time_ms(torch, lambda: fa._fwd_cuda(q, k, v, **kw)))
        lib = time_ms(torch, lambda: sdpa(qs, ks, vs, is_causal=True))
        print(f"timed {name} q[{BKV}, {S}, {G}, 64]: "
              + ", ".join(f"{t} {' / '.join(f'{x:.4f}' for x in ms)} ms" for t, ms in times.items())
              + f"; sdpa {lib:.4f} ms", flush=True)
    print("all checks passed" if ok else "SOME CHECKS FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
