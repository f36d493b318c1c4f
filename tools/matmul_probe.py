#!/usr/bin/env python3
"""A short call on the card for the Newton–Schulz matmul and the paged decode.

    python3 tools/matmul_probe.py [CSRC_DIR ...]

Builds ``csrc/matmul_epilogue.cu`` and ``csrc/paged_decode.cu`` with
ptxas's report and prints each kernel's registers, shared memory and
spills; runs ``chip_smoke.py``'s phase 5b (``matmul_epilogue`` against its
plain version in all four operand layouts, symmetric calls bitwise
symmetric and equal to the full computation, X Xᵀ and B X + a·X timed
beside their bounds and ``torch.baddbmm``, the full Newton–Schulz) and
phase 3b (``paged_decode`` against its plain version, bitwise from run to
run, timed). Each further argument is a copy of ``csrc/`` (a kernel
variant) whose matmul_epilogue library is built, checked on the two timed
products (1e-5 of the largest output; the triangle bitwise symmetric) and
timed in turns with the tree's. Exits nonzero on a failed check. Needs one
card; ``chip_smoke.py`` is the full check.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (adds src/ to the path)
from chip_smoke import ptxas_report, time_ms  # noqa: E402


def use_csrc(_build, csrc: Path, variant: bool = False) -> None:
    """Point the build at ``csrc`` and forget what was built and bound; a
    variant may change the tile sizes, so its matmul library's are not
    checked against the module's."""
    _build.CSRC = csrc
    _build._LIBS.clear()
    _build._ENTRIES.clear()
    _build._TILES_CHECKED.clear()
    if variant:
        _build._TILES_CHECKED.add("matmul_epilogue")


def main() -> int:
    import torch

    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.optim.muon import NS_COEFFS

    if not torch.cuda.is_available():
        raise SystemExit("matmul_probe: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card (nvidia-smi name, power.limit): {smi}")
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    trees = [("tree", _build.CSRC)] + [(Path(a).name, Path(a).resolve()) for a in sys.argv[1:]]
    for tag, csrc in trees:
        use_csrc(_build, csrc)
        names = ["matmul_epilogue", "paged_decode"] if tag == "tree" else ["matmul_epilogue"]
        for name, report in _build.build(names, verbose=True).items():
            print(f"[{tag}] {name}: built in {report['seconds']:.1f} s")
            for fn, line in ptxas_report(report["log"]).items():
                print(f"  {fn}: {line}")
        print(f"  tiles: {_build.kernel_tiles('matmul_epilogue')}", flush=True)
    use_csrc(_build, trees[0][1])
    chip_smoke.phase_paged(torch, fa)
    chip_smoke.phase_matmul(torch, mm, ops, ref)
    if len(trees) == 1:
        return 0

    na, nb, nc = NS_COEFFS
    gen = torch.Generator(device="cuda").manual_seed(12)
    g = torch.randn((30, 576, 1536), generator=gen, device="cuda")
    x = g / torch.sqrt(torch.sum(g * g, dim=(-2, -1), keepdim=True))
    A = mm._matmul_plain(x, x.mT, None, alpha=1.0, beta=0.0, out_dtype=x.dtype)
    A = (A + A.mT) / 2  # bitwise symmetric
    Bm = mm._matmul_plain(A, A, A, alpha=nc, beta=nb, out_dtype=x.dtype)
    calls = {"X X^T sym": (x, x.mT, None, 1.0, 0.0, True),
             "c A A + b A sym": (A, A, A, nc, nb, True),
             "B X + a X": (Bm, x, x, 1.0, na, False)}
    ok = True
    for tag, csrc in trees[1:]:
        use_csrc(_build, csrc, variant=True)
        for name, (a, b, d, alpha, beta, sym) in calls.items():
            c = mm.matmul_epilogue(a, b, d, alpha=alpha, beta=beta, symmetric=sym)
            cp = mm._matmul_plain(a, b, d, alpha=alpha, beta=beta, out_dtype=a.dtype)
            torch.cuda.synchronize()
            err = (c - cp).abs().max().item()
            good = err <= 1e-5 * max(1.0, cp.abs().max().item()) and (
                not sym or torch.equal(c, c.mT))
            ok &= good
            print(f"  [{tag}] {name}: err {err:.3e}{'' if good else '  FAILED'}")
    for name, (a, b, d, alpha, beta, sym) in calls.items():
        times = {}
        for tag, csrc in trees + trees[::-1]:  # in turns: A, B, ..., B, A
            use_csrc(_build, csrc, variant=tag != "tree")
            times.setdefault(tag, []).append(time_ms(torch, lambda: mm.matmul_epilogue(
                a, b, d, alpha=alpha, beta=beta, symmetric=sym)))
        print(f"timed {name}: " + ", ".join(
            f"{t} {' / '.join(f'{v:.4f}' for v in ms)} ms" for t, ms in times.items()), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
