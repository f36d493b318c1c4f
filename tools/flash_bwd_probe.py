#!/usr/bin/env python3
"""A short first call on the card for the flash backward kernels.

    python3 tools/flash_bwd_probe.py

Builds ``csrc/flash_bwd.cu`` with ptxas's report, prints each kernel's
registers and spills and the count of tensor-core instructions in its SASS,
checks the bf16 sweeps against their plain versions (phase 5a's tolerance,
1e-2 of the largest gradient) and run to run (bitwise) at ragged, G = 1 to
4, windowed and non-causal shapes and the training shape, times both sweeps
at the training shape (``chip_smoke.time_ms``) and checks one fp32 case.
Exits nonzero on a failed check. Needs one card; ``chip_smoke.py`` is the
full check.
"""
from __future__ import annotations

import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import ptxas_report, sass_counts, time_ms  # noqa: E402  (adds src/ to the path)


def main() -> int:
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_probe: needs a CUDA card")
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    report = _build.build(["flash_bwd"], verbose=True)["flash_bwd"]
    for fn, line in ptxas_report(report["log"]).items():
        print(f"  {fn}: {line}")
    for fn, ops in sass_counts(report["path"]).items():
        print(f"  {fn}: tensor-core instructions in SASS {ops}")
    print("  tiles (rows, keys, dq smem, dkv smem):", _build.kernel_tiles("flash_bwd"), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = [  # (BKV, S, G, causal, window); the last is the training shape
        (1, 64, 1, False, 0), (1, 64, 1, True, 0), (2, 77, 3, True, 0), (4, 130, 1, True, 0),
        (2, 96, 4, False, 0), (6, 300, 3, True, 100), (2, 77, 2, False, 20),
        (24, 1024, 3, True, 0)]
    ok = True
    for BKV, S, G, causal, window in cases:
        q, do = (torch.randn((BKV, S, G, 64), generator=gen, device="cuda").bfloat16()
                 for _ in "qd")
        k, v = (torch.randn((BKV, S, 64), generator=gen, device="cuda").bfloat16() for _ in "kv")
        kw = dict(causal=causal, window=window, scale=1.0 / math.sqrt(64))
        o, lse = fa._fwd_cuda(q, k, v, **kw)
        args = (q, k, v, do, lse, torch.sum(do.float() * o.float(), dim=-1))
        got, again = fa._bwd_cuda(*args, **kw), fa._bwd_cuda(*args, **kw)
        plain = (fa._dq_plain(*args, **kw), *fa._dkv_plain(*args, **kw))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        line = [f"bf16 BKV={BKV} S={S} G={G} causal={causal} window={window} bitwise={same}"]
        ok &= same
        for name, g, p in zip(("dq", "dk", "dv"), got, plain):
            tol = 1e-2 * max(1.0, p.float().abs().max().item())
            err = (g.float() - p.float()).abs().max().item()
            ok &= err <= tol
            line.append(f"{name} err/tol {err / tol:.3f}")
        print(" | ".join(line), flush=True)
    dq_ms = time_ms(torch, lambda: fa._dq_cuda(*args, **kw))
    dkv_ms = time_ms(torch, lambda: fa._dkv_cuda(*args, **kw))
    print(f"timed at the training shape: flash_dq {dq_ms:.4f} ms, flash_dkv {dkv_ms:.4f} ms")

    q, do = (torch.randn((2, 77, 3, 64), generator=gen, device="cuda") for _ in "qd")
    k, v = (torch.randn((2, 77, 64), generator=gen, device="cuda") for _ in "kv")
    kw = dict(causal=True, window=0, scale=0.125)
    o, lse = fa._fwd_cuda(q, k, v, **kw)
    args = (q, k, v, do, lse, torch.sum(do * o, dim=-1))
    errs = [(a - b).abs().max().item() for a, b in zip(
        fa._bwd_cuda(*args, **kw), (fa._dq_plain(*args, **kw), *fa._dkv_plain(*args, **kw)))]
    print("fp32 errors (dq, dk, dv):", errs)
    ok &= max(errs) <= 1e-4
    print("all checks passed" if ok else "SOME CHECKS FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
