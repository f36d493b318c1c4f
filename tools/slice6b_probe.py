#!/usr/bin/env python3
"""A short call on the card for slice 6b: the Muon variants, the paper's
pseudogradient measurements and scaling-law fits, and deepseek-moe-16b.

    python3 tools/slice6b_probe.py [--only 14,15,16]

Runs ``chip_smoke.py``'s phase 2 (every kernel built), phase 6b (the
training main path, 14a's reference), then phases 14 (14a: ``--inner
muon_bp --ns-period 1`` bitwise 6b's ``--inner muon``; 14b: ``muon_bp
--ns-period 4`` and ``normuon`` captured, against the formula, eager
bitwise), 15 (Figs. 2, 3 and 5 and Prop. 4.2 on paper-150m for Muon and
AdamW at K = 2, 4 and 8; 15c the fits) and 16 (deepseek-moe-16b:
paged_decode at 16 kv heads, the depth-2 fp32 agreement, serving at full
width and depth in bf16 weights, matmul_epilogue at the expert banks'
shapes, one captured MuLoCo round at full width, depth cut). Each phase
runs even when an earlier one failed; exits nonzero if any did. Needs one
card; ``chip_smoke.py`` is the full check.
"""
from __future__ import annotations

import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (adds src/ to the path)


def main() -> int:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import outer_update, quantize  # noqa: F401 (their tiles)
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import build_parser, train
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_map

    if not torch.cuda.is_available():
        raise SystemExit("slice6b_probe: needs a CUDA card")
    only = sys.argv[sys.argv.index("--only") + 1].split(",") if "--only" in sys.argv else None
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card (nvidia-smi name, power.limit): {smi}")
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got: dict = {}

    def main_path():
        _, out = cs.phase_train_main(torch, build_parser, train)
        got.update(hist=out["history"], tok_s=out["tok_s"],
                   host=tree_map(lambda t: t.to("cpu", copy=True), out["state"]))
        del out
        torch.cuda.empty_cache()

    phases = [("2", lambda: cs.phase_build(_build))]
    if only is None or "14" in only:
        phases += [("6b", main_path),
                   ("14", lambda: cs.slice_variants(torch, build_parser, train, got["hist"],
                                                    got["host"], got["tok_s"], smi))]
    if only is None or "15" in only:
        phases += [("15", lambda: cs.phase_pseudogradients(torch, get_config, build_model, smi)),
                   ("15c", cs.phase_scaling_laws)]
    if only is None or "16" in only:
        phases.append(("16", lambda: cs.slice_moe(torch, dict(fa=fa, mm=mm, ops=ops, ref=ref),
                                                  get_config, build_model, serve, smi)))
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
        torch.cuda.reset_peak_memory_stats()
    print(f"slice6b_probe: {time.perf_counter() - t0:.1f} s; "
          + ("all phases passed" if not failed else f"FAILED phases: {failed}"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
