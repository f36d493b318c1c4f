#!/usr/bin/env python3
"""A short call on the card for the head-dim-128 builds of the flash and
paged kernels and the Newton-Schulz matmul at the paper's ladder shapes.

    python3 tools/hd128_probe.py [--ladder]

Runs ``chip_smoke.py``'s phase 2 (every kernel built with ptxas's report and
the SASS count; a bf16 flash sweep at hd 64 or 128 with no HGMMA or with
spills fails it), phases 3a, 3b and 5a at hd 64 (the smollm-135m shapes,
unchanged by the hd-128 builds) and phases 12a and 12b (the kernels at hd
128 against their plain versions, bitwise from run to run, timed; the
matmul at paper-416m's ragged widths). With ``--ladder``: phase 2, then
the whole of slice 6a (phases 12a-12e: the kernels at hd 128, the
full-width fp32 agreements, the training and serving main paths on
paper-416m) and chip_smoke's phase 20 on them (the roofline). Each phase
runs even when an earlier one failed; exits nonzero if any did. Needs one
card; ``chip_smoke.py`` is the full check.
"""
from __future__ import annotations

import json
import subprocess
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (adds src/ to the path)


def main() -> int:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import outer_update as ou
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import build_parser, train
    from repro_torch.models import build_model

    if not torch.cuda.is_available():
        raise SystemExit("hd128_probe: needs a CUDA card")
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phases = [("2", lambda: cs.phase_build(_build))]
    if "--ladder" in sys.argv[1:]:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
        print(f"card (nvidia-smi name, power.limit): {smi}")
        def ladder():
            rows = cs.slice_6a(torch, dict(fa=fa, mm=mm, ops=ops, ref=ref, ou=ou), get_config,
                               build_model, build_parser, train, serve, smi)
            cs.phase_roofline(rows.pop("reads"), smi)
            print(json.dumps(rows))

        phases.append(("12", ladder))
    else:
        phases += [
            ("3a", lambda: cs.phase_flash(torch, fa)),
            ("3b", lambda: cs.phase_paged(torch, fa)),
            ("5a", lambda: cs.phase_flash_bwd(torch, fa)),
            ("12a fwd", lambda: cs.phase_flash(torch, fa, hd=128, phase="12a")),
            ("12a bwd", lambda: cs.phase_flash_bwd(torch, fa, hd=128, phase="12a")),
            ("12a paged", lambda: cs.phase_paged(torch, fa, hd=128, KV=8, G=1, phase="12a")),
            ("12b", lambda: cs.phase_matmul_ladder(torch, mm, ops, ref)),
        ]
    failed = []
    for name, run in phases:
        try:
            run()
        except Exception:  # report every phase, then fail
            traceback.print_exc()
            failed.append(name)
        sys.stdout.flush()
    print("all phases passed" if not failed else f"FAILED phases: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
