#!/usr/bin/env python3
"""A short call on the card for the serving paths: the captured decode span,
the naive engine and nemotron-4-15b.

    python3 tools/serving_probe.py [--no-nemotron]

Runs ``chip_smoke.py``'s phase 2 (every kernel built, with ptxas's report
and the SASS count), phases 3a and 3b (flash_fwd and paged_decode at hd
64), 4a-4d (the fp32 agreement, the serving main path through the captured
span against the eager span, sampled decoding repeated from a seed, the
profile with a span replayed alone, the naive engine), 12a's paged_decode
and 12e/12e' (paper-416m's serving and its profile) and, unless
``--no-nemotron``, phase 13 (the G = 6 kernels, the depth-2 fp32 agreement
and the full-width serving run of nemotron-4-15b). Each phase runs even
when an earlier one failed; exits nonzero if any did. Needs one card;
``chip_smoke.py`` is the full check.
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
    from repro_torch.kernels import matmul, outer_update, quantize  # noqa: F401 (their tiles)
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model

    if not torch.cuda.is_available():
        raise SystemExit("serving_probe: needs a CUDA card")
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card (nvidia-smi name, power.limit): {smi}")
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got: dict = {}

    def smollm():
        launches, engine = cs.phase_main(torch, fa, get_config, serve)
        cs.phase_sampled(torch, engine)
        got["prof"] = cs.phase_profile(torch, engine, got["paged"]["ms"])
        rate = engine.tok_s
        del engine
        torch.cuda.empty_cache()
        cs.phase_naive(torch, fa, get_config, build_model, serve, rate)

    def ladder():
        cfg = get_config(cs.LADDER)
        paged = cs.phase_paged(torch, fa, hd=128, KV=cfg.n_kv_heads, G=1, phase="12a")
        _, engine = cs.phase_main(torch, fa, get_config, serve, cs.LADDER, "12e")
        cs.phase_profile(torch, engine, paged["ms"], phase="12e'")
        del engine
        torch.cuda.empty_cache()

    phases = [("2", lambda: cs.phase_build(_build)),
              ("3a", lambda: cs.phase_flash(torch, fa)),
              ("3b", lambda: got.update(paged=cs.phase_paged(torch, fa))),
              ("4a", lambda: cs.phase_agreement(torch, get_config, build_model)),
              ("4b-4d", smollm),
              ("12e", ladder)]
    if "--no-nemotron" not in sys.argv[1:]:
        phases.append(("13", lambda: cs.slice_nemotron(torch, fa, get_config, build_model,
                                                       serve, smi)))
    failed = []
    for name, run in phases:
        try:
            run()
        except Exception:  # report every phase, then fail
            traceback.print_exc()
            failed.append(name)
        sys.stdout.flush()
    print(f"serving_probe: {time.perf_counter() - t0:.1f} s; "
          + ("all phases passed" if not failed else f"FAILED phases: {failed}"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
