#!/usr/bin/env python3
"""A short call on the card for slice 8: the audio and VLM families.

    python3 tools/slice8_probe.py [--only 18a,18b,...] [--faults]

Runs ``chip_smoke.py``'s phase 2 (every kernel built, ptxas's report), then
the phases of 18: (18a) the flash kernels at whisper's non-causal encoder
shape and the VLM's G = 8 shape against their plain versions, timed, with
ptxas at hd 64, 80 and 128; (18b) matmul_epilogue at whisper's
Newton-Schulz shapes and nesterov over its parameters; (18c) whisper's fp32
agreement; (18d) whisper training; (18e) whisper serving; (18f) the VLM at
one superblock, served and differentiated. Each phase runs even when an
earlier one failed; exits nonzero if any did. Needs one card;
``chip_smoke.py`` is the full check.

``--faults`` reads 18f's gradients again with a fault planted in the flash
backward (``PLANTED``), against the same plain-path gradients, to show
where ``chip_smoke.VLM_ATTN_TOL`` stands between a sound run and a faulty
one. It only reads: 18f's own bound on the attention leaves is lifted.
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


def main() -> int:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import outer_update as ou
    from repro_torch.kernels import quantize  # noqa: F401 (its tiles)
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model

    if not torch.cuda.is_available():
        raise SystemExit("slice8_probe: needs a CUDA card")
    only = sys.argv[sys.argv.index("--only") + 1].split(",") if "--only" in sys.argv else None
    faults = "--faults" in sys.argv
    if faults:
        cs.VLM_ATTN_TOL = float("inf")
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card (nvidia-smi name, power.limit): {smi}")
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got: dict = {}

    def build():
        got["ptxas"] = cs.phase_build(_build)

    def matmul():
        got["xx"], _ = cs.phase_matmul_whisper(torch, mm)
        cs.phase_nesterov(torch, ou, cs.n_params(get_config(cs.WHISPER)), phase="18b")

    steps = {
        "18a": lambda: (
            cs.phase_ptxas_head_dims(got.get("ptxas", {})),
            cs.phase_flash(torch, fa, hd=64, phase="18a", cases=cs.WHISPER_FWD_CASES),
            cs.phase_flash(torch, fa, hd=128, phase="18a", cases=cs.VLM_FWD_CASES),
            cs.phase_flash_bwd(torch, fa, hd=64, phase="18a", cases=cs.WHISPER_BWD_CASES),
            cs.phase_flash_bwd(torch, fa, hd=128, phase="18a", cases=cs.VLM_BWD_CASES)),
        "18b": matmul,
        "18c": lambda: cs.phase_whisper_agreement(torch, get_config, build_model),
        "18d": lambda: cs.phase_whisper_train(torch, get_config, build_model,
                                              got.get("xx", {"ms": float("nan")})),
        "18e": lambda: cs.phase_whisper_serve(torch, get_config, serve),
        "18f": lambda: cs.phase_vlm(torch, get_config, build_model,
                                    after_grads=fault_readings(torch, fa) if faults else None),
    }
    phases = [("2", build)] + [(name, run) for name, run in steps.items()
                               if only is None or name in only]
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
    print(f"slice8_probe: {time.perf_counter() - t0:.1f} s; "
          + ("all phases passed" if not failed else f"FAILED phases: {failed}"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
