#!/usr/bin/env python3
"""A short call on the card for slice 7a: the SSM and hybrid families.

    python3 tools/slice7a_probe.py [--only 17a,17b,...] [--parent DIR]

Runs ``chip_smoke.py``'s phase 2 (every kernel built, ptxas's report), then
the phases of 17: (17a) the flash kernels at hd 80 against their plain
versions and timed at zamba2's training shape, (17b) matmul_epilogue at
the SSM Newton-Schulz shapes, (17c) the fp32 agreements, (17d) mamba2-370m
training, (17e) zamba2-2.7b training at one superblock, (17f) both served
through the naive engine. ``--parent DIR`` (a checkout of the parent
commit, unpacked with ``git archive`` into ``build/parent``, which git
ignores) also builds the parent's flash libraries
and sets them beside this tree's at hd 64 and 128: ptxas's registers,
shared memory and spills of each bf16 sweep (which must be equal), and the
three bf16 sweeps timed at the training shapes of smollm-135m and
paper-416m in turns (parent, tree, tree, parent). Each phase runs even when
an earlier one failed; exits nonzero if any did. Needs one card;
``chip_smoke.py`` is the full check.
"""
from __future__ import annotations

import math
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
PARENT_SHAPES = {64: (24, 1024, 3), 128: (32, 2048, 1)}


def use_csrc(_build, csrc: Path, check_tiles: bool) -> None:
    """Point the build at ``csrc`` and forget what was built and bound; a
    parent's libraries report the parent's tiles, so their check is skipped."""
    _build.CSRC = csrc
    _build._LIBS.clear()
    _build._ENTRIES.clear()
    _build._TILES_CHECKED.clear()
    if not check_tiles:
        _build._TILES_CHECKED.update(("flash_fwd", "flash_bwd"))


def flash_ptxas(_build) -> dict:
    report = _build.build(names=["flash_fwd", "flash_bwd"], verbose=True)
    out = {}
    for r in report.values():
        out.update(cs.ptxas_report(r["log"]))
    return {k: v for k, v in out.items() if "wgmma" in k}


def compare_parent(torch, fa, _build, parent: Path) -> None:
    """ptxas and the bf16 sweeps' times of the parent's flash libraries
    beside this tree's, at hd 64 and 128."""
    tree_csrc = _build.CSRC
    sides = {"tree": tree_csrc, "parent": parent / "src" / "repro_torch" / "kernels" / "csrc"}
    reports = {}
    for side, csrc in sides.items():
        use_csrc(_build, csrc, side == "tree")
        reports[side] = flash_ptxas(_build)
    bad = []
    for fn in sorted(reports["parent"]):
        a, b = reports["parent"][fn], reports["tree"].get(fn)
        print(f"  {fn}: parent {a}; tree {b}")
        if a != b:
            bad.append(fn)
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
    use_csrc(_build, tree_csrc, True)
    for hd in PARENT_SHAPES:
        for name in ("flash_fwd", "flash_dq", "flash_dkv"):
            p = statistics.mean(times[(hd, name, "parent")])
            t = statistics.mean(times[(hd, name, "tree")])
            print(f"  hd {hd} {name} {list(PARENT_SHAPES[hd])}: parent "
                  f"{[round(x, 4) for x in times[(hd, name, 'parent')]]} ms, tree "
                  f"{[round(x, 4) for x in times[(hd, name, 'tree')]]} ms: tree / parent "
                  f"{t / p:.4f}")
    assert not bad, f"ptxas differs from the parent's: {bad}"


def main() -> int:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import outer_update, quantize  # noqa: F401 (their tiles)
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import build_parser, train
    from repro_torch.models import build_model

    if not torch.cuda.is_available():
        raise SystemExit("slice7a_probe: needs a CUDA card")
    only = sys.argv[sys.argv.index("--only") + 1].split(",") if "--only" in sys.argv else None
    parent = Path(sys.argv[sys.argv.index("--parent") + 1]) if "--parent" in sys.argv else None
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

    phases = [("2", build)]
    if parent is not None:
        phases.append(("parent", lambda: compare_parent(torch, fa, _build, parent)))
    steps = {
        "17a": lambda: (cs.phase_ptxas_head_dims(got.get("ptxas", {})),
                        cs.phase_flash(torch, fa, hd=80, phase="17a"),
                        cs.phase_flash_bwd(torch, fa, hd=80, phase="17a")),
        "17b": lambda: cs.phase_matmul_ssm(torch, mm),
        "17c": lambda: (
            cs.phase_train_agreement(torch, get_config, build_model, cs.MAMBA, "17c",
                                     n_layers=2, S=256),
            cs.phase_train_agreement(torch, get_config, build_model, cs.ZAMBA, "17c",
                                     n_layers=cs.ZAMBA_TRAIN["depth"], S=8192),
            cs.phase_ssm_decode_agreement(torch, get_config, build_model, cs.MAMBA, 2),
            cs.phase_ssm_decode_agreement(torch, get_config, build_model, cs.ZAMBA,
                                          cs.ZAMBA_TRAIN["depth"])),
        "17d": lambda: cs.phase_mamba_train(torch, build_parser, train),
        "17e": lambda: cs.phase_zamba_train(torch, get_config, build_model),
        "17f": lambda: (cs.phase_ssm_serve(torch, get_config, serve, cs.MAMBA),
                        cs.phase_ssm_serve(torch, get_config, serve, cs.ZAMBA,
                                           dict(param_dtype="bfloat16"))),
    }
    phases += [(name, run) for name, run in steps.items() if only is None or name in only]
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
    print(f"slice7a_probe: {time.perf_counter() - t0:.1f} s; "
          + ("all phases passed" if not failed else f"FAILED phases: {failed}"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
