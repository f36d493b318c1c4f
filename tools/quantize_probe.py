#!/usr/bin/env python3
"""A short call on the card for the row-wise quantize kernel.

    python3 tools/quantize_probe.py [CHECKOUT ...]

Builds ``csrc/quantize.cu`` with ptxas's report (registers, shared memory
and spills of each kernel function and template instantiation) and runs
``chip_smoke.py``'s phase 8a: ``quantize`` (full and codes-only) and
``dequantize`` against their plain versions, bitwise, at the compressed
runs' shapes (from a full-width smollm-135m tree made on the card) and at
the edges of quantize's regimes, and the two timed shapes in both forms
beside their bounds. Each further argument is another checkout of the
repository (for example the parent commit, unpacked with ``git archive``
into ``build/``, or a copy whose kernel is a variant): its ``quantize``
(full, and codes-only where its wrapper has it) is checked bitwise against
its own plain version and timed at the two shapes in turns with this
tree's (this tree, the others, then the same in reverse), each turn in a
process of its own with that checkout's wrapper and kernel; each kernel's
device time a call, and the quantize and dequantize kernels' device time
in one full-width outer sync of each compressed run (global 2-bit, and
row-wise 2-bit on streaming segment 0 of 2, both with error feedback),
are read from torch.profiler. Exits nonzero on a failed check. Needs one card; ``chip_smoke.py`` is the full check.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (adds src/ to the path)
from chip_smoke import ptxas_report  # noqa: E402

SHAPES = (("global Q1 of embed", 2, 28_311_552, 2), ("row-wise Q1 of w_in", 34_560, 1536, 4))
# one turn: argv = this tree's root (for chip_smoke's helpers), the checkout's
# src, the shapes; times each form the checkout's wrapper has (codes-only
# where it takes with_deq) and, from torch.profiler, each kernel's device
# time a call
TURN = r"""
import inspect, json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
sys.path.insert(0, sys.argv[2])
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import quantize as q
assert q.__file__.startswith(sys.argv[2]), q.__file__
gen = torch.Generator(device="cuda").manual_seed(16)
times, kernels = {}, {}
for name, rows, cols, bits in json.loads(sys.argv[3]):
    x = torch.randn((rows, cols), generator=gen, device="cuda")
    want = q.rowwise_quantize_plain(x, bits)
    forms = {"full": lambda: q._quantize_cuda(x, bits)}
    if "with_deq" in inspect.signature(q._quantize_cuda).parameters:
        forms["codes-only"] = lambda: q._quantize_cuda(x, bits, with_deq=False)
    for form, fn in forms.items():
        got = fn()
        assert all(a is None or torch.equal(a, b) for a, b in zip(got, want)), name
        times[f"{form}, {name}"] = chip_smoke.time_ms(torch, fn)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        for k, (ms, n) in chip_smoke.device_times(torch, prof).items():
            kernels[f"{form}, {name}: {k}"] = ms / 10
    del x, want
# one full-width outer sync of each compressed run (8c: global 2-bit with EF;
# 8d: row-wise 2-bit with EF, streaming segment 0 of 2), the quantize and
# dequantize kernels' device time in it
from repro_torch.configs import get_config
from repro_torch.core import CompressionConfig, DiLoCoConfig, make_outer, outer_step
from repro_torch.core.streaming import streaming_masks
from repro_torch.engine import train_state
from repro_torch.models import build_model
from repro_torch.utils.tree import tree_map
dev = torch.device("cuda")
params = build_model(get_config("smollm-135m")).init(torch.Generator(device=dev).manual_seed(0), dev)
noise = lambda shape: torch.randn(shape, generator=gen, device=dev) * 1e-3
base = dict(outer_params=params, outer_opt={"u": tree_map(lambda p: noise(p.shape), params)},
            worker_params=tree_map(lambda p: p[None] + noise((2, *p.shape)), params),
            inner_state={}, round=torch.zeros((), dtype=torch.int32, device=dev),
            ef=tree_map(lambda p: noise((2, *p.shape)), params))
sync = {}
for tag, ckw, J in (("8c", dict(bits=2), 1), ("8d", dict(bits=2, rowwise=True), 2)):
    dcfg = DiLoCoConfig(n_workers=2, compression=CompressionConfig(
        kind="quant", error_feedback=True, wire_impl="pallas", **ckw),
        streaming_partitions=J, outer_kernel=True)
    mask = streaming_masks(params, J)[0] if J > 1 else None
    outer_step(dcfg, train_state(**tree_map(torch.clone, base)), mask=mask,
               outer=make_outer(dcfg))  # warm
    state = train_state(**tree_map(torch.clone, base))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        outer_step(dcfg, state, mask=mask, outer=make_outer(dcfg))
        torch.cuda.synchronize()
    for k, (ms, n) in chip_smoke.device_times(torch, prof).items():
        if "paged" in k or not any(t in k for t in (
                "quantize_", "minmax_kernel", "row_stats_kernel", "encode_kernel", "decode_kernel")):
            continue
        form = "dequantize" if "decode_kernel" in k else "quantize"
        got = sync.setdefault(f"{tag} sync, {form}", [0.0, 0])
        got[0] += ms
        got[1] += n
print(json.dumps({"times": times, "kernels": kernels, "sync": sync}))
"""


def turn(checkout: Path) -> dict:
    """The checkout's quantize timed in a process of its own."""
    proc = subprocess.run([sys.executable, "-c", TURN, str(ROOT), str(checkout / "src"),
                           json.dumps(SHAPES)], capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: exited {proc.returncode}\n{proc.stdout}{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import quantize as q
    from repro_torch.models import build_model

    if not torch.cuda.is_available():
        raise SystemExit("quantize_probe: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card (nvidia-smi name, power.limit): {smi}")
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    report = _build.build(["quantize"], verbose=True)["quantize"]
    print(f"quantize: built in {report['seconds']:.1f} s")
    for fn, line in ptxas_report(report["log"]).items():
        print(f"  {fn}: {line}")
    params = build_model(get_config("smollm-135m")).init(
        torch.Generator(device="cuda").manual_seed(0), torch.device("cuda"))
    chip_smoke.phase_quantize(torch, q, params)
    del params
    torch.cuda.empty_cache()
    trees = [ROOT] + [Path(a).resolve() for a in sys.argv[1:]]
    if len(trees) == 1:
        return 0
    times: dict = {}
    failed = set()
    for tree in trees + trees[::-1]:  # in turns: A, B, ..., B, A
        tag = "this tree" if tree == ROOT else tree.name
        if tree in failed:
            continue
        try:
            got = turn(tree)
        except RuntimeError as e:  # a variant that does not build or differs
            if tree == ROOT:
                raise
            print(f"  [{tag}] FAILED: {str(e)[-3000:]}", flush=True)
            failed.add(tree)
            continue
        for name, ms in got["times"].items():
            times.setdefault(name, {}).setdefault(tag, []).append(ms)
        if len(times[name][tag]) == 1:
            for name, ms in got["kernels"].items():
                print(f"  [{tag}] {name}: {ms:.4f} ms a call (torch.profiler)")
        for name, (ms, n) in got["sync"].items():
            print(f"  [{tag}] {name} kernels: {ms:.3f} ms device time, {n} kernels (torch.profiler)")
    for name, by_tree in times.items():
        print(f"timed quantize {name}, in turns: " + ", ".join(
            f"{t} {' / '.join(f'{v:.4f}' for v in ms)} ms" for t, ms in by_tree.items()),
            flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
