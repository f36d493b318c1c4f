#!/usr/bin/env python3
"""Run-to-run determinism of the training path on the card.

    python3 tools/determinism_probe.py [--draws N] [--stress N] [--many N]
                                       [--reps N] [--only-r4]

Builds the kernels (``chip_smoke.py``'s phase 2), then:

  * data: draws the chain starts of phase 10a's stream (smollm-135m's
    vocab, 16 sequences a step, seed 0) ``--draws`` times a step for steps
    0-11, once through ``torch.multinomial`` on the start distribution (how
    the stream drew them before) and once through
    ``MarkovStream.batch_stack`` (an inverse-CDF lookup in a host-summed
    table), and counts draws that differ from each step's first, after
    counting the ``torch.cumsum`` results of that distribution that differ;
  * kernels: calls each kernel that the data-parallel Muon step launches
    (flash_fwd, flash_dq, flash_dkv at the step's shape, and the
    Newton-Schulz matmuls on every Muon leaf of smollm-135m) ``--stress``
    times on the same inputs, with the caching allocator's freed blocks
    filled with other bytes before each call (NaN, huge, small, zero), and
    ``--many`` times with the mismatches counted on the card;
  * runs: phase 10a's workload (``dp_engine(model, 'muon')``, 12 steps of
    16 x 1024 tokens) ``--reps`` times captured at R = 1, at R = 4 and
    eagerly (``--only-r4``: at R = 4 only) against a first captured R = 1
    run, and names the first round whose loss differs and the state leaves
    that differ.

Exits nonzero if a kernel, a batch or a run differed (the multinomial
count is reported only). Needs one card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (adds src/ to the path)

FILLS = (0xFF, 0x7F, 0x3C, 0x00)  # bf16/fp32 NaN, ~3e38, ~0.01, zero


def count_differing(torch, fn, n: int, refill: bool = False) -> int:
    """Calls of ``fn`` (``n`` after a first) whose tensors differ from the
    first call's, counted on the card. ``refill``: before each call the
    allocator's freed blocks of the outputs' sizes are filled with other
    bytes, so a read of memory the kernel did not write shows."""
    first = [t.clone() for t in fn()]
    sizes = [t.numel() * t.element_size() for t in first]
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    for i in range(n):
        if refill:
            blocks = [torch.empty(s, dtype=torch.uint8, device="cuda").fill_(FILLS[i % 4])
                      for s in sizes]
            del blocks
        bad += torch.stack([(a != b).any() for a, b in zip(first, fn())]).any()
    return int(bad)


def data_draws(torch, get_config, n: int) -> int:
    from repro_torch.data import DataConfig, MarkovStream
    from repro_torch.data.synthetic import _step_seed

    vocab = get_config("smollm-135m").vocab
    B = cs.DP["batch"]
    # the chain starts alone: a step's starts do not depend on seq_len
    stream = MarkovStream(DataConfig(vocab=vocab, seq_len=1, batch_per_worker=B, n_workers=1,
                                     seed=0), "cuda")
    zipf = 1.0 / (np.arange(1, vocab + 1) ** 1.2)
    probs = torch.from_numpy(zipf / zipf.sum()).float().cuda()
    print(f"[data] phase 10a's stream (vocab {vocab}, {B} chain starts a step), {n} draws a "
          "step: torch.multinomial / batch_stack draws that differ from the step's first")
    scan = count_differing(torch, lambda: (torch.cumsum(probs, 0),), n)
    print(f"  torch.cumsum of the start distribution (the CDF torch.multinomial sums): "
          f"{scan} of {n} calls differ from the first", flush=True)
    bad, rows = 0, []
    for step in range(cs.DP["steps"]):
        gen = torch.Generator(device="cuda")

        def multinomial():
            gen.manual_seed(_step_seed(0, step))
            return (torch.multinomial(probs, B, replacement=True, generator=gen),)

        lib = count_differing(torch, multinomial, n)
        ours = count_differing(torch, lambda: (stream.batch_stack(step, 1)["tokens"][..., 0],), n)
        bad += ours
        rows.append(f"step {step} {lib}/{ours}")
    print("  " + ", ".join(rows), flush=True)
    return bad


def kernel_stress(torch, fa, get_config, build_model, n: int, many: int) -> int:
    from repro_torch.kernels import ops
    from repro_torch.optim.muon import muon_label
    from repro_torch.utils.tree import tree_leaves_with_paths

    print(f"[kernels] each kernel of the Muon DP step: {n} calls with freed blocks refilled, "
          f"{many} calls (a twentieth for Newton-Schulz) counted on the card")
    gen = torch.Generator(device="cuda").manual_seed(5)
    B, S, hd = cs.DP["batch"], cs.DP["seq_len"], 64
    cfg = get_config("smollm-135m").replace(max_seq_len=S, attn_impl="pallas")
    KV, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q, do = (torch.randn((B * KV, S, G, hd), generator=gen, device="cuda").bfloat16()
             for _ in "qd")
    k, v = (torch.randn((B * KV, S, hd), generator=gen, device="cuda").bfloat16() for _ in "kv")
    kw = dict(causal=True, window=0, scale=hd ** -0.5)
    o, lse = fa._fwd_cuda(q, k, v, **kw)
    dl = torch.sum(do.float() * o.float(), dim=-1)
    args = (q, k, v, do, lse, dl)
    calls = {f"flash_fwd q{list(q.shape)}": (lambda: fa._fwd_cuda(q, k, v, **kw), many),
             "flash_dq": (lambda: (fa._dq_cuda(*args, **kw),), many),
             "flash_dkv": (lambda: fa._dkv_cuda(*args, **kw), many)}
    params = build_model(cfg).init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    for path, p in tree_leaves_with_paths(params):
        if muon_label(path, p) == "muon":
            g = torch.randn(p.shape, generator=gen, device="cuda", dtype=torch.float32)
            calls[f"ns_orthogonalize {path} {list(p.shape)}"] = (
                lambda g=g: (ops.ns_orthogonalize(g),), many // 20)
    del params
    bad = 0
    for name, (fn, m) in calls.items():
        t0 = time.perf_counter()
        got = count_differing(torch, fn, n, refill=True), count_differing(torch, fn, m)
        bad += sum(got)
        print(f"  {name}: {got[0]} of {n} (refilled) and {got[1]} of {m} differ "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    torch.cuda.empty_cache()
    return bad


def dp_repeats(torch, get_config, build_model, reps: int, only_r4: bool) -> int:
    from repro_torch.data import DataConfig, MarkovStream, batches_for_round, batches_for_span
    from repro_torch.engine import dp_engine, run_rounds
    from repro_torch.optim import OptimizerConfig
    from repro_torch.utils.tree import tree_leaves_with_paths

    n, B, S = cs.DP["steps"], cs.DP["batch"], cs.DP["seq_len"]
    modes = [("R = 4", 4, None)] if only_r4 else [("R = 1", 1, None), ("R = 4", 4, None),
                                                  ("eager", 1, False)]
    print(f"[runs] phase 10a's workload {reps} times at {', '.join(m[0] for m in modes)} "
          "against a first captured R = 1 run")
    cfg = get_config("smollm-135m").replace(max_seq_len=S, attn_impl="pallas")
    model = build_model(cfg)
    icfg = OptimizerConfig(lr=cs.DP["lr"], weight_decay=1e-4, schedule="cosine",
                           warmup_steps=max(n // 100, 5), total_steps=n)
    data = MarkovStream(DataConfig(vocab=cfg.vocab, seq_len=S, batch_per_worker=B,
                                   n_workers=1, seed=0), "cuda")

    def run(R, capture=None):
        engine = dp_engine(model, "muon", icfg, capture=capture)
        state = engine.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
        state, hist = run_rounds(engine, state, lambda r: batches_for_round(data, r, 1), n,
                                 rounds_per_dispatch=R,
                                 span_batches_for=lambda r0, m: batches_for_span(data, r0, 1, m))
        torch.cuda.synchronize()
        leaves = {p: t.detach().clone() for p, t in tree_leaves_with_paths(state)}
        del engine, state
        torch.cuda.empty_cache()
        return [r["train_loss"] for r in hist], leaves

    base_losses, base = run(1)
    bad = 0
    for rep in range(reps):
        for label, R, capture in modes:
            losses, leaves = run(R, capture)
            first = next((i for i, (a, b) in enumerate(zip(base_losses, losses)) if a != b), None)
            diffs = [p for p in base if not torch.equal(base[p], leaves[p])]
            if first is None and not diffs:
                continue
            bad += 1
            print(f"  rep {rep} {label} differs: first loss that differs at round {first} "
                  f"({base_losses[first] if first is not None else '-'} vs "
                  f"{losses[first] if first is not None else '-'}); {len(diffs)} state "
                  f"leaves differ, e.g. {diffs[:3]}", flush=True)
    print(f"  {bad} of {reps * len(modes)} runs differ", flush=True)
    return bad


def main() -> int:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul, outer_update, quantize  # noqa: F401 (their tiles)
    from repro_torch.models import build_model

    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=500)
    ap.add_argument("--stress", type=int, default=100)
    ap.add_argument("--many", type=int, default=20000)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only-r4", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("determinism_probe: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card (nvidia-smi name, power.limit): {smi}")
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cs.phase_build(_build)
    bad = data_draws(torch, get_config, args.draws)
    bad += kernel_stress(torch, fa, get_config, build_model, args.stress, args.many)
    bad += dp_repeats(torch, get_config, build_model, args.reps, args.only_r4)
    print(f"determinism_probe: {bad} differing results in {time.perf_counter() - t0:.1f} s")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
