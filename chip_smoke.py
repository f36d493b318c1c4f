#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. Device: CUDA must be available; prints the card's name and power limit.
2. Build: compiles every kernel of the serving path from
   ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a (one nvcc per
   source, all started together) and prints the build seconds and ptxas's
   register / spill report.
3. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes in bf16 plus odd-length, sliding-window and fp32 cases
   (tolerances: bf16 outputs 2e-2, lse 1e-3, fp32 1e-5), and times each
   kernel (CUDA events, L2 flushed before each run, median of 30) beside
   its plain version, its bound and, for flash, torch's
   scaled_dot_product_attention as the library yardstick.
4. A full-width fp32 agreement check (kernel path against the plain torch
   path, logits of a prefill and three decode steps), then the main path:
   ``repro_torch.launch.serve`` at full width (smollm-135m, seeded random
   weights, bf16, attn_impl='pallas'), 32 requests of 512 prompt tokens and
   64 new tokens over 16 slots. The launch counters are set to 0 just before
   this run and read just after; every kernel must have launched exactly
   30 times per prefill dispatch / decode step. Then one shorter run of the
   same engine under torch.profiler: wall time, device busy share and the
   kernels that take the device time.
5. Summary: one ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Matmuls in fp32 run in full fp32 (TF32 off for matmul and cuDNN); bf16
GEMMs keep PyTorch's default reduced-precision reduction setting, printed
below. Needs one card and no network.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# peak rates of one H100 SXM (NVIDIA data sheet, dense, 700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

MAIN = dict(batch=32, prompt_len=512, max_new=64, slots=16, page_size=16, max_pages=1024,
            decode_steps_per_dispatch=8)


def time_ms(torch, fn, runs: int = 30) -> float:
    """Median device time of ``fn`` in ms, the 50 MB L2 flushed before each run."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    events = []
    for _ in range(runs):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def check(name: str, err: float, tol: float) -> float:
    print(f"  {name}: max abs err {err:.3e} (tol {tol:g})")
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"{name}: max abs err {err} > {tol}")
    return err


def flash_pairs(S: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head."""
    total = 0
    for i in range(S):
        hi = i + 1 if causal else S
        lo = max(0, i - window + 1) if window else 0
        total += hi - lo
    return total


def phase_flash(torch, fa):
    print("[3a] flash_fwd (replaces flash_attention.py:_fwd_kernel) against its plain version")
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [  # (BKV, S, G, dtype, causal, window); the first is the main path's shape
        (16 * 3, 512, 3, torch.bfloat16, True, 0),
        (2 * 3, 77, 3, torch.bfloat16, True, 0),
        (2 * 3, 300, 3, torch.bfloat16, True, 100),
        (2 * 3, 130, 3, torch.float32, True, 0),
        (2 * 1, 96, 4, torch.float32, False, 0),
    ]
    out = {}
    for BKV, S, G, dt, causal, window in cases:
        hd = 64
        q = torch.randn((BKV, S, G, hd), generator=gen, device="cuda").to(dt)
        k = torch.randn((BKV, S, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((BKV, S, hd), generator=gen, device="cuda").to(dt)
        kw = dict(causal=causal, window=window, scale=1.0 / math.sqrt(hd))
        o, lse = fa._fwd_cuda(q, k, v, **kw)
        o_ref, lse_ref = fa._fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        tag = f"{str(dt)[6:]} q{[BKV, S, G, hd]} causal={causal} window={window}"
        fp32 = dt == torch.float32
        err = check(f"{tag} o", (o.float() - o_ref.float()).abs().max().item(),
                    1e-5 if fp32 else 2e-2)
        check(f"{tag} lse", (lse - lse_ref).abs().max().item(), 1e-5 if fp32 else 1e-3)
        if not out:  # the main path's shape: time it
            ms = time_ms(torch, lambda: fa._fwd_cuda(q, k, v, **kw))
            plain_ms = time_ms(torch, lambda: fa._fwd_plain(q, k, v, **kw))
            qs = q.permute(0, 2, 1, 3).contiguous()  # [BKV, G, S, hd]
            ks = k[:, None].expand(BKV, G, S, hd).contiguous()
            vs = v[:, None].expand(BKV, G, S, hd).contiguous()
            sdpa = torch.nn.functional.scaled_dot_product_attention
            library_ms = time_ms(torch, lambda: sdpa(qs, ks, vs, is_causal=True))
            flops = 4 * hd * flash_pairs(S, causal, window) * BKV * G
            nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() + lse.numel() * 4
            t_ops = flops / PEAK_BF16_FLOPS * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes")
            print(f"  timed {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"sdpa {library_ms:.4f} ms, bound {out['bound_ms']:.4f} ms "
                  f"({out['bound_by']}: {flops:.4g} flop, {nbytes:.4g} B)")
    return out


def phase_paged(torch, fa):
    print("[3b] paged_decode (replaces flash_attention.py:_paged_kernel) against its plain version")
    rng = torch.Generator().manual_seed(2)
    gen = torch.Generator(device="cuda").manual_seed(3)
    KV, G, hd, ps, table_w, n_pages = 3, 3, 64, 16, 37, 1024
    cases = [  # (B, dtype, window, min and max length); the first is the main path's
        (16, torch.bfloat16, 0, 512, 584),  # shape, lengths as its decode spans see them
        (16, torch.bfloat16, 100, 1, 584),
        (4, torch.float32, 0, 1, 200),
    ]
    out = {}
    for B, dt, window, min_len, max_len in cases:
        lengths = torch.randint(min_len, max_len + 1, (B,), generator=rng, dtype=torch.int32)
        lengths[0] = max_len
        table = torch.zeros((B, table_w), dtype=torch.int32)
        free = (torch.randperm(n_pages - 1, generator=rng) + 1).tolist()
        for b in range(B - 1):  # the last slot stays null-padded (an idle slot)
            n = -(-int(lengths[b]) // ps)
            table[b, :n] = torch.tensor([free.pop() for _ in range(n)], dtype=torch.int32)
        lengths[B - 1] = 1
        q = torch.randn((B, KV, G, hd), generator=gen, device="cuda").to(dt)
        kp = torch.randn((n_pages, ps, KV, hd), generator=gen, device="cuda").to(dt)
        vp = torch.randn((n_pages, ps, KV, hd), generator=gen, device="cuda").to(dt)
        table, lengths = table.cuda(), lengths.cuda()
        o = fa._paged_decode_cuda(q, kp, vp, table, lengths, window=window)
        o_ref = fa._paged_decode_plain(q, kp, vp, table, lengths, window=window)
        torch.cuda.synchronize()
        tag = f"{str(dt)[6:]} B={B} window={window} lengths {min_len}..{max_len}"
        err = check(f"{tag} out", (o.float() - o_ref.float()).abs().max().item(),
                    1e-5 if dt == torch.float32 else 2e-2)
        if not out:
            ms = time_ms(torch, lambda: fa._paged_decode_cuda(q, kp, vp, table, lengths,
                                                              window=window))
            plain_ms = time_ms(torch, lambda: fa._paged_decode_plain(q, kp, vp, table, lengths,
                                                                     window=window))
            lens = lengths.cpu().tolist()
            lo = [max(0, n - window) if window else 0 for n in lens]
            positions = sum(n - a for n, a in zip(lens, lo))
            nbytes = (positions * KV * hd * 2 * kp.element_size()   # K and V rows read
                      + 2 * q.numel() * q.element_size()             # q in, out
                      + sum(-(-n // ps) - a // ps for n, a in zip(lens, lo)) * 4 + B * 4)
            flops = 4 * hd * G * KV * positions
            t_bytes = nbytes / PEAK_BYTES * 1e3
            t_ops = flops / PEAK_BF16_FLOPS * 1e3
            out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                       bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops > t_bytes else "bytes")
            print(f"  timed {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {out['bound_ms']:.5f} ms ({out['bound_by']}: {nbytes} B, "
                  f"{positions} positions)")
    return out


def phase_agreement(torch, get_config, build_model):
    """Full width, fp32: the kernel path against the plain torch path."""
    print("[4a] full-width fp32 agreement: attn_impl pallas (kernels) vs xla (plain torch)")
    base = get_config("smollm-135m").replace(dtype="float32")
    dev = torch.device("cuda")
    model_k, model_p = build_model(base.replace(attn_impl="pallas")), build_model(base)
    params = model_k.init(torch.Generator(device=dev).manual_seed(0), dev)
    B, P, ps = 2, 45, 16
    tokens = torch.randint(0, base.vocab, (B, P), generator=torch.Generator().manual_seed(5))
    tokens = tokens.to(dev, torch.int32)
    table = torch.arange(1, 1 + B * 4, dtype=torch.int32, device=dev).reshape(B, 4)
    lengths = torch.tensor([P, P - 7], dtype=torch.int32, device=dev)
    with torch.no_grad():
        caches = [m.init_paged_cache(1 + B * 4, ps, dev) for m in (model_k, model_p)]
        lk, _ = model_k.paged_prefill(params, caches[0], tokens, table, lengths)
        lp, _ = model_p.paged_prefill(params, caches[1], tokens, table, lengths)
        assert torch.isfinite(lk).all()
        check("prefill logits", (lk - lp).abs().max().item(), 1e-3)
        tok = torch.argmax(lp[torch.arange(B, device=dev), lengths.long() - 1], -1).int()
        for t in range(3):
            dk, _ = model_k.paged_decode_step(params, caches[0], tok, table, lengths + t,
                                              impl="pallas")
            dp, _ = model_p.paged_decode_step(params, caches[1], tok, table, lengths + t,
                                              impl="xla")
            assert torch.isfinite(dk).all()
            check(f"decode step {t} logits", (dk - dp).abs().max().item(), 1e-3)
            tok = torch.argmax(dp, -1).int()
    del params, caches
    torch.cuda.empty_cache()


def phase_main(torch, fa, get_config, serve):
    print("[4b] main path: repro_torch.launch.serve, smollm-135m full width, bf16, pallas")
    cfg = get_config("smollm-135m").replace(attn_impl="pallas")
    fa.reset_launch_counts()
    results, seconds, engine, model, params = serve(cfg, device="cuda", **MAIN)
    launches = dict(fa.LAUNCHES)
    st = engine.stats
    print(f"  {st}, launches {launches}")
    assert len(results) == MAIN["batch"], sorted(results)
    for rid, toks in results.items():
        assert toks.shape == (MAIN["max_new"],), (rid, toks.shape)
        assert ((toks >= 0) & (toks < cfg.vocab)).all(), rid
    L = cfg.n_layers
    assert launches["flash_fwd"] == L * st["prefill_dispatches"] > 0, (launches, st)
    assert launches["paged_decode"] == L * st["decode_steps"] > 0, (launches, st)
    n_new = MAIN["batch"] * MAIN["max_new"]
    print(f"  generated {n_new} tokens in {seconds:.3f} s ({n_new / seconds:.1f} tok/s)")
    with torch.no_grad():
        prompt = torch.tensor([results["req0"].tolist()], dtype=torch.int32, device="cuda")
        logits, _ = model.forward(params, prompt)
    assert torch.isfinite(logits).all(), "non-finite logits"
    return launches, engine


def phase_profile(torch, engine):
    """Where the time goes: one engine run (16 requests, prompt 512, 16 new
    tokens: one prefill dispatch and two decode spans) under torch.profiler."""
    print("[4c] profile: 16 requests x (512 prompt + 16 new) through the same engine")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Request

    gen = torch.Generator().manual_seed(7)
    reqs = [Request(f"p{i}", tuple(torch.randint(0, engine.model.cfg.vocab, (512,),
                                                 generator=gen).tolist()), 16)
            for i in range(16)]
    engine.run(reqs)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run(reqs)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name if len(e.name) < 70 else e.name[:67] + "..."
            acc = by_name.setdefault(name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us() / 1e3
            acc[1] += 1
    busy = sum(v[0] for v in by_name.values())
    # kernel times are the card's own; the profiler slows the host, so the
    # idle share is taken against the same run's wall time unprofiled
    print(f"  wall {plain_wall_ms:.1f} ms unprofiled ({wall_ms:.1f} ms profiled), device busy "
          f"{busy:.1f} ms: idle {100 * (1 - busy / plain_wall_ms):.1f}% of the unprofiled "
          f"wall, {engine.stats}")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"    {ms:9.3f} ms {100 * ms / plain_wall_ms:5.1f}%  x{n:<6d} {name}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; the port's "
                         "kernels run on the card only")
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model

    t_start = time.perf_counter()
    print("[1] device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card (nvidia-smi name, power.limit): {smi}")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, capability {torch.cuda.get_device_capability(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("fp32 matmul: allow_tf32=False (full fp32); bf16 GEMM "
          "allow_bf16_reduced_precision_reduction="
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")

    print("[2] build")
    report = _build.build(verbose=True)
    for name, r in report.items():
        print(f"  {name}: built in {r['seconds']:.2f} s -> {Path(r['path']).name}")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                print("   ", line.strip())

    flash = phase_flash(torch, fa)
    paged = phase_paged(torch, fa)
    phase_agreement(torch, get_config, build_model)
    launches, engine = phase_main(torch, fa, get_config, serve)
    phase_profile(torch, engine)

    src = "src/repro_torch/kernels/csrc"
    summary = {"kernels": [
        {"name": "flash_fwd", "route": "cuda", "source": f"{src}/flash_fwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:184",
         "launches": launches["flash_fwd"], **flash},
        {"name": "paged_decode", "route": "cuda", "source": f"{src}/paged_decode.cu",
         "replaces": "src/repro/kernels/flash_attention.py:439",
         "launches": launches["paged_decode"], **paged},
    ]}
    print(f"[5] done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
