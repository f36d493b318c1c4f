#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits nonzero:

1. Device: CUDA must be available; prints the card's name and power limit.
2. Build: compiles every kernel of the serving and training paths from
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
5. The training kernels against their plain PyTorch versions at the
   training main path's shapes, each timed beside its plain version, its
   bound and, where one PyTorch call computes the same function, that call:
   the flash backward (``flash_dq``, ``flash_dkv``; bf16 and fp32, against
   autograd through the plain forward, and bitwise equal from run to run),
   ``matmul_epilogue`` (fp32, the w_in stack's X X^T and a square stack
   with its epilogue; library: ``torch.baddbmm``), the full Newton-Schulz
   through it, and ``nesterov`` over all 134,515,008 parameters (bitwise
   equal to its plain version).
6. Training: a full-width fp32 agreement check (loss and every gradient
   leaf with attn_impl pallas against xla, then one Muon step through the
   kernel against the plain fp32 Newton-Schulz), then the main path,
   ``repro_torch.launch.train`` in-process with the command in ``TRAIN``
   (smollm-135m full width, MuLoCo, K=2, H=4, 3 rounds, 8 x 1024 tokens
   per worker step, every kernel switch on, inner lr 3e-3). The launch counters are set to
   0 just before it and read just after, and must equal the port's formula
   (``TrainEngine.launches_per_round``). Losses must be finite and fall
   from the first round to the last. Then one more round under
   torch.profiler: device busy share and the kernels that take the time.
7. Summary: one ``{"kernels": [...]}`` line, then the last line
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

# peak rates of one H100 SXM (NVIDIA data sheet, dense, 700 W); fp32 is the
# CUDA-core (non-tensor) rate
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

MAIN = dict(batch=32, prompt_len=512, max_new=64, slots=16, page_size=16, max_pages=1024,
            decode_steps_per_dispatch=8)
# --lr 3e-3, not the default 2e-2: at the full 49152-token vocabulary the default
# lr's AdamW step moves every entry of the tied embedding by about lr, half its
# init scale, and the eval loss rises at the schedule's peak (round 2); the
# reference does the same at this lr, so the loss-falls check would test the
# hyperparameter, not the port
TRAIN = ["--arch", "smollm-135m", "--inner", "muon", "--outer", "nesterov", "--workers", "2",
         "--sync-interval", "4", "--rounds", "3", "--seq-len", "1024", "--batch-per-worker", "8",
         "--attn-impl", "pallas", "--ns-impl", "pallas", "--outer-kernel", "--seed", "0",
         "--lr", "3e-3", "--out", str(ROOT / "build" / "chip_smoke_train"), "--verbose"]


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


def bound(flops: float, nbytes: float, peak_flops: float) -> dict:
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes")


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


def phase_flash_bwd(torch, fa):
    """[5a] flash_dq and flash_dkv against autograd through the plain forward
    and against their plain versions; bitwise equal from run to run."""
    print("[5a] flash_dq / flash_dkv (replace flash_attention.py:_dq_kernel / _dkv_kernel)")
    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = [  # (B, KV, S, G, dtype, causal, window); the first is the main path's shape
        (8, 3, 1024, 3, torch.bfloat16, True, 0),
        (8, 3, 1024, 3, torch.float32, True, 0),
        (2, 3, 77, 3, torch.float32, True, 0),
        (2, 3, 300, 3, torch.bfloat16, True, 100),
        (2, 1, 96, 4, torch.float32, False, 0),
        (2, 2, 130, 1, torch.float32, True, 0),
    ]
    out = {}
    for B, KV, S, G, dt, causal, window in cases:
        BKV, hd = B * KV, 64
        fp32 = dt == torch.float32
        q, do = (torch.randn((BKV, S, G, hd), generator=gen, device="cuda").to(dt) for _ in "qd")
        k, v = (torch.randn((BKV, S, hd), generator=gen, device="cuda").to(dt) for _ in "kv")
        kw = dict(causal=causal, window=window, scale=1.0 / math.sqrt(hd))
        o, lse = fa._fwd_cuda(q, k, v, **kw)
        dl = torch.sum(do.float() * o.float(), dim=-1)
        args = (q, k, v, do, lse, dl)
        got = fa._bwd_cuda(*args, **kw)
        again = fa._bwd_cuda(*args, **kw)
        plain = (fa._dq_plain(*args, **kw), *fa._dkv_plain(*args, **kw))
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o_ref, _ = fa._fwd_plain(*leaves, **kw)
        auto = torch.autograd.grad(o_ref, leaves, do)
        torch.cuda.synchronize()
        tag = f"{str(dt)[6:]} q{[BKV, S, G, hd]} causal={causal} window={window}"
        assert all(torch.equal(a, b) for a, b in zip(got, again)), f"{tag}: not deterministic"
        errs = {}
        for name, g, p, a in zip(("dq", "dk", "dv"), got, plain, auto):
            scale = max(1.0, p.float().abs().max().item())
            # fp32: summation order only; bf16: ~2.5 ulps of the largest gradient
            tol = (1e-5 if fp32 else 1e-2) * scale
            errs[name] = check(f"{tag} {name} vs plain", (g.float() - p.float()).abs().max().item(),
                               tol)
            check(f"{tag} {name} vs autograd", (g.float() - a.float()).abs().max().item(), tol)
        print(f"  {tag}: bitwise equal over two runs")
        if out:
            continue
        # the main path's shape: time each kernel, its plain version, the bound
        pairs = sum(hi - lo for lo, hi in (
            (max(0, i - window + 1) if window else 0, i + 1 if causal else S) for i in range(S)))
        rows = BKV * G * pairs
        io = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size() \
            + 2 * lse.numel() * 4  # q, do, k, v read; lse, dl read
        dq_ms = time_ms(torch, lambda: fa._dq_cuda(*args, **kw))
        dkv_ms = time_ms(torch, lambda: fa._dkv_cuda(*args, **kw))
        dq_plain = time_ms(torch, lambda: fa._dq_plain(*args, **kw), runs=5)
        dkv_plain = time_ms(torch, lambda: fa._dkv_plain(*args, **kw), runs=5)
        # library: SDPA's backward (dq, dk and dv in one call) through autograd
        # with enable_gqa, minus its forward
        qs = q.reshape(B, KV, S, G, hd).permute(0, 1, 3, 2, 4).reshape(B, KV * G, S, hd)
        ks, vs = k.reshape(B, KV, S, hd), v.reshape(B, KV, S, hd)
        dos = do.reshape(B, KV, S, G, hd).permute(0, 1, 3, 2, 4).reshape(B, KV * G, S, hd)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lq, lk, lv = (t.detach().requires_grad_(True) for t in (qs, ks, vs))

        def sdpa_fwd():
            with torch.no_grad():
                sdpa(lq, lk, lv, is_causal=True, enable_gqa=True)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(lq, lk, lv, is_causal=True, enable_gqa=True),
                                (lq, lk, lv), dos)

        lib_ms = time_ms(torch, sdpa_fwd_bwd) - time_ms(torch, sdpa_fwd)
        out["flash_dq"] = dict(max_abs_err=errs["dq"], ms=dq_ms, plain_ms=dq_plain,
                               library_ms=lib_ms,
                               **bound(6 * hd * rows, io + q.numel() * q.element_size(),
                                       PEAK_BF16_FLOPS))
        out["flash_dkv"] = dict(max_abs_err=max(errs["dk"], errs["dv"]), ms=dkv_ms,
                                plain_ms=dkv_plain, library_ms=lib_ms,
                                **bound(8 * hd * rows, io + 2 * k.numel() * k.element_size(),
                                        PEAK_BF16_FLOPS))
        for name in ("flash_dq", "flash_dkv"):
            r = out[name]
            print(f"  timed {name} {tag}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}), sdpa backward "
                  f"(dq, dk, dv) {lib_ms:.4f} ms; {pairs} causal pairs per head")
    return out


def phase_matmul(torch, mm, ops, ref):
    """[5b] matmul_epilogue in fp32 at the Newton-Schulz shapes, then the
    full Newton-Schulz of the w_in stack through it."""
    print("[5b] matmul_epilogue (replaces matmul.py:_matmul_epilogue_kernel), fp32, TF32 off")
    gen = torch.Generator(device="cuda").manual_seed(12)
    g = torch.randn((30, 576, 1536), generator=gen, device="cuda")
    x = g / torch.sqrt(torch.sum(g * g, dim=(-2, -1), keepdim=True))  # NS's first input
    a_sq = torch.randn((30, 576, 576), generator=gen, device="cuda") / 24.0
    cases = [  # (name, a, b, d, alpha, beta); the first is the one timed
        ("X X^T, w_in stack [30, 576, 1536]", x, x.transpose(-1, -2), None, 1.0, 0.0),
        ("c A A + b A, [30, 576, 576]", a_sq, a_sq, a_sq, 2.0315, -4.7750),
        ("B X + a X, [30, 576, 576] x [30, 576, 1536]", a_sq, x, x, 1.0, 3.4445),
        ("ragged [3, 77, 50] x [3, 50, 33]", g[:3, :77, :50], g[:3, :50, :33],
         g[:3, 100:177, 7:40], 0.5, -2.0),
    ]
    out = {}
    for name, a, b, d, alpha, beta in cases:
        c = mm.matmul_epilogue(a, b, d, alpha=alpha, beta=beta)
        cp = mm._matmul_plain(a, b, d, alpha=alpha, beta=beta, out_dtype=a.dtype)
        torch.cuda.synchronize()
        # fp32 summation order only: 1e-5 of the largest output
        err = check(name, (c - cp).abs().max().item(), 1e-5 * max(1.0, cp.abs().max().item()))
        if out:
            continue
        z, m, k = a.shape
        n = b.shape[-1]
        ms = time_ms(torch, lambda: mm.matmul_epilogue(a, b, d, alpha=alpha, beta=beta))
        plain_ms = time_ms(torch, lambda: mm._matmul_plain(a, b, d, alpha=alpha, beta=beta,
                                                          out_dtype=a.dtype))
        dst = torch.empty((z, m, n), device="cuda")
        library_ms = time_ms(torch, lambda: torch.baddbmm(dst, a, b, beta=0.0, alpha=alpha))
        # X is read once (A and B are the same tensor), C written once
        out = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   **bound(2.0 * z * m * n * k, (a.numel() + z * m * n) * 4, PEAK_FP32_FLOPS))
        print(f"  timed {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, baddbmm "
              f"{library_ms:.4f} ms, bound {out['bound_ms']:.4f} ms ({out['bound_by']}, "
              f"{2.0 * z * m * n * k:.4g} flop at 67 TFLOP/s fp32)")
    y = ops.ns_orthogonalize(g)
    y_ref = ref.ns_orthogonalize_ref(g)
    torch.cuda.synchronize()
    check("full Newton-Schulz, w_in stack, kernel vs plain fp32", (y - y_ref).abs().max().item(),
          1e-5)
    ns_ms = time_ms(torch, lambda: ops.ns_orthogonalize(g), runs=5)
    ns_plain = time_ms(torch, lambda: ref.ns_orthogonalize_ref(g), runs=5)
    print(f"  timed full Newton-Schulz (15 launches) of the w_in stack: kernel {ns_ms:.3f} ms, "
          f"plain {ns_plain:.3f} ms")
    return out


def phase_nesterov(torch, ou):
    """[5c] nesterov over the full parameter count: bitwise equal."""
    print("[5c] nesterov (replaces outer_update.py:_nesterov_kernel) over 134,515,008 fp32")
    n = 134_515_008
    gen = torch.Generator(device="cuda").manual_seed(13)
    theta, psi, u = (torch.randn(n, generator=gen, device="cuda") * s for s in (1.0, 1e-2, 1e-1))
    kw = dict(lr=0.7, momentum=0.9)
    got = ou._nesterov_cuda(theta, psi, u, **kw)
    want = ou._nesterov_plain(theta, psi, u, **kw)
    small = [ou._nesterov_cuda(theta[1:4099], psi[1:4099], u[1:4099], **kw),  # unaligned
             ou._nesterov_plain(theta[1:4099], psi[1:4099], u[1:4099], **kw),
             ou._nesterov_cuda(theta[:4099].bfloat16(), psi[:4099], u[:4099], **kw),
             ou._nesterov_plain(theta[:4099].bfloat16(), psi[:4099], u[:4099], **kw)]
    torch.cuda.synchronize()
    for (a, b), tag in [((got, want), "full, fp32"), ((small[0], small[1]), "unaligned, fp32"),
                        ((small[2], small[3]), "bf16 theta")]:
        assert all(torch.equal(x, y) for x, y in zip(a, b)), f"nesterov {tag}: not bitwise"
        print(f"  {tag}: theta' and u' bitwise equal to the plain version")
    ms = time_ms(torch, lambda: ou._nesterov_cuda(theta, psi, u, **kw))
    plain_ms = time_ms(torch, lambda: ou._nesterov_plain(theta, psi, u, **kw))
    out = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
               **bound(7.0 * n, 5.0 * 4 * n, PEAK_FP32_FLOPS))
    print(f"  timed: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}: {5 * 4 * n} B)")
    return out


def phase_train_agreement(torch, get_config, build_model):
    """[6a] full width, fp32: loss and gradients pallas vs xla, then one Muon
    step through the kernel vs the plain fp32 Newton-Schulz."""
    print("[6a] full-width fp32 training agreement (B=1, S=256)")
    from repro_torch.kernels import ref
    from repro_torch.optim import OptimizerConfig, chain, descend, stateless, trace_momentum
    from repro_torch.optim.muon import muon, muon_mults, muon_partition
    from repro_torch.utils.tree import (tree_leaves, tree_leaves_with_paths, tree_map,
                                       tree_map_with_path)

    base = get_config("smollm-135m").replace(dtype="float32")
    dev = torch.device("cuda")
    model_k, model_p = build_model(base.replace(attn_impl="pallas")), build_model(base)
    params = model_k.init(torch.Generator(device=dev).manual_seed(0), dev)
    toks = torch.randint(0, base.vocab, (1, 257), generator=torch.Generator().manual_seed(6))
    batch = {"tokens": toks[:, :-1].to(dev, torch.int32), "labels": toks[:, 1:].to(dev, torch.int32)}
    paths = []
    tree_map_with_path(lambda p, _: paths.append(p), params)  # tree_leaves' order
    grads = {}
    for name, model in (("pallas", model_k), ("xla", model_p)):
        tree = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = model.loss(tree, batch)
        grads[name] = (loss.detach(), torch.autograd.grad(loss, tree_leaves(tree)))
    (lk, gk), (lp, gp) = grads["pallas"], grads["xla"]
    assert torch.isfinite(lk), lk
    check("loss", abs(lk.item() - lp.item()), 1e-4)
    worst = 0.0
    for path, a, b in zip(paths, gk, gp):
        # fp32 kernels vs plain: summation order, 1e-4 of each leaf's largest entry
        worst = max(worst, check(f"grad {path}", (a - b).abs().max().item(),
                                 1e-4 * max(1e-3, b.abs().max().item())))
    icfg = OptimizerConfig(lr=2e-2, weight_decay=1e-4)
    plain_ns = stateless(lambda u, _p: tree_map(lambda m: ref.ns_orthogonalize_ref(m).float(), u))
    plain_opt = descend(muon_partition(icfg, chain(trace_momentum(icfg), plain_ns)), icfg,
                        muon_mults(icfg))
    it = iter(gk)
    g_tree = tree_map(lambda _: next(it), params)
    new_k, _ = muon(icfg, ns_impl="pallas").step(params, g_tree, muon(icfg).init(params))
    new_p, _ = plain_opt.step(params, g_tree, plain_opt.init(params))
    err = max((a - b).abs().max().item() for (_, a), (_, b) in
              zip(tree_leaves_with_paths(new_k), tree_leaves_with_paths(new_p)))
    # the NS kernel differs from the plain fp32 NS by ~1e-6; the step scales it by lr
    check("one Muon step, kernel NS vs plain fp32 NS, every leaf", err, 1e-6)
    del params, grads, new_k, new_p
    torch.cuda.empty_cache()


def phase_train_main(torch, build_parser, train):
    """[6b] the training main path through the CLI entry point, in-process."""
    from repro_torch.kernels import _build

    print("[6b] main path: repro_torch.launch.train " + " ".join(TRAIN))
    args = build_parser().parse_args(TRAIN)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    out = train(args)
    launches = dict(_build.LAUNCHES)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    engine, state, hist = out["engine"], out["state"], out["history"]
    per_round = engine.launches_per_round(state["outer_params"])
    want = {k: args.rounds * v for k, v in per_round.items()}
    print(f"  launches {launches}")
    print(f"  formula  {want} (rounds x TrainEngine.launches_per_round)")
    assert launches == want, (launches, want)
    for name in ("flash_fwd", "flash_dq", "flash_dkv", "matmul_epilogue", "nesterov"):
        assert launches[name] > 0, name
    tokens = args.workers * args.sync_interval * args.batch_per_worker * args.seq_len
    for rec in hist:
        assert math.isfinite(rec["train_loss"]) and math.isfinite(rec["eval_loss"]), rec
        print(f"  round {rec['round']}: train {rec['train_loss']:.4f}, eval "
              f"{rec['eval_loss']:.4f}, wall {rec['wall_s']:.3f} s "
              f"({tokens / rec['wall_s']:.0f} tok/s)")
    assert hist[-1]["train_loss"] < hist[0]["train_loss"], "train loss did not fall"
    assert hist[-1]["eval_loss"] < hist[0]["eval_loss"], "eval loss did not fall"
    later = hist[1:]
    tok_s = len(later) * tokens / sum(r["wall_s"] for r in later)
    print(f"  training tokens/s over rounds 2-{len(hist)}: {tok_s:.1f} "
          f"({tokens} tokens per round = K*H*B*S, round wall ended by a device sync)")
    print(f"  peak device memory {peak_gb:.2f} GB; final smoothed eval loss "
          f"{out['final_loss']:.4f}")
    return launches, out


def phase_train_profile(torch, out, args_list):
    """[6c] where a training round's time goes: one more round unprofiled,
    then one under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import DataConfig, MarkovStream, batches_for_round
    from repro_torch.launch.train import build_parser

    print("[6c] profile: one more training round of the same run")
    args = build_parser().parse_args(args_list)
    engine, state, model = out["engine"], out["state"], out["model"]
    data = MarkovStream(DataConfig(vocab=model.cfg.vocab, seq_len=args.seq_len,
                                   batch_per_worker=args.batch_per_worker,
                                   n_workers=args.workers, seed=args.seed), "cuda")

    def one_round(r):
        nonlocal state
        state, info = engine.step(state, batches_for_round(data, r, args.sync_interval))
        return float(info["loss"].mean())

    t0 = time.perf_counter()
    one_round(args.rounds)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_round(args.rounds + 1)
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
    print(f"  wall {plain_wall_ms:.1f} ms unprofiled ({wall_ms:.1f} ms profiled), device busy "
          f"{busy:.1f} ms: idle {100 * (1 - busy / plain_wall_ms):.1f}% of the unprofiled wall; "
          f"{sum(v[1] for v in by_name.values())} kernels")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"    {ms:9.3f} ms {100 * ms / plain_wall_ms:5.1f}%  x{n:<6d} {name}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; the port's "
                         "kernels run on the card only")
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import outer_update as ou
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import build_parser, train
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
    del engine
    torch.cuda.empty_cache()

    bwd = phase_flash_bwd(torch, fa)
    matmul = phase_matmul(torch, mm, ops, ref)
    nesterov = phase_nesterov(torch, ou)
    phase_train_agreement(torch, get_config, build_model)
    train_launches, out = phase_train_main(torch, build_parser, train)
    phase_train_profile(torch, out, TRAIN)

    src = "src/repro_torch/kernels/csrc"
    jax_src = "src/repro/kernels"
    summary = {"kernels": [
        {"name": "flash_fwd", "route": "cuda", "source": f"{src}/flash_fwd.cu",
         "replaces": f"{jax_src}/flash_attention.py:184",
         "launches": launches["flash_fwd"], **flash},
        {"name": "paged_decode", "route": "cuda", "source": f"{src}/paged_decode.cu",
         "replaces": f"{jax_src}/flash_attention.py:439",
         "launches": launches["paged_decode"], **paged},
        {"name": "flash_dq", "route": "cuda", "source": f"{src}/flash_bwd.cu",
         "replaces": f"{jax_src}/flash_attention.py:230",
         "launches": train_launches["flash_dq"], **bwd["flash_dq"]},
        {"name": "flash_dkv", "route": "cuda", "source": f"{src}/flash_bwd.cu",
         "replaces": f"{jax_src}/flash_attention.py:254",
         "launches": train_launches["flash_dkv"], **bwd["flash_dkv"]},
        {"name": "matmul_epilogue", "route": "cuda", "source": f"{src}/matmul_epilogue.cu",
         "replaces": f"{jax_src}/matmul.py:47",
         "launches": train_launches["matmul_epilogue"], **matmul},
        {"name": "nesterov", "route": "cuda", "source": f"{src}/outer_update.cu",
         "replaces": f"{jax_src}/outer_update.py:58",
         "launches": train_launches["nesterov"], **nesterov},
    ]}
    print(f"training main path launches of flash_fwd: {train_launches['flash_fwd']} "
          "(the flash_fwd row counts the serving main path's)")
    print(f"[7] done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
