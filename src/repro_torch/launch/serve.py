"""Serving driver (port of ``repro/launch/serve.py``): paged-KV continuous
batching on one card.

    python -m repro_torch.launch.serve --arch smollm-135m --engine paged --attn-impl pallas

The flags are the reference's, plus ``--device`` (default ``cuda``). One
deliberate difference: ``--attn-impl`` defaults to ``pallas`` here, which on
the card means the hand-written Hopper kernels (flash prefill and paged
decode); ``xla`` is the plain torch path. ``--engine naive`` is not ported
yet (ROADMAP.md). Weights and prompts are random, drawn from seed 0.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.models import build_model
from repro_torch.serving import PagedEngine, Request


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="number of requests (paged: admitted across --slots)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--engine", choices=["naive", "paged"], default="paged",
                    help="paged: continuous batching over the KV page pool; "
                         "naive: not ported yet")
    ap.add_argument("--page-size", type=int, default=16, help="KV slots per page")
    ap.add_argument("--max-pages", type=int, default=128,
                    help="total pages in the pool, incl. reserved null page 0")
    ap.add_argument("--decode-steps-per-dispatch", type=int, default=8,
                    help="tokens decoded per engine dispatch")
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent batch slots of the paged engine")
    ap.add_argument("--attn-impl", default="pallas", choices=["xla", "pallas"],
                    help="attention backend: 'pallas' = the hand-written Hopper "
                         "kernels (default), 'xla' = plain torch")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return ap


def serve(cfg, *, batch: int, prompt_len: int, max_new: int, slots: int, page_size: int,
          max_pages: int, decode_steps_per_dispatch: int, temperature: float = 0.0,
          device="cuda"):
    """Serve ``batch`` random prompts through the paged engine. Returns
    ``(results, seconds, engine, model, params)``; ``seconds`` covers
    ``engine.run`` and ends after a device synchronise."""
    device = torch.device(device)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    gen = torch.Generator().manual_seed(0)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen)
    reqs = [Request(f"req{i}", tuple(row.tolist()), max_new) for i, row in enumerate(prompts)]
    engine = PagedEngine(model, params, slots=slots, page_size=page_size, max_pages=max_pages,
                         decode_steps_per_dispatch=decode_steps_per_dispatch,
                         temperature=temperature, attn_impl=cfg.attn_impl, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    results = engine.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return results, time.perf_counter() - t0, engine, model, params


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.engine == "naive":
        raise NotImplementedError("--engine naive is not ported to repro_torch yet (ROADMAP.md)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    cfg = cfg.replace(attn_impl=args.attn_impl)
    results, dt, *_ = serve(
        cfg, batch=args.batch, prompt_len=args.prompt_len, max_new=args.max_new,
        slots=args.slots, page_size=args.page_size, max_pages=args.max_pages,
        decode_steps_per_dispatch=args.decode_steps_per_dispatch,
        temperature=args.temperature, device=args.device)
    n_new = args.batch * args.max_new
    print(f"[{args.engine}] generated {n_new} tokens in {dt:.2f}s ({n_new/dt:.1f} tok/s)")
    print("sample:", results["req0"][:8].tolist())
    return results


if __name__ == "__main__":
    main()
