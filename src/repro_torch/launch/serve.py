"""Serving driver (port of ``repro/launch/serve.py``): paged-KV continuous
batching or the dense-cache baseline, on one card.

    python -m repro_torch.launch.serve --arch smollm-135m --engine paged --attn-impl pallas

Two engines (``--engine``):

* ``paged`` — ``repro_torch.serving.PagedEngine``: a fixed pool of KV pages
  (``--max-pages`` x ``--page-size``), continuous batching over ``--slots``
  batch slots, one batched prefill per admission, and decode spans of
  ``--decode-steps-per-dispatch`` tokens, each on the card one replay of a
  captured CUDA graph.
* ``naive`` — the lockstep dense-cache loop (:func:`generate`): one batched
  prefill, then one decode step per token against the dense cache (the
  ring buffer with a sliding window).

The flags are the reference's, plus ``--device`` (default ``cuda``). One
deliberate difference: ``--attn-impl`` defaults to ``pallas`` here, which on
the card means the hand-written Hopper kernels (flash prefill and paged
decode); ``xla`` is the plain torch path. Weights and prompts are random,
drawn from seed 0.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.models import build_model
from repro_torch.serving import PagedEngine, Request, naive_generate


def generate(model, params, prompts: torch.Tensor, max_new: int, temperature: float = 0.0,
             context: torch.Tensor | None = None, rng: torch.Generator | None = None,
             batched_prefill: bool = True) -> torch.Tensor:
    """prompts: [B, P] int32 -> tokens [B, P + max_new] (the dense-cache
    path): :func:`repro_torch.serving.naive_generate`."""
    return naive_generate(model, params, prompts, max_new, temperature=temperature,
                          context=context, rng=rng, batched_prefill=batched_prefill)


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
                         "naive: lockstep dense-cache baseline")
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


def random_prompts(vocab: int, batch: int, prompt_len: int) -> torch.Tensor:
    """The served prompts: [batch, prompt_len] token ids drawn from seed 0."""
    return torch.randint(0, vocab, (batch, prompt_len), generator=torch.Generator().manual_seed(0))


def zero_context(cfg, batch: int, device) -> torch.Tensor | None:
    """The reference's request context for the audio and VLM families: zero
    frames or patches [batch, N, d_model] in fp32 (None for the others)."""
    n = {"audio": cfg.n_audio_frames, "vlm": cfg.n_image_tokens}.get(cfg.arch_type)
    if n is None:
        return None
    return torch.zeros((batch, n, cfg.d_model), dtype=torch.float32, device=device)


def requests_for(prompts: torch.Tensor, max_new: int) -> list[Request]:
    """One request ``req<i>`` of ``max_new`` new tokens per prompt row."""
    return [Request(f"req{i}", tuple(row.tolist()), max_new) for i, row in enumerate(prompts)]


def serve(cfg, *, batch: int, prompt_len: int, max_new: int, slots: int = 4,
          page_size: int = 16, max_pages: int = 128, decode_steps_per_dispatch: int = 8,
          temperature: float = 0.0, engine: str = "paged", device="cuda"):
    """Serve ``batch`` random prompts through ``engine``. Returns
    ``(results, seconds, engine, model, params)``: ``results`` maps
    ``req<i>`` to its ``max_new`` generated tokens; ``seconds`` covers the
    engine's run (``PagedEngine.run`` or one :func:`generate` call) and ends
    after a device synchronise; ``engine`` is the PagedEngine (None for the
    naive one). The slot and page options are the paged engine's. The audio
    and VLM families are served the reference's zero context
    (:func:`zero_context`) through the naive engine."""
    device = torch.device(device)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0), device)
    prompts = random_prompts(cfg.vocab, batch, prompt_len)
    paged = None
    if engine == "paged":
        reqs = requests_for(prompts, max_new)
        paged = PagedEngine(model, params, slots=slots, page_size=page_size,
                            max_pages=max_pages,
                            decode_steps_per_dispatch=decode_steps_per_dispatch,
                            temperature=temperature, attn_impl=cfg.attn_impl, device=device)
    elif engine != "naive":
        raise ValueError(f"unknown engine {engine!r}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    if paged is not None:
        results = paged.run(reqs)
    else:
        rng = torch.Generator(device=device).manual_seed(0)
        toks = generate(model, params, prompts.to(device, torch.int32), max_new,
                        temperature=temperature, context=zero_context(cfg, batch, device),
                        rng=rng)
        results = {f"req{i}": row for i, row in
                   enumerate(toks[:, prompt_len:].cpu().numpy().astype(np.int32))}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return results, time.perf_counter() - t0, paged, model, params


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    cfg = cfg.replace(attn_impl=args.attn_impl)
    results, dt, *_ = serve(
        cfg, batch=args.batch, prompt_len=args.prompt_len, max_new=args.max_new,
        slots=args.slots, page_size=args.page_size, max_pages=args.max_pages,
        decode_steps_per_dispatch=args.decode_steps_per_dispatch,
        temperature=args.temperature, engine=args.engine, device=args.device)
    n_new = args.batch * args.max_new
    print(f"[{args.engine}] generated {n_new} tokens in {dt:.2f}s ({n_new/dt:.1f} tok/s)")
    print("sample:", results["req0"][:8].tolist())
    return results


if __name__ == "__main__":
    main()
