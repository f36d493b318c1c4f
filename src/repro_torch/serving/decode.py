"""Device programs of the serving engine (port of ``repro/serving/decode.py``).

Two dispatches cover a request's lifecycle:

* :func:`build_prefill_fn` — one forward pass over an admitted group's
  (padded) prompts that writes the paged KV pool at every prompt position
  and samples each request's first token.
* :func:`build_span_fn` — ``span`` decode steps for all slots per call. The
  reference scans over the steps inside one jitted program; the port loops
  in Python, with tokens, lengths and the page table on the device for the
  whole span: no ``.item()`` or host copy inside the span, so the host
  issues the span's kernels without waiting and copies the ``[span, B]``
  tokens back once, after the span.

Both update the paged pool in place (JAX donates it).
"""
from __future__ import annotations

from typing import Callable

import torch


def sample_tokens(logits: torch.Tensor, gen: torch.Generator | None,
                  temperature: float) -> torch.Tensor:
    """Greedy (temperature 0) or temperature sampling. logits [B, V] -> [B] int32."""
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def build_prefill_fn(model, temperature: float) -> Callable:
    """(params, cache, tokens [N,P], table [N,max_pages], lengths [N], gen)
    -> (cache, first_token [N]); all tensors on the model's device."""

    @torch.no_grad()
    def prefill(params, cache, tokens, page_table, lengths, gen):
        logits, cache = model.paged_prefill(params, cache, tokens, page_table, lengths)
        n = tokens.shape[0]
        rows = torch.arange(n, device=tokens.device)
        last = logits[rows, lengths.long() - 1]  # each row's true last position
        return cache, sample_tokens(last, gen, temperature)

    return prefill


def build_span_fn(model, span: int, temperature: float, impl: str = "xla") -> Callable:
    """(params, cache, tok [B], lengths [B], table [B,max_pages], gen)
    -> (cache, tokens [span, B] on the device).

    Step t consumes the carry token (written at its slot's current
    position), samples the next, and advances every slot's length; slots
    without a live request decode into the null page and their outputs are
    discarded by the host.
    """

    @torch.no_grad()
    def span_fn(params, cache, tok, lengths, page_table, gen):
        toks = []
        for _ in range(span):
            logits, cache = model.paged_decode_step(params, cache, tok, page_table, lengths,
                                                    impl=impl)
            tok = sample_tokens(logits, gen, temperature)
            lengths = lengths + 1
            toks.append(tok)
        return cache, torch.stack(toks)

    return span_fn
