"""Device programs of the serving engine (port of ``repro/serving/decode.py``).

Two dispatches cover a request's lifecycle:

* :func:`build_prefill_fn` — one forward pass over an admitted group's
  (padded) prompts that writes the paged KV pool at every prompt position
  and samples each request's first token. It runs eagerly: its shapes
  change with every admission.
* :func:`build_span_fn` — ``span`` decode steps for all slots per call. The
  reference scans over the steps inside one jitted program. The port writes
  the span's steps into static buffers (:func:`span_steps`); on a CUDA
  device it captures them once in a ``torch.cuda.CUDAGraph`` per (slots,
  page-table width) and replays the graph for every later span
  (:class:`CapturedSpan`), so a span costs the host one graph launch and one
  copy of the ``[span, B]`` tokens back. On the CPU the same steps run
  eagerly.

Both update the paged pool in place (JAX donates it). On a mesh,
``kernel_parts`` (``launch/sharding.kernel_specs(mesh, cfg,
plain_whole=True)``) is installed around every step: each rank holds every
slot, and the flash and paged-decode kernels run on the rank's block of
the batch (``kernels/partition.py``), their outputs gathered whole.
"""
from __future__ import annotations

import time
from typing import Callable

import torch


def sample_tokens(logits: torch.Tensor, gen: torch.Generator | None,
                  temperature: float) -> torch.Tensor:
    """Greedy (temperature 0) or temperature sampling. logits [B, V] -> [B] int32.

    Sampling races exponential clocks: ``argmax(p / E)`` with ``E ~ Exp(1)``
    draws index i with probability p_i (what ``torch.multinomial`` does for
    one sample), with no host read, so it runs inside a captured span."""
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        race = torch.empty_like(probs).exponential_(generator=gen)
        return torch.argmax(probs / race, dim=-1).to(torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def build_prefill_fn(model, temperature: float, kernel_parts=None) -> Callable:
    """(params, cache, tokens [N,P], table [N,max_pages], lengths [N], gen)
    -> (cache, first_token [N]); all tensors on the model's device."""
    from repro_torch.kernels.partition import kernel_partitioning

    @torch.no_grad()
    def prefill(params, cache, tokens, page_table, lengths, gen):
        with kernel_partitioning(kernel_parts):
            logits, cache = model.paged_prefill(params, cache, tokens, page_table, lengths)
        n = tokens.shape[0]
        rows = torch.arange(n, device=tokens.device)
        last = logits[rows, lengths.long() - 1]  # each row's true last position
        return cache, sample_tokens(last, gen, temperature)

    return prefill


@torch.no_grad()
def span_steps(model, params, cache, tok: torch.Tensor, lengths: torch.Tensor,
               page_table: torch.Tensor, gen: torch.Generator | None, out: torch.Tensor,
               temperature: float, impl: str = "xla"):
    """The span's decode steps: step t consumes the carry token (written at
    its slot's current position), samples the next into ``out[t]`` and
    advances every slot's length. ``tok``, ``lengths`` and ``page_table``
    are only read, the pool and ``out`` ([span, B] int32) written in place.
    Slots without a live request decode into the null page and their
    outputs are discarded by the host."""
    for t in range(out.shape[0]):
        logits, cache = model.paged_decode_step(params, cache, tok, page_table, lengths,
                                                impl=impl)
        tok = sample_tokens(logits, gen, temperature)
        out[t].copy_(tok)
        lengths = lengths + 1
    return cache


class CapturedSpan:
    """A decode span captured in one CUDA graph on static buffers.

    Built on the span's first call with a new (slots, table width): it runs
    that span for real, eagerly on a side stream (the warm-up: it builds
    the kernels and makes PyTorch's lazy handles), and captures the same
    steps on the same buffers and pool. A capture executes nothing, so the
    pool and the tokens in :attr:`out` are the warm-up span's, exactly one
    real span. :meth:`replay` copies a span's inputs into the static
    buffers, replays, and counts the launches the capture recorded; the
    tokens land in :attr:`out`, on the device.
    """

    def __init__(self, steps: Callable, params, cache, tok, lengths, page_table,
                 gen: torch.Generator | None, span: int, sampled: bool):
        from repro_torch.kernels import _build

        device = tok.device
        self.params, self.cache = params, cache
        self.tok = tok.detach().clone()
        self.lengths = lengths.detach().clone()
        self.page_table = page_table.detach().clone()
        self.out = torch.empty((span, tok.shape[0]), dtype=torch.int32, device=device)
        generators = (gen,) if sampled else ()

        def run():
            return steps(params, cache, self.tok, self.lengths, self.page_table, gen, self.out)

        t0 = time.perf_counter()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        self.warmup_s = time.perf_counter() - t0
        self.graph, _, self.launches, self.capture_s = _build.capture_graph(
            run, device, generators)

    def replay(self, params, cache, tok, lengths, page_table) -> torch.Tensor:
        from repro_torch.kernels import _build

        if params is not self.params or any(cache[k] is not self.cache[k] for k in cache):
            raise ValueError("a captured span replays on the params and the pool it was "
                             "captured on")
        self.tok.copy_(tok)
        self.lengths.copy_(lengths)
        self.page_table.copy_(page_table)
        self.graph.replay()
        _build.add_launch_counts(self.launches)
        return self.out


class SpanFn:
    """``span`` decode steps for all slots per call::

        cache, toks = span_fn(params, cache, tok [B], lengths [B], table [B, W], gen,
                              stats)

    ``toks`` is [span, B] int32 on the device. ``capture`` (default: on a
    CUDA device) runs the span as a CUDA graph, captured once per (slots,
    table width) and kept in :attr:`graphs` (the span and the temperature
    are fixed per ``SpanFn``); ``capture=True`` with tensors on the CPU
    raises. A captured call adds to ``stats`` (when given) one of
    ``captures`` (with its ``warmup_s`` and ``capture_s`` seconds) or
    ``replays``."""

    def __init__(self, model, span: int, temperature: float, impl: str = "xla",
                 capture: bool | None = None, kernel_parts=None):
        self.model, self.span, self.temperature, self.impl = model, span, temperature, impl
        self.capture = capture
        self.kernel_parts = kernel_parts
        self.graphs: dict[tuple[int, int], CapturedSpan] = {}

    def _steps(self, params, cache, tok, lengths, page_table, gen, out):
        from repro_torch.kernels.partition import kernel_partitioning

        with kernel_partitioning(self.kernel_parts):
            return span_steps(self.model, params, cache, tok, lengths, page_table, gen, out,
                              self.temperature, self.impl)

    def captures_on(self, device: torch.device) -> bool:
        on_cuda = device.type == "cuda"
        if self.capture and not on_cuda:
            raise ValueError(f"SpanFn(capture=True) captures CUDA graphs: tensors on {device}")
        return on_cuda if self.capture is None else bool(self.capture)

    def __call__(self, params, cache, tok, lengths, page_table, gen, stats: dict | None = None):
        if not self.captures_on(tok.device):
            out = torch.empty((self.span, tok.shape[0]), dtype=torch.int32, device=tok.device)
            return self._steps(params, cache, tok, lengths, page_table, gen, out), out
        stats = {} if stats is None else stats
        key = (tok.shape[0], page_table.shape[1])
        graph = self.graphs.get(key)
        if graph is not None:
            stats["replays"] = stats.get("replays", 0) + 1
            return cache, graph.replay(params, cache, tok, lengths, page_table)
        graph = CapturedSpan(self._steps, params, cache, tok, lengths, page_table, gen,
                             self.span, sampled=self.temperature > 0)
        self.graphs[key] = graph
        for name, value in (("captures", 1), ("warmup_s", graph.warmup_s),
                            ("capture_s", graph.capture_s)):
            stats[name] = stats.get(name, 0) + value
        return cache, graph.out


def build_span_fn(model, span: int, temperature: float, impl: str = "xla",
                  capture: bool | None = None, kernel_parts=None) -> SpanFn:
    """(params, cache, tok [B], lengths [B], table [B,max_pages], gen)
    -> (cache, tokens [span, B] on the device); see :class:`SpanFn`."""
    return SpanFn(model, span, temperature, impl, capture, kernel_parts)
