"""Serving engines over the dense model family (port of
``repro/serving/engine.py``).

* :class:`PageAllocator` (``serving.paging``) owns a fixed pool of KV pages
  on the host; the device holds the page contents
  (``model.init_paged_cache``), made once per engine and kept across
  ``run`` calls, so the captured spans keep their addresses.
* :class:`Scheduler` admits pending requests into freed batch slots as soon
  as pages are available; its admission check accounts for the worst-case
  remaining growth of every in-flight request, so allocate-on-demand
  (``PageAllocator.ensure``) can never fail mid-span.
* Admitted requests are prefilled in one batched call (``model.paged_prefill``).
* Decode runs ``decode_steps_per_dispatch`` tokens for all active slots per
  call (``decode.build_span_fn``): on the card one replay of a captured CUDA
  graph; the host syncs once per span.
* :func:`naive_generate` is the reference's lockstep dense-cache loop
  (``--engine naive``): one batched prefill (or the token-stepped one), then
  one decode step per token against the dense (or ring) cache.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.serving import decode as _decode
from repro_torch.serving.paging import OutOfPages, PageAllocator, pages_needed

Tree = Any


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request. ``arrival`` is the dispatch step at which the
    request becomes visible to the scheduler (0 = present at start)."""

    rid: str
    tokens: tuple[int, ...]
    max_new: int
    arrival: int = 0

    def __post_init__(self):
        if len(self.tokens) < 1 or self.max_new < 1:
            raise ValueError("request needs >=1 prompt token and max_new >= 1")


@dataclasses.dataclass
class DecodeState:
    """Engine state between dispatches. ``cache`` lives on the device (and is
    updated in place by every dispatch); everything else is host-side."""

    cache: Tree
    tok: np.ndarray        # [B] int32 — each slot's pending (last sampled) token
    lengths: np.ndarray    # [B] int64 — tokens already written to each slot's pages
    owners: list[Request | None]

    @property
    def active(self) -> list[int]:
        return [i for i, o in enumerate(self.owners) if o is not None]


class Scheduler:
    """FIFO admission of pending requests into free batch slots.

    A request is admitted only when the pool can cover its entire worst-case
    footprint (prompt + max_new + one decode span, rounded up to pages) on
    top of the outstanding growth of already-admitted requests. Only the
    prompt pages are allocated up front; decode pages are allocated on
    demand.
    """

    def __init__(self, allocator: PageAllocator, requests: Sequence[Request], span: int):
        self.alloc = allocator
        self.span = span
        self.pending = collections.deque(sorted(requests, key=lambda r: r.arrival))

    def _budget_pages(self, req: Request) -> int:
        return pages_needed(len(req.tokens) + req.max_new + self.span, self.alloc.page_size)

    def _outstanding(self, owners: Sequence[Request | None]) -> int:
        """Pages in-flight requests may still allocate on demand."""
        tot = 0
        for r in owners:
            if r is not None:
                tot += max(0, self._budget_pages(r) - len(self.alloc.pages_for(r.rid)))
        return tot

    def admit(self, state: DecodeState, step: int) -> list[tuple[int, Request]]:
        """Fill free slots from the pending queue; allocates prompt pages."""
        admitted: list[tuple[int, Request]] = []
        for slot, owner in enumerate(state.owners):
            if owner is not None or not self.pending:
                continue
            req = self.pending[0]
            if req.arrival > step:
                break  # FIFO: don't let later arrivals jump the queue
            if self._budget_pages(req) > self.alloc.n_free - self._outstanding(state.owners):
                break
            self.pending.popleft()
            self.alloc.alloc(req.rid, pages_needed(len(req.tokens), self.alloc.page_size))
            state.owners[slot] = req
            admitted.append((slot, req))
        return admitted

    def finish(self, state: DecodeState, slot: int) -> int:
        """Release a finished request's pages and free its slot."""
        req = state.owners[slot]
        state.owners[slot] = None
        return self.alloc.release(req.rid)


class PagedEngine:
    """Paged-KV continuous-batching engine (``--engine paged``).

    ``run(requests)`` drives every request to completion and returns
    ``{rid: np.ndarray[max_new] generated tokens}``. ``stats`` counts the
    last run's prefill dispatches, decode spans and decode steps, and of
    the spans the ``captures`` (each one a real span run eagerly as the
    warm-up, then captured) and ``replays``, with the run's ``capture_s``
    and ``warmup_s`` seconds; ``prefill_s`` and ``span_s`` are the host
    seconds from issuing each prefill dispatch or span to its tokens on the
    host (capture included), the rest of the run's wall is the host's own
    scheduling. ``capture`` (default: on a CUDA device) runs
    the spans as CUDA graphs (``decode.SpanFn``); ``capture=False`` keeps
    them eager on the card. The graphs and the pool are kept across runs:
    a later run with the same page-table width only replays.

    ``mesh`` (a DeviceMesh over the ranks of the process group, the
    reference's axes) or ``kernel_parts`` routes the kernels as the
    reference's ``serving/engine.py`` does: every rank runs the same
    schedule on every slot, and the flash and paged-decode kernels run on
    the rank's block of the batch (slots and their page-table rows over
    'data', the pool whole), their outputs gathered whole. Spans run
    eagerly on a mesh (a collective of gloo, two ranks on one card, cannot
    be captured in a CUDA graph).
    """

    def __init__(self, model, params, *, slots: int = 4, page_size: int = 16,
                 max_pages: int = 64, decode_steps_per_dispatch: int = 8,
                 temperature: float = 0.0, attn_impl: str = "xla",
                 device="cuda", seed: int = 0, capture: bool | None = None,
                 mesh=None, kernel_parts=None):
        if not model.supports_paged_decode:
            raise ValueError(
                f"arch_type {model.cfg.arch_type!r} has no paged decode path; "
                "serve it with --engine naive")
        self.model, self.params = model, params
        self.slots = slots
        self.page_size = page_size
        self.max_pages = max_pages
        self.span = decode_steps_per_dispatch
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        if kernel_parts is None and mesh is not None:
            from repro_torch.launch.sharding import kernel_specs

            kernel_parts = kernel_specs(mesh, model.cfg, plain_whole=True)
        if kernel_parts is not None:
            if capture:
                raise ValueError("a mesh's spans run eagerly: PagedEngine(mesh=..., capture=True)")
            capture = False
        self._prefill = _decode.build_prefill_fn(model, temperature, kernel_parts)
        self.attn_impl = attn_impl
        self._span_fn = _decode.build_span_fn(model, self.span, temperature, impl=attn_impl,
                                              capture=capture, kernel_parts=kernel_parts)
        self._span_fn.captures_on(self.device)  # capture=True off the card raises here
        self._pool = None
        self.stats = self._new_stats()

    @staticmethod
    def _new_stats() -> dict:
        return {"prefill_dispatches": 0, "spans": 0, "decode_steps": 0, "captures": 0,
                "replays": 0, "capture_s": 0.0, "warmup_s": 0.0, "prefill_s": 0.0,
                "span_s": 0.0}

    def launches_per_prefill(self) -> dict[str, int]:
        """Hopper-kernel launches of one prefill dispatch: the flash forward
        once per layer (``attn_impl='pallas'``)."""
        cfg = self.model.cfg
        return {"flash_fwd": cfg.n_layers if cfg.attn_impl == "pallas" else 0}

    def launches_per_span(self) -> dict[str, int]:
        """Hopper-kernel launches of one span (eager, warm-up or replay: a
        replay counts what its capture recorded): ``paged_decode`` once per
        layer per decode step, L x span."""
        L = self.model.cfg.n_layers
        return {"paged_decode": L * self.span if self.attn_impl == "pallas" else 0}

    def launches(self, stats: dict | None = None) -> dict[str, int]:
        """The launches a run with ``stats`` (default: the last run's) makes:
        prefill dispatches x :meth:`launches_per_prefill` + spans (captures +
        replays on the captured path) x :meth:`launches_per_span`."""
        st = self.stats if stats is None else stats
        pre, span = self.launches_per_prefill(), self.launches_per_span()
        return {"flash_fwd": st["prefill_dispatches"] * pre["flash_fwd"],
                "paged_decode": st["spans"] * span["paged_decode"]}

    def _init_state(self) -> DecodeState:
        if self._pool is None:
            self._pool = self.model.init_paged_cache(self.max_pages, self.page_size, self.device)
        else:  # every run starts from the pool a fresh engine has
            for t in self._pool.values():
                t.zero_()
        return DecodeState(
            cache=self._pool,
            tok=np.zeros((self.slots,), np.int32),
            lengths=np.zeros((self.slots,), np.int64),
            owners=[None] * self.slots,
        )

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(self.device)

    def run(self, requests: Sequence[Request]) -> dict[str, np.ndarray]:
        rids = [r.rid for r in requests]
        if len(set(rids)) != len(rids):
            raise ValueError("request ids must be unique")
        sched = Scheduler(PageAllocator(self.max_pages, self.page_size), requests, self.span)
        # static page-table width for this run: the largest footprint any
        # single request can reach
        table_w = max(sched._budget_pages(r) for r in requests)
        state = self._init_state()
        emitted: dict[str, list[int]] = {r.rid: [] for r in requests}
        results: dict[str, np.ndarray] = {}
        self.stats = self._new_stats()
        step = 0

        def _maybe_finish(slot: int) -> None:
            req = state.owners[slot]
            if len(emitted[req.rid]) >= req.max_new:
                results[req.rid] = np.asarray(emitted[req.rid][: req.max_new], np.int32)
                sched.finish(state, slot)

        while sched.pending or state.active:
            admitted = sched.admit(state, step)
            if admitted:
                n = len(admitted)
                pmax = max(len(r.tokens) for _, r in admitted)
                toks = np.zeros((n, pmax), np.int32)
                lens = np.zeros((n,), np.int32)
                for i, (_, r) in enumerate(admitted):
                    toks[i, : len(r.tokens)] = r.tokens
                    lens[i] = len(r.tokens)
                rows = np.stack([sched.alloc.page_table_row(r.rid, table_w) for _, r in admitted])
                t0 = time.perf_counter()
                state.cache, first = self._prefill(
                    self.params, state.cache, self._dev(toks), self._dev(rows),
                    self._dev(lens), self.gen)
                self.stats["prefill_dispatches"] += 1
                first = first.cpu().numpy()
                self.stats["prefill_s"] += time.perf_counter() - t0
                for i, (slot, r) in enumerate(admitted):
                    state.tok[slot] = first[i]
                    state.lengths[slot] = len(r.tokens)
                    emitted[r.rid].append(int(first[i]))
                    _maybe_finish(slot)

            active = state.active
            if active:
                for i in active:
                    sched.alloc.ensure(state.owners[i].rid, int(state.lengths[i]) + self.span)
                table = sched.alloc.page_table(
                    [o.rid if o is not None else None for o in state.owners], table_w)
                t0 = time.perf_counter()
                state.cache, toks = self._span_fn(
                    self.params, state.cache, self._dev(state.tok), self._dev(state.lengths),
                    self._dev(table), self.gen, self.stats)
                self.stats["spans"] += 1
                self.stats["decode_steps"] += self.span
                toks = toks.cpu().numpy()  # [span, B]: the span's one copy to the host
                self.stats["span_s"] += time.perf_counter() - t0
                for i in active:
                    emitted[state.owners[i].rid].extend(toks[:, i].tolist())
                    state.lengths[i] += self.span
                    state.tok[i] = toks[-1, i]
                    _maybe_finish(i)
            elif sched.pending and not admitted:
                if sched.pending[0].arrival <= step:
                    raise OutOfPages(
                        f"request {sched.pending[0].rid!r} needs "
                        f"{sched._budget_pages(sched.pending[0])} pages but the "
                        f"pool has {sched.alloc.n_free} free even when idle — "
                        "raise --max-pages or lower --page-size waste")
            step += 1
        return results


@torch.no_grad()
def naive_generate(model, params, prompts: torch.Tensor, max_new: int,
                   temperature: float = 0.0, context: torch.Tensor | None = None,
                   rng: torch.Generator | None = None,
                   batched_prefill: bool = True) -> torch.Tensor:
    """Dense-cache lockstep serving (``--engine naive``): ``context`` is
    threaded into the cache through ``model.fill_context``, and attention
    families prefill the whole prompt in one dispatch (``batched_prefill``),
    else step the decode path through it token by token. ``rng`` is the
    sampling generator at ``temperature > 0`` (the reference takes a JAX
    key; None draws from torch's default generator).

    prompts [B, P] int32 on the params' device -> tokens [B, P + max_new].
    """
    B, P = prompts.shape
    cache = model.init_cache(params, B, P + max_new)
    if context is not None:
        cache = model.fill_context(params, cache, context)
    out = [prompts[:, t] for t in range(P)]
    if batched_prefill and model.supports_batched_prefill:
        logits, cache = model.prefill_with_cache(params, cache, prompts)
        logits = logits[:, -1]
    else:
        # recurrent-state families: prefill by stepping the decode path
        for t in range(P):
            logits, cache = model.decode_step(params, cache, prompts[:, t], t)
    tok = _decode.sample_tokens(logits, rng, temperature)
    out.append(tok)
    for t in range(P, P + max_new - 1):
        logits, cache = model.decode_step(params, cache, tok, t)
        tok = _decode.sample_tokens(logits, rng, temperature)
        out.append(tok)
    return torch.stack(out, dim=1)
