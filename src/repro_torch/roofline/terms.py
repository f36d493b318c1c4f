"""Per-program roofline terms, and the record of a program measured on the card.

:func:`analytic_terms` is the per-plan arithmetic of the reference's
``launch/dryrun.py:_analytic_terms``, the one part of the dry run that needs
no mesh: for a plan kind, a shape and the program's trees it returns the
reference's per-chip ``(flops, hbm_bytes)`` for the same inputs. The
multi-GPU slice's ``dryrun.py`` is to call it. The trees are read for their
shapes and dtypes only: :func:`meta_like` turns a tree of tensors on the
card into one on the ``meta`` device, and :func:`abstract_params` builds a
config's parameters there, so a full-width count allocates nothing.

:func:`card_record` writes one measured program in the reference's dry-run
record schema (the keys ``report.py`` reads), so
``repro_torch.roofline.report`` renders a card's reads as it renders the
reference's dry runs.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.models.common import ModelConfig
from repro_torch.roofline.analysis import (
    PEAK_FLOPS,
    PEAK_FP32_FLOPS,
    RooflineTerms,
    active_params,
    model_flops,
)
from repro_torch.roofline.flops import (
    forward_flops,
    hbm_bytes,
    newton_schulz_flops,
    train_step_flops,
)
from repro_torch.utils.tree import (
    tree_bytes,
    tree_count_params,
    tree_leaves_with_paths,
    tree_map,
)

Tree = Any

KINDS = ("train", "round", "superstep", "sync", "prefill", "decode")
MESH = "h100x1"  # the ``mesh`` of a one-card record


def meta_like(tree: Tree) -> Tree:
    """``tree`` with every tensor replaced by an empty one of its shape and
    dtype on the ``meta`` device."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def abstract_params(cfg: ModelConfig) -> Tree:
    """The parameter tree of ``cfg``, built on the ``meta`` device."""
    from repro_torch.models import build_model

    return build_model(cfg).init(torch.Generator(), torch.device("meta"))


def param_count(cfg: ModelConfig) -> int:
    """The parameter count of ``cfg``, from its init on the ``meta`` device."""
    return tree_count_params(abstract_params(cfg))


def analytic_terms(kind: str, cfg: ModelConfig, params: Tree, *, shape: str | None = None,
                   seq_len: int | None = None, global_batch: int | None = None,
                   inner_state: Tree = None, outer_opt: Tree = None, cache: Tree = None,
                   chips: int = 1, inner_name: str = "muon", n_workers: int = 1,
                   H: int = 1, R: int = 1) -> tuple[float, float]:
    """Per-chip (flops, hbm_bytes) of one program, from the closed-form
    models (:mod:`.flops`).

    ``kind`` is a plan kind of ``KINDS``. The shape is a name of
    ``INPUT_SHAPES`` or an explicit ``seq_len`` and ``global_batch`` (the
    sequences of all K workers together). ``params`` is one replica's tree;
    the training kinds read the state's K-stacked ``inner_state`` and
    ``outer_opt``, ``decode`` the decode ``cache`` (a dense ``init_cache``
    of ``global_batch`` x ``seq_len``). ``n_workers`` is K, ``H`` the inner
    steps of a round and ``R`` the rounds of a superstep (1 for any other
    kind, as the reference's plans carry it)."""
    if kind not in KINDS:
        raise ValueError(f"unknown plan kind {kind!r}; one of {KINDS}")
    if shape is not None:
        spec = INPUT_SHAPES[shape]
        S, Bg = spec.seq_len, spec.global_batch
    elif seq_len is None or global_batch is None:
        raise ValueError("analytic_terms: give a shape name or seq_len and global_batch")
    else:
        S, Bg = seq_len, global_batch
    if R != 1 and kind != "superstep":
        raise ValueError(f"R = {R} rounds a dispatch applies to kind 'superstep', not {kind!r}")
    pbytes = tree_bytes(params)
    act_elt = 2.0  # bf16 activations
    d_ff_active = cfg.d_ff * (cfg.experts_per_token + cfg.n_shared_experts) if cfg.n_experts else cfg.d_ff
    per_tok_layer = (8.0 * cfg.d_model + 2.0 * d_ff_active) * act_elt

    if kind in ("train", "round", "superstep"):
        sf = train_step_flops(cfg, S, Bg, params, inner_name)
        # optimizer state per chip: m (+v for adamw / embeds)
        opt_bytes = tree_bytes(inner_state)
        act_bytes = Bg * S * cfg.n_layers * per_tok_layer
        # each worker's params are fully sharded within its pod (chips/K chips)
        chips_per_worker = chips / max(n_workers, 1)
        total_bytes = hbm_bytes("train", param_bytes_chip=pbytes / chips_per_worker,
                                opt_state_bytes_chip=opt_bytes / chips,
                                act_bytes_chip=act_bytes / chips)
        if kind in ("round", "superstep"):
            # the fused round = H inner steps + one sync (elementwise terms);
            # a superstep is R such rounds in one dispatch
            n = tree_count_params(params)
            sync_flops = 10.0 * n * 3.0
            sync_bytes = hbm_bytes("sync", param_bytes_chip=pbytes / chips * 4.0,
                                   opt_state_bytes_chip=tree_bytes(outer_opt) / chips,
                                   act_bytes_chip=0.0)
            return (R * (sf.total * H + sync_flops) / chips,
                    R * (total_bytes * H + sync_bytes))
        return sf.total / chips, total_bytes
    if kind == "sync":
        n = tree_count_params(params)
        flops = 10.0 * n * 3.0  # EF/compress + nesterov + reset, elementwise
        total_bytes = hbm_bytes("sync", param_bytes_chip=pbytes / chips * 4.0,
                                opt_state_bytes_chip=tree_bytes(outer_opt) / chips,
                                act_bytes_chip=0.0)
        return flops / chips, total_bytes
    if kind == "prefill":
        f = forward_flops(cfg, S, Bg)
        act_bytes = Bg * S * cfg.n_layers * per_tok_layer
        total_bytes = hbm_bytes("prefill", param_bytes_chip=pbytes / chips,
                                opt_state_bytes_chip=0.0, act_bytes_chip=act_bytes / chips)
        return f / chips, total_bytes
    # decode
    f = forward_flops(cfg, S, Bg, T=1, kv_len=S)
    cache_bytes = tree_bytes(cache)
    act_bytes = Bg * cfg.n_layers * per_tok_layer
    total_bytes = hbm_bytes("decode", param_bytes_chip=pbytes / chips,
                            opt_state_bytes_chip=0.0, act_bytes_chip=act_bytes / chips,
                            cache_bytes_chip=cache_bytes / chips)
    return f / chips, total_bytes


def newton_schulz_part(params: Tree, inner_name: str) -> float:
    """The Newton-Schulz share of ``flops.optimizer_flops`` (one step, one
    replica): the iterations alone, without the Muon leaves' elementwise
    6 x size and the AdamW leaves."""
    from repro_torch.optim.muon import muon_label

    if inner_name not in ("muon", "muon_bp", "normuon"):
        return 0.0
    total = 0.0
    for path, leaf in tree_leaves_with_paths(params):
        if muon_label(path, leaf) == "muon":
            *batch, m, n = leaf.shape
            nb = 1
            for d in batch:
                nb *= int(d)
            total += nb * newton_schulz_flops(int(m), int(n))
    return total


def card_record(*, arch: str, shape: str, plan: str, kind: str, cfg: ModelConfig,
                params: Tree, flops: float, hbm: float, tokens: float, seconds: float,
                setup_s: float, argument_bytes: int, alias_bytes: int, peak_bytes: int,
                wire_bytes: float = 0.0, inner: str | None = None, ns_flops: float = 0.0,
                forward_tokens: float = 0.0, card: str = "") -> dict:
    """One measured program in the reference's dry-run record schema.

    The model FLOPs are ``model_flops(kind, N_active, tokens)`` plus a
    forward's 2 N_active over ``forward_tokens``: the tokens of an eval batch
    that a captured round folds in (``flops`` and ``hbm`` then hold that
    forward's terms too).

    The keys ``report.py`` reads keep their meaning where one card has a
    counterpart; where it has none, a measured value stands in:

    * ``mesh`` is :data:`MESH`, ``chips`` 1;
    * ``compile_s``: ``setup_s``, the seconds of the CUDA-graph capture
      (the warm-up round or span that precedes it runs eagerly apart);
    * ``memory``: ``argument_bytes`` the program's inputs at rest (a round's
      training state; a decode step's weights and paged pool),
      ``alias_bytes`` and ``output_bytes`` what it updates in place (the
      state; the cache), ``temp_bytes`` the measured peak of
      ``torch.cuda.max_memory_allocated`` (``peak_bytes``) less the
      arguments, ``peak_per_chip_gib`` that peak;
    * ``collectives``: 0 (no collective runs on one card); the pseudogradient
      ``wire_bytes`` of the round's sync go to the wire term;
    * ``hlo_cost_analysis`` and ``collectives_uncorrected`` (XLA's) are left
      out.

    ``measured`` holds what the reference's records cannot: ``seconds`` (the
    program's measured time), the model FLOPs utilisation (model FLOPs over
    ``seconds`` x the bf16 peak), the roofline share (max(compute_s,
    memory_s) / ``seconds``), the compute term with the Newton-Schulz part
    (``ns_flops``) priced at the fp32 CUDA-core peak and the rest at bf16
    (the port's ``ns_impl='pallas'`` iterates Newton-Schulz in fp32, where
    the reference's single-peak term prices every operation at bf16), and
    the card (nvidia-smi's name and power limit)."""
    n = tree_count_params(params)
    n_active = active_params(cfg, n)
    terms = RooflineTerms(flops=flops, hlo_bytes=hbm, collective_bytes=0.0, chips=1,
                          model_flops=(model_flops(kind, n_active, tokens)
                                       + model_flops("prefill", n_active, forward_tokens)),
                          wire_bytes=wire_bytes)
    t = terms.as_dict()
    return {
        "arch": arch, "shape": shape, "plan": plan, "mesh": MESH, "chips": 1, "inner": inner,
        "status": "ok", "compile_s": round(setup_s, 1), "n_params": n,
        "n_active_params": n_active,
        "memory": {"argument_bytes": int(argument_bytes), "output_bytes": int(alias_bytes),
                   "temp_bytes": max(int(peak_bytes) - int(argument_bytes), 0),
                   "alias_bytes": int(alias_bytes),
                   "peak_per_chip_gib": round(peak_bytes / 2**30, 3)},
        "collectives": {"total": 0, "flat_total": 0},
        "roofline": t,
        "measured": {
            "seconds": seconds,
            "mfu": t["model_flops"] / (seconds * PEAK_FLOPS),
            "roofline_share": max(t["compute_s"], t["memory_s"]) / seconds,
            "compute_fp32_ns_s": (flops - ns_flops) / PEAK_FLOPS + ns_flops / PEAK_FP32_FLOPS,
            "card": card,
        },
    }
