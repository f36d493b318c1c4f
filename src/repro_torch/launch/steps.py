"""Step plans: (callable, arguments on the ``meta`` device, specs) per input
shape (port of ``repro/launch/steps.py``).

  train_4k     -> the DiLoCo ``train_step`` (one inner step of every
                  worker), ``sync_step`` (the outer step, every H steps:
                  the cross-pod exchange the paper optimizes), ``round_step``
                  (H steps and the sync, the engine's round program) and
                  ``superstep`` (R rounds a dispatch)
  prefill_32k  -> ``prefill_step`` (full-sequence forward, last logits)
  decode_32k / long_500k -> ``serve_step`` (one token against the cache)

A plan holds its callable, its arguments as tensors on the ``meta`` device
(nothing is allocated, so a 1T-parameter config plans on the CPU), their
specs (``in_shardings``: trees of ``launch.sharding.P``, the reference's
layout rules), and the reference's ``donate`` and ``meta``. The train plans
run through a :class:`repro_torch.engine.TrainEngine` on the mesh, so a
plan and the trainer run the same program: called with arguments placed
by their specs (``place_args``), each rank runs its compute layout under
the mesh's kernel routing and activation rules.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs import INPUT_SHAPES, config_for_shape
from repro_torch.core.diloco import DiLoCoConfig, make_optimizer
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.launch.sharding import (
    P,
    batch_shardings,
    cache_shardings,
    diloco_state_shardings,
    kernel_specs,
    params_shardings,
    replicated,
)
from repro_torch.models import build_model
from repro_torch.models.common import ModelConfig, activation_sharding
from repro_torch.optim import OptimizerConfig
from repro_torch.utils.tree import tree_count_params, tree_map

Tree = Any

# Configs above this many params plan with bf16 params and optimizer state
# (the reference's mixed-precision production policy).
BF16_PARAM_THRESHOLD = 3e10


@dataclasses.dataclass
class StepPlan:
    name: str
    fn: Callable
    args: tuple  # trees of meta tensors
    in_shardings: tuple  # trees of specs, one per argument
    donate: tuple[int, ...]
    meta: dict


def _needs_context(cfg: ModelConfig) -> bool:
    return cfg.arch_type in ("audio", "vlm")


def _context_struct(cfg: ModelConfig, lead: tuple[int, ...]) -> torch.Tensor:
    n = cfg.n_audio_frames if cfg.arch_type == "audio" else cfg.n_image_tokens
    return torch.empty((*lead, n, cfg.d_model), dtype=cfg.compute_dtype, device="meta")


def _meta_ints(*shape: int) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device="meta")


def production_model_config(cfg: ModelConfig, shape: str, seq_len: int | None = None
                            ) -> ModelConfig:
    """The shape's policy (``config_for_shape``), the autotune table's
    attention blocks, blocks clamped to divide the sequence (``seq_len``, or
    the shape's), and bf16 params above ``BF16_PARAM_THRESHOLD`` parameters."""
    from repro_torch.kernels.autotune import tuned_model_config
    from repro_torch.kernels.flash_attention import clamp_block
    from repro_torch.roofline.terms import abstract_params

    cfg = config_for_shape(cfg, shape)
    S = seq_len or INPUT_SHAPES[shape].seq_len
    cfg = tuned_model_config(cfg, S)
    cfg = cfg.replace(attn_block_q=clamp_block(cfg.attn_block_q, S),
                      attn_block_kv=clamp_block(cfg.attn_block_kv, S))
    if tree_count_params(abstract_params(cfg)) > BF16_PARAM_THRESHOLD:
        cfg = cfg.replace(param_dtype="bfloat16")
    return cfg


def default_inner_cfg(cfg: ModelConfig) -> OptimizerConfig:
    state_dtype = "bfloat16" if cfg.param_dtype == "bfloat16" else "float32"
    return OptimizerConfig(lr=1.56e-2, weight_decay=5e-4, schedule="constant",
                           state_dtype=state_dtype)


def tp_friendly(cfg: ModelConfig, mesh) -> bool:
    """Tensor parallelism only pays when heads split across the model axis
    (smollm's 9 heads and whisper's 20 do not split over model = 16)."""
    model_n = mesh_axis_sizes(mesh).get("model", 1)
    if cfg.arch_type == "ssm":
        return cfg.ssm_heads % model_n == 0
    return cfg.n_heads % model_n == 0 and cfg.hd % 2 == 0


def tp_compute(cfg: ModelConfig, mesh) -> tuple[bool, str]:
    """Whether a mesh round splits each worker's compute over 'model'
    (``core/collectives.py``), and why not: the dense LM only, with
    :func:`tp_friendly` heads, kv heads, d_model and d_ff that divide the
    axis. Otherwise every 'model' rank computes each worker whole."""
    model_n = mesh_axis_sizes(mesh).get("model", 1)
    if model_n <= 1:
        return False, "'model' = 1"
    if cfg.arch_type != "dense" or cfg.n_experts:
        return False, (f"the {cfg.arch_type} family has no tensor-parallel compute "
                       "(the dense LM's only)")
    if not tp_friendly(cfg, mesh):
        return False, f"{cfg.n_heads} heads of hd {cfg.hd} do not split over 'model' = {model_n}"
    for name in ("n_kv_heads", "d_model", "d_ff"):
        if getattr(cfg, name) % model_n:
            return False, f"{name} = {getattr(cfg, name)} does not divide over 'model' = {model_n}"
    return True, ""


def activation_rules(mesh, batch_per_worker: int, cfg: ModelConfig,
                     train: bool = True) -> dict[str, P]:
    """Named activation specs installed around every step (the reference's):
    the residual stream and FFN hidden d over 'model', batch over 'data'
    where it divides; MoE buffers d-passthrough; with heads that do not
    divide the model axis, the per-head attention activations whole over
    'model'."""
    sizes = mesh_axis_sizes(mesh)
    dp = "data" if batch_per_worker % sizes.get("data", 1) == 0 else None
    rules = {
        "residual": P(dp, None, "model"),
        "ffn_hidden": P(dp, None, "model"),
        "moe_tokens": P(dp, None, "model"),
        "moe_buffer": P(dp, None, "model"),
        "moe_dispatch": P(dp, None, None, "model"),
    }
    if not tp_friendly(cfg, sizes):
        rules["attn_kv"] = P(dp, None, None, None)
    return rules


# ---------------------------------------------------------------------------
# Train plans
# ---------------------------------------------------------------------------


def _mesh_call(engine, rules: dict, fn: Callable) -> Callable:
    """``fn(state, *batches)`` on the mesh: the state and batches (placed
    DTensors, or whole on a one-rank mesh) taken to the compute layout, then
    ``fn`` under the routing, the mesh's groups, the 'model' axis of a
    tensor-parallel round and the activation rules."""
    def call(state, *batches):
        state = engine.compute_state(state)
        local = [engine.local_batches(b) for b in batches]
        with activation_sharding(rules), engine.mesh_context():
            return fn(state, *local)

    return call


def build_train_plans(arch_cfg: ModelConfig, shape: str, mesh, dcfg: DiLoCoConfig | None = None,
                      rounds_per_dispatch: int = 4, input_shape=None) -> list[StepPlan]:
    """The four train plans; ``input_shape`` (an ``InputShape``) replaces
    the named shape's sizes (a small world's plans in tests)."""
    from repro_torch.core.diloco import inner_step, outer_step
    from repro_torch.engine import TrainEngine
    from repro_torch.engine.superstep import build_superstep_fn

    spec = input_shape or INPUT_SHAPES[shape]
    assert spec.kind == "train"
    sizes = mesh_axis_sizes(mesh)
    cfg = production_model_config(arch_cfg, shape, spec.seq_len)
    model = build_model(cfg)
    dcfg = dcfg or DiLoCoConfig(n_workers=sizes.get("pod", 1), sync_interval=30,
                                inner_name="muon")
    icfg = default_inner_cfg(cfg)
    if dcfg.inner_name == "muon_bp":  # one orthogonalization per sync interval
        icfg = dataclasses.replace(icfg, ns_period=dcfg.sync_interval)
    engine = TrainEngine(model, dcfg, icfg, mesh=mesh)
    opt = make_optimizer(dcfg, icfg)

    state_abs = engine.abstract_state()
    K = dcfg.n_workers
    B = spec.global_batch // K
    S = spec.seq_len
    batch_abs = {"tokens": _meta_ints(K, B, S), "labels": _meta_ints(K, B, S)}
    if _needs_context(cfg):
        batch_abs["context"] = _context_struct(cfg, (K, B))
    tp = tp_friendly(cfg, sizes)
    state_sh = diloco_state_shardings(sizes, state_abs, tensor_parallel=tp)
    batch_sh = batch_shardings(sizes, batch_abs, k_stacked=True)
    rules = activation_rules(sizes, B, cfg, train=True)

    train_step = _mesh_call(engine, rules, lambda st, b: inner_step(model, opt, st, b))
    sync_step = _mesh_call(engine, rules,
                           lambda st: outer_step(dcfg, st, outer=engine.outer))
    round_fn = _mesh_call(engine, rules, lambda st, b: engine._round(st, b))
    H = dcfg.sync_interval
    round_batch_abs = tree_map(lambda b: torch.empty((H, *b.shape), dtype=b.dtype,
                                                     device="meta"), batch_abs)
    round_batch_sh = batch_shardings(sizes, round_batch_abs, k_stacked=True, leading_scan=1)
    R = max(1, rounds_per_dispatch)
    superstep_fn = _mesh_call(engine, rules, build_superstep_fn(engine._round))
    super_batch_abs = tree_map(lambda b: torch.empty((R, *b.shape), dtype=b.dtype,
                                                     device="meta"), round_batch_abs)
    super_batch_sh = batch_shardings(sizes, super_batch_abs, k_stacked=True, leading_scan=2)

    base = {"cfg": cfg, "dcfg": dcfg, "engine": engine}
    return [
        StepPlan("train_step", train_step, (state_abs, batch_abs), (state_sh, batch_sh), (0,),
                 {"kind": "train", "tokens_per_step": spec.global_batch * S, "amortize": 1,
                  **base}),
        StepPlan("sync_step", sync_step, (state_abs,), (state_sh,), (0,),
                 {"kind": "sync", "tokens_per_step": 0, "amortize": dcfg.sync_interval, **base}),
        StepPlan("round_step", round_fn, (state_abs, round_batch_abs),
                 (state_sh, round_batch_sh), (0,),
                 {"kind": "round", "tokens_per_step": spec.global_batch * S * H, "amortize": 1,
                  **base}),
        StepPlan("superstep", superstep_fn, (state_abs, super_batch_abs),
                 (state_sh, super_batch_sh), (0,),
                 {"kind": "superstep", "tokens_per_step": spec.global_batch * S * H * R,
                  "amortize": 1, "rounds_per_dispatch": R, **base}),
    ]


# ---------------------------------------------------------------------------
# Serve plans (prefill / decode)
# ---------------------------------------------------------------------------


def build_serve_plan(arch_cfg: ModelConfig, shape: str, mesh, input_shape=None) -> StepPlan:
    """The prefill or decode plan. On a mesh its callable runs with every
    rank holding the whole batch (the serving engine's layout) and the
    kernels routed on their blocks (``kernel_specs(..., plain_whole=True)``)."""
    from repro_torch.kernels.partition import kernel_partitioning
    from repro_torch.roofline.terms import abstract_params

    spec = input_shape or INPUT_SHAPES[shape]
    sizes = mesh_axis_sizes(mesh)
    cfg = production_model_config(arch_cfg, shape, spec.seq_len)
    model = build_model(cfg)
    params_abs = abstract_params(cfg)
    tp = tp_friendly(cfg, sizes)
    B = spec.global_batch
    # expert-parallel serving pays when there is a batch to amortize the
    # token all-to-all; at B = 1 (long_500k) the FSDP layout wins
    ep = bool(cfg.n_experts) and B >= 32
    params_sh = params_shardings(sizes, params_abs, tensor_parallel=tp, expert_parallel=ep)
    kparts = kernel_specs(mesh, cfg, plain_whole=True)
    rules = activation_rules(sizes, B, cfg, train=False)

    def whole(t):
        from repro_torch.core.collectives import whole as gather

        return gather(t)

    if spec.kind == "prefill":
        tokens = _meta_ints(B, spec.seq_len)
        args: tuple = (params_abs, tokens)
        shards: tuple = (params_sh, batch_shardings(sizes, tokens, k_stacked=False))
        if _needs_context(cfg):
            ctx = _context_struct(cfg, (B,))
            args += (ctx,)
            shards += (batch_shardings(sizes, ctx, k_stacked=False),)

        @torch.no_grad()
        def prefill_step(params, tokens, context=None):
            params, tokens = tree_map(whole, params), whole(tokens)
            kw = {} if context is None else {"context": whole(context)}
            with activation_sharding(rules), kernel_partitioning(kparts):
                return model.prefill(params, tokens, **kw)

        return StepPlan("prefill_step", prefill_step, args, shards, (),
                        {"kind": "prefill", "tokens_per_step": B * spec.seq_len,
                         "amortize": 1, "cfg": cfg})

    cache_abs = model.init_cache(params_abs, B, spec.seq_len)
    cache_sh = cache_shardings(sizes, cache_abs, batch=B)
    token = _meta_ints(B)
    pos = torch.empty((), dtype=torch.int32, device="meta")
    if ep:  # expert-parallel banks: the token buffers move to the experts
        rules["moe_dispatch"] = P(None, "model", None, None)
        rules["moe_buffer"] = P(None, None, "model")

    @torch.no_grad()
    def serve_step(params, cache, token, pos):
        params, cache = tree_map(whole, params), tree_map(whole, cache)
        with activation_sharding(rules), kernel_partitioning(kparts):
            return model.decode_step(params, cache, whole(token), whole(pos))

    return StepPlan("serve_step", serve_step, (params_abs, cache_abs, token, pos),
                    (params_sh, cache_sh, batch_shardings(sizes, token, k_stacked=False),
                     replicated(sizes, pos)), (1,),
                    {"kind": "decode", "tokens_per_step": B, "amortize": 1, "cfg": cfg})


def build_plans(arch_cfg: ModelConfig, shape: str, mesh, **kw) -> list[StepPlan]:
    if INPUT_SHAPES[shape].kind == "train":
        return build_train_plans(arch_cfg, shape, mesh, **kw)
    return [build_serve_plan(arch_cfg, shape, mesh, kw.get("input_shape"))]


def place_args(plan: StepPlan, mesh) -> tuple:
    """The plan's arguments placed on ``mesh`` by its specs: each rank's
    block a meta tensor of its local shape."""
    from repro_torch.launch.sharding import place

    return tuple(place(mesh, a, sh) for a, sh in zip(plan.args, plan.in_shardings))
