"""Child process of tests/test_torch_engine.py's mesh worlds (not a test
file): one rank of a gloo world on the CPU. It imports torch and the port
only.

    RANK=r WORLD_SIZE=n MASTER_ADDR=localhost MASTER_PORT=p \
        python tests/_torch_mesh_harness.py

World of 2 ranks: every kernel's plain version routed through
``kernels/partition.py`` on the (pod=2) mesh, bitwise against the one-process
call on the whole tensor; one reduced smollm round (K = 2, H = 2, 2-bit
quantized pseudogradients with error feedback) on ``2x1x1`` against the
one-process engine, bitwise; two rounds each of streaming (J = 2, 2-bit
row-wise EF), elastic drops (a drop schedule, 2-bit EF) and a sync delay
of 1 on ``2x1x1``, bitwise; the train CLI with ``--mesh 2x1x1`` against the
one-process CLI, plain, with in-program checkpoints (the files byte for
byte, then loaded back under the state's specs) and as the NaN drill
(``metrics.csv`` less ``wall_s``); a paged decode span on a (data=2) mesh
against one process. World of 4 ranks: the kernels on (pod=2, data=2), the
round on ``2x2x1`` and on the no-pod ``2x2`` against one process at the
tolerance of ``test_compressed_round_matches_reference``, and the Muon and
AdamW DP baselines (``dp_engine(..., mesh=)``) on the (data=2, model=2)
mesh within :data:`DP_TOL`.

``MESH_TP=1`` (a world of 2 ranks): tensor parallelism over 'model' on the
1x2 mesh (``core/collectives.py``): the narrow dense LM of
:data:`TP_CFG` against one process within :data:`TP_TOL` (plain, streaming,
elastic drops, a sync delay, the DP baseline) and its planted faults outside
it, streaming on the 2-bit EF wire within :data:`TP_WIRE_TOL`, each rank's
block shapes, a config that does not split (bitwise the whole-worker
round), the checkpoint / resume and NaN drills through the CLI, what raises
by name; and Newton-Schulz's stack split over 'data' on (data = 2), bitwise
the same mesh with ``ns_axes=()``.

``MESH_DRILL=kill`` / ``MESH_DRILL=resume`` (worlds of 2 ranks started one
after the other): the train CLI on ``2x1x1`` with ``--inject-kill-round 1``
(every rank dies by SIGKILL), then ``--resume auto`` in a new world, whose
``metrics.csv`` less ``wall_s`` and final outer params rank 0 holds against
the uninterrupted one-process run.

Rank 0 prints one JSON object of verdicts on its last stdout line; every
check that raises is recorded with its error.
"""
import json
import os
import sys
import traceback

import numpy as np
import torch

torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate  # noqa: E402

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core import CompressionConfig, DiLoCoConfig  # noqa: E402
from repro_torch.core.faults import FaultPlan  # noqa: E402
from repro_torch.core import wire  # noqa: E402
from repro_torch.data import DataConfig, MarkovStream  # noqa: E402
from repro_torch.engine import TrainEngine, dp_engine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    gqa_flash_attention,
    paged_decode_attention,
)
from repro_torch.kernels.partition import kernel_partitioning  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.sharding import kernel_specs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import OptimizerConfig  # noqa: E402
from repro_torch.utils.tree import tree_leaves_with_paths, tree_map  # noqa: E402

RANK = int(os.environ["RANK"])
WORLD = int(os.environ["WORLD_SIZE"])
DRILL = os.environ.get("MESH_DRILL")


def rng(seed):
    return np.random.default_rng(seed)


def normal(seed, *shape):
    return torch.from_numpy(rng(seed).standard_normal(shape).astype(np.float32))


def replicated(mesh, t):
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def whole(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def blocks(x) -> list:
    """The local shape of a routed output (shows the kernel ran on a block)."""
    return list(x.to_local().shape) if isinstance(x, DTensor) else list(x.shape)


# ---------------------------------------------------------------------------
# Kernels through the partition
# ---------------------------------------------------------------------------


def kernel_cases():
    """name -> (fn(*inputs), inputs): each public wrapper on whole inputs."""
    B, S, H, KV, hd = 4, 16, 4, 2, 16
    q, k, v = normal(1, B, S, H, hd), normal(2, B, S, KV, hd), normal(3, B, S, KV, hd)
    n_pages, ps, W = 12, 4, 3
    pq = normal(4, 4, H, hd)
    kp, vp = normal(5, n_pages, ps, KV, hd), normal(6, n_pages, ps, KV, hd)
    table = torch.from_numpy(rng(7).integers(1, n_pages, (4, W)).astype(np.int32))
    lengths = torch.tensor([1, 5, 9, 12], dtype=torch.int32)
    x = normal(8, 8, 40)
    th, psi, u = normal(9, 8, 6), normal(10, 8, 6), normal(11, 8, 6)
    codes = torch.from_numpy(rng(12).integers(0, 4, (8, 40)).astype(np.uint8))
    lo, scale = normal(13, 8, 1), normal(14, 8, 1).abs()
    return {
        "flash_fwd": (lambda a, b, c: gqa_flash_attention(a, b, c, causal=True), (q, k, v)),
        "paged_decode": (lambda *a: paged_decode_attention(*a, impl="pallas"),
                         (pq, kp, vp, table, lengths)),
        "matmul_epilogue": (lambda g: ops.ns_orthogonalize(g, iters=2), (normal(15, 6, 8, 12),)),
        "nesterov": (lambda a, b, c: ops.nesterov_update(a, b, c, lr=0.7, momentum=0.9),
                     (th, psi, u)),
        "quantize": (lambda a: ops.quantize_rowwise(a, bits=2), (x,)),
        "quantize_codes": (lambda a: ops.quantize_codes_rowwise(a, bits=2), (x,)),
        "dequantize": (lambda *a: ops.dequantize_rowwise(*a), (codes, lo, scale)),
    }


def flash_grads(parts, mesh):
    """dq, dk, dv (flash_dq / flash_dkv) of gqa_flash_attention through the
    partition (DTensor autograd), against one process."""
    B, S, H, KV, hd = 4, 16, 4, 2, 16
    ins = [normal(21, B, S, H, hd), normal(22, B, S, KV, hd), normal(23, B, S, KV, hd)]
    do = normal(24, B, S, H, hd)

    def grads(routed):
        leaves = [t.clone().requires_grad_(True) for t in ins]
        if routed:
            with kernel_partitioning(parts):
                out = gqa_flash_attention(*(replicated(mesh, t) for t in leaves))
            out = out.to_local()
        else:
            out = gqa_flash_attention(*leaves)
        (out * do).sum().backward()
        return [t.grad for t in leaves]

    return grads(False), grads(True)


def check_kernels(mesh) -> dict:
    parts = kernel_specs(mesh)
    out = {}
    for name, (fn, args) in kernel_cases().items():
        try:
            single = fn(*args)
            with kernel_partitioning(parts):
                routed = fn(*(replicated(mesh, a) for a in args))
            single = single if isinstance(single, tuple) else (single,)
            routed = routed if isinstance(routed, tuple) else (routed,)
            out[name] = {"bitwise": all(torch.equal(whole(r), s) for r, s in zip(routed, single)),
                         "local": blocks(routed[0]), "whole": list(single[0].shape)}
        except Exception:
            out[name] = {"error": traceback.format_exc()[-1500:]}
    try:
        a, b = flash_grads(parts, mesh)
        out["flash_bwd"] = {"bitwise": all(torch.equal(x, y) for x, y in zip(a, b))}
    except Exception:
        out["flash_bwd"] = {"error": traceback.format_exc()[-1500:]}
    return out


# ---------------------------------------------------------------------------
# A training round
# ---------------------------------------------------------------------------

ROUND = dict(K=2, H=2, B=2, S=16)


def round_setup():
    cfg = reduce_config(get_config("smollm-135m")).replace(attn_impl="pallas")
    ccfg = CompressionConfig(kind="quant", bits=2, error_feedback=True)
    dcfg = DiLoCoConfig(n_workers=ROUND["K"], sync_interval=ROUND["H"], inner_name="muon",
                        ns_impl="pallas", outer_kernel=True, compression=ccfg)
    icfg = OptimizerConfig(lr=2e-2, weight_decay=1e-4, schedule="cosine", warmup_steps=1,
                           total_steps=4)
    stream = MarkovStream(DataConfig(vocab=cfg.vocab, seq_len=ROUND["S"],
                                     batch_per_worker=ROUND["B"], n_workers=ROUND["K"], seed=3),
                          "cpu")
    batches = {k: v for k, v in stream.batch_stack(0, ROUND["H"]).items()}
    return cfg, dcfg, icfg, batches


def one_round(mesh=None):
    """(whole state after one round, info) of the engine, on ``mesh`` or in
    one process, from the state made whole from seed 0."""
    cfg, dcfg, icfg, batches = round_setup()
    engine = TrainEngine(build_model(cfg), dcfg, icfg, mesh=mesh)
    state = engine.init(torch.Generator().manual_seed(0), "cpu")
    state, info = engine.step(state, batches)
    return engine.whole_state(state), info, dcfg


def _grid_codes(v: np.ndarray, rows: int, nlevels: int):
    v = v.reshape(rows, -1).astype(np.float64)
    lo = v.min(axis=1, keepdims=True)
    step = (v.max(axis=1, keepdims=True) - lo) / nlevels
    return np.round((v - lo) / np.where(step > 0, step, 1.0)), step


def compare_round(ref, got, dcfg) -> dict:
    """Bitwise, and the compressed-round tolerance of
    test_compressed_round_matches_reference: losses atol 2e-5 + rtol 1e-4;
    Psi's codes equal on >= 99.9% of entries and its values within one
    quantization step; the outer params and momentum within lr (1 + mu)
    steps; the EF residuals within 1.01 times their range over a worker's
    leaf."""
    (rs, ri), (gs, gi) = ref[:2], got[:2]
    bitwise = (torch.equal(ri["loss"], gi["loss"])
               and all(torch.equal(a, b) for (_, a), (_, b) in
                       zip(tree_leaves_with_paths(rs), tree_leaves_with_paths(gs)))
               and all(torch.equal(a, b) for (_, a), (_, b) in
                       zip(tree_leaves_with_paths(ri["psi"]), tree_leaves_with_paths(gi["psi"]))))
    diffs = [(p, float((a.double() - b.double()).abs().max()))
             for (p, a), (_, b) in zip(tree_leaves_with_paths(rs), tree_leaves_with_paths(gs))
             if not torch.equal(a, b)]
    ccfg, K = dcfg.compression, dcfg.n_workers
    nlevels = (1 << ccfg.bits) - 1
    ok = bool(np.allclose(gi["loss"].numpy(), ri["loss"].numpy(), atol=2e-5, rtol=1e-4))
    same = total = 0
    u_r, u_g = dict(tree_leaves_with_paths(rs["outer_opt"]["u"])), dict(
        tree_leaves_with_paths(gs["outer_opt"]["u"]))
    o_r, o_g = dict(tree_leaves_with_paths(rs["outer_params"])), dict(
        tree_leaves_with_paths(gs["outer_params"]))
    e_r, e_g = dict(tree_leaves_with_paths(rs["ef"])), dict(tree_leaves_with_paths(gs["ef"]))
    psi_g = dict(tree_leaves_with_paths(gi["psi"]))
    for path, j in tree_leaves_with_paths(ri["psi"]):
        j, t = j.numpy(), psi_g[path].numpy()
        rows, _ = wire._row_layout(j.shape, ccfg.rowwise, 0)
        tc, _ = _grid_codes(t, rows, nlevels)
        jc, step = _grid_codes(j, rows, nlevels)
        same += int((tc == jc).sum())
        total += j.size
        step = np.broadcast_to(step, (rows, j.size // rows)).reshape(j.shape)
        ok &= bool(np.all(np.abs(t - j) <= 1.001 * step + 1e-9))
        lr_step = dcfg.outer_lr * (1 + dcfg.outer_momentum) * step + 1e-6
        ok &= bool(np.all(np.abs(u_g[path].numpy() - u_r[path].numpy()) <= lr_step))
        ok &= bool(np.all(np.abs(o_g[path].numpy() - o_r[path].numpy()) <= lr_step))
        e, je = e_g[path].numpy().reshape(K, -1), e_r[path].numpy().reshape(K, -1)
        e_step = je.max(axis=1, keepdims=True) - je.min(axis=1, keepdims=True)
        ok &= bool(np.all(np.abs(e - je) <= 1.01 * e_step + 1e-9))
    return {"bitwise": bool(bitwise), "within_tolerance": bool(ok and same / total >= 0.999),
            "codes_same": same / total, "leaves_not_bitwise": len(diffs),
            "first_gap": diffs[0] if diffs else None}


def check_cli(tmp: str) -> dict:
    """``launch/train.py --mesh 2x1x1`` against the one-process CLI: the
    per-round losses and the eval losses, bitwise."""
    from repro_torch.launch.train import build_parser, train

    argv = ["--reduced", "--device", "cpu", "--workers", "2", "--sync-interval", "2",
            "--rounds", "2", "--seq-len", "16", "--batch-per-worker", "2", "--compression",
            "quant", "--bits", "2", "--error-feedback", "--outer-kernel"]
    got = train(build_parser().parse_args(argv + ["--mesh", "2x1x1", "--out",
                                                  os.path.join(tmp, f"mesh{RANK}")]))
    out = {"rounds": len(got["history"])}
    if RANK == 0:
        ref = train(build_parser().parse_args(argv + ["--out", os.path.join(tmp, "one")]))
        out["bitwise"] = ([h["train_loss"] for h in got["history"]]
                          == [h["train_loss"] for h in ref["history"]]
                          and got["losses"] == ref["losses"])
    return out


# ---------------------------------------------------------------------------
# The rest of the trainer on a mesh: streaming, elastic drops, a sync delay,
# the DP baseline, checkpoints and the drills
# ---------------------------------------------------------------------------

# the variants' configs over ``round_setup``'s, and the masks an elastic run
# takes (worker 1 out in round 0, worker 0 in round 1)
VARIANTS = {
    "streaming": dict(streaming_partitions=2, compression=CompressionConfig(
        kind="quant", bits=2, rowwise=True, error_feedback=True)),
    "elastic": dict(elastic=True),
    "delay": dict(sync_delay=1),
}
DROPS = "0:1;1:0"


def variant_rounds(name: str, mesh=None) -> dict:
    """Two rounds of a variant on ``mesh`` or in one process: the whole
    state after each round, the rounds' infos, and (elastic) each round's
    EF residuals of its dropped worker before and after it."""
    import dataclasses

    from repro_torch.core.faults import parse_drop_schedule

    cfg, dcfg, icfg, batches = round_setup()
    dcfg = dataclasses.replace(dcfg, **VARIANTS[name])
    engine = TrainEngine(build_model(cfg), dcfg, icfg, mesh=mesh)
    state = engine.init(torch.Generator().manual_seed(0), "cpu")
    plan = FaultPlan(n_workers=dcfg.n_workers, schedule=parse_drop_schedule(DROPS))
    out = {"states": [], "infos": [], "frozen": []}
    for r in range(2):
        mask = plan.masks(r, 1)[0] if dcfg.elastic else None
        before = tree_map(torch.clone, engine.whole_state(state).get("ef"))
        state, info = engine.step(state, batches, participation=mask)
        whole = engine.whole_state(state)
        if mask is not None:
            k = int(np.argmin(mask))
            out["frozen"].append(all(torch.equal(a[k], b[k]) for (_, a), (_, b) in zip(
                tree_leaves_with_paths(before), tree_leaves_with_paths(whole["ef"]))))
        out["states"].append({k: tree_map(torch.clone, v) for k, v in whole.items()})
        out["infos"].append(info)
    return out


def compare_variant(ref: dict, got: dict) -> dict:
    """Bitwise: every leaf of the whole state after each round, each round's
    losses, Psi, comm_bytes, active_workers and staleness."""
    def same(a, b):
        la, lb = tree_leaves_with_paths(a), tree_leaves_with_paths(b)
        return [p for (p, x), (_, y) in zip(la, lb) if not torch.equal(x, y)] + (
            ["<paths>"] if [p for p, _ in la] != [p for p, _ in lb] else [])

    apart = []
    for r, (rs, gs, ri, gi) in enumerate(zip(ref["states"], got["states"], ref["infos"],
                                             got["infos"])):
        apart += [f"round {r} state {p}" for p in same(rs, gs)]
        apart += [f"round {r} psi {p}" for p in same(ri["psi"], gi["psi"])]
        apart += [f"round {r} {k}" for k in ("loss", "comm_bytes", "active_workers", "staleness")
                  if not torch.equal(ri[k], gi[k])]
    return {"bitwise": not apart, "apart": apart[:5], "frozen": got["frozen"],
            "comm_bytes": [float(i["comm_bytes"]) for i in got["infos"]],
            "active_workers": [float(i["active_workers"]) for i in got["infos"]]}


def check_fault_plan() -> dict:
    """Every rank's masks of one plan (8 rounds, K = 4), gathered."""
    from repro_torch.core.faults import parse_drop_schedule

    plan = FaultPlan(n_workers=4, drop_prob=0.5, schedule=parse_drop_schedule("2:1"), seed=7)
    mine = torch.from_numpy(plan.masks(0, 8))
    every = [torch.empty_like(mine) for _ in range(WORLD)]
    dist.all_gather(every, mine)
    return {"same": all(torch.equal(m, every[0]) for m in every),
            "dropped": int((every[0] == 0).sum())}


def check_variants(mesh) -> dict:
    out = {"fault_plan": guarded(check_fault_plan)}
    for name in VARIANTS:
        ref = variant_rounds(name) if RANK == 0 else None
        got = guarded(variant_rounds, name, mesh)
        out[name] = (compare_variant(ref, got) if RANK == 0 and "error" not in got
                     else got if "error" in got else {})
    return out


# fp32 on the CPU: the two ranks' half-batch gradients summed then halved
# against the whole batch's, one rounding apart per sum. The losses keep
# that (rtol 1e-5); a parameter moves by the optimizer's normalised step,
# where an entry whose gradient nearly cancels turns the rounding into a
# share of a step (AdamW's m / (sqrt(v) + eps), Muon's AdamW leaves): each
# param within 5% of the peak inner LR over the three steps (the CPU read
# 1.4% for AdamW's w_out, 0.13% for Muon's embed; a half-batch gradient
# moves entries by whole steps)
DP_TOL = dict(loss_rtol=1e-5, param_lr_share=0.05)


def dp_rounds(inner: str, mesh=None) -> dict:
    """Three DP steps (``dp_engine``: K = 1, a round one step) of 4 rows x 16
    tokens on ``mesh`` or in one process: losses and the whole params."""
    cfg, _, icfg, _ = round_setup()
    stream = MarkovStream(DataConfig(vocab=cfg.vocab, seq_len=ROUND["S"], batch_per_worker=4,
                                     n_workers=1, seed=5), "cpu")
    engine = dp_engine(build_model(cfg), inner, icfg, mesh=mesh)
    state = engine.init(torch.Generator().manual_seed(0), "cpu")
    losses = []
    for r in range(3):
        state, info = engine.step(state, stream.batch_stack(r, 1))
        losses.append(info["loss"].clone())
    return {"loss": torch.stack(losses), "params": engine.whole_state(state)["outer_params"],
            "lr": icfg.lr}


def check_dp(mesh) -> dict:
    out = {}
    for inner in ("muon", "adamw"):
        ref = dp_rounds(inner) if RANK == 0 else None
        got = guarded(dp_rounds, inner, mesh)
        if RANK != 0 or "error" in got:
            out[inner] = got if "error" in got else {}
            continue
        gaps = [float((a - b).abs().max()) for (_, a), (_, b) in zip(
            tree_leaves_with_paths(ref["params"]), tree_leaves_with_paths(got["params"]))]
        out[inner] = {
            "within": bool(torch.allclose(got["loss"], ref["loss"], rtol=DP_TOL["loss_rtol"],
                                          atol=0.0)
                           and max(gaps) <= DP_TOL["param_lr_share"] * ref["lr"]),
            "loss_gap": float((got["loss"] - ref["loss"]).abs().max()),
            "param_gap": max(gaps), "param_bound": DP_TOL["param_lr_share"] * ref["lr"],
            "bitwise": max(gaps) == 0.0}
    return out


CLI = ["--reduced", "--device", "cpu", "--workers", "2", "--sync-interval", "2",
       "--seq-len", "16", "--batch-per-worker", "2"]
# the crash drills' command (tests/test_torch_recovery.py's _BASE)
DRILL_CLI = CLI + ["--inner", "adamw", "--lr", "4e-3", "--rounds", "3", "--seed", "0",
                   "--checkpoint-every", "1"]


def _rows_sans_wall(path) -> list:
    import csv

    with open(path, newline="") as f:
        return [row[:-1] for row in csv.reader(f)]


def _cli_pair(args: list, tmp: str, name: str) -> tuple:
    """The train CLI with ``args`` on the 2x1x1 mesh (every rank, one --out)
    and, on rank 0, in one process: (mesh run, one-process run | None, the
    two --out directories)."""
    from repro_torch.launch.train import build_parser, train

    mesh_out, one_out = os.path.join(tmp, f"{name}_mesh"), os.path.join(tmp, f"{name}_one")
    got = train(build_parser().parse_args(args + ["--mesh", "2x1x1", "--out", mesh_out]))
    ref = (train(build_parser().parse_args(args + ["--out", one_out])) if RANK == 0 else None)
    return got, ref, mesh_out, one_out


def check_checkpoints(tmp: str) -> dict:
    """In-program checkpoints every round on 2x1x1: each file byte for byte
    the one-process run's; the last loaded back with the state's specs on
    the mesh, its placements ``state_shardings()``' and its leaves the
    mesh run's final whole state."""
    from repro_torch.checkpoint import load_checkpoint

    args = CLI + ["--rounds", "2", "--checkpoint-every", "1", "--checkpoint-in-program",
                  "--compression", "quant", "--bits", "2", "--error-feedback"]
    got, ref, mesh_out, one_out = _cli_pair(args, tmp, "ckpt")
    engine, final = got["engine"], got["engine"].whole_state(got["state"])
    loaded, step = load_checkpoint(os.path.join(mesh_out, "ckpt_2.npz"), engine.abstract_state(),
                                   device="cpu", shardings=engine.state_shardings(),
                                   mesh=engine.mesh)
    out = {"step": step}
    try:
        engine.check_placement(loaded)
        out["placed"] = True
    except ValueError as e:
        out["placed"] = str(e)
    loaded = engine.whole_state(loaded)
    out["loaded_equal"] = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_leaves_with_paths(loaded), tree_leaves_with_paths(final)))
    if RANK == 0:
        files = sorted(f for f in os.listdir(one_out) if f.endswith(".npz"))
        out["files"] = files
        out["bytes_equal"] = files == sorted(f for f in os.listdir(mesh_out)
                                             if f.endswith(".npz")) and all(
            open(os.path.join(one_out, f), "rb").read()
            == open(os.path.join(mesh_out, f), "rb").read() for f in files)
    return out


def check_nan_drill(tmp: str) -> dict:
    """``--health-sentinel on --checkpoint-every 1 --inject-nan-round 1`` on
    2x1x1 against one process: metrics.csv less wall_s, and the rollback."""
    args = DRILL_CLI + ["--health-sentinel", "on", "--health-warmup", "1",
                        "--inject-nan-round", "1"]
    got, ref, mesh_out, one_out = _cli_pair(args, tmp, "nan")
    out = {"telemetry": {k: got["telemetry"][k] for k in ("rollbacks", "skipped_rounds")}}
    if RANK == 0:
        rows = _rows_sans_wall(os.path.join(mesh_out, "metrics.csv"))
        out["csv_equal"] = rows == _rows_sans_wall(os.path.join(one_out, "metrics.csv"))
        out["rounds"] = [r[0] for r in rows[1:]]
    return out


def drill(kind: str, out_dir: str) -> dict:
    """The kill / resume drill's rank: ``kill`` dies at round 1 by SIGKILL
    (returns only if it did not); ``resume`` restarts with ``--resume auto``
    and rank 0 holds the run against the uninterrupted one-process run."""
    from repro_torch.launch.train import build_parser, train

    args = DRILL_CLI + ["--mesh", "2x1x1", "--out", out_dir]
    if kind == "kill":
        train(build_parser().parse_args(args + ["--inject-kill-round", "1"]))
        return {"error": "the kill drill's rank survived its kill round"}
    got = train(build_parser().parse_args(args + ["--resume", "auto"]))
    final = got["engine"].whole_state(got["state"])["outer_params"]
    out = {"rounds": len(got["history"])}
    if RANK == 0:
        one_out = out_dir + "_one"
        ref = train(build_parser().parse_args(DRILL_CLI + ["--out", one_out]))
        rows = _rows_sans_wall(os.path.join(out_dir, "metrics.csv"))
        out["csv_equal"] = rows == _rows_sans_wall(os.path.join(one_out, "metrics.csv"))
        out["rows"] = [r[0] for r in rows[1:]]
        out["outer_equal"] = all(torch.equal(a, b) for (_, a), (_, b) in zip(
            tree_leaves_with_paths(ref["state"]["outer_params"]), tree_leaves_with_paths(final)))
    return out


# ---------------------------------------------------------------------------
# Tensor parallelism over 'model' (MESH_TP=1, a world of 2 ranks)
# ---------------------------------------------------------------------------

# a narrow dense LM in fp32 that splits over 'model' = 2: 2 layers, d 64, 4
# heads of 16 over 2 kv heads, d_ff 128, vocab 256 (QK-norm, post-norms and
# an untied head, the paper ladder's layout), Newton-Schulz through the
# kernel route (fp32 iterations)
TP_CFG = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256)
# the tensor-parallel round against one process (fp32 on the CPU): the
# largest per-step train-loss gap and the largest gap of any outer-param
# leaf after two rounds. The split sums each product over 'model' in
# another order than one process, so neither is bitwise, and AdamW's
# normalised step (Muon's embed, head and norm leaves) turns a nearly
# cancelling gradient's last bits into a share of a step. The sound 1x2
# runs read losses up to 9.5e-7 and params up to 8.4e-5 apart (head); the
# planted faults (the MLP's row-parallel sum skipped; the QK-norm gradients
# not summed) 4.6e-2 / 2.2e-1 and 9.7e-3 / 8.2e-2: each limit is about the
# geometric mean of the sound and the nearer fault reading, ~100x (losses)
# and ~30x (params) from both
TP_TOL = dict(loss=1e-4, param=2.5e-3)
# streaming on the 2-bit EF wire: a code flips wherever a delta sits within
# those gaps of a grid line, a third of a row's range, so no run that sums in
# another order holds TP_TOL (the same command on (data = 2) without tensor
# parallelism reads losses 5.6e-3 apart after two rounds). Held on the
# outer params alone: the sound 1x2 run reads 6.6e-2 (embed), a planted
# fault in the sync's layout (each rank given the other's blocks back after
# the reset) 1.34 (wv); the limit is their geometric mean
TP_WIRE_TOL = dict(loss=float("inf"), param=0.3)
# the checkpoint / resume and NaN drills' command: paper-150m at reduced
# widths (4 heads of 64, MHA, d_ff 512) on the 1x2 mesh
TP_CLI = ["--arch", "paper-150m", "--reduced", "--device", "cpu", "--workers", "2",
          "--sync-interval", "2", "--seq-len", "16", "--batch-per-worker", "2", "--seed", "0"]


def tp_setup(over: dict | None = None):
    import dataclasses

    cfg = reduce_config(get_config("paper-150m")).replace(attn_impl="pallas", **TP_CFG)
    dcfg = DiLoCoConfig(n_workers=2, sync_interval=2, inner_name="muon", ns_impl="pallas",
                        outer_kernel=True)
    dcfg = dataclasses.replace(dcfg, **(over or {}))
    icfg = OptimizerConfig(lr=2e-2, weight_decay=1e-4, schedule="constant")
    stream = MarkovStream(DataConfig(vocab=cfg.vocab, seq_len=16, batch_per_worker=2,
                                     n_workers=dcfg.n_workers, seed=3), "cpu")
    return cfg, dcfg, icfg, stream


def tp_rounds(mesh=None, over: dict | None = None, drops: str | None = None,
              dp: bool = False) -> dict:
    """Two rounds (DP: three steps) of the narrow LM on ``mesh`` or in one
    process: each round's losses, the whole outer params, and each worker
    leaf's block shape on this rank after the rounds."""
    from repro_torch.core.faults import parse_drop_schedule

    cfg, dcfg, icfg, stream = tp_setup(over)
    if dp:  # one worker of 4 rows
        stream = MarkovStream(DataConfig(vocab=cfg.vocab, seq_len=16, batch_per_worker=4,
                                         n_workers=1, seed=5), "cpu")
        engine = dp_engine(build_model(cfg), "muon", icfg, mesh=mesh)
    else:
        engine = TrainEngine(build_model(cfg), dcfg, icfg, mesh=mesh)
    state = engine.init(torch.Generator().manual_seed(0), "cpu")
    plan = (FaultPlan(n_workers=dcfg.n_workers, schedule=parse_drop_schedule(drops))
            if drops else None)
    H = 1 if dp else dcfg.sync_interval
    losses = []
    for r in range(3 if dp else 2):
        mask = plan.masks(r, 1)[0] if plan is not None else None
        state, info = engine.step(state, stream.batch_stack(r * H, H), participation=mask)
        losses.append(info["loss"].clone())
    blocks = {p: list(t.shape) for p, t in tree_leaves_with_paths(state["worker_params"])}
    return {"loss": torch.stack(losses),
            "outer": tree_map(torch.clone, engine.whole_state(state)["outer_params"]),
            "blocks": blocks, "tp": engine.model_group is not None}


def tp_gaps(ref: dict, got: dict, tol: dict) -> dict:
    """The largest loss and outer-param gaps, and whether both are within
    ``tol`` or (a planted fault) either is outside it."""
    gaps = {p: float((a.double() - b.double()).abs().max()) for (p, a), (_, b) in zip(
        tree_leaves_with_paths(ref["outer"]), tree_leaves_with_paths(got["outer"]))}
    worst = max(gaps, key=gaps.get)
    loss = float((ref["loss"].double() - got["loss"].double()).abs().max())
    within = loss <= tol["loss"] and gaps[worst] <= tol["param"]
    return {"loss_gap": loss, "param_gap": gaps[worst], "param_leaf": worst,
            "within": within, "tp": got["tp"]}


def _planted(fault: str):
    """(module, name, stand-in) of a planted tensor-parallel fault."""
    import torch.distributed as dist

    from repro_torch.core import collectives, diloco
    from repro_torch.models import attention, mlp
    from repro_torch.utils.tree import tree_map_with_path

    if fault == "row_sum":  # the MLP's row-parallel partials left unsummed
        return mlp, "reduce_out", lambda x: x
    if fault == "qk_norm":  # QK-norm gradients of the rank's own heads only
        return attention, "shared_weight", lambda w: w

    def swapped(tree, group=None):  # the sync hands each rank the other rank's blocks back
        group = group or collectives.model_group()
        n, r = dist.get_world_size(group), dist.get_rank(group)

        def other(path, x):
            dim = collectives._split(path, x)
            return x if dim is None else x.chunk(n, dim=dim)[n - 1 - r].contiguous()

        return tree_map_with_path(other, tree)

    return diloco, "split_model", swapped


def check_tp_rounds(mesh) -> dict:
    """(a) sound, (b) its two planted faults, (e) streaming (dense, and on
    the 2-bit EF wire beside a planted fault of the sync's layout), elastic
    drops, a sync delay and the DP baseline, each under 1x2 against one
    process; the block shapes of the sound run's workers."""
    wire = VARIANTS["streaming"]
    runs = {"sound": {}, "streaming": {"streaming_partitions": 2}, "elastic": {"elastic": True},
            "delay": {"sync_delay": 1}, "dp": None, "row_sum": {}, "qk_norm": {},
            "streaming_wire": wire, "streaming_wire_swap": wire}
    out = {}
    for name, over in runs.items():
        kw = {"dp": True} if over is None else {
            "over": over, "drops": DROPS if name == "elastic" else None}
        ref = tp_rounds(**kw) if RANK == 0 else None
        fault = {"row_sum": "row_sum", "qk_norm": "qk_norm", "streaming_wire_swap": "swap"}
        patch = _planted(fault[name]) if name in fault else None
        saved = getattr(*patch[:2]) if patch else None
        try:
            if patch:
                setattr(patch[0], patch[1], patch[2])
            got = guarded(lambda: tp_rounds(mesh, **kw))
        finally:
            if patch:
                setattr(patch[0], patch[1], saved)
        if "error" in got:
            out[name] = got
        elif RANK == 0:
            out[name] = tp_gaps(ref, got, TP_WIRE_TOL if over is wire else TP_TOL)
        if name == "sound" and "error" not in got:
            out["blocks"] = got["blocks"]
    return out


def check_ns_split(mesh) -> dict:
    """(c) one round of the reduced smollm (2-bit EF) on (data = 2), Newton-
    Schulz's stack split over 'data' against the same mesh with
    ``ns_axes=()``: every state leaf, the losses and Psi bitwise; the stack
    rows each call ran on."""
    import dataclasses

    cfg, dcfg, icfg, batches = round_setup()
    out = {}
    for name, axes in (("split", ("data",)), ("whole", ())):
        parts = dataclasses.replace(kernel_specs(mesh, cfg), ns_axes=axes)
        rows = []
        local = ops._ns_local

        def recording(g3, *a):
            rows.append(int(g3.shape[0]))
            return local(g3, *a)

        ops._ns_local = recording
        try:
            engine = TrainEngine(build_model(cfg), dcfg, icfg, mesh=mesh, kernel_parts=parts)
            state = engine.init(torch.Generator().manual_seed(0), "cpu")
            state, info = engine.step(state, batches)
        finally:
            ops._ns_local = local
        out[name] = {"state": {k: tree_map(torch.clone, v)
                               for k, v in engine.whole_state(state).items()},
                     "info": info, "rows": sorted(set(rows))}
    same = compare_variant({"states": [out["whole"]["state"]], "infos": [out["whole"]["info"]],
                            "frozen": []},
                           {"states": [out["split"]["state"]], "infos": [out["split"]["info"]],
                            "frozen": []})
    return {"bitwise": same["bitwise"], "apart": same["apart"],
            "rows_split": out["split"]["rows"], "rows_whole": out["whole"]["rows"]}


def check_tp_off(mesh) -> dict:
    """(d) the reduced smollm (one kv head: it does not split over 'model' =
    2) on 1x2 keeps each worker whole on both ranks, bitwise one process."""
    ref = one_round() if RANK == 0 else None
    got = one_round(mesh)
    cfg, dcfg, icfg, _ = round_setup()
    tp = TrainEngine(build_model(cfg), dcfg, icfg, mesh=mesh).model_group is not None
    out = {"tp": tp}
    if RANK == 0:
        out.update(compare_round(ref, got, got[2]))
    return out


def check_tp_cli(tmp: str) -> dict:
    """(f) the train CLI on 1x2 with ``--checkpoint-every 1``, then the same
    command resumed from its ckpt_1 into another directory: round 1's
    metrics row (but wall_s) and the final whole state bitwise the
    uninterrupted run's; ckpt_2 is the whole state (the one-process leaf
    shapes). And the NaN drill under 1x2 against one process: round 1
    rolled back and skipped, the losses within ``TP_TOL``."""
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.launch.train import build_parser, train

    a, b = os.path.join(tmp, "tp_a"), os.path.join(tmp, "tp_b")
    args = TP_CLI + ["--rounds", "2", "--checkpoint-every", "1", "--mesh", "1x2"]
    full = train(build_parser().parse_args(args + ["--out", a]))
    resumed = train(build_parser().parse_args(
        args + ["--out", b, "--resume", os.path.join(a, "ckpt_1.npz")]))
    fa = full["engine"].whole_state(full["state"])
    fb = resumed["engine"].whole_state(resumed["state"])
    out = {"tp": full["engine"].model_group is not None,
           "state_equal": all(torch.equal(x, y) for (_, x), (_, y) in zip(
               tree_leaves_with_paths(fa), tree_leaves_with_paths(fb)))}
    nan = TP_CLI + ["--rounds", "3", "--checkpoint-every", "1", "--inner", "adamw", "--lr",
                    "4e-3", "--health-sentinel", "on", "--health-warmup", "1",
                    "--inject-nan-round", "1"]
    got = train(build_parser().parse_args(nan + ["--mesh", "1x2",
                                                 "--out", os.path.join(tmp, "tp_nan")]))
    out["nan_telemetry"] = {k: got["telemetry"][k] for k in ("rollbacks", "skipped_rounds")}
    if RANK == 0:
        ra, rb = (_rows_sans_wall(os.path.join(d, "metrics.csv")) for d in (a, b))
        out["row_equal"] = ra[2] == rb[1] and len(rb) == 2
        ckpt, _ = load_checkpoint(os.path.join(a, "ckpt_2.npz"),
                                  full["engine"].abstract_state(), device="cpu")
        out["ckpt_whole"] = all(x.shape == y.shape for (_, x), (_, y) in zip(
            tree_leaves_with_paths(ckpt), tree_leaves_with_paths(fa)))
        one = train(build_parser().parse_args(nan + ["--out", os.path.join(tmp, "tp_nan_one")]))
        out["nan_rounds"] = [h["round"] for h in got["history"]]
        out["nan_loss_gap"] = max(abs(x["train_loss"] - y["train_loss"])
                                  for x, y in zip(got["history"], one["history"]))
        out["nan_rounds_one"] = [h["round"] for h in one["history"]]
        out["nan_within"] = out["nan_loss_gap"] <= TP_TOL["loss"]
    return out


def check_tp_raises(mesh) -> dict:
    """(g) what does not run tensor-parallel raises, naming itself:
    ``--inner normuon``."""
    import dataclasses

    cfg, dcfg, icfg, _ = tp_setup()
    try:
        TrainEngine(build_model(cfg), dataclasses.replace(dcfg, inner_name="normuon"), icfg,
                    mesh=mesh)
        return {"normuon": "did not raise"}
    except ValueError as e:
        return {"normuon": str(e)}


def tp_world() -> dict:
    import tempfile

    out = {"rounds": guarded(check_tp_rounds, make_debug_mesh(1, 2))}
    out["ns_split"] = guarded(check_ns_split, make_debug_mesh(2, 1))
    out["off"] = guarded(check_tp_off, make_debug_mesh(1, 2))
    out["raises"] = guarded(check_tp_raises, make_debug_mesh(1, 2))
    with tempfile.TemporaryDirectory() as tmp:
        tmp = [tmp]
        dist.broadcast_object_list(tmp, src=0)
        out["cli"] = guarded(check_tp_cli, tmp[0])
        dist.barrier()
    return out


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def check_serving(mesh) -> dict:
    """A paged decode span (2 slots, span 3) on a (data=2) mesh against one
    process: greedy tokens equal."""
    from repro_torch.serving import PagedEngine, Request

    cfg = reduce_config(get_config("smollm-135m")).replace(attn_impl="pallas")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    specs = [(f"r{i}", tuple(int(t) for t in rng(20 + i).integers(0, cfg.vocab, n)), new)
             for i, (n, new) in enumerate([(6, 8), (3, 7), (5, 9)])]
    kw = dict(slots=2, page_size=4, max_pages=32, decode_steps_per_dispatch=3,
              attn_impl="pallas", device="cpu")
    ref = PagedEngine(model, params, **kw).run([Request(*s) for s in specs])
    eng = PagedEngine(model, params, mesh=mesh, **kw)
    got = eng.run([Request(*s) for s in specs])
    return {"tokens_equal": sorted(got) == sorted(ref)
            and all(np.array_equal(got[r], ref[r]) for r in ref),
            "spans": eng.stats["spans"]}


def guarded(fn, *args) -> dict:
    try:
        return fn(*args)
    except Exception:
        return {"error": traceback.format_exc()[-2500:]}


def main() -> dict:
    import tempfile
    import time

    dist.init_process_group("gloo", init_method="env://", world_size=WORLD, rank=RANK)
    out: dict = {"world": WORLD}
    if os.environ.get("MESH_TP"):
        out["tp"] = tp_world()
        dist.barrier()
        dist.destroy_process_group()
        return out
    if DRILL:
        out[DRILL] = guarded(drill, DRILL, os.environ["MESH_DRILL_OUT"])
        dist.barrier()
        dist.destroy_process_group()
        return out
    laps = out["seconds"] = {}
    t0 = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        laps[name] = round(now - t0[0], 2)
        t0[0] = now

    if WORLD == 2:
        out["kernels"] = guarded(check_kernels, make_debug_mesh(1, 1, pod=2))
        ref = one_round() if RANK == 0 else None
        got = guarded(one_round, make_debug_mesh(1, 1, pod=2))
        out["round_2x1x1"] = (compare_round(ref, got, got[2]) if RANK == 0 and
                              isinstance(got, tuple) else got if isinstance(got, dict) else {})
        lap("round")
        out.update(guarded(check_variants, make_debug_mesh(1, 1, pod=2)))
        lap("variants")
        with tempfile.TemporaryDirectory() as tmp:
            # one directory for every rank: rank 0 writes what every rank reads
            tmp = [tmp]
            dist.broadcast_object_list(tmp, src=0)
            out["cli_2x1x1"] = guarded(check_cli, tmp[0])
            lap("cli")
            out["ckpt_2x1x1"] = guarded(check_checkpoints, tmp[0])
            lap("ckpt")
            out["nan_2x1x1"] = guarded(check_nan_drill, tmp[0])
            lap("nan")
            dist.barrier()
        out["serving_data2"] = guarded(check_serving, make_debug_mesh(2, 1))
        lap("serving")
    else:
        out["kernels"] = guarded(check_kernels, make_debug_mesh(2, 1, pod=2))
        ref = one_round() if RANK == 0 else None
        for name, mesh in (("round_2x2x1", make_debug_mesh(2, 1, pod=2)),
                           ("round_2x2", make_debug_mesh(2, 2))):
            got = guarded(one_round, mesh)
            out[name] = (compare_round(ref, got, got[2]) if RANK == 0 and isinstance(got, tuple)
                         else got if isinstance(got, dict) else {})
        lap("rounds")
        out["dp_data2"] = guarded(check_dp, make_debug_mesh(2, 2))
        lap("dp")
    dist.barrier()
    dist.destroy_process_group()
    return out


if __name__ == "__main__":
    result = main()
    if RANK == 0:
        print(json.dumps(result, default=str))
    sys.stdout.flush()
