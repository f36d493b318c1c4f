"""Child process of tests/test_torch_engine.py's mesh worlds (not a test
file): one rank of a gloo world on the CPU. It imports torch and the port
only.

    RANK=r WORLD_SIZE=n MASTER_ADDR=localhost MASTER_PORT=p \
        python tests/_torch_mesh_harness.py

World of 2 ranks: every kernel's plain version routed through
``kernels/partition.py`` on the (pod=2) mesh, bitwise against the one-process
call on the whole tensor; one reduced smollm round (K = 2, H = 2, 2-bit
quantized pseudogradients with error feedback) on ``2x1x1`` against the
one-process engine, bitwise; the train CLI with ``--mesh 2x1x1`` against the
one-process CLI; a paged decode span on a (data=2) mesh against one process.
World of 4 ranks: the kernels on (pod=2, data=2), and the round on
``2x2x1`` and on the no-pod ``2x2`` against one process at the tolerance of
``test_compressed_round_matches_reference``.

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
from repro_torch.core import wire  # noqa: E402
from repro_torch.data import DataConfig, MarkovStream  # noqa: E402
from repro_torch.engine import TrainEngine  # noqa: E402
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
from repro_torch.utils.tree import tree_leaves_with_paths  # noqa: E402

RANK = int(os.environ["RANK"])
WORLD = int(os.environ["WORLD_SIZE"])


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

    dist.init_process_group("gloo", init_method="env://", world_size=WORLD, rank=RANK)
    out: dict = {"world": WORLD}
    if WORLD == 2:
        out["kernels"] = guarded(check_kernels, make_debug_mesh(1, 1, pod=2))
        ref = one_round() if RANK == 0 else None
        got = guarded(one_round, make_debug_mesh(1, 1, pod=2))
        out["round_2x1x1"] = (compare_round(ref, got, got[2]) if RANK == 0 and
                              isinstance(got, tuple) else got if isinstance(got, dict) else {})
        with tempfile.TemporaryDirectory() as tmp:
            out["cli_2x1x1"] = guarded(check_cli, tmp)
        out["serving_data2"] = guarded(check_serving, make_debug_mesh(2, 1))
    else:
        out["kernels"] = guarded(check_kernels, make_debug_mesh(2, 1, pod=2))
        ref = one_round() if RANK == 0 else None
        for name, mesh in (("round_2x2x1", make_debug_mesh(2, 1, pod=2)),
                           ("round_2x2", make_debug_mesh(2, 2))):
            got = guarded(one_round, mesh)
            out[name] = (compare_round(ref, got, got[2]) if RANK == 0 and isinstance(got, tuple)
                         else got if isinstance(got, dict) else {})
    dist.barrier()
    dist.destroy_process_group()
    return out


if __name__ == "__main__":
    result = main()
    if RANK == 0:
        print(json.dumps(result, default=str))
    sys.stdout.flush()
