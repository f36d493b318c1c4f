"""TrainEngine (port of ``repro/engine/engine.py``).

The reference compiles one donated, jitted program per superstep (a
``lax.scan`` over H inner steps with the outer sync folded in, scanned
again over R rounds). PyTorch runs eagerly, so the port's engine runs one
round per call of :meth:`TrainEngine.step`, updating the state in place
where JAX donates it. Every R that divides a run is bitwise the same
arithmetic in the reference, so running rounds one at a time changes no
number; the superstep (one CUDA graph per round or R rounds) is deferred
(ROADMAP.md).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.diloco import (
    DiLoCoConfig,
    diloco_init,
    diloco_round,
    make_optimizer,
    make_outer,
)
from repro_torch.optim import OptimizerConfig

Tree = Any


class TrainEngine:
    """Runs DiLoCo/MuLoCo rounds::

        engine = TrainEngine(model, dcfg, icfg)
        state = engine.init(torch.Generator(device).manual_seed(0), device)
        for r in range(rounds):
            state, info = engine.step(state, batches_for_round(stream, r, H))

    ``step`` updates ``state`` in place and returns it.
    """

    def __init__(self, model, dcfg: DiLoCoConfig, icfg: OptimizerConfig):
        self.model = model
        self.dcfg = dcfg
        self.icfg = icfg
        self.opt = make_optimizer(dcfg, icfg)
        self.outer = make_outer(dcfg, state_dtype=icfg.state_dtype)

    def init(self, gen: torch.Generator, device) -> dict:
        return diloco_init(self.model, self.dcfg, self.icfg, gen, device)

    def step(self, state: dict, batches: dict) -> tuple[dict, dict]:
        """One communication round (H inner steps + the outer sync)."""
        return diloco_round(self.model, self.dcfg, self.opt, state, batches, outer=self.outer)

    def launches_per_round(self, params: Tree) -> dict[str, int]:
        """Hopper-kernel launches one round makes on the card (with an eval
        loss): per worker step, the flash forward once per layer (twice
        with ``remat``: the backward recomputes it), dq and dkv once per
        layer, and three matmul-epilogue launches per Newton-Schulz
        iteration per Muon leaf (one launch covers a whole [L, m, n] stack);
        the eval loss runs the forward once per layer; the outer step
        launches the Nesterov kernel once per leaf."""
        from repro_torch.optim.muon import muon_label
        from repro_torch.utils.tree import tree_leaves_with_paths

        cfg, dcfg = self.model.cfg, self.dcfg
        leaves = tree_leaves_with_paths(params)
        steps = dcfg.n_workers * dcfg.sync_interval
        attn = cfg.n_layers if cfg.attn_impl == "pallas" else 0
        ns = (3 * self.icfg.ns_iters * sum(muon_label(p, x) == "muon" for p, x in leaves)
              if dcfg.inner_name == "muon" and dcfg.ns_impl == "pallas" else 0)
        outer = dcfg.outer_kernel and dcfg.outer_name == "nesterov"
        return {"flash_fwd": steps * attn * (2 if cfg.remat else 1) + attn,
                "paged_decode": 0, "flash_dq": steps * attn, "flash_dkv": steps * attn,
                "matmul_epilogue": steps * ns, "nesterov": len(leaves) if outer else 0}

    @torch.no_grad()
    def eval_loss(self, params: Tree, batch: dict) -> torch.Tensor:
        """Loss of the synced (outer) params on one un-stacked batch."""
        return self.model.loss(params, batch)[0]
