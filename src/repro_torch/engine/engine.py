"""TrainEngine (port of ``repro/engine/engine.py``): R rounds per dispatch,
captured on the card.

The reference jits one donated program per superstep: a ``lax.scan`` over
H inner steps with the outer sync folded in, scanned again over R rounds.
The port's unit is the *round program* (``superstep.round_program``): the
K·H worker steps (forward, checkpointed backward, the Muon or AdamW
update), the J outer syncs with the wire path, the eval loss of the synced
params and, when armed, the health update. On a CUDA device the engine
captures it once in a ``torch.cuda.CUDAGraph`` and replays it for every
later round, so a round costs the host one graph launch instead of ~67,000
kernel launches; :func:`repro_torch.engine.superstep.build_superstep_fn`
runs R of them per dispatch with no host read in between. On the CPU there
is no capture and the same program runs eagerly. Every R that divides a run
is the same arithmetic, bit for bit, and so is a replay against the eager
round.

One graph holds a whole round. With and without the eval loss are two
graphs, and an elastic run has two programs, dense (every worker takes
part: the lockstep round's own operations) and masked (a worker dropped),
which the host picks per round from its copy of the mask, as the
reference's ``lax.cond`` picks on the device; each graph is captured at its
first use, so a run that never drops a worker never captures the masked
one. The first use of each runs one real round eagerly on a side stream
(the warm-up: it builds the kernels, checks their tiles and makes
PyTorch's lazy handles), then captures it.
The graph reads and writes fixed addresses: the state it was captured on,
updated in place, and static batch buffers the engine fills before each
replay. A state passed in with other tensors (a restored checkpoint, a
round counter set by the recovery path) is copied into the captured
tensors first. A capture that fails raises; nothing falls back to eager.
``TrainEngine(..., capture=False)`` keeps the eager path on the card for
the equality checks.

On a mesh (``TrainEngine(model, dcfg, icfg, mesh=...)``, a DeviceMesh with
the reference's axes 'pod', 'data' and 'model'): :meth:`state_shardings`
gives the reference's specs of the TrainState (``launch/sharding.py``),
:meth:`place_state` lays a whole state out by them as DTensors (each rank
keeps its blocks: a placed state holds the bits of the whole one) and
:meth:`place_batches` the batches (K -> 'pod', B -> 'data'). A dispatch
runs on the state's compute layout (:meth:`compute_state`): each rank
holds its own K / pod workers, each worker tree whole (gathered over
'data' and 'model' once), and its B / data rows of their batches, while the
outer params and outer optimizer state stay DTensors in their ZeRO layout,
where the outer update runs on each rank's block. When the mesh's 'model'
axis splits each worker's compute (``launch/steps.tp_compute``: the dense
LM with heads, kv heads and widths that divide it), the worker leaves are
gathered over 'data' only and each rank keeps its block of the split
matrices (``core/collectives.py``: column-parallel ``wq`` / ``wk`` /
``wv`` / ``w_in`` / ``w_gate`` as they rest, row-parallel ``wo`` / ``w_out``
moved to dim -2 once), their inner-optimizer state following them; the
forward and backward run tensor-parallel, Muon orthogonalizes each split
matrix whole, the sync gathers the worker params whole over 'model' and
splits them back after the reset, and the eval loss runs the same split
forward. Any other config with 'model' > 1 says once why it keeps each
worker whole on every 'model' rank. The worker loop runs over
the rank's own workers; the exchanges are those of
:mod:`repro_torch.core.collectives` (gradients averaged over 'data', the
losses and the wire packets gathered across 'pod' and summed in the
one-process order, θ_outer gathered whole for Δ, the reset and the eval
loss), and every kernel wrapper runs under the mesh's routing
(``kernels/partition.py``). Nothing is captured on a mesh: a round runs
eagerly, and gloo's collectives (two ranks on one card) cannot be captured
in a CUDA graph. Eager rounds are the captured ones' arithmetic (bitwise),
so every R is still the same bits. The mesh runs every round the one
process runs: streaming (masks from the whole shapes, merged on each
rank's block), elastic drops (each rank reads its workers' entries of the
replicated mask, so every rank takes the same program), a sync delay (the
FIFO in the outer layout) and the DP baseline (``dp_engine(..., mesh=)``:
K = 1, the batch split over 'data'). A checkpoint is the whole state on
rank 0's host (:meth:`checkpoint_state`, a collective every rank takes),
the one writer; :meth:`agree_max` is the host-side agreement ``run_rounds``
takes on health flags and the stop flag.
"""
from __future__ import annotations

import functools
import time
from typing import Any, Callable

import torch

from repro_torch.core.diloco import (
    DiLoCoConfig,
    diloco_init,
    diloco_round,
    dp_config,
    make_optimizer,
    make_outer,
    make_streaming_masks,
    round_constants,
)
from repro_torch.engine.superstep import build_superstep_fn, round_program
from repro_torch.optim import OptimizerConfig
from repro_torch.utils.tree import tree_leaves_with_paths, tree_map, tree_map_with_path

Tree = Any


class CapturedRound:
    """One round program captured in a CUDA graph, on the state it was
    warmed up on. :meth:`replay` stages the batches into the static
    buffers, replays, and adds the launches the capture recorded to
    ``_build.LAUNCHES`` (a capture executes nothing, so its own launches
    are taken back)."""

    def __init__(self, program: Callable, state: dict, batches: dict,
                 eval_batch: dict | None):
        from repro_torch.kernels import _build

        self.state = state
        self._leaves = [t for _, t in tree_leaves_with_paths(state)]
        self.batches = {k: torch.empty_like(v) for k, v in batches.items()}
        self.eval_batch = (None if eval_batch is None else
                           {k: torch.empty_like(v) for k, v in eval_batch.items()})
        self.graph, (_, self.info), self.launches, self.capture_s = _build.capture_graph(
            lambda: program(state, self.batches, self.eval_batch), state["round"].device)

    def bind(self, state: dict) -> dict:
        """The captured state, holding ``state``'s values: a state with
        other tensors is copied in (same paths, shapes and dtypes)."""
        if state is self.state:
            return state
        leaves = tree_leaves_with_paths(state)
        if (len(leaves) == len(self._leaves)
                and all(t is c for (_, t), c in zip(leaves, self._leaves))):
            return self.state
        mine = tree_leaves_with_paths(self.state)
        if [p for p, _ in leaves] != [p for p, _ in mine]:
            raise ValueError("state does not match the captured round's state: "
                             f"{len(leaves)} leaves vs {len(mine)}")
        with torch.no_grad():
            for (p, src), (_, dst) in zip(leaves, mine):
                if src.shape != dst.shape or src.dtype != dst.dtype:
                    raise ValueError(f"state leaf {p}: {tuple(src.shape)} {src.dtype}, "
                                     f"captured {tuple(dst.shape)} {dst.dtype}")
                if src is not dst:
                    dst.copy_(src)
        return self.state

    def replay(self, state: dict, batches: dict,
               eval_batch: dict | None) -> tuple[dict, dict]:
        from repro_torch.kernels import _build

        state = self.bind(state)
        for k, v in batches.items():
            self.batches[k].copy_(v)
        if eval_batch is not None:
            for k, v in eval_batch.items():
                self.eval_batch[k].copy_(v)
        self.graph.replay()
        _build.add_launch_counts(self.launches)
        return state, self.info


class TrainEngine:
    """Runs DiLoCo/MuLoCo rounds::

        engine = TrainEngine(model, dcfg, icfg)
        state = engine.init(torch.Generator(device).manual_seed(0), device)
        state, info = engine.step(state, batches_for_round(stream, 0, H))
        # or R rounds in one dispatch (leaves [R, H, K, B, ...]):
        state, out = engine.superstep(state, batches_for_span(stream, 1, H, R))

    ``step`` / ``superstep`` update the state in place and return it; on a
    captured engine the returned state is the captured one, so always
    rebind from the return value. ``capture`` (default: on a CUDA device)
    runs the round program as a CUDA graph; ``capture=True`` with a state
    on the CPU raises. For late metric reads and checkpoints use
    :func:`repro_torch.engine.driver.run_rounds`.
    """

    def __init__(self, model, dcfg: DiLoCoConfig, icfg: OptimizerConfig, *,
                 capture: bool | None = None, mesh=None, kernel_parts=None):
        self.model = model
        self.dcfg = dcfg
        self.icfg = icfg
        self.mesh = mesh
        if mesh is not None:
            _check_mesh_config(dcfg, mesh)
            if capture:
                raise ValueError("a mesh round runs eagerly: TrainEngine(mesh=..., capture=True)")
            capture = False
            if kernel_parts is None:
                from repro_torch.launch.sharding import kernel_specs

                kernel_parts = kernel_specs(mesh, getattr(model, "cfg", None))
        self.kernel_parts = kernel_parts
        # the 'model' group of a tensor-parallel round, or None
        self.model_group = None if mesh is None else self._tensor_parallel(dcfg)
        self.capture = capture
        self.opt = make_optimizer(dcfg, icfg)
        self.outer = make_outer(dcfg, state_dtype=icfg.state_dtype)
        self._masks = None
        self._consts = None
        # (with the eval loss?, masked program?) -> its captured round
        self._graphs: dict[tuple[bool, bool], CapturedRound] = {}
        # in-program checkpoints: the driver installs a sink for its run
        self.checkpoint_sink: Callable | None = None
        self.dispatch_count = 0
        # capture record: seconds of each warm-up round and capture, replays
        self.warmup_s: list[float] = []
        self.capture_s: list[float] = []
        self.replays = 0

    def init(self, gen: torch.Generator, device) -> dict:
        """A fresh state; on a mesh, the whole state made from ``gen`` on
        every rank (so every rank holds the same bits), then placed."""
        state = diloco_init(self.model, self.dcfg, self.icfg, gen, device)
        if self.mesh is not None:
            return self.place_state(state)
        self._captures(state)
        return state

    # -- the mesh -------------------------------------------------------------

    def abstract_state(self) -> dict:
        """The TrainState on the ``meta`` device (nothing allocated)."""
        return diloco_init(self.model, self.dcfg, self.icfg, torch.Generator(),
                           torch.device("meta"))

    def state_shardings(self, tensor_parallel: bool | None = None) -> dict:
        """The reference's specs of the TrainState on the engine's mesh
        (``tensor_parallel`` None: ``launch.steps.tp_friendly`` of the model)."""
        if self.mesh is None:
            raise ValueError("engine was built without a mesh")
        from repro_torch.launch.sharding import diloco_state_shardings
        from repro_torch.launch.steps import tp_friendly

        tp = tp_friendly(self.model.cfg, self.mesh) if tensor_parallel is None else tensor_parallel
        return diloco_state_shardings(self.mesh, self.abstract_state(), tensor_parallel=tp)

    def place_state(self, state: dict, tensor_parallel: bool | None = None) -> dict:
        """A whole TrainState (every rank holds the same bits) as DTensors
        laid out by :meth:`state_shardings` (local slices, no communication)."""
        from repro_torch.launch.sharding import place

        return place(self.mesh, state, self.state_shardings(tensor_parallel))

    def place_batches(self, batches: dict, leading_scan: int = 1) -> dict:
        """Whole [H, K, B, ...] round batches (``leading_scan`` 1; [R, H, ...]
        superstep batches: 2) as DTensors, K -> 'pod', B -> 'data'."""
        if self.mesh is None:
            return batches
        from repro_torch.launch.sharding import batch_shardings, place

        return place(self.mesh, batches, batch_shardings(self.mesh, batches, k_stacked=True,
                                                         leading_scan=leading_scan))

    def local_batches(self, batches: dict, leading_scan: int = 1) -> dict:
        """This rank's rows of batches: a placed (DTensor) batch's local
        blocks, or the blocks of whole batches (the same on every rank)."""
        from torch.distributed.tensor import DTensor

        if all(isinstance(v, DTensor) for v in batches.values()):
            return {k: v.to_local() for k, v in batches.items()}
        return {k: v.to_local() for k, v in self.place_batches(batches, leading_scan).items()}

    def _tensor_parallel(self, dcfg: DiLoCoConfig):
        """The round's 'model' group when the mesh splits each worker's
        compute over it (``launch/steps.tp_compute``), else None; with
        'model' > 1 and no split, rank 0 says once why."""
        import sys

        import torch.distributed as dist

        from repro_torch.launch.mesh import mesh_axis_sizes
        from repro_torch.launch.steps import tp_compute

        M = mesh_axis_sizes(self.mesh).get("model", 1)
        if M <= 1:
            return None
        on, why = tp_compute(self.model.cfg, self.mesh)
        if not on:
            if dist.get_rank() == 0:
                print(f"tensor parallel: off on 'model' = {M} ({why}): every 'model' rank "
                      "computes each worker whole", file=sys.stderr, flush=True)
            return None
        if dcfg.inner_name == "normuon":
            raise ValueError(f"--inner normuon under tensor parallelism ('model' = {M}): its "
                             "neuron-wise RMS reads whole rows of each update, which a rank's "
                             "block of a split matrix does not hold; train it on 'model' = 1")
        return self.mesh.get_group("model")

    def compute_state(self, state: dict) -> dict:
        """The compute layout of a placed state (the identity on a state in
        it already): the worker groups as plain [K / pod, ...] tensors, each
        worker whole (gathered over every mesh axis but 'pod'), or, on a
        tensor-parallel round, each split matrix of ``worker_params`` and
        ``inner_state`` as this rank's block over 'model'
        (``collectives.split_dim``: a column-parallel leaf keeps the
        block it rests in, a row-parallel one is gathered and split along
        dim -2); the outer params, outer optimizer state and the sync
        delay's FIFO as they are (DTensors); the counters, the participation
        mask and the health stats as plain tensors (replicated: whole on
        every rank)."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        from repro_torch.core.collectives import model_block, split_dim
        from repro_torch.launch.mesh import gather_whole

        names = list(self.mesh.mesh_dim_names)
        group = self.model_group

        def worker(path, x, split=True):  # gathered over every axis but 'pod'
            if not isinstance(x, DTensor):
                return x
            dim = split_dim(path) if group is not None and split and x.dim() >= 3 else None
            keep = dim == -1 and x.placements[names.index("model")] == Shard(x.dim() - 1)
            pl = [Replicate() if name == "pod" or (keep and name == "model") else p
                  for name, p in zip(names, x.placements)]
            out = gather_whole(x.to_local(), self.mesh, pl, tag="workers")
            return out if dim is None or keep else model_block(out, dim, group)

        def plain(x):
            return x.to_local() if isinstance(x, DTensor) else x

        out = {}
        for key, sub in state.items():
            if key in ("worker_params", "inner_state", "ef"):
                out[key] = tree_map_with_path(
                    lambda p, x, split=key != "ef": worker(p, x, split), sub)
            elif key in _OUTER_LAYOUT:
                out[key] = sub
            else:
                out[key] = tree_map(plain, sub)
        return out

    def whole_state(self, state: dict) -> dict:
        """Every leaf of a mesh state whole on every rank (worker groups
        gathered across 'pod', the outer groups from their ZeRO layout):
        the state the one-process run holds, for checks and saving."""
        from repro_torch.core.collectives import gather_workers, mesh_groups, whole

        if self.mesh is None:
            return state
        state = self._whole_over_model(self.compute_state(state))
        with mesh_groups(self._groups()):
            return {key: (tree_map(gather_workers, sub)
                          if key in ("worker_params", "inner_state", "ef")
                          else tree_map(whole, sub)) for key, sub in state.items()}

    def checkpoint_state(self, state: dict) -> dict | None:
        """The state a checkpoint writes: ``state`` itself off a mesh; on a
        mesh (a collective every rank takes) the whole state on rank 0's
        host, the bits of :meth:`whole_state`, and None on every other
        rank. The worker groups go only to the writer, across 'pod'
        (:func:`repro_torch.launch.mesh.gather_host`), the outer groups are
        gathered whole as the round gathers them."""
        if self.mesh is None:
            return state
        import torch.distributed as dist

        from repro_torch.core.collectives import whole
        from repro_torch.launch.mesh import gather_host

        first = dist.get_rank() == 0
        pods = self._groups().workers

        def host(x):  # a copy: the state goes on updating in place
            return x.detach().to("cpu", copy=True) if first else None

        def worker(x):
            return host(x) if pods is None else gather_host(x, pods, tag="workers")

        state = self._whole_over_model(self.compute_state(state))
        out = {key: tree_map(worker if key in ("worker_params", "inner_state", "ef")
                             else lambda x: host(whole(x)), sub)
               for key, sub in state.items()}
        return out if first else None

    def _whole_over_model(self, state: dict) -> dict:
        """A compute-layout state with its worker params and inner state
        gathered whole over 'model' (a collective every rank takes on a
        tensor-parallel round; the state as it is otherwise)."""
        if self.model_group is None:
            return state
        from repro_torch.core.collectives import gather_model

        return {key: (gather_model(sub, self.model_group, tag="workers")
                      if key in ("worker_params", "inner_state") else sub)
                for key, sub in state.items()}

    def mesh_context(self):
        """The context a mesh round runs in: the kernels' routing and the
        mesh's groups ('model' among them on a tensor-parallel round)."""
        import contextlib

        from repro_torch.core.collectives import mesh_groups
        from repro_torch.kernels.partition import kernel_partitioning

        stack = contextlib.ExitStack()
        for ctx in (kernel_partitioning(self.kernel_parts), mesh_groups(self._groups())):
            stack.enter_context(ctx)
        return stack

    def agree_max(self, values: list[float]) -> list[float]:
        """The element-wise max of a host list over every rank (the list as
        it is off a mesh): health flags and the stop flag, so that no rank
        decides alone."""
        if self.mesh is None:
            return values
        from repro_torch.launch.mesh import host_max

        return host_max(values)

    def held_workers(self) -> list[int]:
        """The global indices of the workers this rank holds (all K off a
        mesh): ``collectives.local_workers``' slice of them."""
        from repro_torch.core.collectives import local_workers, mesh_groups

        with mesh_groups(None if self.mesh is None else self._groups()):
            return local_workers(torch.arange(self.dcfg.n_workers)).tolist()

    def check_placement(self, state: dict) -> None:
        """Raise unless every leaf of a placed state sits under
        :meth:`state_shardings`' placements (a resumed state, re-placed)."""
        from torch.distributed.tensor import DTensor

        from repro_torch.kernels.partition import spec_placements

        specs = dict(tree_leaves_with_paths(self.state_shardings()))
        for path, leaf in tree_leaves_with_paths(state):
            want = tuple(spec_placements(self.mesh, specs[path]))
            got = tuple(leaf.placements) if isinstance(leaf, DTensor) else None
            if got != want:
                raise ValueError(f"resumed leaf {path} placed under {got}, expected {want}")

    def _groups(self):
        from repro_torch.core.collectives import MeshGroups

        names = list(self.mesh.mesh_dim_names)

        def group(name):
            if name not in names or self.mesh.size(names.index(name)) == 1:
                return None
            return self.mesh.get_group(name)

        return MeshGroups(workers=group("pod"), data=group("data"), model=self.model_group)

    # -- the round program ----------------------------------------------------

    def _prepare(self, state: dict) -> None:
        """Streaming masks, their subset plans and the round's constant
        metrics, made once from the first state, before any capture. On a
        mesh the outer params are DTensors whose ``shape`` is the whole
        tensor's: the masks, their plans and ``comm_bytes`` are the one
        process's, the same on every rank."""
        if self._consts is not None:
            return
        self._masks = make_streaming_masks(state, self.dcfg)
        if self._masks is not None:
            from repro_torch.core.streaming import prepare_plans

            prepare_plans(self._masks, state["outer_params"], self.dcfg.compression)
        self._consts = round_constants(state, self.dcfg, self._masks)

    def _round(self, state: dict, batches: dict, masked: bool | None = None):
        return diloco_round(self.model, self.dcfg, self.opt, state, batches,
                            masks=self._masks, outer=self.outer, consts=self._consts,
                            masked=masked)

    def _program(self, state: dict, batches: dict, eval_batch: dict | None = None,
                 masked: bool | None = None) -> tuple[dict, dict]:
        # built per call, not kept: an engine holding closures over itself
        # would live (with its graphs and state) until the cyclic GC ran
        return round_program(self._round, self.eval_loss)(state, batches, eval_batch,
                                                          masked=masked)

    def _captures(self, state: dict) -> bool:
        on_cuda = state["round"].device.type == "cuda"
        if self.capture and not on_cuda:
            raise ValueError("TrainEngine(capture=True) captures CUDA graphs: the state "
                             f"is on {state['round'].device}")
        return on_cuda if self.capture is None else bool(self.capture)

    def _dispatch_round(self, state: dict, batches: dict, eval_batch: dict | None = None,
                        masked: bool | None = None) -> tuple[dict, dict]:
        """One round: eager, or the captured graph's replay (warm-up and
        capture at the first use of each graph). ``masked`` names an elastic
        round's program; without it the state's mask is read back."""
        self._prepare(state)
        captures = self._captures(state)
        if captures and self._graphs:  # every graph runs on the first one's state
            state = next(iter(self._graphs.values())).bind(state)
        if masked is None:
            part = state.get("participation")
            masked = part is not None and not bool((part > 0).all())
        if not captures:
            return self._program(state, batches, eval_batch, masked=masked)
        key = (eval_batch is not None, masked)
        graph = self._graphs.get(key)
        if graph is not None:
            self.replays += 1
            return graph.replay(state, batches, eval_batch)
        device = state["round"].device
        t0 = time.perf_counter()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            state, info = self._program(state, batches, eval_batch, masked=masked)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        self.warmup_s.append(time.perf_counter() - t0)
        # the warm-up's freed blocks stay cached for its side stream, which the
        # capture's pool cannot take, and nothing cached can be freed during a
        # capture: release them first (whisper-large-v3's round needs its
        # transient twice, ~21 GB, beside a 39.5 GB state on an 80 GB card)
        torch.cuda.empty_cache()
        graph = CapturedRound(functools.partial(self._program, masked=masked), state, batches,
                              eval_batch)
        self.capture_s.append(graph.capture_s)
        self._graphs[key] = graph
        return state, info

    # -- execution -------------------------------------------------------------

    def step(self, state: dict, batches: dict,
             participation=None) -> tuple[dict, dict]:
        """One communication round (H inner steps + the outer sync(s)): the
        degenerate R = 1 :meth:`superstep`, with ``loss`` f32[H] and the
        round's ``psi`` (on a captured engine, the graph's buffers: valid
        until the next dispatch). ``participation`` is the round's [K] mask
        (elastic configs only; it stays in the state until overwritten)."""
        if participation is not None:
            participation = (participation[None] if hasattr(participation, "shape")
                             else [participation])
        state, out = self.superstep(state, {k: v[None] for k, v in batches.items()},
                                    participation=participation)
        return state, {k: (v if k == "psi" else v[0]) for k, v in out.items()}

    def superstep(self, state: dict, batches: dict, eval_batches: dict | None = None,
                  participation=None, ckpt_flags=None) -> tuple[dict, dict]:
        """R rounds in one dispatch. ``batches`` leaves [R, H, K, B, ...];
        ``eval_batches`` (optional) leaves [R, B, ...]; ``participation``
        (elastic configs only) the [R, K] fp32 {0, 1} masks, on the host;
        ``ckpt_flags`` (optional, R bools) emits each flagged round's
        post-round state to :attr:`checkpoint_sink`. Returns ``(state,
        out)`` with ``loss`` f32[R, H], ``comm_bytes``, ``active_workers``
        and ``staleness`` f32[R], ``eval_loss`` f32[R] with eval batches,
        ``health`` f32[R] with the sentinel on, and ``psi`` at R = 1."""
        self.dispatch_count += 1
        superstep_fn = build_superstep_fn(self._round, eval_loss_fn=self.eval_loss,
                                          checkpoint_cb=self._emit_checkpoint,
                                          program=self._dispatch_round)
        if self.mesh is None:
            return superstep_fn(state, batches, eval_batches, participation, ckpt_flags)
        state = self.compute_state(state)
        local = self.local_batches(batches, 2)
        with self.mesh_context():
            return superstep_fn(state, local, eval_batches, participation, ckpt_flags)

    def _emit_checkpoint(self, state: dict) -> None:
        """Hand a flagged round's state to the sink as ``(host_state,
        event)``: on the card, asynchronous copies into pinned host buffers
        and the event that marks them done (the host does not wait here);
        on the CPU, a copy and ``None``. On a mesh every rank takes
        :meth:`checkpoint_state` (a collective) and rank 0 alone hands its
        host copy over."""
        sink = self.checkpoint_sink
        if sink is None:
            return
        if self.mesh is not None:
            state = self.checkpoint_state(state)
            if state is not None:
                sink((state, None))
            return
        if state["round"].device.type != "cuda":
            sink((tree_map(lambda t: t.detach().clone(), state), None))
            return
        host = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                        .copy_(t, non_blocking=True), state)
        event = torch.cuda.Event()
        event.record()
        sink((host, event))

    def launches_per_round(self, params: Tree, with_eval: bool = True) -> dict[str, int]:
        """Hopper-kernel launches one round makes on the card (``with_eval``:
        and its eval loss): per worker step, the flash forward once per
        attention layer (``Model.attention_layers``: none in the SSM family,
        the shared block once a superblock in the hybrid; twice with
        ``remat``: the backward recomputes it), dq and dkv once per
        attention layer, and three matmul-epilogue launches per Newton-Schulz
        iteration per Muon leaf (one launch covers a whole [L, m, n] stack;
        ``muon_bp`` and ``normuon`` too: MuonBP's off-period steps select
        the momentum over the orthogonalized update, so NS runs every step);
        the eval loss runs the forward once per attention layer; each outer sync (J
        per round) launches the Nesterov kernel once per leaf, and the
        quantize and dequantize launches are :meth:`wire_launches_per_round`'s.
        A replayed round counts the launches its capture recorded, so the
        formula holds for warm-up, eager and replayed rounds alike, and for
        the dense and the masked program of an elastic run (the masked one
        runs every worker's step and selects)."""
        from repro_torch.optim.muon import muon_label
        from repro_torch.utils.tree import tree_leaves_with_paths

        cfg, dcfg = self.model.cfg, self.dcfg
        leaves = tree_leaves_with_paths(params)
        steps = dcfg.n_workers * dcfg.sync_interval
        attn = self.model.attention_layers if cfg.attn_impl == "pallas" else 0
        ns = (3 * self.icfg.ns_iters * sum(muon_label(p, x) == "muon" for p, x in leaves)
              if dcfg.inner_name != "adamw" and dcfg.ns_impl == "pallas" else 0)
        outer = dcfg.outer_kernel and dcfg.outer_name == "nesterov" and dcfg.outer_enabled
        syncs = max(dcfg.streaming_partitions, 1)
        quantize, dequantize = self.wire_launches_per_round(params)
        return {"flash_fwd": steps * attn * (2 if cfg.remat else 1) + attn * with_eval,
                "paged_decode": 0, "flash_dq": steps * attn, "flash_dkv": steps * attn,
                "matmul_epilogue": steps * ns, "nesterov": syncs * len(leaves) if outer else 0,
                "quantize": quantize, "dequantize": dequantize}

    def wire_launches_per_round(self, params: Tree) -> tuple[int, int]:
        """(quantize, dequantize) launches of one round's sync(s), one per
        wrapper call. Only linear quantization with ``wire_impl='pallas'``
        reaches the kernels. Every encoded leaf costs Q1 and its decode D1,
        plus Q2 and D2 on the a2a_rs_ag collective. In the single sync
        (J = 1) the stages run as a chain: the EF stage decodes its packet
        for the residual and the reduce decodes it again, so EF adds one D1
        per leaf. A streaming segment runs ``_leaf_wire_pipeline``, which
        decodes once, on each leaf its ``subset_plan`` does not skip."""
        from repro_torch.core.streaming import streaming_masks, subset_plan
        from repro_torch.utils.tree import tree_leaves

        ccfg, J = self.dcfg.compression, self.dcfg.streaming_partitions
        if not (ccfg.kind == "quant" and ccfg.quant_mode == "linear"
                and ccfg.wire_impl == "pallas"):
            return 0, 0
        q2 = int(ccfg.collective == "a2a_rs_ag")
        leaves = tree_leaves(params)
        if J <= 1:
            ef = int(ccfg.error_feedback)
            return len(leaves) * (1 + q2), len(leaves) * (1 + ef + q2)
        encoded = sum(subset_plan(m, tuple(p.shape), ccfg)[0] != "skip"
                      for mask in streaming_masks(params, J)
                      for p, m in zip(leaves, tree_leaves(mask)))
        return encoded * (1 + q2), encoded * (1 + q2)

    @torch.no_grad()
    def eval_loss(self, params: Tree, batch: dict) -> torch.Tensor:
        """Loss of the synced (outer) params on one un-stacked batch (the
        function the round program folds in); on a mesh every rank takes the
        whole batch on the whole params, split over 'model' as the workers
        are on a tensor-parallel round."""
        from repro_torch.core.collectives import split_model, whole

        return self.model.loss(split_model(tree_map(whole, params)), batch)[0]


# the TrainState fields a mesh round keeps in the outer state's ZeRO layout
_OUTER_LAYOUT = ("outer_params", "outer_opt", "pending")


def _check_mesh_config(dcfg: DiLoCoConfig, mesh) -> None:
    """Raise for a worker count the 'pod' axis does not divide."""
    from repro_torch.launch.mesh import mesh_axis_sizes

    pods = mesh_axis_sizes(mesh).get("pod", 1)
    if dcfg.n_workers % pods:
        raise ValueError(f"{dcfg.n_workers} workers do not divide over a 'pod' axis of {pods}")


def dp_engine(model, inner_name: str, icfg: OptimizerConfig, *, ns_impl: str = "pallas",
              **kw) -> TrainEngine:
    """The data-parallel baseline as the degenerate engine config
    (``dp_config``: K = 1, H = 1, no outer optimizer): a round is one step.
    ``ns_impl`` defaults to 'pallas', as the trainer's ``--ns-impl`` does:
    Muon's Newton-Schulz through the Hopper matmul kernel ('jnp': the bf16
    plain version); ``kw`` goes to :class:`TrainEngine`."""
    return TrainEngine(model, dp_config(inner_name, ns_impl=ns_impl), icfg, **kw)
