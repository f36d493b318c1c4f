"""PyTorch port: elastic DiLoCo (Slice 4b) against the JAX package.

Worker drops (``core/faults.FaultPlan``, the participation mask), the
delayed outer sync (the ``pending`` FIFO) and the straggler wall-clock
model. Inputs come from seeds through numpy and cross to the port with
``state_from_numpy``; the model is a two-layer toy (d = 32, vocab 64).

The port's own invariants are held bitwise: an all-ones mask runs the
lockstep round's operations, a dropped worker's params, inner state and EF
residual keep every bit, and an elastic superstep equals its rounds one by
one. Against the reference: masks and the schedule parser bitwise, a masked
and a delayed round within the tolerances of
tests/test_torch_train.py::test_one_diloco_round_matches_reference, the
masked reduce and the reported loss bitwise.
"""
import csv
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_train import _jstate_numpy, assert_tree_close  # noqa: E402

from repro.checkpoint import load_checkpoint as jload_checkpoint  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave_checkpoint  # noqa: E402
from repro.core import DiLoCoConfig as JDiLoCoConfig  # noqa: E402
from repro.core import diloco_init as jdiloco_init  # noqa: E402
from repro.core import diloco_round as jdiloco_round  # noqa: E402
from repro.core import inner_step as jinner_step  # noqa: E402
from repro.core import make_optimizer as jmake_optimizer  # noqa: E402
from repro.core import make_outer as jmake_outer  # noqa: E402
from repro.core import make_streaming_masks as jmake_streaming_masks  # noqa: E402
from repro.core import outer_step as jouter_step  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import wallclock as jwallclock  # noqa: E402
from repro.core.compression import CompressionConfig as JCompressionConfig  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import MarkovStream as JMarkovStream  # noqa: E402
from repro.models import ModelConfig as JModelConfig  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.optim import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.core import (  # noqa: E402
    DiLoCoConfig,
    diloco_init,
    diloco_round,
    inner_step,
    make_optimizer,
    make_outer,
    make_streaming_masks,
    outer_step,
)
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import wallclock as twallclock  # noqa: E402
from repro_torch.core.collectives import measured_sync_bytes  # noqa: E402
from repro_torch.core.compression import CompressionConfig  # noqa: E402
from repro_torch.data import DataConfig, MarkovStream, batches_for_round, batches_for_span  # noqa: E402
from repro_torch.engine import TrainEngine, run_rounds, train_state  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.optim import OptimizerConfig  # noqa: E402
from repro_torch.utils.tree import (  # noqa: E402
    state_from_numpy,
    state_to_numpy,
    tree_leaves_with_paths,
    tree_map,
)

MODEL = dict(arch_type="dense", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
             vocab=64, remat=False, dtype="float32", qk_norm=True)
CFG = ModelConfig(**MODEL)
ICFG = OptimizerConfig(lr=1e-2, weight_decay=0.0)
# the paper's compressed variant: 2-bit quantization with error feedback
WIRE = {"none": dict(kind="none"),
        "quant2-ef": dict(kind="quant", bits=2, error_feedback=True),
        "rowwise2-ef": dict(kind="quant", bits=2, error_feedback=True, rowwise=True)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models: one torch thread computes them as fast and leaves the
    cores to the other files of a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(K, seed=3):
    return MarkovStream(DataConfig(vocab=CFG.vocab, seq_len=16, batch_per_worker=2,
                                   n_workers=K, seed=seed))


def _engine(K=2, H=2, inner="muon", comp="none", **dkw):
    dcfg = DiLoCoConfig(n_workers=K, sync_interval=H, inner_name=inner,
                        compression=CompressionConfig(**WIRE[comp]), **dkw)
    engine = TrainEngine(build_model(CFG), dcfg, ICFG)
    return engine, engine.init(torch.Generator().manual_seed(0), "cpu")


def _equal(a, b, what=""):
    la, lb = tree_leaves_with_paths(a), tree_leaves_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb], what
    for (p, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), f"{what}{p}"


def _worker(tree, k):
    return tree_map(lambda x: x[k].clone(), tree)


# ------------------------------------------------------------------- masks

@pytest.mark.parametrize("K,drop_prob,schedule", [
    (1, 0.5, None), (2, 0.0, "1:1"), (3, 0.3, None), (4, 0.4, "1:1;1:2,5:0"),
    (8, 0.9, None), (16, 1.0, "0:3")])
@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_fault_plan_masks_bitwise_equal_reference(seed, K, drop_prob, schedule):
    """FaultPlan's [K] masks over rounds 0..63 == the reference's, bit for
    bit, the keep-one tie-break included (drop_prob 0.9 and 1.0 drop
    everyone in many rounds); chunked spans equal round by round."""
    sched = tfaults.parse_drop_schedule(schedule) if schedule else None
    mine = tfaults.FaultPlan(n_workers=K, drop_prob=drop_prob, schedule=sched, seed=seed)
    ref = jfaults.FaultPlan(n_workers=K, drop_prob=drop_prob, schedule=sched, seed=seed)
    got, want = mine.masks(0, 64), ref.masks(0, 64)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    assert (got.sum(axis=1) >= 1).all()
    assert np.array_equal(mine.masks(5, 7), got[5:12])
    assert mine.is_trivial == ref.is_trivial


@pytest.mark.parametrize("spec", ["1:2;1:3,4:0", "", " 3:1 ; 3:1 ;", "0:0,0:1", "1-2",
                                  "1:-2", "a:1", "1:2:3", "-1:0"])
def test_parse_drop_schedule_matches_reference(spec):
    """parse_drop_schedule gives the reference's schedule, or raises its
    ValueError with its message."""
    try:
        want = jfaults.parse_drop_schedule(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tfaults.parse_drop_schedule(spec)
        assert str(got.value) == str(e)
        return
    assert tfaults.parse_drop_schedule(spec) == want


# ------------------------------------------------------- the port's invariants

@pytest.mark.parametrize("comp", ["none", "quant2-ef"])
def test_all_ones_mask_bitwise_equals_dense(comp):
    """An elastic run with every worker present (the masks passed each
    round) equals the lockstep run over 3 rounds, bit for bit: losses,
    comm_bytes, outer and worker params, inner state and EF residuals."""
    e_dense, s_dense = _engine(comp=comp)
    e_el, s_el = _engine(comp=comp, elastic=True)
    assert torch.equal(s_el["participation"], torch.ones(2))
    for r in range(3):
        batches = batches_for_round(_stream(2), r, 2)
        s_dense, i_dense = e_dense.step(s_dense, batches)
        s_el, i_el = e_el.step(s_el, batches, participation=np.ones(2, np.float32))
        assert torch.equal(i_dense["loss"], i_el["loss"])
        assert torch.equal(i_dense["comm_bytes"], i_el["comm_bytes"])
        assert float(i_el["active_workers"]) == 2.0
    s_el = dict(s_el)
    del s_el["participation"]
    _equal(s_dense, s_el)


def test_drop_then_rejoin_preserves_ef_params_and_inner_state():
    """A dropped worker (K = 3, worker 1 out in round 1, 2-bit EF): its
    params through a masked inner step, and its inner state and EF residual
    through the whole round, keep every bit; the survivors move; after the
    sync every worker holds the new outer params (rejoining is the
    broadcast); in round 2 it trains again."""
    engine, state = _engine(K=3, comp="quant2-ef", elastic=True)
    state, _ = engine.step(state, batches_for_round(_stream(3), 0, 2))
    ef1, inner1, params1 = (_worker(state[f], 1) for f in ("ef", "inner_state",
                                                            "worker_params"))
    assert any(float(x.abs().max()) > 0 for _, x in tree_leaves_with_paths(ef1))
    mask = torch.tensor([1.0, 0.0, 1.0])

    probe = tree_map(torch.clone, state)  # one masked inner step, outside the round
    probe, m = inner_step(engine.model, engine.opt, probe,
                          {k: v[0] for k, v in batches_for_round(_stream(3), 1, 2).items()},
                          participation=mask)
    _equal(params1, _worker(probe["worker_params"], 1), "params ")
    _equal(inner1, _worker(probe["inner_state"], 1), "inner ")
    assert not torch.equal(probe["worker_params"]["embed"][0], params1["embed"])
    per = m["loss_per_worker"]
    assert float(m["loss"]) == float((per[0] + per[2]) * (1.0 / torch.tensor(2.0)))

    state, info = engine.step(state, batches_for_round(_stream(3), 1, 2),
                              participation=mask.numpy())
    assert float(info["active_workers"]) == 2.0
    _equal(ef1, _worker(state["ef"], 1), "ef ")
    _equal(inner1, _worker(state["inner_state"], 1), "inner ")
    for k in range(3):
        _equal(state["outer_params"], _worker(state["worker_params"], k), f"w{k} ")
    count = int(state["inner_state"]["count"][1])
    state, info = engine.step(state, batches_for_round(_stream(3), 2, 2),
                              participation=np.ones(3, np.float32))
    assert float(info["active_workers"]) == 3.0
    assert int(state["inner_state"]["count"][1]) == count + 2


def test_masked_round_comm_bytes_scale_by_surviving_fraction():
    """comm_bytes = c·(sum(p)/K): half the dense bytes with 2 of 4 workers
    present, exactly, and the dense bytes at full participation."""
    engine, state = _engine(K=4, inner="adamw", comp="quant2-ef", elastic=True)
    dense = measured_sync_bytes(state["outer_params"], engine.dcfg.compression, 4)
    state, info = engine.step(state, batches_for_round(_stream(4), 0, 2),
                              participation=np.array([1, 0, 1, 0], np.float32))
    assert float(info["comm_bytes"]) == np.float32(dense) * np.float32(0.5)
    state, info = engine.step(state, batches_for_round(_stream(4), 1, 2),
                              participation=np.ones(4, np.float32))
    assert float(info["comm_bytes"]) == np.float32(dense)


def test_sync_delay_first_round_holds_outer_params():
    """sync_delay = 1: round 0 applies the FIFO's zero pseudogradient, so
    the outer params hold every bit, and pending[0] is the round's fresh
    Psi; round 1 applies it and the params move."""
    engine, state = _engine(inner="adamw", sync_delay=1)
    p0 = tree_map(torch.clone, state["outer_params"])
    state, info = engine.step(state, batches_for_round(_stream(2), 0, 2))
    assert float(info["staleness"]) == 1.0
    _equal(p0, state["outer_params"], "outer ")
    _equal(tree_map(lambda q: q[0], state["pending"]), info["psi"], "pending ")
    state, _ = engine.step(state, batches_for_round(_stream(2), 1, 2))
    assert max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        tree_leaves_with_paths(state["outer_params"]), tree_leaves_with_paths(p0))) > 0


def test_sync_delay_fifo_shifts_each_round():
    """sync_delay = 2: every round the FIFO's tail is the round's fresh Psi
    and the slot before it the previous round's (the in-place shift)."""
    engine, state = _engine(inner="adamw", sync_delay=2)
    prev = None
    for r in range(3):
        state, info = engine.step(state, batches_for_round(_stream(2), r, 2))
        psi = tree_map(torch.clone, info["psi"])
        _equal(tree_map(lambda q: q[-1], state["pending"]), psi, f"r{r} tail ")
        if prev is not None:
            _equal(tree_map(lambda q: q[0], state["pending"]), prev, f"r{r} head ")
        prev = psi


def test_sync_delay_config_guards():
    """sync_delay is refused without the outer optimizer and with streaming,
    as the reference refuses it."""
    model = build_model(CFG)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="outer optimizer"):
        diloco_init(model, DiLoCoConfig(n_workers=1, sync_interval=1, outer_enabled=False,
                                        sync_delay=1), ICFG, gen, "cpu")
    with pytest.raises(ValueError, match="streaming"):
        diloco_init(model, DiLoCoConfig(n_workers=2, sync_interval=4,
                                        streaming_partitions=2, sync_delay=1), ICFG, gen, "cpu")


@pytest.mark.parametrize("inner", ["adamw", "muon"])
def test_superstep_elastic_matches_sequential_rounds_bitwise(inner):
    """One R = 3 dispatch with a per-round mask stack (a drop in the middle,
    2-bit EF) equals three masked engine.step rounds, bit for bit."""
    masks = np.array([[1, 1], [1, 0], [1, 1]], np.float32)
    e1, s1 = _engine(inner=inner, comp="quant2-ef", elastic=True)
    losses = []
    for r in range(3):
        s1, info = e1.step(s1, batches_for_round(_stream(2), r, 2), participation=masks[r])
        losses.append(info["loss"])
    e2, s2 = _engine(inner=inner, comp="quant2-ef", elastic=True)
    s2, out = e2.superstep(s2, batches_for_span(_stream(2), 0, 2, 3), participation=masks)
    assert torch.equal(out["loss"], torch.stack(losses))
    assert out["active_workers"].tolist() == [2.0, 1.0, 2.0]
    _equal(s1, s2)


def test_run_rounds_elastic_any_dispatch_width():
    """run_rounds with FaultPlan masks (drops in rounds 1 and 3) at R = 1,
    2 and 4 gives the same records and final state."""
    plan = tfaults.FaultPlan(n_workers=2, schedule={1: (1,), 3: (0,)})
    got = []
    for R in (1, 2, 4):
        engine, state = _engine(elastic=True, comp="quant2-ef")
        state, hist = run_rounds(engine, state, lambda r: batches_for_round(_stream(2), r, 2),
                                 4, rounds_per_dispatch=R, participation_for=plan.masks)
        got.append((state, [{k: v for k, v in h.items() if k != "wall_s"} for h in hist]))
    assert [h["active_workers"] for h in got[0][1]] == [2.0, 1.0, 2.0, 1.0]
    for state, hist in got[1:]:
        assert hist == got[0][1]
        _equal(state, got[0][0])


# ------------------------------------------------------- against the reference

def _ref_pair(K, inner="muon", comp="none", **dkw):
    """A reference TrainState of the toy model and the port's copy, plus
    both configs, models and optimizers."""
    ckw = WIRE[comp]
    common = dict(n_workers=K, sync_interval=2, inner_name=inner, ns_impl="pallas",
                  outer_kernel=inner == "muon", **dkw)
    jd = JDiLoCoConfig(compression=JCompressionConfig(**ckw), **common)
    td = DiLoCoConfig(compression=CompressionConfig(**ckw), **common)
    okw = dict(lr=2e-2, weight_decay=1e-4, schedule="cosine", warmup_steps=1, total_steps=4)
    jo, to = JOptimizerConfig(**okw), OptimizerConfig(**okw)
    jmodel = jbuild_model(JModelConfig(**MODEL))
    jstate = jdiloco_init(jmodel, jd, jo, jax.random.PRNGKey(0))
    return jd, td, jo, to, jmodel, build_model(CFG), jstate


def _batches(K, r0=0):
    stream = JMarkovStream(JDataConfig(vocab=64, seq_len=16, batch_per_worker=2, n_workers=K,
                                       seed=3))
    return {k: np.array(v) for k, v in stream.batch_stack(r0, 2).items()}


def _round_both(jd, td, jo, to, jmodel, tmodel, jstate, tstate, batches):
    """One round of each package; with J > 1 each side builds its own
    partition masks from its own state."""
    streaming = td.streaming_partitions > 1
    jmasks = jmake_streaming_masks(jstate, jd) if streaming else None
    jnew, jinfo = jax.jit(lambda st, b: jdiloco_round(
        jmodel, jd, jmake_optimizer(jd, jo), st, b, masks=jmasks, outer=jmake_outer(jd)))(
        jstate, {k: jnp.asarray(v) for k, v in batches.items()})
    tnew, tinfo = diloco_round(tmodel, td, make_optimizer(td, to), tstate,
                               {k: torch.from_numpy(v) for k, v in batches.items()},
                               masks=make_streaming_masks(tstate, td) if streaming else None,
                               outer=make_outer(td))
    return jnew, jinfo, tnew, tinfo


TIGHT = dict(atol=2e-5, rtol=1e-4)
LOOSE = dict(atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("inner,comp,K,mask,J", [
    ("muon", "none", 3, [1, 0, 1], 1), ("adamw", "none", 2, [0, 1], 1),
    ("muon", "quant2-ef", 3, [0, 1, 1], 1), ("muon", "none", 3, [1, 1, 1], 1),
    ("muon", "none", 3, [1, 0, 1], 2), ("muon", "rowwise2-ef", 3, [1, 0, 1], 2)],
    ids=["muon-K3", "adamw-K2", "muon-quant2-ef", "muon-all-ones", "muon-J2",
         "muon-rowwise2-ef-J2"])
def test_elastic_round_matches_reference(inner, comp, K, mask, J):
    """One elastic round from one TrainState (the mask set in the state,
    the reference's jitted round choosing its branch on the device, the
    port's on the host; with J = 2 the streaming round, whose two segment
    syncs each take the mask): losses and inner state at the tolerances of
    test_one_diloco_round_matches_reference (TIGHT; AdamW-updated leaves as
    there), a dropped worker's inner state and EF residual bitwise the
    reference's (both the untouched input), active_workers and comm_bytes
    exactly. Uncompressed, also the params (TIGHT), u and Psi (LOOSE). The
    2-bit case stops there: deltas that differ by ~1e-6 across the two
    frameworks land a few entries on the other side of a 2-bit level, which
    moves Psi by a quantization step (the sync itself is held bitwise from
    one set of deltas by test_masked_reduce_matches_reference and
    test_masked_segment_sync_matches_reference). Streaming with 2 bits stops
    earlier, at the first segment's losses: the second segment's steps start
    from params the first segment's 2-bit sync reset, which moves them so
    even with every worker present."""
    jd, td, jo, to, jmodel, tmodel, jstate = _ref_pair(K, inner, comp, elastic=True,
                                                       streaming_partitions=J)
    if comp != "none":  # nonzero residuals, so frozen and updated differ
        ef = jax.tree.map(lambda e: jax.random.normal(jax.random.PRNGKey(4), e.shape) * 1e-3,
                          jstate.ef)
        jstate = jstate.replace(ef=ef)
    jstate = jstate.replace(participation=jnp.asarray(mask, jnp.float32))
    tstate = train_state(**state_from_numpy(_jstate_numpy(jstate), "cpu"))
    jnew, jinfo, tnew, tinfo = _round_both(jd, td, jo, to, jmodel, tmodel, jstate, tstate,
                                           _batches(K))
    adam = dict(adamw_tol=to.lr, all_adam=inner == "adamw")
    if J > 1 and comp != "none":
        seg = td.sync_interval // J
        assert_tree_close(tinfo["loss"][:seg], np.asarray(jinfo["loss"])[:seg], "loss", **TIGHT,
                          **adam)
    else:
        assert_tree_close(tinfo["loss"], jinfo["loss"], "loss", **TIGHT, **adam)
        assert_tree_close(tnew["inner_state"], jax.tree.map(np.asarray, jnew.inner_state),
                          "inner", **TIGHT, **adam)
    if comp == "none":
        assert_tree_close(tnew["worker_params"], jnew.worker_params, "workers", **TIGHT,
                          **adam)
        assert_tree_close(tnew["outer_params"], jnew.outer_params, "outer", **TIGHT, **adam)
        assert_tree_close(tnew["outer_opt"], jax.tree.map(np.asarray, jnew.outer_opt), "u",
                          **LOOSE, **adam)
        assert_tree_close(tinfo["psi"], jax.tree.map(np.asarray, jinfo["psi"]), "psi",
                          **LOOSE, **adam)
    for k in np.flatnonzero(np.asarray(mask) == 0):
        for f in ["inner_state"] + (["ef"] if comp != "none" else []):
            want = jax.tree.map(lambda x: np.asarray(x)[k], getattr(jnew, f))
            assert_tree_close(_worker(tnew[f], k), want, f, atol=0, rtol=0)
    assert float(tinfo["active_workers"]) == float(jinfo["active_workers"]) == sum(mask)
    assert float(tinfo["comm_bytes"]) == float(jinfo["comm_bytes"])


@pytest.mark.parametrize("inner,comp", [("adamw", "none"), ("muon", "none")])
def test_delayed_round_matches_reference(inner, comp):
    """Two rounds at sync_delay = 1 from one TrainState: round 0 holds the
    outer params bitwise on both sides, round 1 applies Psi_0; params,
    pending and u within the round test's tolerances; staleness 1."""
    jd, td, jo, to, jmodel, tmodel, jstate = _ref_pair(2, inner, comp, sync_delay=1)
    tstate = train_state(**state_from_numpy(_jstate_numpy(jstate), "cpu"))
    p0 = tree_map(torch.clone, tstate["outer_params"])
    adam = dict(adamw_tol=to.lr, all_adam=inner == "adamw")
    for r in range(2):
        jstate, jinfo, tstate, tinfo = _round_both(jd, td, jo, to, jmodel, tmodel, jstate,
                                                   tstate, _batches(2, 2 * r))
        if r == 0:
            _equal(p0, tstate["outer_params"], "held ")
            assert_tree_close(tstate["outer_params"], jstate.outer_params, "held", atol=0,
                              rtol=0)
        assert_tree_close(tstate["outer_params"], jstate.outer_params, "outer", **TIGHT, **adam)
        assert_tree_close(tstate["pending"], jax.tree.map(np.asarray, jstate.pending),
                          "pending", **LOOSE, **adam)
        assert_tree_close(tstate["outer_opt"], jax.tree.map(np.asarray, jstate.outer_opt),
                          "u", **LOOSE, **adam)
        assert float(tinfo["staleness"]) == float(jinfo["staleness"]) == 1.0


@pytest.mark.parametrize("comp", ["none", "quant2-ef"])
def test_masked_reduce_matches_reference(comp):
    """OuterOptimizer.reduce under a mask, from one TrainState's deltas and
    residuals (K = 4, workers 1 and 3 out): Psi and the new residuals equal
    the reference's jitted reduce bitwise (the K-mean is the reciprocal
    form on both sides), the dropped workers' residuals untouched."""
    jd, td, *_ , jstate = _ref_pair(4, "adamw", comp, elastic=True)
    rng = np.random.default_rng(11)
    deltas = jax.tree.map(lambda w: rng.standard_normal(w.shape).astype(np.float32) * 1e-2,
                          jstate.worker_params)
    ef = (None if jstate.ef is None else
          jax.tree.map(lambda e: rng.standard_normal(e.shape).astype(np.float32) * 1e-3,
                       jstate.ef))
    mask = np.array([1, 0, 1, 0], np.float32)
    jpsi, jef = jax.jit(lambda p, d, e, m: jmake_outer(jd).reduce(p, d, e, participation=m))(
        jstate.outer_params, deltas, ef, jnp.asarray(mask))
    tpsi, tef = make_outer(td).reduce(
        state_from_numpy(jax.tree.map(np.asarray, jstate.outer_params), "cpu"),
        state_from_numpy(deltas, "cpu"), None if ef is None else state_from_numpy(ef, "cpu"),
        participation=torch.from_numpy(mask))
    assert_tree_close(tpsi, jax.tree.map(np.asarray, jpsi), "psi", atol=0, rtol=0)
    if ef is not None:
        assert_tree_close(tef, jax.tree.map(np.asarray, jef), "ef", atol=0, rtol=0)
        for k in (1, 3):
            assert_tree_close(_worker(tef, k), jax.tree.map(lambda e: e[k], ef), "frozen",
                              atol=0, rtol=0)


@pytest.mark.parametrize("j", [0, 1])
def test_masked_segment_sync_matches_reference(j):
    """A streaming segment's sync under a mask (row-wise 2-bit EF, J = 2,
    K = 3, worker 1 out), from one TrainState (workers moved off the outer
    params, nonzero residuals): Psi and the new residuals equal the
    reference's jitted outer_step bitwise, the dropped worker's residuals
    untouched; the outer params within the outer Nesterov's FMA contraction
    (3 ulps, as test_compressed_sync_bitwise_matches_reference)."""
    jd, td, *_, jstate = _ref_pair(3, "adamw", "rowwise2-ef", elastic=True,
                                   streaming_partitions=2)
    rng = np.random.default_rng(17)
    mask = np.array([1, 0, 1], np.float32)
    jstate = jstate.replace(
        worker_params=jax.tree.map(lambda w: w + jnp.asarray(
            rng.standard_normal(w.shape).astype(np.float32) * 1e-3), jstate.worker_params),
        ef=jax.tree.map(lambda e: jnp.asarray(
            rng.standard_normal(e.shape).astype(np.float32) * 1e-4), jstate.ef),
        participation=jnp.asarray(mask))
    tstate = train_state(**state_from_numpy(_jstate_numpy(jstate), "cpu"))
    jm = jmake_streaming_masks(jstate, jd)[j]
    jnew, jpsi = jax.jit(lambda st: jouter_step(jd, st, mask=jm, outer=jmake_outer(jd)))(jstate)
    tnew, tpsi = outer_step(td, tstate, mask=make_streaming_masks(tstate, td)[j],
                            outer=make_outer(td))
    assert_tree_close(tpsi, jax.tree.map(np.asarray, jpsi), "psi", atol=0, rtol=0)
    assert_tree_close(tnew["ef"], jax.tree.map(np.asarray, jnew.ef), "ef", atol=0, rtol=0)
    assert_tree_close(_worker(tnew["ef"], 1), jax.tree.map(lambda e: np.asarray(e)[1], jstate.ef),
                      "frozen", atol=0, rtol=0)
    for path, t in tree_leaves_with_paths(tnew["outer_params"]):
        want = dict(tree_leaves_with_paths(state_from_numpy(
            jax.tree.map(np.asarray, jnew.outer_params), "cpu")))[path].numpy()
        np.testing.assert_allclose(t.numpy(), want, rtol=0,
                                   atol=3 * np.spacing(np.abs(want).max()), err_msg=path)


@pytest.mark.parametrize("masked", [False, True])
def test_reported_loss_bitwise_matches_reference_k3(masked):
    """The inner step's reported loss at K = 3, from one TrainState and one
    batch: the reference's jnp.mean (sum * (1/3)) and, with a mask, its
    sum(p*l) * (1/max(sum p, 1)), bit for bit; the per-worker losses too."""
    jd, td, jo, to, jmodel, tmodel, jstate = _ref_pair(3, "adamw", elastic=True)
    part = np.array([1, 1, 0] if masked else [1, 1, 1], np.float32)
    batch = {k: v[0] for k, v in _batches(3).items()}
    jopt = jmake_optimizer(jd, jo)
    _, jm = jax.jit(lambda st, b: jinner_step(
        jmodel, jopt, st, b, participation=jnp.asarray(part) if masked else None))(
        {"worker_params": jstate.worker_params, "inner_state": jstate.inner_state},
        {k: jnp.asarray(v) for k, v in batch.items()})
    tstate = train_state(**state_from_numpy(_jstate_numpy(jstate), "cpu"))
    _, tm = inner_step(tmodel, make_optimizer(td, to), tstate,
                       {k: torch.from_numpy(v) for k, v in batch.items()},
                       participation=torch.from_numpy(part) if masked else None)
    jper = np.asarray(jm["loss_per_worker"])
    np.testing.assert_allclose(tm["loss_per_worker"].numpy(), jper, atol=1e-5, rtol=0)
    # on the reference's per-worker losses the port's reduction is bitwise
    # the reference's reported loss (a true division by 3, torch.mean's,
    # differs in the last ulp for some values)
    from repro_torch.core.collectives import participation_mean

    got = participation_mean(torch.from_numpy(jper.copy()), torch.from_numpy(part) if masked else None)
    assert got.numpy().tobytes() == np.asarray(jm["loss"], np.float32).tobytes()
    assert torch.equal(tm["loss"], participation_mean(
        tm["loss_per_worker"], torch.from_numpy(part) if masked else None))


# -------------------------------------------------------------- checkpoints

def test_checkpoint_with_participation_and_pending_loads_both_ways(tmp_path):
    """A TrainState with participation, pending and EF residuals: the
    reference's checkpoint loads in the port and the port's in the
    reference, every leaf bitwise, under the same leaf paths."""
    jd, td, jo, to, jmodel, tmodel, jstate = _ref_pair(2, "muon", "quant2-ef", elastic=True,
                                                       sync_delay=2)
    rng = np.random.default_rng(5)
    jstate = jstate.replace(
        participation=jnp.asarray([1.0, 0.0]),
        pending=jax.tree.map(lambda q: jnp.asarray(rng.standard_normal(q.shape), jnp.float32),
                             jstate.pending))
    tstate = train_state(**state_from_numpy(_jstate_numpy(jstate), "cpu"))
    assert {"participation", "pending", "ef"} <= set(tstate)
    template = diloco_init(tmodel, td, to, torch.Generator().manual_seed(1), "cpu")
    jsave_checkpoint(str(tmp_path / "ref.npz"), jstate, step=3)
    loaded, step = load_checkpoint(str(tmp_path / "ref.npz"), template)
    assert step == 3
    _equal(loaded, tstate)
    save_checkpoint(str(tmp_path / "port.npz"), tstate, step=4)
    back, step = jload_checkpoint(str(tmp_path / "port.npz"), jstate)
    assert step == 4
    assert_tree_close(state_to_numpy(tstate), _jstate_numpy(back), atol=0, rtol=0)


# -------------------------------------------------------------- the CLI

def _cli(tmp_path, sub, *extra):
    args = ttrain.build_parser().parse_args([
        "--arch", "smollm-135m", "--reduced", "--device", "cpu", "--inner", "adamw",
        "--lr", "4e-3", "--workers", "4", "--sync-interval", "2", "--rounds", "3",
        "--batch-per-worker", "2", "--seq-len", "32", "--out", str(tmp_path / sub), *extra])
    return ttrain.train(args)


def _csv(tmp_path, sub):
    with open(os.path.join(tmp_path, sub, "metrics.csv")) as f:
        return list(csv.DictReader(f))


def test_train_cli_fault_scenario_completes_and_logs_columns(tmp_path):
    """The reference's K = 4 scenario (tests/test_elastic.py): workers 1
    and 2 out in round 1 and --sync-delay 1 complete; metrics.csv's
    active_workers are [4, 2, 4] and staleness 1; the lockstep run logs 4
    and 0; the final loss stays within the reference's budget of 2.0 of
    the lockstep run's."""
    lockstep = _cli(tmp_path, "lockstep")
    faulty = _cli(tmp_path, "faulty", "--drop-schedule", "1:1;1:2", "--sync-delay", "1")
    rows, dense = _csv(tmp_path, "faulty"), _csv(tmp_path, "lockstep")
    assert [float(r["active_workers"]) for r in rows] == [4.0, 2.0, 4.0]
    assert all(float(r["staleness"]) == 1.0 for r in rows)
    assert all(float(r["active_workers"]) == 4.0 and float(r["staleness"]) == 0.0
               for r in dense)
    assert np.isfinite(faulty["final_loss"])
    assert abs(faulty["final_loss"] - lockstep["final_loss"]) < 2.0


def test_resume_inside_a_dropped_span_reproduces_masks(tmp_path):
    """--drop-prob masks are a pure function of (seed, round): a run stopped
    after round 1 and resumed with --resume auto writes metrics.csv rows,
    less wall_s, equal to an uninterrupted run's, drops included."""
    drop = ["--workers", "2", "--drop-prob", "0.5", "--drop-seed", "0",
            "--checkpoint-every", "1"]
    _cli(tmp_path, "full", *drop)
    args = ["--rounds", "2"]
    _cli(tmp_path, "cut", *drop, *args)
    _cli(tmp_path, "cut", *drop, "--resume", "auto")
    full, cut = _csv(tmp_path, "full"), _csv(tmp_path, "cut")
    plan = tfaults.FaultPlan(n_workers=2, drop_prob=0.5, seed=0)
    assert [float(r["active_workers"]) for r in full] == plan.masks(0, 3).sum(axis=1).tolist()
    assert min(float(r["active_workers"]) for r in full) < 2
    strip = [[{k: v for k, v in r.items() if k != "wall_s"} for r in rows]
             for rows in (full, cut)]
    assert strip[0] == strip[1]


# ----------------------------------------------------- the wall-clock model

HW = dict(peak_flops=500e12, hbm_bw=2e12, link_bw=100e9, chips=64, assumed_mfu=0.35)
SPEC = dict(n_params=1e8, n_active_params=1e8, batch_tokens=2 ** 17, seq_len=1024,
            n_steps=300, sync_interval=30, n_workers=16, wire_bytes_per_sync=3.3e7)


@pytest.mark.parametrize("sigma,drop_prob,seed", [
    (0.0, 0.0, 0), (0.5, 0.0, 1), (0.5, 0.3, 2), (0.8, 1.0, 3), (0.1, 0.6, 4)])
def test_straggler_models_equal_reference(sigma, drop_prob, seed):
    """Under one explicit HardwareModel: the step, sync and training times,
    the utilization, the sampled multipliers and masks, the round times and
    the straggler stats equal the reference's exactly."""
    jhw, thw = jwallclock.HardwareModel(**HW), twallclock.HardwareModel(**HW)
    jspec, tspec = jwallclock.RunSpec(**SPEC), twallclock.RunSpec(**SPEC)
    jm = jwallclock.StragglerModel(sigma=sigma, drop_prob=drop_prob, seed=seed, n_rounds=512)
    tm = twallclock.StragglerModel(sigma=sigma, drop_prob=drop_prob, seed=seed, n_rounds=512)
    assert tm.is_trivial == jm.is_trivial
    for name in ("step_compute_time",):
        assert getattr(twallclock, name)(tspec, thw) == getattr(jwallclock, name)(jspec, jhw)
    assert twallclock.sync_comm_time(tspec, 1e9) == jwallclock.sync_comm_time(jspec, 1e9)
    for name in ("training_time_hours", "compute_utilization"):
        assert (getattr(twallclock, name)(tspec, 1e9, thw)
                == getattr(jwallclock, name)(jspec, 1e9, jhw))
    for a, b in zip(tm.sample(16), jm.sample(16)):
        assert a.tobytes() == b.tobytes()
    assert (twallclock.straggler_round_times(tspec, 1e9, tm, thw).tobytes()
            == jwallclock.straggler_round_times(jspec, 1e9, jm, jhw).tobytes())
    assert (twallclock.straggler_stats(tspec, 1e9, tm, thw)
            == jwallclock.straggler_stats(jspec, 1e9, jm, jhw))
    ratio = dataclasses.replace(tspec, wire_bytes_per_sync=0.0, compression_ratio=0.0625)
    jratio = dataclasses.replace(jspec, wire_bytes_per_sync=0.0, compression_ratio=0.0625)
    assert twallclock.sync_comm_time(ratio, 1e9) == jwallclock.sync_comm_time(jratio, 1e9)


def test_hardware_model_defaults_are_an_h100s():
    """The port's default HardwareModel is the H100 SXM data sheet's (dense
    bf16, HBM3, NVLink 4 per direction), not the reference's chip."""
    hw = twallclock.HardwareModel()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12, 450e9)
