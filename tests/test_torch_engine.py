"""PyTorch port: R rounds per dispatch (engine/superstep.py, the engine and
the driver) and checkpoints that cross between the two packages.

On the CPU the engine runs its round program eagerly (no CUDA graph), which
is what these tests pin: any R is bitwise the same run, the folded eval is
the separate eval, the port's superstep agrees with the reference's on the
same TrainState, and a checkpoint written by either package loads in the
other, bf16 leaves included. The captured path on the card is held to the
same equalities by ``chip_smoke.py``.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_models import LAST_SMALL  # noqa: E402  (kimi-k2's and mistral-large's narrow widths)
from test_torch_train import _cfgs, _jstate_numpy, _ladder_cfgs, assert_tree_close  # noqa: E402

from repro.checkpoint import load_checkpoint as jload_checkpoint  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave_checkpoint  # noqa: E402
from repro.core import DiLoCoConfig as JDiLoCoConfig  # noqa: E402
from repro.core import diloco_init as jdiloco_init  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import MarkovStream as JMarkovStream  # noqa: E402
from repro.engine import TrainEngine as JTrainEngine  # noqa: E402
from repro.engine import superstep as jsuperstep  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.optim import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.core import DiLoCoConfig  # noqa: E402
from repro_torch.data import (  # noqa: E402
    DataConfig,
    MarkovStream,
    batches_for_round,
    batches_for_span,
)
from repro_torch.engine import TrainEngine, run_rounds, train_state  # noqa: E402
from repro_torch.engine import superstep as tsuperstep  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.optim import OptimizerConfig  # noqa: E402
from repro_torch.utils.tree import state_from_numpy, tree_leaves_with_paths  # noqa: E402

CFG = ModelConfig(arch_type="dense", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                  d_ff=64, vocab=64, remat=False, dtype="float32", qk_norm=True)
H, K = 2, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one torch thread computes them as fast and
    leaves the cores to the other files of a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(seed=3, n_workers=K):
    return MarkovStream(DataConfig(vocab=CFG.vocab, seq_len=16, batch_per_worker=2,
                                   n_workers=n_workers, seed=seed))


def _engine(inner="muon", **dkw):
    dcfg = DiLoCoConfig(n_workers=K, sync_interval=H, inner_name=inner, **dkw)
    engine = TrainEngine(build_model(CFG), dcfg, OptimizerConfig(lr=1e-2, weight_decay=0.0))
    return engine, engine.init(torch.Generator().manual_seed(0), "cpu")


def _eval(r0, n):
    return {k: v[:, 0] for k, v in _stream(seed=99, n_workers=1).batch_stack(r0, n).items()}


def _assert_states_equal(a, b):
    la, lb = tree_leaves_with_paths(a), tree_leaves_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), p


# ------------------------------------------------------------ dispatch plan

_GRID = [(rounds, every, start, measured)
         for rounds in (0, 1, 5, 6, 12) for every in (0, 2, 3, 4) for start in (0, 3, 4)
         for measured in (None, (0.001, 0.05), (0.010, 0.020), (0.0001, 0.05))]


@pytest.mark.parametrize("requested", [1, 2, 3, 4, 12, "auto"])
def test_rounds_per_dispatch_equal_reference(requested):
    """``effective_rounds_per_dispatch`` (the cadence clamps, a resumed
    start, "auto" measured and not) and ``auto_rounds_per_dispatch`` give
    the reference's R on a grid of inputs."""
    assert tsuperstep.MAX_DISPATCH_OVERHEAD_FRAC == jsuperstep.MAX_DISPATCH_OVERHEAD_FRAC
    for rounds, every, start, measured in _GRID:
        kw = {} if measured is None else dict(host_overhead_s=measured[0],
                                              device_round_s=measured[1])
        want = jsuperstep.effective_rounds_per_dispatch(requested, rounds, every, start, **kw)
        got = tsuperstep.effective_rounds_per_dispatch(requested, rounds, every, start, **kw)
        assert got == want, (requested, rounds, every, start, measured)
        if requested == "auto":
            assert (tsuperstep.auto_rounds_per_dispatch(rounds, **kw)
                    == jsuperstep.auto_rounds_per_dispatch(rounds, **kw))


# ------------------------------------------------------------- R invariance

def _six_rounds(inner, R):
    engine, state = _engine(inner)
    stream = _stream()
    losses, evals = [], []
    for r0 in range(0, 6, R):
        state, out = engine.superstep(state, batches_for_span(stream, r0, H, R), _eval(r0, R))
        assert out["loss"].shape == (R, H) and out["eval_loss"].shape == (R,)
        assert ("psi" in out) == (R == 1)
        losses.append(out["loss"])
        evals.append(out["eval_loss"])
    return state, torch.cat(losses), torch.cat(evals), engine.dispatch_count


@pytest.mark.parametrize("R", [1, 2, 3, 6])
@pytest.mark.parametrize("inner", ["muon", "adamw"])
def test_rounds_per_dispatch_bitwise_equal_six_single_rounds(inner, R):
    """Six rounds as 6/R dispatches of R rounds equal six ``engine.step``
    calls plus a separate eval per round: losses, eval losses and the final
    state, bit for bit."""
    engine, state = _engine(inner)
    stream = _stream()
    losses, evals = [], []
    for r in range(6):
        state, info = engine.step(state, batches_for_round(stream, r, H))
        losses.append(info["loss"])
        evals.append(engine.eval_loss(state["outer_params"],
                                      {k: v[0] for k, v in _eval(r, 1).items()}))
    got_state, got_losses, got_evals, dispatches = _six_rounds(inner, R)
    assert dispatches == 6 // R
    assert torch.equal(got_losses, torch.stack(losses))
    assert torch.equal(got_evals, torch.stack(evals))
    assert int(got_state["round"]) == 6
    _assert_states_equal(got_state, state)


def test_folded_eval_equals_separate_eval():
    """The eval loss folded into the round program is the engine's
    ``eval_loss`` of the post-sync outer params, bitwise."""
    engine, state = _engine("adamw")
    state, out = engine.superstep(state, batches_for_span(_stream(), 0, H, 1), _eval(0, 1))
    sep = engine.eval_loss(state["outer_params"], {k: v[0] for k, v in _eval(0, 1).items()})
    assert torch.equal(out["eval_loss"][0], sep)


def test_batches_for_span_equals_stacked_rounds():
    stream = _stream()
    span = batches_for_span(stream, 2, 3, 4)
    for k, v in span.items():
        assert v.shape == (4, 3, K, 2, 16) and v.dtype == torch.int32
        assert torch.equal(v, torch.stack([batches_for_round(stream, 2 + i, 3)[k]
                                           for i in range(4)]))


def _driven(R, **kw):
    engine, state = _engine("muon")
    stream = _stream()
    telemetry = {}
    state, hist = run_rounds(engine, state, lambda r: batches_for_round(stream, r, H), 6,
                             rounds_per_dispatch=R, eval_batches_for=_eval,
                             span_batches_for=lambda r0, n: batches_for_span(stream, r0, H, n),
                             telemetry=telemetry, **kw)
    return state, [{k: v for k, v in h.items() if k != "wall_s"} for h in hist], telemetry


def test_run_rounds_three_per_dispatch_equals_one():
    """run_rounds at R = 3 (two dispatches, late reads) and R = 1 give the
    same records and the same final state; the telemetry says what ran."""
    s1, h1, t1 = _driven(1)
    s3, h3, t3 = _driven(3, max_in_flight=1)
    sa, ha, ta = _driven("auto")
    assert (t1["dispatches"], t3["dispatches"], ta["dispatches"]) == (6, 2, 1)
    assert (t1["rounds_per_dispatch"], t3["rounds_per_dispatch"],
            ta["rounds_per_dispatch"]) == (1, 3, 6)
    assert [h["round"] for h in h3] == list(range(6))
    assert h1 == h3 == ha
    assert all(h["comm_bytes"] > 0 and h["active_workers"] == K for h in h1)
    _assert_states_equal(s1, s3)
    _assert_states_equal(s1, sa)


def test_capture_true_on_cpu_raises():
    """capture=True asks for CUDA graphs: on a CPU state it raises rather
    than running eagerly."""
    dcfg = DiLoCoConfig(n_workers=K, sync_interval=H, inner_name="adamw")
    engine = TrainEngine(build_model(CFG), dcfg, OptimizerConfig(), capture=True)
    with pytest.raises(ValueError, match="capture"):
        engine.init(torch.Generator().manual_seed(0), "cpu")
    eager, state = _engine("adamw")
    with pytest.raises(ValueError, match="capture"):
        engine.step(state, batches_for_round(_stream(), 0, H))
    assert int(state["round"]) == 0  # nothing ran
    assert not engine._graphs and engine.replays == 0


# ------------------------------------------------- against the reference

@pytest.mark.parametrize("inner", ["muon", "adamw"])
def test_superstep_r2_matches_reference(inner):
    """Two rounds in one dispatch, with the folded eval, from one TrainState
    (bridged) and the same batches: the port's superstep against the
    reference's ``build_superstep_fn`` (through its engine), at the
    tolerances of test_one_diloco_round_matches_reference; the round
    counter and comm_bytes exactly."""
    jcfg, tcfg = _cfgs()
    dkw = dict(n_workers=2, sync_interval=2, inner_name=inner, ns_impl="pallas",
               outer_kernel=inner == "muon")
    jd, td = JDiLoCoConfig(**dkw), DiLoCoConfig(**dkw)
    okw = dict(lr=2e-2, weight_decay=1e-4, schedule="cosine", warmup_steps=1, total_steps=4)
    jo, to = JOptimizerConfig(**okw), OptimizerConfig(**okw)
    jmodel = jbuild_model(jcfg)
    jstate = jdiloco_init(jmodel, jd, jo, jax.random.PRNGKey(0))
    tstate = train_state(**state_from_numpy(_jstate_numpy(jstate), "cpu"))
    stream = JMarkovStream(JDataConfig(vocab=jcfg.vocab, seq_len=16, batch_per_worker=2,
                                       n_workers=2, seed=3))
    flat = {k: np.array(v) for k, v in stream.batch_stack(0, 4).items()}
    batches = {k: v.reshape(2, 2, *v.shape[1:]) for k, v in flat.items()}
    ev = {k: np.array(v)[:, 0] for k, v in JMarkovStream(JDataConfig(
        vocab=jcfg.vocab, seq_len=16, batch_per_worker=2, seed=9)).batch_stack(0, 2).items()}

    jnew, jout = JTrainEngine(jmodel, jd, jo).superstep(
        jstate, {k: jnp.asarray(v) for k, v in batches.items()},
        {k: jnp.asarray(v) for k, v in ev.items()})
    tnew, tout = TrainEngine(build_model(tcfg), td, to).superstep(
        tstate, {k: torch.from_numpy(v) for k, v in batches.items()},
        {k: torch.from_numpy(v) for k, v in ev.items()})
    adam = dict(adamw_tol=okw["lr"], all_adam=inner == "adamw")
    tight = dict(atol=2e-5, rtol=1e-4, **adam)
    assert set(tout) == set(jout)
    assert_tree_close(tout["loss"], jout["loss"], "loss", **tight)
    assert_tree_close(tout["eval_loss"], jout["eval_loss"], "eval_loss", **tight)
    assert_tree_close(tnew["worker_params"], jnew.worker_params, "workers", **tight)
    assert_tree_close(tnew["outer_params"], jnew.outer_params, "outer", **tight)
    assert_tree_close(tnew["outer_opt"], jax.tree.map(np.asarray, jnew.outer_opt), "u",
                      atol=2e-4, rtol=1e-4, **adam)
    assert int(tnew["round"]) == int(jnew.round) == 2
    assert np.array_equal(tout["comm_bytes"].numpy(), np.asarray(jout["comm_bytes"]))


# deepseek-moe-16b at a narrow width (test_torch_models.py's MOE_SMALL)
MOE_SMALL = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, d_ff=32,
                 vocab=128, n_experts=8, experts_per_token=2, n_shared_experts=1, moe_groups=2,
                 dtype="float32", remat=False, attn_impl="pallas")


def test_moe_round_matches_reference(monkeypatch):
    """One MuLoCo round (K = 2, H = 2, fp32 Newton-Schulz, the outer
    Nesterov) of the narrow deepseek-moe-16b from one bridged TrainState:
    losses (aux included), worker and outer params and the outer momentum
    against the reference's superstep at the dense round's tolerances. The port runs its kernels' plain versions
    (``ns_impl='pallas'``, ``outer_kernel``); the reference runs its fp32
    Newton-Schulz through its own plain oracle (``kernels/ref.py``, which
    its tests hold its Pallas kernel to; interpret mode would take ~10 s)
    and its XLA outer update. The launch formula counts 11 Muon leaves (four
    attention matrices, the router, three expert banks, three shared
    matrices) among 18."""
    from repro.configs import get_config as jget_config
    from repro.kernels import ref as jref
    from repro_torch.configs import get_config as tget_config

    jmuon = sys.modules["repro.optim.muon"]  # the module (repro.optim.muon is the function)

    def ns_plain(g, iters=5, eps=1e-7):
        *batch, m, n = g.shape
        return jref.ns_orthogonalize_ref(g.reshape(-1, m, n), iters, eps).reshape(g.shape)

    monkeypatch.setattr(jmuon, "newton_schulz_pallas", ns_plain)
    jcfg = jget_config("deepseek-moe-16b").replace(**MOE_SMALL)
    tcfg = tget_config("deepseek-moe-16b").replace(**MOE_SMALL)
    dkw = dict(n_workers=2, sync_interval=2, inner_name="muon", ns_impl="pallas")
    jd, td = JDiLoCoConfig(**dkw), DiLoCoConfig(**dkw, outer_kernel=True)
    okw = dict(lr=2e-2, weight_decay=1e-4, schedule="cosine", warmup_steps=1, total_steps=2)
    jo, to = JOptimizerConfig(**okw), OptimizerConfig(**okw)
    jmodel = jbuild_model(jcfg)
    # one compile for the whole init (eager, each draw compiles on its own)
    jstate = jax.jit(lambda key: jdiloco_init(jmodel, jd, jo, key))(jax.random.PRNGKey(0))
    tstate = train_state(**state_from_numpy(_jstate_numpy(jstate), "cpu"))
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 2, 2, 17)).astype(np.int32)
    batches = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}  # [H, K, B, S]
    jnew, jout = JTrainEngine(jmodel, jd, jo).superstep(
        jstate, {k: jnp.asarray(v)[None] for k, v in batches.items()})
    tengine = TrainEngine(build_model(tcfg), td, to)
    tnew, tout = tengine.superstep(
        tstate, {k: torch.from_numpy(v)[None] for k, v in batches.items()})
    tight = dict(atol=2e-5, rtol=1e-4, adamw_tol=okw["lr"])
    assert_tree_close(tout["loss"], jout["loss"], "loss", **tight)
    assert_tree_close(tnew["worker_params"], jnew.worker_params, "workers", **tight)
    assert_tree_close(tnew["outer_params"], jnew.outer_params, "outer", **tight)
    assert_tree_close(tnew["outer_opt"], jax.tree.map(np.asarray, jnew.outer_opt), "u",
                      atol=2e-4, rtol=1e-4, adamw_tol=okw["lr"])
    n = tengine.launches_per_round(tnew["outer_params"])
    assert n["matmul_epilogue"] == 2 * 2 * 3 * 5 * 11 and n["nesterov"] == 18


def _last_cfgs(name: str):
    """kimi-k2's or mistral-large's narrow widths (test_torch_models.py's
    LAST_SMALL) in both packages: the reference on its XLA attention, the
    port on the flash path (the kernels' plain versions, which
    test_torch_kernels.py holds to the interpret-mode Pallas kernels)."""
    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config as tget_config

    small = LAST_SMALL[name]
    return (jget_config(name).replace(attn_impl="xla", **small),
            tget_config(name).replace(attn_impl="pallas", **small))


@pytest.mark.parametrize("name", sorted(LAST_SMALL))
def test_last_models_round_matches_reference(name, monkeypatch):
    """One MuLoCo round (K = 2, H = 2, fp32 Newton-Schulz, the outer
    Nesterov) of the narrow kimi-k2 (hd 112, G = 8, 6 experts top-2) and
    mistral-large (G = 12) from one TrainState bridged by state_from_numpy:
    losses, worker and outer params and the outer momentum against the
    reference's superstep at the MoE round's tolerances (the reference's
    Newton-Schulz through its plain oracle, as there); the launch formula's
    Muon leaves: kimi-k2's four attention matrices, router, three expert
    banks and three shared matrices (11), mistral-large's seven matrices."""
    from repro.kernels import ref as jref

    jmuon = sys.modules["repro.optim.muon"]

    def ns_plain(g, iters=5, eps=1e-7):
        *batch, m, n = g.shape
        return jref.ns_orthogonalize_ref(g.reshape(-1, m, n), iters, eps).reshape(g.shape)

    monkeypatch.setattr(jmuon, "newton_schulz_pallas", ns_plain)
    jcfg, tcfg = _last_cfgs(name)
    dkw = dict(n_workers=2, sync_interval=2, inner_name="muon", ns_impl="pallas")
    jd, td = JDiLoCoConfig(**dkw), DiLoCoConfig(**dkw, outer_kernel=True)
    okw = dict(lr=2e-2, weight_decay=1e-4, schedule="cosine", warmup_steps=1, total_steps=2)
    jo, to = JOptimizerConfig(**okw), OptimizerConfig(**okw)
    jmodel = jbuild_model(jcfg)
    jstate = jax.jit(lambda key: jdiloco_init(jmodel, jd, jo, key))(jax.random.PRNGKey(0))
    tstate = train_state(**state_from_numpy(_jstate_numpy(jstate), "cpu"))
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 2, 2, 17)).astype(np.int32)
    batches = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}  # [H, K, B, S]
    jnew, jout = JTrainEngine(jmodel, jd, jo).superstep(
        jstate, {k: jnp.asarray(v)[None] for k, v in batches.items()})
    tengine = TrainEngine(build_model(tcfg), td, to)
    tnew, tout = tengine.superstep(
        tstate, {k: torch.from_numpy(v)[None] for k, v in batches.items()})
    tight = dict(atol=2e-5, rtol=1e-4, adamw_tol=okw["lr"])
    assert_tree_close(tout["loss"], jout["loss"], "loss", **tight)
    assert_tree_close(tnew["worker_params"], jnew.worker_params, "workers", **tight)
    assert_tree_close(tnew["outer_params"], jnew.outer_params, "outer", **tight)
    assert_tree_close(tnew["outer_opt"], jax.tree.map(np.asarray, jnew.outer_opt), "u",
                      atol=2e-4, rtol=1e-4, adamw_tol=okw["lr"])
    n = tengine.launches_per_round(tnew["outer_params"])
    n_muon = 11 if jcfg.arch_type == "moe" else 7
    assert n["matmul_epilogue"] == 2 * 2 * 3 * 5 * n_muon
    assert n["flash_dq"] == n["flash_dkv"] == 2 * 2 * jcfg.n_layers


# ------------------------------------------------------------- checkpoints

def _bf16_state(jcfg=None):
    """A reference TrainState with bf16 leaves (bf16 inner state) and the
    port's copy of it (reduced smollm-135m unless ``jcfg`` is given)."""
    jcfg = jcfg or _cfgs()[0]
    jd = JDiLoCoConfig(n_workers=2, sync_interval=2, inner_name="muon")
    jmodel = jbuild_model(jcfg)
    jstate = jax.jit(lambda key: jdiloco_init(jmodel, jd, JOptimizerConfig(state_dtype="bfloat16"),
                                              key))(jax.random.PRNGKey(0))

    def to_torch(x):
        x = np.asarray(x)
        if x.dtype == jnp.bfloat16:
            return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(x))

    tstate = {f: jax.tree.map(to_torch, getattr(jstate, f)) for f in
              ("outer_params", "outer_opt", "worker_params", "inner_state", "round")}
    return jstate, train_state(**tstate)


def _assert_bits_equal(t_tree, j_tree):
    jflat = dict(jax.tree_util.tree_flatten_with_path(j_tree)[0])
    jflat = {"/".join(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))
                      for k in path): v for path, v in jflat.items()}
    tflat = tree_leaves_with_paths(t_tree)
    assert sorted(jflat) == [p for p, _ in tflat]
    n_bf16 = 0
    for p, t in tflat:
        j = np.asarray(jflat[p])
        if t.dtype == torch.bfloat16:
            n_bf16 += 1
            assert j.dtype == jnp.bfloat16, p
            assert np.array_equal(t.view(torch.int16).numpy(), j.view(np.int16)), p
        else:
            assert np.array_equal(t.numpy(), j), p
    assert n_bf16 > 0


def test_reference_checkpoint_loads_in_port(tmp_path):
    """A reference save_checkpoint of a reference TrainState with bf16
    leaves loads into the port bit for bit (bf16 read without ml_dtypes)."""
    jstate, tstate = _bf16_state()
    path = str(tmp_path / "ref.npz")
    jsave_checkpoint(path, jstate, step=5)
    loaded, step = load_checkpoint(path, tstate)
    assert step == 5
    _assert_bits_equal(loaded, jstate)
    for (p, a), (_, b) in zip(tree_leaves_with_paths(loaded), tree_leaves_with_paths(tstate)):
        assert a.dtype == b.dtype and torch.equal(a, b), p


def test_port_checkpoint_loads_in_reference(tmp_path):
    """A port save_checkpoint loads into the reference's load_checkpoint
    (its TrainState template) bit for bit; the file's meta has the
    reference's keys and stores bf16 as uint16 bits."""
    jstate, tstate = _bf16_state()
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, tstate, step=7)
    loaded, step = jload_checkpoint(path, jstate)
    assert step == 7
    _assert_bits_equal(tstate, loaded)
    with np.load(path) as z:
        import json

        meta = json.loads(bytes(z["__tree_meta__"]).decode())
        assert set(meta) == {"step", "paths", "dtypes", "crc32"}
        i = meta["dtypes"].index("bfloat16")
        assert z[f"leaf_{i}"].dtype == np.uint16


def test_ladder_checkpoint_crosses_both_ways(tmp_path):
    """The paper's ladder at hd 128 (post-norm and q/k norm scales, the
    untied head, Muon momenta on the hidden matrices and AdamW moments on
    the rest): a reference checkpoint of its TrainState loads into the port
    bit for bit, and the port's loads into the reference."""
    jstate, tstate = _bf16_state(_ladder_cfgs()[0])
    paths = [p for p, _ in tree_leaves_with_paths(tstate["outer_params"])]
    assert "head" in paths and "layers/ln2_post_scale" in paths
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    jsave_checkpoint(ref_path, jstate, step=3)
    loaded, step = load_checkpoint(ref_path, tstate)
    assert step == 3
    _assert_bits_equal(loaded, jstate)
    save_checkpoint(port_path, tstate, step=4)
    jloaded, step = jload_checkpoint(port_path, jstate)
    assert step == 4
    _assert_bits_equal(tstate, jloaded)


@pytest.mark.parametrize("name", sorted(LAST_SMALL))
def test_last_models_checkpoints_cross_both_ways(tmp_path, name):
    """The narrow kimi-k2 (expert banks, router, shared experts, q/k norm
    scales at hd 112) and mistral-large (G = 12) TrainStates with bf16 inner
    state: a reference checkpoint loads into the port bit for bit, and the
    port's loads into the reference."""
    jcfg = _last_cfgs(name)[0]
    jstate, tstate = _bf16_state(jcfg)
    paths = [p for p, _ in tree_leaves_with_paths(tstate["outer_params"])]
    assert ("layers/moe/experts/w_in" in paths) == (jcfg.arch_type == "moe")
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    jsave_checkpoint(ref_path, jstate, step=3)
    loaded, step = load_checkpoint(ref_path, tstate)
    assert step == 3
    _assert_bits_equal(loaded, jstate)
    save_checkpoint(port_path, tstate, step=4)
    jloaded, step = jload_checkpoint(port_path, jstate)
    assert step == 4
    _assert_bits_equal(tstate, jloaded)


def test_in_program_checkpoint_bytes_identical_to_host_path(tmp_path):
    """Checkpoints copied out inside the dispatch (one dispatch for 4 rounds)
    equal, byte for byte, those written between dispatches (R clamped to
    the cadence: two dispatches); both runs end in the same state."""
    def saves(sub, **kw):
        d = tmp_path / sub
        os.makedirs(d)
        seen = []

        def on_state(r, st):
            path = str(d / f"ckpt_{r}.npz")
            save_checkpoint(path, st, step=r + 1)
            seen.append(path)

        engine, state = _engine("muon")
        stream = _stream()
        tel = {}
        state, _ = run_rounds(engine, state, lambda r: batches_for_round(stream, r, H), 4,
                              rounds_per_dispatch="auto", on_state=on_state, on_state_every=2,
                              telemetry=tel, **kw)
        assert engine.checkpoint_sink is None
        return state, seen, tel

    host_state, host_ckpts, host_tel = saves("host")
    prog_state, prog_ckpts, prog_tel = saves("prog", checkpoint_in_program=True)
    assert host_tel["dispatches"] == 2 and not host_tel["in_program_checkpoints"]
    assert prog_tel["dispatches"] == 1 and prog_tel["in_program_checkpoints"]
    assert [os.path.basename(p) for p in host_ckpts] == \
           [os.path.basename(p) for p in prog_ckpts] == ["ckpt_1.npz", "ckpt_3.npz"]
    for a, b in zip(host_ckpts, prog_ckpts):
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
    _assert_states_equal(host_state, prog_state)


def test_ckpt_flags_require_sink():
    engine, state = _engine("adamw")
    batches = batches_for_span(_stream(), 0, H, 2)
    fn = tsuperstep.build_superstep_fn(lambda s, b: (s, {"loss": s["round"]}))
    with pytest.raises(ValueError, match="checkpoint_cb"):
        fn(state, batches, ckpt_flags=[True, False])


# ---------------------------------------------------------------------------
# The mesh: worlds of 2 and 4 gloo ranks on the CPU (tests/_torch_mesh_harness.py)
# ---------------------------------------------------------------------------

HARNESS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_mesh_harness.py")
MESH_KERNELS = ("flash_fwd", "flash_bwd", "paged_decode", "matmul_epilogue", "nesterov",
                "quantize", "quantize_codes", "dequantize")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# the dry run on a fake world of 8 ranks (2x2x2) over reduced smollm and
# reduced paper-150m (whose 4 heads split over 'model' = 2: the plans run
# tensor-parallel), the train plans at 64 positions x 8 sequences (one
# process; the fake backend)
DRYRUN = """
import json, torch
torch.set_num_threads(1)
from repro_torch.launch.dryrun import run_one
recs = {arch: run_one(arch, "train_4k", True, mesh_shape=(2, 2, 2), reduced=True,
                      sync_interval=2, rounds_per_dispatch=2, seq_len=64, global_batch=8,
                      verbose=False) for arch in ("smollm-135m", "paper-150m")}
print(json.dumps(recs, default=str))
"""


@pytest.fixture(scope="module")
def mesh_worlds(tmp_path_factory) -> dict:
    """Both worlds, the dry run, the kill drill's world and the tensor-
    parallel world (``MESH_TP``, two ranks) started together, each process
    with its own timeout, then the resume drill's world once every rank of
    the kill drill is dead; rank 0's JSON verdicts by world size, the dry
    run's records under "dryrun", the drill's under "drill" (the killed
    ranks' exit codes under "killed"), the tensor-parallel world's under
    "tp"."""
    import json
    import subprocess

    repo = os.path.dirname(os.path.dirname(HARNESS))
    drill_out = str(tmp_path_factory.mktemp("mesh_drill") / "run")

    def world_procs(name, world, **extra):
        port = _free_port()
        for rank in range(world):
            env = dict(os.environ, PYTHONPATH="src", RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                       **extra)
            procs[(name, rank)] = subprocess.Popen(
                [sys.executable, HARNESS], cwd=repo, env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    procs = {}
    procs[("dryrun", 0)] = subprocess.Popen(
        [sys.executable, "-c", DRYRUN], cwd=repo, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, env=dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1"))
    world_procs("kill", 2, MESH_DRILL="kill", MESH_DRILL_OUT=drill_out)
    world_procs("tp", 2, MESH_TP="1")
    for world in (2, 4):
        world_procs(world, world)
    outs = {}
    try:
        for rank in range(2):  # the killed world, then the resumed one
            outs[("kill", rank)] = procs[("kill", rank)].communicate(timeout=240)
        world_procs("resume", 2, MESH_DRILL="resume", MESH_DRILL_OUT=drill_out)
        for key, proc in procs.items():
            if key not in outs:
                outs[key] = proc.communicate(timeout=240)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    verdicts = {"killed": [procs[("kill", r)].returncode for r in range(2)]}
    for world in (2, 4, "dryrun", "resume", "tp"):
        for rank in range(world if isinstance(world, int) else 1 if world == "dryrun" else 2):
            assert procs[(world, rank)].returncode == 0, outs[(world, rank)][1][-3000:]
        verdicts[world] = json.loads(outs[(world, 0)][0].strip().splitlines()[-1])
    verdicts["drill"] = verdicts.pop("resume")["resume"]
    verdicts["tp"] = verdicts["tp"]["tp"]
    return verdicts


@pytest.mark.parametrize("world", [2, 4], ids=["pod2", "pod2_data2"])
@pytest.mark.parametrize("kernel", MESH_KERNELS)
def test_mesh_kernel_bitwise_single_process(mesh_worlds, world, kernel):
    """Each kernel wrapper's plain version, given replicated DTensors and
    routed by ``kernel_specs`` on the (pod=2) and (pod=2, data=2) meshes,
    runs on each rank's block and gathers to the one-process result on the
    whole tensor, bitwise (flash_bwd: dq, dk and dv through DTensor
    autograd). The row-split kernels show their local block."""
    v = mesh_worlds[world]["kernels"][kernel]
    assert "error" not in v, v.get("error")
    assert v["bitwise"]
    split = {2: {"nesterov", "quantize", "quantize_codes", "dequantize"},
             4: {"paged_decode", "matmul_epilogue", "nesterov", "quantize", "quantize_codes",
                 "dequantize"}}[world]
    if kernel in split:  # the rows the routed kernel ran on: a block of the whole
        assert v["local"][0] * (2 if kernel in ("paged_decode", "matmul_epilogue") else world) \
            == v["whole"][0], v


def test_mesh_round_2x1x1_bitwise_single_process(mesh_worlds):
    """One reduced smollm MuLoCo round (K = 2, H = 2, Muon with the fp32
    Newton-Schulz kernel route, 2-bit EF wire, the outer Nesterov kernel)
    on a 2x1x1 mesh, each rank holding one worker, from the placed
    one-process state: losses, Psi and every leaf of the gathered state ==
    the one-process engine's, bitwise."""
    v = mesh_worlds[2]["round_2x1x1"]
    assert "error" not in v, v.get("error")
    assert v["bitwise"], v


def test_mesh_train_cli_2x1x1_bitwise_single_process(mesh_worlds):
    """``launch/train.py --mesh 2x1x1 --device cpu`` in a world of two
    ranks trains two reduced rounds whose train and eval losses are the
    one-process CLI's, bitwise."""
    v = mesh_worlds[2]["cli_2x1x1"]
    assert "error" not in v, v.get("error")
    assert v["rounds"] == 2 and v["bitwise"], v


@pytest.mark.parametrize("mesh", ["2x2x1", "2x2"])
def test_mesh_round_within_compressed_round_tolerance(mesh_worlds, mesh):
    """The same round on 2x2x1 (pod, data) and on the no-pod 2x2 (data,
    model): each worker's batch is split over 'data' and its gradients
    averaged there, which sums in another order, so the round is held at
    test_compressed_round_matches_reference's tolerance (losses atol 2e-5 +
    rtol 1e-4; Psi's codes equal on >= 99.9% and within one quantization
    step; outer params and momentum within lr (1 + mu) steps; EF residuals
    within 1.01 of their range)."""
    v = mesh_worlds[4][f"round_{mesh}"]
    assert "error" not in v, v.get("error")
    assert v["within_tolerance"], v


@pytest.mark.parametrize("variant", ["streaming", "elastic", "delay"])
def test_mesh_round_variants_2x1x1_bitwise_single_process(mesh_worlds, variant):
    """Two reduced smollm rounds on 2x1x1 of streaming (J = 2, 2-bit
    row-wise EF: each segment syncs its partition's rows), elastic drops
    (2-bit EF, worker 1 out in round 0 and worker 0 in round 1) and a sync
    delay of 1 (Psi applied a round late through the FIFO in the outer
    layout): every leaf of the whole state after each round, the losses,
    Psi, comm_bytes, active_workers and staleness == the one-process
    engine's, bitwise. Elastic: each round's dropped worker's EF residual
    comes back bit-identical."""
    v = mesh_worlds[2][variant]
    assert "error" not in v, v.get("error")
    assert v["bitwise"], v
    if variant == "elastic":
        assert v["frozen"] == [True, True] and v["active_workers"] == [1.0, 1.0], v


def test_mesh_fault_plan_same_masks_on_every_rank(mesh_worlds):
    """``FaultPlan`` built from the same flags on each rank of the world of
    two (drop_prob 0.5, a schedule, ``--drop-seed 7``) gives every rank the
    same [8, K] masks, gathered and compared on rank 0."""
    v = mesh_worlds[2]["fault_plan"]
    assert "error" not in v, v.get("error")
    assert v["same"] and v["dropped"] > 0, v


@pytest.mark.parametrize("inner", ["muon", "adamw"])
def test_mesh_dp_baseline_data2_within_tolerance(mesh_worlds, inner):
    """``dp_engine(model, inner, icfg, mesh=)`` on the (data=2, model=2)
    mesh: K = 1, each rank 2 of the 4 rows and the gradients averaged over
    'data'. fp32 on the CPU, where only the sum order of the two half-batch
    gradients differs from one process: three steps' losses within rtol
    1e-5 and every param within 5% of the inner LR
    (``_torch_mesh_harness.DP_TOL``, which says why); not bitwise."""
    v = mesh_worlds[4]["dp_data2"][inner]
    assert "error" not in v, v.get("error")
    assert v["within"], v


def test_mesh_checkpoint_bytes_and_placement(mesh_worlds):
    """``--checkpoint-every 1 --checkpoint-in-program`` on 2x1x1: rank 0
    writes each round's file from the whole state, byte for byte the
    one-process run's (leaf paths, dtypes, CRC32s, archive); ckpt_2 loaded
    with ``shardings=state_shardings()`` sits under those placements and
    gathers to the mesh run's final state, bitwise."""
    v = mesh_worlds[2]["ckpt_2x1x1"]
    assert "error" not in v, v.get("error")
    assert v["files"] == ["ckpt_1.npz", "ckpt_2.npz"] and v["bytes_equal"], v
    assert v["step"] == 2 and v["placed"] is True and v["loaded_equal"], v


def test_mesh_nan_drill_metrics_equal_single_process(mesh_worlds):
    """``--health-sentinel on --checkpoint-every 1 --inject-nan-round 1`` on
    2x1x1: the NaN lands on global worker 0 (rank 0 only), both ranks roll
    back to ckpt_1 and skip round 1, and metrics.csv less wall_s equals the
    one-process drill's."""
    v = mesh_worlds[2]["nan_2x1x1"]
    assert "error" not in v, v.get("error")
    assert v["csv_equal"] and v["rounds"] == ["0", "2"], v
    assert v["telemetry"] == {"rollbacks": 1, "skipped_rounds": 1}, v


def test_mesh_kill_resume_drill_equals_single_process(mesh_worlds):
    """``--inject-kill-round 1`` on 2x1x1 kills every rank (SIGKILL, after
    rank 0's row and a barrier); ``--resume auto`` in a new world of two
    resumes from ckpt_1: metrics.csv less wall_s and the final outer params
    equal the uninterrupted one-process run's."""
    import signal

    assert mesh_worlds["killed"] == [-signal.SIGKILL] * 2
    v = mesh_worlds["drill"]
    assert "error" not in v, v.get("error")
    assert v["csv_equal"] and v["rows"] == ["0", "1", "2"] and v["outer_equal"], v


def test_mesh_paged_decode_span_data2(mesh_worlds):
    """A PagedEngine on a (data=2) mesh (the paged kernel's plain version on
    each rank's block of slots, the pool whole): greedy tokens == one
    process's over the same requests, through five spans."""
    v = mesh_worlds[2]["serving_data2"]
    assert "error" not in v, v.get("error")
    assert v["tokens_equal"] and v["spans"] == 5, v


def test_dryrun_fake_world_train_plans_ok(mesh_worlds):
    """``launch/dryrun.run_one`` on a fake world of 8 ranks (2x2x2) over
    reduced smollm: the four train plans placed and called, each record
    ``status: ok`` with rank 0's placed-argument bytes, the bytes it
    gathered (the sync's pseudogradients across 'pod', θ from its ZeRO
    layout, the gradients over 'data') and no peak memory, which a dry run
    does not measure."""
    recs = mesh_worlds["dryrun"]["smollm-135m"]
    assert [r["plan"] for r in recs] == ["train_step", "sync_step", "round_step", "superstep"]
    for r in recs:
        assert r["status"] == "ok", r.get("error")
        assert r["mesh"] == "2x2x2" and r["chips"] == 8
        assert r["memory"]["argument_bytes"] > 0 and r["memory"]["peak_per_chip_gib"] is None
        assert r["collectives"]["total"] > 0 and r["roofline"]["compute_s"] > 0
    sync = recs[1]["collectives"]
    assert sync["outer"] > 0 and sync["workers"] > 0
    assert recs[0]["collectives"]["grads"] > 0


# ---------------------------------------------------------------------------
# Tensor parallelism over 'model' and Newton-Schulz over 'data' (the world of
# two ranks with MESH_TP; the narrow dense LM of _torch_mesh_harness.TP_CFG)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("run", ["sound", "streaming", "elastic", "delay", "dp"])
def test_mesh_tp_1x2_within_tolerance_of_single_process(mesh_worlds, run):
    """(a) The narrow dense LM (fp32, Muon with the fp32 Newton-Schulz kernel
    route, the outer Nesterov kernel) on 1x2 splits each worker over
    'model' (column-parallel q/k/v and FFN columns, row-parallel wo and
    w_out, the partial outputs summed): after two rounds its per-step losses
    and every outer-param leaf are within ``TP_TOL`` of one process; so are
    streaming (J = 2, dense), elastic drops (worker 1 out in round 0, worker
    0 in round 1), a sync delay of 1 and the DP baseline (``dp_engine``,
    three steps)."""
    v = mesh_worlds["tp"]["rounds"][run]
    assert "error" not in v, v.get("error")
    assert v["tp"] and v["within"], v


@pytest.mark.parametrize("fault", ["row_sum", "qk_norm"])
def test_mesh_tp_planted_fault_leaves_tolerance(mesh_worlds, fault):
    """(b) The same 1x2 run with a planted fault is outside ``TP_TOL``: the
    MLP's row-parallel partial outputs left unsummed, or the QK-norm scales'
    gradients left to each rank's own heads (the round still runs, the norms
    drift apart)."""
    v = mesh_worlds["tp"]["rounds"][fault]
    assert "error" not in v, v.get("error")
    assert v["tp"] and not v["within"], v


def test_mesh_tp_streaming_wire_within_wire_tolerance(mesh_worlds):
    """(e) Streaming (J = 2) on the 2-bit row-wise EF wire under 1x2: the
    outer params within ``TP_WIRE_TOL`` of one process (the 2-bit wire turns
    any reordered sum into code flips; the harness says why), and a planted
    fault of the sync's layout (each rank given the other's blocks back after
    the reset) outside it."""
    rounds = mesh_worlds["tp"]["rounds"]
    sound, fault = rounds["streaming_wire"], rounds["streaming_wire_swap"]
    assert "error" not in sound and "error" not in fault, (sound, fault)
    assert sound["tp"] and sound["within"] and not fault["within"], (sound, fault)


def test_mesh_tp_blocks_are_a_share_of_the_whole(mesh_worlds):
    """During a 1x2 round each rank holds 1/2 of every block matrix of its
    workers ([K, L, ...] leaves of the narrow LM: d 64, 4 heads of 16, 2 kv
    heads, d_ff 128): column-parallel wq / wk / wv / w_in / w_gate split on
    dim -1, row-parallel wo / w_out on dim -2; every other leaf whole."""
    blocks = mesh_worlds["tp"]["rounds"]["blocks"]
    want = {"layers/attn/wq": [2, 2, 64, 32], "layers/attn/wk": [2, 2, 64, 16],
            "layers/attn/wv": [2, 2, 64, 16], "layers/attn/wo": [2, 2, 32, 64],
            "layers/mlp/w_in": [2, 2, 64, 64], "layers/mlp/w_gate": [2, 2, 64, 64],
            "layers/mlp/w_out": [2, 2, 64, 64], "embed": [2, 256, 64], "head": [2, 64, 256],
            "layers/attn/q_norm_scale": [2, 2, 16], "layers/ln1_scale": [2, 2, 64]}
    assert {p: blocks[p] for p in want} == want, blocks


def test_mesh_ns_split_over_data_bitwise_unsplit(mesh_worlds):
    """(c) One reduced smollm round (2-bit EF) on (data = 2): Muon's
    Newton-Schulz stack split over 'data' (each rank one of the 2 matrices
    of a stacked leaf, gathered whole) against the same mesh with the
    engine's ``KernelPartitioning`` at ``ns_axes=()`` (each rank the whole
    stack): every state leaf, the losses and Psi bitwise."""
    v = mesh_worlds["tp"]["ns_split"]
    assert "error" not in v, v.get("error")
    assert v["bitwise"] and v["rows_split"] == [1] and v["rows_whole"] == [2], v


def test_mesh_tp_off_config_bitwise_whole_worker(mesh_worlds):
    """(d) The reduced smollm (4 heads over one kv head, which does not
    divide 'model' = 2) on 1x2 keeps each worker whole on both ranks (the
    engine says why) and its round is the one-process round, bitwise."""
    v = mesh_worlds["tp"]["off"]
    assert "error" not in v, v.get("error")
    assert v["tp"] is False and v["bitwise"], v


def test_mesh_tp_checkpoint_resume_bitwise(mesh_worlds):
    """(f) ``--arch paper-150m --reduced --mesh 1x2 --checkpoint-every 1``:
    ckpt_2 holds the whole state (the one-process leaf shapes), and the
    command resumed from ckpt_1 into another directory ends in the
    uninterrupted run's whole state, bitwise, with its round-1 metrics row
    (but wall_s)."""
    v = mesh_worlds["tp"]["cli"]
    assert "error" not in v, v.get("error")
    assert v["tp"] and v["state_equal"] and v["row_equal"] and v["ckpt_whole"], v


def test_mesh_tp_nan_drill_rolls_back(mesh_worlds):
    """The health rollback under 1x2: ``--health-sentinel on --inject-nan-round
    1`` rolls back to ckpt_1 and skips round 1 on both ranks, as one process
    does, its losses within ``TP_TOL``."""
    v = mesh_worlds["tp"]["cli"]
    assert "error" not in v, v.get("error")
    assert v["nan_telemetry"] == {"rollbacks": 1, "skipped_rounds": 1}, v
    assert v["nan_rounds"] == v["nan_rounds_one"] == [0, 2], v
    assert v["nan_within"], v


@pytest.mark.parametrize("feature", ["normuon"])
def test_mesh_tp_unsupported_feature_raises_by_name(mesh_worlds, feature):
    """(g) A feature that does not run tensor-parallel raises, naming
    itself: ``--inner normuon`` (its neuron-wise RMS reads whole rows)."""
    v = mesh_worlds["tp"]["raises"][feature]
    assert f"--inner {feature}" in v and "tensor parallel" in v, v


def test_dryrun_fake_world_tensor_parallel_plans_ok(mesh_worlds):
    """The dry run's four train plans over reduced paper-150m on the fake
    2x2x2 world run tensor-parallel over 'model' = 2: each ``status: ok``;
    the inner step sums partial activations over 'model' and gathers Muon's
    momentum whole there, the sync gathers the worker params whole there."""
    recs = mesh_worlds["dryrun"]["paper-150m"]
    assert [r["plan"] for r in recs] == ["train_step", "sync_step", "round_step", "superstep"]
    for r in recs:
        assert r["status"] == "ok", r.get("error")
    assert recs[0]["collectives"]["model"] > 0 and recs[0]["collectives"]["model_momentum"] > 0
    assert recs[1]["collectives"]["model_sync"] > 0 and "model" not in recs[1]["collectives"]
