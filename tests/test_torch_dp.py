"""PyTorch port: the data-parallel baselines (AdamW DP and Muon DP) against
the JAX package.

``dp_config`` / ``dp_init`` / ``dp_step`` (``core/diloco.py``) and
``dp_engine`` (``engine/engine.py``): the degenerate DiLoCo config K = 1,
H = 1 with no outer optimizer, so a round is one step of the inner
optimizer. Params come from the reference's ``model.init`` (a two-layer toy,
d = 32, vocab 64) and cross through numpy; batches are the reference's
``MarkovStream`` draws. Muon runs its fp32 Newton-Schulz (``ns_impl=
'pallas'``, the kernel's plain version on the CPU) on both sides.
Tolerances: TIGHT (atol 2e-5 + rtol 1e-4) on params, optimizer state and
losses after a few fp32 steps in another summation order; AdamW-updated
leaves as in tests/test_torch_train.py (``assert_tree_close``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_train import _jstate_numpy, assert_tree_close  # noqa: E402

from repro.core import diloco_init as jdiloco_init  # noqa: E402
from repro.core import dp_config as jdp_config  # noqa: E402
from repro.core import dp_init as jdp_init  # noqa: E402
from repro.core import dp_step as jdp_step  # noqa: E402
from repro.core import outer_step as jouter_step  # noqa: E402
from repro.core import DiLoCoConfig as JDiLoCoConfig  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import MarkovStream as JMarkovStream  # noqa: E402
from repro.engine import TrainEngine as JTrainEngine  # noqa: E402
from repro.models import ModelConfig as JModelConfig  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.optim import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.optim import make_inner_optimizer as jmake_inner_optimizer  # noqa: E402
from repro_torch.core import (  # noqa: E402
    DiLoCoConfig,
    dp_config,
    dp_init,
    dp_step,
    outer_step,
)
from repro_torch.data import DataConfig, MarkovStream, batches_for_round  # noqa: E402
from repro_torch.engine import dp_engine, run_rounds, train_state  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.optim import OptimizerConfig, make_inner_optimizer  # noqa: E402
from repro_torch.utils.tree import (  # noqa: E402
    state_from_numpy,
    tree_leaves_with_paths,
    tree_map,
)

MODEL = dict(arch_type="dense", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
             vocab=64, remat=False, dtype="float32", qk_norm=True, attn_impl="pallas")
OKW = dict(lr=2e-2, weight_decay=1e-4, schedule="cosine", warmup_steps=1, total_steps=8)
TIGHT = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal(a, b, what=""):
    la, lb = tree_leaves_with_paths(a), tree_leaves_with_paths(b)
    assert [p for p, _ in la] == [p for p, _ in lb], what
    for (p, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), f"{what}{p}"


def _batches(n, B=4, seed=3):
    """n reference batches of [B, 16] tokens and labels, numpy."""
    st = JMarkovStream(JDataConfig(vocab=64, seq_len=16, batch_per_worker=B, seed=seed))
    return [{k: np.array(v[0]) for k, v in st.batch(i).items()} for i in range(n)]


def _models():
    return jbuild_model(JModelConfig(**MODEL)), build_model(ModelConfig(**MODEL))


def _adam(inner):
    return dict(adamw_tol=OKW["lr"], all_adam=inner == "adamw")


@pytest.mark.parametrize("inner,ns_impl", [("adamw", "jnp"), ("muon", "jnp"),
                                           ("muon", "pallas")])
def test_dp_config_equals_reference(inner, ns_impl):
    """dp_config is the reference's degenerate config field for field."""
    want = dataclasses.asdict(jdp_config(inner, ns_impl=ns_impl))
    got = dataclasses.asdict(dp_config(inner, ns_impl=ns_impl))
    assert got == want
    assert (got["n_workers"], got["sync_interval"], got["outer_enabled"]) == (1, 1, False)


@pytest.mark.parametrize("inner", ["adamw", "muon"])
def test_dp_step_matches_reference(inner):
    """Three dp_step calls from the reference's dp_init state (bridged) on
    the same batches: losses, params and optimizer state within TIGHT."""
    jmodel, tmodel = _models()
    kw = {"ns_impl": "pallas"} if inner == "muon" else {}
    jstate, _ = jdp_init(jmodel, inner, JOptimizerConfig(**OKW), jax.random.PRNGKey(0))
    jopt = jmake_inner_optimizer(inner, JOptimizerConfig(**OKW), **kw)
    topt = make_inner_optimizer(inner, OptimizerConfig(**OKW), **kw)
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), "cpu")
    jstep = jax.jit(lambda st, b: jdp_step(jmodel, jopt, st, b))
    for b in _batches(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = dp_step(tmodel, topt, tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        assert_tree_close(tm["loss"], jm["loss"], "loss", **TIGHT, **_adam(inner))
    assert_tree_close(tstate["params"], jax.tree.map(np.asarray, jstate["params"]), "params",
                      **TIGHT, **_adam(inner))
    assert_tree_close(tstate["opt_state"], jax.tree.map(np.asarray, jstate["opt_state"]),
                      "opt", **TIGHT, **_adam(inner))


def test_dp_init_matches_reference_structure():
    """dp_init gives the reference's {"params", "opt_state"} with the same
    leaf paths and a working optimizer."""
    jmodel, tmodel = _models()
    jstate, _ = jdp_init(jmodel, "muon", JOptimizerConfig(), jax.random.PRNGKey(0))
    tstate, opt = dp_init(tmodel, "muon", OptimizerConfig(), torch.Generator().manual_seed(0),
                          "cpu")
    from repro.utils.tree import tree_paths as jtree_paths
    from repro_torch.utils.tree import tree_paths

    assert tree_paths(tstate) == sorted(jtree_paths(jstate))
    assert callable(opt.step)


def _dp_states(inner):
    """The reference's dp_engine state (fp32 Newton-Schulz for Muon) and the
    port's copy, with both engines."""
    jmodel, tmodel = _models()
    ns = "pallas" if inner == "muon" else "jnp"
    jengine = JTrainEngine(jmodel, jdp_config(inner, ns_impl=ns), JOptimizerConfig(**OKW))
    tengine = dp_engine(tmodel, inner, OptimizerConfig(**OKW), ns_impl=ns)
    jstate = jengine.init(jax.random.PRNGKey(0))
    tstate = train_state(**state_from_numpy(_jstate_numpy(jstate), "cpu"))
    return jengine, tengine, jstate, tstate


def _span(n, r0=0):
    """Round-stacked [n, H=1, K=1, B, S] batches of rounds r0..r0+n-1."""
    bs = _batches(r0 + n)[r0:]
    return {k: np.stack([b[k] for b in bs])[:, None, None] for k in bs[0]}


@pytest.mark.parametrize("inner", ["adamw", "muon"])
def test_dp_engine_matches_reference(inner):
    """Two dispatches of two rounds (= four DP steps) through dp_engine
    against the reference's engine from one TrainState: losses within
    TIGHT, outer and worker params within TIGHT, the outer params equal to
    worker 0's bitwise (K = 1: the sync copies w[0]), comm_bytes 0 and the
    round counter exactly."""
    jengine, tengine, jstate, tstate = _dp_states(inner)
    assert int(tengine.dcfg.n_workers) == 1 and not tengine.dcfg.outer_enabled
    for r0 in (0, 2):
        span = _span(2, r0)
        jstate, jout = jengine.superstep(jstate, {k: jnp.asarray(v) for k, v in span.items()})
        tstate, tout = tengine.superstep(tstate, {k: torch.from_numpy(v)
                                                  for k, v in span.items()})
        assert_tree_close(tout["loss"], jout["loss"], "loss", **TIGHT, **_adam(inner))
        assert tout["comm_bytes"].tolist() == np.asarray(jout["comm_bytes"]).tolist() == [0, 0]
    assert_tree_close(tstate["outer_params"], jstate.outer_params, "outer", **TIGHT,
                      **_adam(inner))
    assert_tree_close(tstate["worker_params"], jstate.worker_params, "workers", **TIGHT,
                      **_adam(inner))
    _equal(tstate["outer_params"], tree_map(lambda w: w[0], tstate["worker_params"]))
    assert int(tstate["round"]) == int(jstate.round) == 4


@pytest.mark.parametrize("inner", ["adamw", "muon"])
def test_dp_engine_round_is_dp_step_bitwise(inner):
    """A dp_engine round is one dp_step of the same optimizer, bit for bit
    (the same inner step; the K = 1 sync copies w[0] and broadcasts it
    back), over three rounds."""
    _, tmodel = _models()
    icfg = OptimizerConfig(**OKW)
    engine = dp_engine(tmodel, inner, icfg, ns_impl="pallas")
    state = engine.init(torch.Generator().manual_seed(0), "cpu")
    dp = {"params": tree_map(torch.clone, state["outer_params"]),
          "opt_state": tree_map(lambda s: s[0].clone(), state["inner_state"])}
    opt = make_inner_optimizer(inner, icfg, ns_impl="pallas")
    for b in _batches(3):
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        state, info = engine.step(state, {k: v[None, None] for k, v in tb.items()})
        dp, m = dp_step(tmodel, opt, dp, tb)
        assert torch.equal(info["loss"][0], m["loss"])
    _equal(dp["params"], state["outer_params"])
    _equal(dp["opt_state"], tree_map(lambda s: s[0], state["inner_state"]))


def test_dp_rounds_per_dispatch_bitwise():
    """run_rounds over 8 DP steps at R = 1, 4 and auto (one dispatch):
    the same records and final state, bit for bit."""
    _, tmodel = _models()
    stream = MarkovStream(DataConfig(vocab=64, seq_len=16, batch_per_worker=4, n_workers=1,
                                     seed=3))
    got = []
    for R in (1, 4, "auto"):
        engine = dp_engine(tmodel, "muon", OptimizerConfig(**OKW), ns_impl="pallas")
        state = engine.init(torch.Generator().manual_seed(0), "cpu")
        tel = {}
        state, hist = run_rounds(engine, state, lambda r: batches_for_round(stream, r, 1), 8,
                                 rounds_per_dispatch=R, telemetry=tel)
        got.append((state, [{k: v for k, v in h.items() if k != "wall_s"} for h in hist], tel))
    assert [t["dispatches"] for _, _, t in got] == [8, 2, 1]
    assert [h["step"] for h in got[0][1]] == list(range(1, 9))
    assert all(h["comm_bytes"] == 0 and h["active_workers"] == 1 for h in got[0][1])
    assert got[0][1][-1]["train_loss"] < got[0][1][0]["train_loss"]
    for state, hist, _ in got[1:]:
        assert hist == got[0][1]
        _equal(state, got[0][0])


@pytest.mark.parametrize("mask", [None, [1.0, 0.0, 1.0]])
def test_parameter_average_sync_matches_reference(mask):
    """outer_enabled=False at K = 3 (every-H parameter averaging): from one
    TrainState with the workers moved apart, the synced params are the
    K-mean (or the survivors' mean) of the worker params and every worker
    holds them after; Psi, params bitwise the reference's jitted
    outer_step; outer_opt untouched, and a state without outer_opt or ef
    syncs the same."""
    kw = dict(n_workers=3, sync_interval=2, outer_enabled=False, elastic=mask is not None)
    jd, td = JDiLoCoConfig(**kw), DiLoCoConfig(**kw)
    jmodel, _ = _models()
    jstate = jdiloco_init(jmodel, jd, JOptimizerConfig(), jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    jstate = jstate.replace(worker_params=jax.tree.map(
        lambda w: w + jnp.asarray(rng.standard_normal(w.shape), jnp.float32) * 1e-2,
        jstate.worker_params))
    if mask is not None:
        jstate = jstate.replace(participation=jnp.asarray(mask, jnp.float32))
    tstate = train_state(**state_from_numpy(_jstate_numpy(jstate), "cpu"))
    u0 = tree_map(torch.clone, tstate["outer_opt"])
    jnew, jpsi = jax.jit(lambda st: jouter_step(jd, st))(jstate)
    bare = {k: tree_map(torch.clone, v) for k, v in tstate.items() if k != "outer_opt"}
    tnew, tpsi = outer_step(td, tstate)
    assert_tree_close(tpsi, jax.tree.map(np.asarray, jpsi), "psi", atol=0, rtol=0)
    assert_tree_close(tnew["outer_params"], jnew.outer_params, "outer", atol=0, rtol=0)
    assert_tree_close(tnew["worker_params"], jnew.worker_params, "workers", atol=0, rtol=0)
    _equal(tnew["outer_opt"], u0)
    bare, _ = outer_step(td, bare)
    _equal(bare["outer_params"], tnew["outer_params"])
    assert int(tnew["round"]) == int(jnew.round) == 1


def test_dp_launch_formula():
    """The launches chip_smoke.py counts per DP step on the card: the flash
    forward twice a layer under remat (no eval in the DP run), dq and dkv
    once, 105 matmul_epilogue launches a step for Muon DP at full width's 7
    Muon leaves (3 x 5 iterations each), none for AdamW, and no Nesterov or
    wire launches."""
    from repro_torch.configs import get_config

    cfg = get_config("smollm-135m").replace(attn_impl="pallas")
    model = build_model(cfg.replace(n_layers=2, d_model=64, n_heads=2, n_kv_heads=1,
                                    head_dim=32, d_ff=128, vocab=128))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    for inner, ns in (("muon", 105), ("adamw", 0)):
        engine = dp_engine(model, inner, OptimizerConfig())  # the default: the kernel
        n = engine.launches_per_round(params, with_eval=False)
        assert n == {"flash_fwd": 4, "paged_decode": 0, "flash_dq": 2, "flash_dkv": 2,
                     "matmul_epilogue": ns, "nesterov": 0, "quantize": 0,
                     "dequantize": 0}, (inner, n)
