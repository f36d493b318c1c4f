"""PyTorch port: the training slice against the JAX package, reduced smollm-135m.

Parameters come from the reference's ``model.init`` and whole TrainStates
from its ``diloco_init``; both cross to the port through numpy
(``params_from_numpy`` / ``state_from_numpy``). Batches are the reference's
``MarkovStream`` draws, handed to both sides. Each kernel path runs as its
plain PyTorch version on the CPU; the reference's Pallas kernels run in
interpret mode. Tolerances are stated per test with their reason.
"""
import csv
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.core import DiLoCoConfig as JDiLoCoConfig  # noqa: E402
from repro.core import diloco_init as jdiloco_init  # noqa: E402
from repro.core import diloco_round as jdiloco_round  # noqa: E402
from repro.core import make_optimizer as jmake_optimizer  # noqa: E402
from repro.core import make_outer as jmake_outer  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import MarkovStream as JMarkovStream  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.optim import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import DiLoCoConfig, make_optimizer, make_outer  # noqa: E402
from repro_torch.core import diloco_round as tdiloco_round  # noqa: E402
from repro_torch.data import DataConfig, MarkovStream, batches_for_round  # noqa: E402
from repro_torch.data import synthetic as tsynthetic  # noqa: E402
from repro_torch.engine import FIELDS, TrainEngine, train_state  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import build_model as tbuild_model  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.optim import OptimizerConfig, muon_label  # noqa: E402
from repro_torch.utils.tree import (  # noqa: E402
    params_from_numpy,
    state_from_numpy,
    state_to_numpy,
    tree_leaves_with_paths,
)


def _cfgs(**upd):
    j = reduce_config(get_config("smollm-135m")).replace(**upd)
    t = tconfigs.reduce_config(tconfigs.get_config("smollm-135m")).replace(**upd)
    return j, t


def _batch(vocab, B=2, S=16, seed=0):
    """One reference batch ([B, S] tokens and labels) as numpy."""
    st = JMarkovStream(JDataConfig(vocab=vocab, seq_len=S, batch_per_worker=B, seed=seed))
    return {k: np.array(v[0]) for k, v in st.batch(0).items()}


def assert_tree_close(t_tree, j_tree, path="", adamw_tol=None, all_adam=False, **tol):
    """Same structure (dict keys, tuple lengths, None holes) and close leaves.

    ``adamw_tol`` (an absolute bound) relaxes the leaves AdamW updates
    (``muon_label``, or every leaf with ``all_adam``): Adam's direction
    m / (sqrt(v) + eps) maps a gradient entry near eps = 1e-8 to anything in
    (-1, 1), so a 1e-9 cross-framework difference in such an entry can move
    that parameter by up to lr. All but 1% of those entries must still meet
    ``tol``; the rest meet adamw_tol."""
    if j_tree is None or t_tree is None:
        assert j_tree is None and t_tree is None, f"{path}: hole mismatch"
        return
    if isinstance(j_tree, dict):
        assert set(t_tree) == set(j_tree), f"{path}: keys {set(t_tree)} != {set(j_tree)}"
        for k in j_tree:
            assert_tree_close(t_tree[k], j_tree[k], f"{path}/{k}", adamw_tol, all_adam, **tol)
        return
    if isinstance(j_tree, (tuple, list)):
        assert len(t_tree) == len(j_tree), f"{path}: length"
        for i, (a, b) in enumerate(zip(t_tree, j_tree)):
            assert_tree_close(a, b, f"{path}/{i}", adamw_tol, all_adam, **tol)
        return
    t = t_tree.detach().float().numpy() if isinstance(t_tree, torch.Tensor) else t_tree
    j = np.asarray(j_tree, np.float32)
    assert t.shape == j.shape, f"{path}: shape {t.shape} != {j.shape}"
    if adamw_tol is not None and (all_adam or muon_label(path, j) == "adamw"):
        bad = np.abs(t - j) > tol["atol"] + tol["rtol"] * np.abs(j)
        assert bad.mean() <= 1e-2, f"{path}: {bad.sum()} of {bad.size} entries off"
        np.testing.assert_allclose(t, j, atol=adamw_tol, rtol=0, err_msg=path)
        return
    np.testing.assert_allclose(t, j, err_msg=path, **tol)


# ------------------------------------------------------------------- data

def test_markov_stream_table_and_shapes():
    """The transition table (numpy) is bitwise the reference's; batches have
    the reference's [H, K, B, S] shapes, labels are tokens shifted by one,
    every transition is one of the chain's, and a round's batches are a pure
    function of its steps (the same for any chunking)."""
    jcfg = JDataConfig(vocab=64, seq_len=12, batch_per_worker=3, n_workers=2, seed=5)
    tcfg = DataConfig(vocab=64, seq_len=12, batch_per_worker=3, n_workers=2, seed=5)
    table = jsynthetic._transition_table(jcfg)
    np.testing.assert_array_equal(tsynthetic._transition_table(tcfg), table)
    stream = MarkovStream(tcfg)
    b = batches_for_round(stream, 2, 4)
    assert b["tokens"].shape == b["labels"].shape == (4, 2, 3, 12)
    assert b["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(b["tokens"][..., 1:].numpy(), b["labels"][..., :-1].numpy())
    toks = torch.cat([b["tokens"], b["labels"][..., -1:]], -1).numpy()
    for prev, nxt in zip(toks[..., :-1].ravel(), toks[..., 1:].ravel()):
        assert nxt in table[prev]
    again = stream.batch_stack(9, 2)
    np.testing.assert_array_equal(again["tokens"].numpy(), b["tokens"][1:3].numpy())
    assert stream.entropy_floor_nats() == JMarkovStream(jcfg).entropy_floor_nats()


# --------------------------------------------------------- loss and grads

@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_loss_and_grads_match_reference(impl, fused):
    """Model.loss and every gradient leaf == jax.value_and_grad(model.loss)
    on the reference's params and batch, fp32. The fused loss is chunked by
    8 positions here (S = 16) to run the chunk loop. Loss atol 1e-5; grads
    atol 2e-5 + rtol 1e-4: the two frameworks sum in another order through
    two layers and the backward of the tied embedding (a scatter-add)."""
    jcfg, tcfg = _cfgs(attn_impl=impl)
    jmodel, tmodel = build_model(jcfg), tbuild_model(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    batch = _batch(jcfg.vocab)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    def jloss(p):
        if fused:
            hidden, _ = jmodel._fam["forward"](jcfg, p, jbatch["tokens"], hidden_only=True)
            from repro.models.common import fused_cross_entropy
            return fused_cross_entropy(hidden, jmodel.head_weight(p), jbatch["labels"], chunk=8)
        return jmodel.loss(p, jbatch, fused=False)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    leaves = {p: t.requires_grad_(True) for p, t in tree_leaves_with_paths(tparams)}
    if fused:
        hidden, _ = tmodel._fam["forward"](tcfg, tparams, tbatch["tokens"], hidden_only=True)
        tl, tm = tcommon.fused_cross_entropy(hidden, tmodel.head_weight(tparams),
                                             tbatch["labels"], chunk=8)
    else:
        tl, tm = tmodel.loss(tparams, tbatch, fused=False)
    grads = torch.autograd.grad(tl, list(leaves.values()))
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5)
    assert float(tm["tokens"]) == float(jm["tokens"])
    jflat = dict(tree_leaves_with_paths(params_from_numpy(jax.tree.map(np.asarray, jg), "cpu")))
    assert set(jflat) == set(leaves)
    for path, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), jflat[path].numpy(), atol=2e-5, rtol=1e-4,
                                   err_msg=path)


def test_model_loss_defaults_and_remat_change_no_number():
    """Model.loss (fused, the reference's default) == the unfused loss, and
    cfg.remat (per-layer torch.utils.checkpoint) gives the same loss and
    gradients bit for bit."""
    _, tcfg = _cfgs(attn_impl="pallas")
    jparams = build_model(_cfgs()[0]).init(jax.random.PRNGKey(1))
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg.vocab, seed=1).items()}
    out = {}
    for remat in (False, True):
        model = tbuild_model(tcfg.replace(remat=remat))
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        leaves = [t.requires_grad_(True) for _, t in tree_leaves_with_paths(params)]
        loss, metrics = model.loss(params, batch)
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
        assert set(metrics) == {"loss", "tokens", "loss_total"}
        with torch.no_grad():
            unfused, _ = model.loss(params, batch, fused=False)
        np.testing.assert_allclose(loss.item(), unfused.item(), atol=1e-6)
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)


# --------------------------------------------------- TrainState and round

def _jstate_numpy(state):
    return {f: jax.tree.map(np.asarray, getattr(state, f)) for f in FIELDS
            if getattr(state, f) is not None}


def test_state_bridge_round_trip():
    """The whole reference TrainState (outer params, K-stacked workers, the
    inner state with its None holes, Nesterov u, the round counter) crosses
    to the port and back unchanged, with the reference's field names."""
    jcfg, _ = _cfgs()
    dcfg = JDiLoCoConfig(n_workers=2, sync_interval=2, inner_name="muon")
    jstate = jdiloco_init(build_model(jcfg), dcfg, JOptimizerConfig(), jax.random.PRNGKey(0))
    np_state = _jstate_numpy(jstate)
    tstate = train_state(**state_from_numpy(np_state, "cpu"))
    assert set(tstate) == {"outer_params", "outer_opt", "worker_params", "inner_state", "round"}
    assert tstate["round"].dtype == torch.int32
    assert tstate["inner_state"]["tx"]["muon"][0]["m"]["embed"] is None
    assert tstate["inner_state"]["tx"]["adamw"]["m"]["layers"]["mlp"]["w_in"] is None
    back = state_to_numpy(tstate)
    assert_tree_close(back, np_state, atol=0, rtol=0)
    with pytest.raises(KeyError):
        train_state(**state_from_numpy(np_state, "cpu"), bogus=1)


@pytest.mark.parametrize("inner,outer_kernel", [("muon", True), ("adamw", False)])
def test_one_diloco_round_matches_reference(inner, outer_kernel):
    """One round, K = 2, H = 2, compression none, fp32 Newton-Schulz
    (ns_impl='pallas' on both sides), from the same TrainState (bridged) and
    the same batches: worker params, outer params, Nesterov u, Psi, the
    inner state and the per-step losses agree. atol 2e-5 + rtol 1e-4 on
    parameters, momenta and losses (two inner steps of fp32 arithmetic in
    another summation order); 2e-4 on u and Psi, which are differences of
    parameters of size ~0.1 and keep their absolute error. The AdamW-updated
    leaves (embed, norms) hold 99% of entries to those bounds and all to
    lr = 2e-2 (see assert_tree_close); with the AdamW inner optimizer that
    is every leaf."""
    jcfg, tcfg = _cfgs(attn_impl="pallas")
    dkw = dict(n_workers=2, sync_interval=2, inner_name=inner, ns_impl="pallas",
               outer_kernel=outer_kernel)
    jd, td = JDiLoCoConfig(**dkw), DiLoCoConfig(**dkw)
    okw = dict(lr=2e-2, weight_decay=1e-4, schedule="cosine", warmup_steps=1, total_steps=4)
    jo, to = JOptimizerConfig(**okw), OptimizerConfig(**okw)
    jmodel = build_model(jcfg)
    jstate = jdiloco_init(jmodel, jd, jo, jax.random.PRNGKey(0))
    tstate = train_state(**state_from_numpy(_jstate_numpy(jstate), "cpu"))
    stream = JMarkovStream(JDataConfig(vocab=jcfg.vocab, seq_len=16, batch_per_worker=2,
                                       n_workers=2, seed=3))
    batches = {k: np.array(v) for k, v in stream.batch_stack(0, 2).items()}

    jnew, jinfo = jdiloco_round(jmodel, jd, jmake_optimizer(jd, jo), jstate,
                                {k: jnp.asarray(v) for k, v in batches.items()},
                                outer=jmake_outer(jd))
    tnew, tinfo = tdiloco_round(tbuild_model(tcfg), td, make_optimizer(td, to), tstate,
                                {k: torch.from_numpy(v) for k, v in batches.items()},
                                outer=make_outer(td))
    adam = dict(adamw_tol=okw["lr"], all_adam=inner == "adamw")
    tight = dict(atol=2e-5, rtol=1e-4, **adam)
    assert_tree_close(tinfo["loss"], jinfo["loss"], "loss", **tight)
    assert_tree_close(tnew["worker_params"], jnew.worker_params, "workers", **tight)
    assert_tree_close(tnew["outer_params"], jnew.outer_params, "outer", **tight)
    assert_tree_close(tnew["inner_state"], jax.tree.map(np.asarray, jnew.inner_state),
                      "inner", **tight)
    assert_tree_close(tnew["outer_opt"], jax.tree.map(np.asarray, jnew.outer_opt), "u",
                      atol=2e-4, rtol=1e-4, **adam)
    assert_tree_close(tinfo["psi"], jax.tree.map(np.asarray, jinfo["psi"]), "psi",
                      atol=2e-4, rtol=1e-4, **adam)
    assert int(tnew["round"]) == int(jnew.round) == 1
    assert float(tinfo["comm_bytes"]) == float(jinfo["comm_bytes"])
    assert float(tinfo["active_workers"]) == 2.0 and float(tinfo["staleness"]) == 0.0


def test_engine_eval_loss_and_deferred_configs():
    """TrainEngine runs a round and evaluates the outer params; configs of
    later slices raise NotImplementedError naming ROADMAP.md."""
    _, tcfg = _cfgs()
    model = tbuild_model(tcfg)
    dcfg = DiLoCoConfig(n_workers=2, sync_interval=1, inner_name="adamw")
    engine = TrainEngine(model, dcfg, OptimizerConfig(lr=1e-2))
    state = engine.init(torch.Generator().manual_seed(0), "cpu")
    stream = MarkovStream(DataConfig(vocab=tcfg.vocab, seq_len=8, batch_per_worker=2,
                                     n_workers=2))
    state, info = engine.step(state, batches_for_round(stream, 0, 1))
    assert info["loss"].shape == (1,) and int(state["round"]) == 1
    ev = engine.eval_loss(state["outer_params"], {k: v[0, 0] for k, v in
                                                  stream.batch_stack(5, 1).items()})
    assert math.isfinite(float(ev))
    from repro_torch.core import CompressionConfig

    for bad in (dict(compression=CompressionConfig(kind="quant")), dict(streaming_partitions=2),
                dict(elastic=True), dict(sync_delay=1), dict(outer_enabled=False)):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            TrainEngine(model, DiLoCoConfig(**bad), OptimizerConfig())


def test_launches_per_round_formula():
    """The launch formula chip_smoke.py asserts on the card: 7 Muon leaves,
    11 leaves in all, the forward twice per layer and step under remat."""
    _, tcfg = _cfgs(attn_impl="pallas")
    dcfg = DiLoCoConfig(n_workers=2, sync_interval=3, ns_impl="pallas", outer_kernel=True)
    for remat in (False, True):
        model = tbuild_model(tcfg.replace(remat=remat))
        engine = TrainEngine(model, dcfg, OptimizerConfig())
        n = engine.launches_per_round(model.init(torch.Generator().manual_seed(0), "cpu"))
        assert n == {"flash_fwd": 6 * 2 * (2 if remat else 1) + 2, "paged_decode": 0,
                     "flash_dq": 12, "flash_dkv": 12, "matmul_epilogue": 6 * 3 * 5 * 7,
                     "nesterov": 11}


# ------------------------------------------------------------------- CLI

def _args(tmp_path, *extra):
    return ttrain.build_parser().parse_args([
        "--reduced", "--device", "cpu", "--workers", "2", "--sync-interval", "2",
        "--rounds", "2", "--seq-len", "16", "--batch-per-worker", "2",
        "--out", str(tmp_path), *extra])


def test_train_cli_on_cpu(tmp_path, capsys):
    """The CLI writes metrics.csv with the reference's columns and prints
    the reference's last lines; losses are finite."""
    out = ttrain.train(_args(tmp_path, "--outer-kernel"))
    text = capsys.readouterr().out
    with open(os.path.join(tmp_path, "metrics.csv")) as f:
        rows = list(csv.reader(f))
    ref_header = None
    src = open(jtrain.__file__).read()
    start = src.index('header = [')
    ref_header = eval(src[src.index("[", start):src.index("]", start) + 1])
    assert rows[0] == ref_header == ttrain.HEADER
    assert [r[0] for r in rows[1:]] == ["0", "1"]
    assert "dispatch telemetry: dispatches=2 rounds_per_dispatch=1" in text
    assert "final smoothed eval loss:" in text.splitlines()[-1]
    assert all(math.isfinite(v) for v in out["losses"])
    assert math.isfinite(out["final_loss"])
    # the reference's and the port's smoothing agree on the same history
    np.testing.assert_allclose(ttrain.smoothed_eval_loss(out["losses"], out["steps"], 2),
                               jtrain.smoothed_eval_loss(out["losses"], out["steps"], 2),
                               rtol=1e-6)


@pytest.mark.parametrize("flags", [
    ["--compression", "quant"], ["--error-feedback"], ["--streaming", "2"],
    ["--resume", "auto"], ["--checkpoint-every", "1"], ["--checkpoint-in-program"],
    ["--health-sentinel", "on"], ["--mesh", "2x2"], ["--drop-prob", "0.5"],
    ["--drop-schedule", "1:0"], ["--sync-delay", "1"], ["--inject-nan-round", "1"],
    ["--inject-spike-round", "1"], ["--inject-kill-round", "1"],
    ["--inner", "muon_bp"], ["--inner", "normuon"]])
def test_train_cli_deferred_flags_raise(tmp_path, flags):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ttrain.train(_args(tmp_path, *flags))


def test_train_parser_keeps_reference_flags():
    """Every flag of the reference's train parser exists in the port's, with
    --device the one addition and the two kernel switches defaulting to the
    kernels."""
    def flags(p):
        return {o for a in p._actions for o in a.option_strings}

    jflags, tflags = flags(jtrain.build_parser()), flags(ttrain.build_parser())
    assert tflags - jflags == {"--device"}
    assert jflags <= tflags
    args = ttrain.build_parser().parse_args([])
    assert (args.attn_impl, args.ns_impl, args.device) == ("pallas", "pallas", "cuda")
