"""PyTorch port: the training slice against the JAX package, reduced smollm-135m.

Parameters come from the reference's ``model.init`` and whole TrainStates
from its ``diloco_init``; both cross to the port through numpy
(``params_from_numpy`` / ``state_from_numpy``). Batches are the reference's
``MarkovStream`` draws, handed to both sides. Each kernel path runs as its
plain PyTorch version on the CPU; the reference's Pallas kernels run in
interpret mode. Tolerances are stated per test with their reason.
"""
import csv
import dataclasses
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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Reduced models: one torch thread computes them faster than a pool of
    threads that spin beside the other files of a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**upd):
    j = reduce_config(get_config("smollm-135m")).replace(**upd)
    t = tconfigs.reduce_config(tconfigs.get_config("smollm-135m")).replace(**upd)
    return j, t


# the paper's ladder at a narrow hd-128 width, built the same way in both
# packages (reduce_config would give it hd 64)
LADDER_SMALL = dict(n_layers=2, d_model=256, n_heads=2, n_kv_heads=2, head_dim=128, d_ff=512,
                    vocab=512, dtype="float32", remat=False)


def _ladder_cfgs(**upd):
    return (get_config("paper-150m").replace(**LADDER_SMALL, **upd),
            tconfigs.get_config("paper-150m").replace(**LADDER_SMALL, **upd))


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


def test_markov_stream_starts_by_inverse_cdf():
    """Chain starts are the step generator's first K*B float64 uniforms
    looked up in the Zipf start distribution's CDF, summed once in numpy
    (a fixed table, so a step's draws repeat bit for bit on any device), and
    their frequencies follow that distribution."""
    cfg = DataConfig(vocab=64, seq_len=4, batch_per_worker=512, n_workers=2, seed=7)
    stream = MarkovStream(cfg)
    starts = stream.batch_stack(3, 2)["tokens"][..., 0].reshape(2, -1).numpy()
    zipf = 1.0 / (np.arange(1, cfg.vocab + 1) ** 1.2)
    cdf = np.cumsum(zipf / zipf.sum())
    np.testing.assert_array_equal(stream.start_cdf.numpy()[:-1], cdf[:-1])
    assert stream.start_cdf.dtype == torch.float64 and float(stream.start_cdf[-1]) == 1.0
    for h in range(2):
        gen = torch.Generator().manual_seed(tsynthetic._step_seed(cfg.seed, 3 + h))
        u = torch.rand(1024, generator=gen, dtype=torch.float64).numpy()
        np.testing.assert_array_equal(starts[h], np.searchsorted(stream.start_cdf.numpy(), u,
                                                                 side="right"))
    freq = np.bincount(starts.ravel(), minlength=cfg.vocab) / starts.size
    assert np.abs(freq - zipf / zipf.sum()).max() < 0.03


# --------------------------------------------------------- loss and grads

@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_loss_and_grads_match_reference(impl, fused):
    """Model.loss and every gradient leaf == jax.value_and_grad(model.loss)
    on the reference's params and batch, fp32. The fused loss is chunked by
    8 positions here (S = 16) to run the chunk loop. Loss atol 1e-5; grads
    atol 2e-5 + rtol 1e-4: the two frameworks sum in another order through
    two layers and the backward of the tied embedding (a scatter-add)."""
    _check_loss_and_grads(*_cfgs(attn_impl=impl), fused)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ladder_loss_and_grads_match_reference(impl):
    """As above (the same tolerances) for the paper's ladder at hd 128:
    post-norm scales, QK-norm at hd 128, MHA and the untied head, whose
    gradient comes from the fused loss's chunks."""
    _check_loss_and_grads(*_ladder_cfgs(attn_impl=impl), True)


def _check_loss_and_grads(jcfg, tcfg, fused):
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
    to the port and back unchanged, with the reference's field names and
    leaf path strings."""
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
    # path strings through tuples and None holes == the reference's path_str
    from repro.utils.tree import tree_paths as jtree_paths
    from repro_torch.utils.tree import tree_paths

    assert tree_paths(tstate["inner_state"]) == sorted(jtree_paths(jstate.inner_state))
    with pytest.raises(KeyError):
        train_state(**state_from_numpy(np_state, "cpu"), bogus=1)


@pytest.mark.parametrize("inner,outer_kernel,K", [
    ("muon", True, 2), ("adamw", False, 2), ("muon", True, 3), ("adamw", False, 3)],
    ids=["muon-True", "adamw-False", "muon-True-K3", "adamw-False-K3"])
def test_one_diloco_round_matches_reference(inner, outer_kernel, K):
    """One round, K = 2 or 3, H = 2, compression none, fp32 Newton-Schulz
    (ns_impl='pallas' on both sides), from the same TrainState (bridged) and
    the same batches: worker params, outer params, Nesterov u, Psi, the
    inner state and the per-step losses agree. atol 2e-5 + rtol 1e-4 on
    parameters, momenta and losses (two inner steps of fp32 arithmetic in
    another summation order); 2e-4 on u and Psi, which are differences of
    parameters of size ~0.1 and keep their absolute error. The AdamW-updated
    leaves (embed, norms) hold 99% of entries to those bounds and all to
    lr = 2e-2 (see assert_tree_close); with the AdamW inner optimizer that
    is every leaf."""
    _check_one_round(*_cfgs(attn_impl="pallas"), inner, outer_kernel, K)


@pytest.mark.parametrize("inner,outer_kernel", [("muon", True), ("adamw", False)])
def test_ladder_diloco_round_matches_reference(inner, outer_kernel):
    """One MuLoCo (Muon inner) and one DiLoCo (AdamW inner) round of the
    paper's ladder at hd 128, K = 2, with the tolerances of
    test_one_diloco_round_matches_reference; Muon takes the hidden matrices
    (q/k/v/o, w_in, w_gate, w_out) and AdamW the embed, the untied head and
    every norm scale, post-norms and q/k norms included."""
    _check_one_round(*_ladder_cfgs(attn_impl="pallas"), inner, outer_kernel, 2)


def _check_one_round(jcfg, tcfg, inner, outer_kernel, K, atol=2e-5, context: int = 0):
    """One round of both packages from one TrainState on the same batches
    ([H, K, B, S] tokens, and with ``context`` a [H, K, B, context,
    d_model] normal draw as the batch's "context" leaf)."""
    dkw = dict(n_workers=K, sync_interval=2, inner_name=inner, ns_impl="pallas",
               outer_kernel=outer_kernel)
    jd, td = JDiLoCoConfig(**dkw), DiLoCoConfig(**dkw)
    okw = dict(lr=2e-2, weight_decay=1e-4, schedule="cosine", warmup_steps=1, total_steps=4)
    jo, to = JOptimizerConfig(**okw), OptimizerConfig(**okw)
    jmodel = build_model(jcfg)
    jstate = jdiloco_init(jmodel, jd, jo, jax.random.PRNGKey(0))
    tstate = train_state(**state_from_numpy(_jstate_numpy(jstate), "cpu"))
    stream = JMarkovStream(JDataConfig(vocab=jcfg.vocab, seq_len=16, batch_per_worker=2,
                                       n_workers=K, seed=3))
    batches = {k: np.array(v) for k, v in stream.batch_stack(0, 2).items()}
    if context:
        batches["context"] = np.random.default_rng(4).standard_normal(
            (2, K, 2, context, jcfg.d_model)).astype(np.float32)

    jnew, jinfo = jdiloco_round(jmodel, jd, jmake_optimizer(jd, jo), jstate,
                                {k: jnp.asarray(v) for k, v in batches.items()},
                                outer=jmake_outer(jd))
    tnew, tinfo = tdiloco_round(tbuild_model(tcfg), td, make_optimizer(td, to), tstate,
                                {k: torch.from_numpy(v) for k, v in batches.items()},
                                outer=make_outer(td))
    adam = dict(adamw_tol=okw["lr"], all_adam=inner == "adamw")
    tight = dict(atol=atol, rtol=1e-4, **adam)
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
    assert float(tinfo["active_workers"]) == K and float(tinfo["staleness"]) == 0.0
    return tnew, jnew


SSM_ARCHS = {"ssm": "mamba2-370m", "hybrid": "zamba2-2.7b"}


@pytest.mark.parametrize("kind", sorted(SSM_ARCHS))
def test_ssm_diloco_round_matches_reference(kind, tmp_path, monkeypatch):
    """One MuLoCo round (Muon inner, fp32 Newton-Schulz on both sides, the
    outer Nesterov kernel's plain version) of the reduced mamba2-370m and
    zamba2-2.7b (the hybrid's 4-D [ns, period, ...] mamba leaves and its
    unstacked shared block through Muon; the reference runs its fp32
    Newton-Schulz through its own plain oracle, ``kernels/ref.py``, which
    its tests hold its Pallas kernel to: interpret mode would take ~25 s),
    with the tolerances of
    test_one_diloco_round_matches_reference but atol 1e-4 on parameters,
    momenta and losses: the second inner step's gradients carry the
    AdamW-updated head's difference (up to 1e-3 after one step, within
    adamw_tol), which reaches 4e-5 in 8 of the 1,048,576 entries of the
    hybrid's out_proj momentum; then the new state crosses the two packages'
    .npz checkpoints both ways bit for bit."""
    name = SSM_ARCHS[kind]
    _round_and_checkpoints(reduce_config(get_config(name)),
                           tconfigs.reduce_config(tconfigs.get_config(name)), tmp_path,
                           monkeypatch)


def _round_and_checkpoints(jcfg, tcfg, tmp_path, monkeypatch, context: int = 0):
    """One MuLoCo round (Muon, the reference's Newton-Schulz through its
    plain oracle, the outer Nesterov kernel) as ``_check_one_round`` at atol
    1e-4, then the new state through the two packages' .npz checkpoints
    both ways, bit for bit."""
    import sys

    from repro.checkpoint import load_checkpoint as jload_checkpoint
    from repro.checkpoint import save_checkpoint as jsave_checkpoint
    from repro.kernels import ref as jref
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint

    def ns_plain(g, iters=5, eps=1e-7):
        *_, m, n = g.shape
        return jref.ns_orthogonalize_ref(g.reshape(-1, m, n), iters, eps).reshape(g.shape)

    monkeypatch.setattr(sys.modules["repro.optim.muon"], "newton_schulz_pallas", ns_plain)
    tnew, jnew = _check_one_round(jcfg, tcfg, "muon", True, 2, atol=1e-4, context=context)
    save_checkpoint(str(tmp_path / "port.npz"), tnew, step=1)
    loaded, step = jload_checkpoint(str(tmp_path / "port.npz"), jnew)
    assert step == 1
    assert_tree_close(tnew, _jstate_numpy(loaded), atol=0, rtol=0)
    jsave_checkpoint(str(tmp_path / "ref.npz"), jnew, step=2)
    tloaded, step = load_checkpoint(str(tmp_path / "ref.npz"), tnew)
    assert step == 2
    assert_tree_close(tloaded, _jstate_numpy(jnew), atol=0, rtol=0)
    return tnew


CONTEXT_ARCHS = {"audio": "whisper-large-v3", "vlm": "llama-3.2-vision-90b"}


@pytest.mark.parametrize("kind", sorted(CONTEXT_ARCHS))
def test_context_diloco_round_matches_reference(kind, tmp_path, monkeypatch):
    """One MuLoCo round of the reduced whisper-large-v3 and
    llama-3.2-vision-90b from one TrainState, each batch carrying a
    "context" leaf [H, K, B, N, d_model] (the reference's step plans'
    layout), as test_ssm_diloco_round_matches_reference (atol 1e-4, the
    .npz checkpoints both ways): whisper's 17 Muon stacks, frontend_proj
    among them, and the VLM's 4-D [ns, per, ...] self-layer stacks through
    Newton-Schulz per matrix; its gates [ns] through AdamW (they leave zero
    in the round)."""
    name = CONTEXT_ARCHS[kind]
    jcfg = reduce_config(get_config(name))
    n = jcfg.n_audio_frames if kind == "audio" else jcfg.n_image_tokens
    tnew = _round_and_checkpoints(jcfg, tconfigs.reduce_config(tconfigs.get_config(name)),
                                  tmp_path, monkeypatch, context=n)
    if kind == "vlm":
        assert (tnew["outer_params"]["cross_layers"]["mlp_gate"] != 0).all()


@pytest.mark.parametrize("kind", sorted(CONTEXT_ARCHS))
def test_context_launches_per_round_formula(kind):
    """The launch formula of the audio family (the encoder's and the
    decoder's self-attention through the flash kernels: 4 layers at reduced
    depth; 17 Muon leaves of 26) and of the VLM (its self layers only: 2
    superblocks x 1 at reduced depth; cross-attention is plain torch; 15
    Muon leaves of 28, the 4-D stacks one launch each), remat on."""
    tcfg = tconfigs.reduce_config(tconfigs.get_config(CONTEXT_ARCHS[kind])).replace(
        attn_impl="pallas", remat=True)
    dcfg = DiLoCoConfig(n_workers=2, sync_interval=3, ns_impl="pallas", outer_kernel=True)
    model = tbuild_model(tcfg)
    engine = TrainEngine(model, dcfg, OptimizerConfig())
    n = engine.launches_per_round(model.init(torch.Generator().manual_seed(0), "cpu"))
    attn, muon, leaves = (4, 17, 26) if kind == "audio" else (2, 15, 28)
    assert model.attention_layers == attn
    assert n == {"flash_fwd": 6 * attn * 2 + attn, "paged_decode": 0, "flash_dq": 6 * attn,
                 "flash_dkv": 6 * attn, "matmul_epilogue": 6 * 3 * 5 * muon,
                 "nesterov": leaves, "quantize": 0, "dequantize": 0}
    full = tbuild_model(tconfigs.get_config(CONTEXT_ARCHS[kind]))
    assert full.attention_layers == (64 if kind == "audio" else 80)


def test_engine_eval_loss_and_deferred_configs():
    """TrainEngine runs a round and evaluates the outer params. The configs
    Slice 4b and the DP baseline brought (elastic, sync delay,
    outer_enabled=False) build and run a round; the Muon variants (muon_bp,
    normuon) build an engine and its state."""
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
    for ported in (dict(elastic=True), dict(sync_delay=1), dict(outer_enabled=False)):
        dcfg = DiLoCoConfig(n_workers=2, sync_interval=1, inner_name="adamw", **ported)
        engine = TrainEngine(model, dcfg, OptimizerConfig(lr=1e-2))
        state = engine.init(torch.Generator().manual_seed(0), "cpu")
        state, info = engine.step(state, batches_for_round(stream, 0, 1))
        assert int(state["round"]) == 1 and math.isfinite(float(info["loss"][0])), ported
    for inner, stage in (("muon_bp", 1), ("normuon", 2)):  # the stage with a counter
        engine = TrainEngine(model, DiLoCoConfig(n_workers=2, sync_interval=1, inner_name=inner),
                             OptimizerConfig(ns_period=2))
        state = engine.init(torch.Generator().manual_seed(0), "cpu")
        assert state["inner_state"]["tx"]["muon"][stage]["count"].tolist() == [0, 0], inner


def test_launches_per_round_formula():
    """The launch formula chip_smoke.py asserts on the card: 7 Muon leaves,
    11 leaves in all, the forward twice per layer and step under remat; an
    uncompressed sync launches no quantize or dequantize."""
    _, tcfg = _cfgs(attn_impl="pallas")
    dcfg = DiLoCoConfig(n_workers=2, sync_interval=3, ns_impl="pallas", outer_kernel=True)
    for remat in (False, True):
        model = tbuild_model(tcfg.replace(remat=remat))
        engine = TrainEngine(model, dcfg, OptimizerConfig())
        n = engine.launches_per_round(model.init(torch.Generator().manual_seed(0), "cpu"))
        assert n == {"flash_fwd": 6 * 2 * (2 if remat else 1) + 2, "paged_decode": 0,
                     "flash_dq": 12, "flash_dkv": 12, "matmul_epilogue": 6 * 3 * 5 * 7,
                     "nesterov": 11, "quantize": 0, "dequantize": 0}


@pytest.mark.parametrize("kind", sorted(SSM_ARCHS))
def test_ssm_launches_per_round_formula(kind):
    """The launch formula of the SSM family (no attention: no flash launch;
    2 Muon leaves, in_proj and out_proj, of 12) and of the hybrid (the shared
    block's flash kernels once a superblock, 2 superblocks at reduced
    depth; 9 Muon leaves of 23), with remat on as on the card."""
    tcfg = tconfigs.reduce_config(tconfigs.get_config(SSM_ARCHS[kind])).replace(
        attn_impl="pallas", remat=True)
    dcfg = DiLoCoConfig(n_workers=2, sync_interval=3, ns_impl="pallas", outer_kernel=True)
    model = tbuild_model(tcfg)
    engine = TrainEngine(model, dcfg, OptimizerConfig())
    n = engine.launches_per_round(model.init(torch.Generator().manual_seed(0), "cpu"))
    attn, muon, leaves = (0, 2, 12) if kind == "ssm" else (2, 9, 23)
    assert model.attention_layers == attn
    assert n == {"flash_fwd": 6 * attn * 2 + attn, "paged_decode": 0, "flash_dq": 6 * attn,
                 "flash_dkv": 6 * attn, "matmul_epilogue": 6 * 3 * 5 * muon,
                 "nesterov": leaves, "quantize": 0, "dequantize": 0}


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
    # --rounds-per-dispatch auto (the default): both rounds in one dispatch
    assert "dispatch telemetry: dispatches=1 rounds_per_dispatch=2" in text
    assert "final smoothed eval loss:" in text.splitlines()[-1]
    assert all(math.isfinite(v) for v in out["losses"])
    assert math.isfinite(out["final_loss"])
    # the reference's and the port's smoothing agree on the same history
    np.testing.assert_allclose(ttrain.smoothed_eval_loss(out["losses"], out["steps"], 2),
                               jtrain.smoothed_eval_loss(out["losses"], out["steps"], 2),
                               rtol=1e-6)


def test_train_cli_ladder_reduced_on_cpu(tmp_path):
    """``--arch paper-150m --reduced --device cpu`` runs end to end: the
    ladder's rung cut by reduce_config (2 layers, d 256, hd 64, post-norms,
    the untied head), finite losses in metrics.csv."""
    out = ttrain.train(_args(tmp_path, "--arch", "paper-150m", "--outer-kernel"))
    assert out["model"].cfg.post_norm and not out["model"].cfg.tie_embeddings
    assert "head" in out["state"]["outer_params"]
    with open(os.path.join(tmp_path, "metrics.csv")) as f:
        rows = list(csv.reader(f))
    assert [r[0] for r in rows[1:]] == ["0", "1"]
    assert all(math.isfinite(v) for v in out["losses"]) and math.isfinite(out["final_loss"])


@pytest.mark.parametrize("flags", [["--mesh", "2x2"]])
def test_train_cli_deferred_flags_raise(tmp_path, flags):
    """``--mesh`` (once deferred) runs: a mesh whose size is not the
    world's raises a ValueError naming both numbers (2x2 is 4 ranks, a
    process with no launcher a world of 1), and ``--mesh 1x1`` trains a
    round in this process, its losses those of the run without a mesh."""
    with pytest.raises(ValueError, match="has 4 ranks, but the world has 1"):
        ttrain.train(_args(tmp_path, *flags))
    one = ttrain.train(_args(tmp_path / "one", "--rounds", "1"))
    mesh = ttrain.train(_args(tmp_path / "mesh", "--rounds", "1", "--mesh", "1x1"))
    assert len(mesh["history"]) == 1
    assert mesh["losses"] == one["losses"]
    assert [h["train_loss"] for h in mesh["history"]] == [h["train_loss"] for h in one["history"]]


@pytest.mark.parametrize("flags", [["--inner", "muon_bp", "--ns-period", "2"],
                                   ["--inner", "normuon"]])
def test_train_cli_muon_variants_run(tmp_path, flags):
    """``--inner muon_bp --ns-period b`` and ``--inner normuon`` run through
    the CLI (once raising cases of the test above): finite losses, and
    muon_bp's own NS counter counted every inner step (K·H per round)."""
    out = ttrain.train(_args(tmp_path, *flags))
    assert all(math.isfinite(v) for v in out["losses"]) and math.isfinite(out["final_loss"])
    tx = out["state"]["inner_state"]["tx"]["muon"]
    if flags[1] == "muon_bp":
        assert tx[1]["count"].tolist() == [4, 4]  # 2 rounds x H = 2, per worker
    else:
        assert tx[2]["v"]["layers"]["mlp"]["w_in"].shape[-1] == 1


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "llama-3.2-vision-90b",
                                  "whisper-large-v3"])
def test_train_cli_families_run_as_reference(tmp_path, arch):
    """Every architecture is ported. ``--arch kimi-k2-1t-a32b --reduced``
    (once a KeyError naming ROADMAP.md; reduced: 4 experts top-2 and one
    shared at hd 64) trains a round through the CLI as the reference's does,
    its losses finite. The vlm and audio
    families are ported but, as the reference's CLI, it feeds them no
    context, so their forward's assertion stops the run (the reference
    trains them only through its step plans, whose batches carry a
    "context" leaf)."""
    if arch == "kimi-k2-1t-a32b":
        out = ttrain.train(_args(tmp_path, "--arch", arch, "--rounds", "1"))
        assert out["model"].cfg.n_experts == 4 and "moe" in out["state"]["outer_params"]["layers"]
        with open(os.path.join(tmp_path, "metrics.csv")) as f:
            assert [r[0] for r in list(csv.reader(f))[1:]] == ["0"]
        assert all(math.isfinite(v) for v in out["losses"]) and math.isfinite(out["final_loss"])
        return
    with pytest.raises(AssertionError, match="forward requires .* context"):
        ttrain.train(_args(tmp_path, "--arch", arch))
    with pytest.raises(AssertionError, match="forward requires .* context"):
        jtrain.train(jtrain.build_parser().parse_args([
            "--arch", arch, "--reduced", "--workers", "2", "--sync-interval", "2", "--rounds",
            "1", "--seq-len", "16", "--batch-per-worker", "2", "--out", str(tmp_path / "ref")]))


@pytest.mark.parametrize("flags,active,staleness", [
    (["--drop-prob", "0.5"], None, 0.0),
    (["--drop-schedule", "1:0"], [2.0, 1.0], 0.0),
    (["--sync-delay", "1"], [2.0, 2.0], 1.0)])
def test_train_cli_elastic_flags_run(tmp_path, flags, active, staleness):
    """The elastic flags (Slice 4b) run: metrics.csv's active_workers follow
    the run's masks (FaultPlan's, for --drop-prob) and staleness is the
    sync delay."""
    from repro_torch.core.faults import FaultPlan

    out = ttrain.train(_args(tmp_path, *flags))
    rows = [r for r in csv.DictReader(open(os.path.join(tmp_path, "metrics.csv")))]
    if active is None:
        active = FaultPlan(n_workers=2, drop_prob=0.5).masks(0, 2).sum(axis=1).tolist()
    assert [float(r["active_workers"]) for r in rows] == active
    assert all(float(r["staleness"]) == staleness for r in rows)
    assert all(math.isfinite(v) for v in out["losses"])


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


# ------------------------------------------- compressed pseudogradients (Slice 3)

from repro.core import CompressionConfig as JCompressionConfig  # noqa: E402
from repro.core import collectives as jcoll  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import make_streaming_masks as jmake_streaming_masks  # noqa: E402
from repro.core import outer_step as jouter_step  # noqa: E402
from repro.core import streaming as jstreaming  # noqa: E402
from repro.core import wire as jwire  # noqa: E402
from repro.engine import TrainEngine as JTrainEngine  # noqa: E402
from repro_torch.core import CompressionConfig, make_streaming_masks, outer_step  # noqa: E402
from repro_torch.core import collectives as tcoll  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import streaming as tstreaming  # noqa: E402
from repro_torch.core import wire as twire  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402


def _ccfgs(**kw):
    return JCompressionConfig(**kw), CompressionConfig(**kw)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _flat(tree):
    """path -> numpy leaf of a reference tree (dict keys sorted as JAX sorts)."""
    return {p: t.numpy() for p, t in tree_leaves_with_paths(
        state_from_numpy(jax.tree.map(np.asarray, tree), "cpu"))}


def _assert_tree_equal(t_tree, j_tree, what):
    jflat = _flat(j_tree)
    tflat = {p: t.detach().numpy() for p, t in tree_leaves_with_paths(t_tree)}
    assert set(tflat) == set(jflat), what
    for p in jflat:
        np.testing.assert_array_equal(tflat[p], jflat[p], err_msg=f"{what} {p}")


def _assert_packets_equal(tw, jw):
    assert type(tw).__name__ == type(jw).__name__
    assert tw.shape == tuple(jw.shape)
    for f in twire._BUFFERS[type(tw)]:
        a, b = getattr(tw, f).numpy(), np.asarray(getattr(jw, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("impl", ["pallas", "jnp"])
@pytest.mark.parametrize("bits,rowwise", [(2, False), (3, False), (4, True), (8, True)])
def test_quant_wire_round_trip_matches_reference(impl, bits, rowwise):
    """QuantWire encode (both impls) of a K-stacked leaf: packed codes, lo
    and scale == the reference's packet (jitted, as the engine runs it), and
    the decoded leaf == the reference's decode, bitwise. Global rows fold the
    workers: one row per worker."""
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((3, 24, 40)) * 3).astype(np.float32)
    jcfg, tcfg = _ccfgs(kind="quant", bits=bits, rowwise=rowwise, wire_impl=impl)

    @jax.jit
    def roundtrip(x):
        w = jwire.encode_leaf(x, jcfg, batch_ndim=1)
        return w, jwire.decode_leaf(w, impl=impl)

    jw, jdec = roundtrip(jnp.asarray(x))
    tw = twire.encode_leaf(_t(x), tcfg, batch_ndim=1)
    _assert_packets_equal(tw, jw)
    assert (tw.cols, tw.bits) == (jw.cols, jw.bits)
    assert tw.lo.shape == ((3 * 24, 1) if rowwise else (3, 1))
    np.testing.assert_array_equal(twire.decode_leaf(tw, impl=impl).numpy(), np.asarray(jdec))


@pytest.mark.parametrize("bits,rowwise,batch_ndim", [
    (1, False, 1), (2, False, 1), (3, True, 1), (4, True, 1), (8, True, 0), (2, False, 0)])
def test_quant_encode_codes_only_matches_jnp_and_reference(bits, rowwise, batch_ndim):
    """quant_encode's kernel route (impl='pallas': the codes-only quantize,
    its plain version on the CPU) == its plain route (impl='jnp') and the
    reference's jitted quant_encode in both of its routes, packet for
    packet: packed codes, lo, scale, shape, cols and bits."""
    rng = np.random.default_rng(40 + bits)
    x = (rng.standard_normal((2, 7, 45))
         * np.exp(rng.uniform(-8.0, 2.0, (2, 7, 1)))).astype(np.float32)
    tws = [twire.quant_encode(_t(x), bits, rowwise, batch_ndim=batch_ndim, impl=impl)
           for impl in ("pallas", "jnp")]
    for impl in ("pallas", "jnp"):
        jw = jax.jit(lambda v: jwire.quant_encode(v, bits, rowwise, batch_ndim=batch_ndim,
                                                  impl=impl))(jnp.asarray(x))
        for tw in tws:
            _assert_packets_equal(tw, jw)
            assert (tw.cols, tw.bits) == (jw.cols, jw.bits)


@pytest.mark.parametrize("bits,rowwise", [(2, False), (3, True)])
def test_codebook_wire_round_trip_matches_reference(bits, rowwise):
    """CodebookWire: the quantile levels (jnp.quantile's linear method, with
    XLA's fused multiply-add), the packed codes and the decode of the packet
    == the reference's, bitwise. (Decoded in the program that encoded it,
    the reference gathers from levels it recomputes with other rounding:
    ROADMAP.md, Queue 3.)"""
    rng = np.random.default_rng(10 + bits)
    x = (rng.standard_normal((2, 16, 33)) * 1e-2).astype(np.float32)
    jcfg, tcfg = _ccfgs(kind="quant", bits=bits, rowwise=rowwise, quant_mode="statistical")
    jw = jax.jit(lambda x: jwire.encode_leaf(x, jcfg, batch_ndim=1))(jnp.asarray(x))
    tw = twire.encode_leaf(_t(x), tcfg, batch_ndim=1)
    _assert_packets_equal(tw, jw)
    np.testing.assert_array_equal(twire.decode_leaf(tw).numpy(),
                                  np.asarray(jax.jit(jwire.decode_leaf)(jw)))
    vs = jax.jit(lambda v: jcomp.quantize_statistical(v, bits, rowwise))(jnp.asarray(x))
    np.testing.assert_array_equal(tcomp.quantize_statistical(_t(x), bits, rowwise).numpy(),
                                  np.asarray(vs))


def test_topk_wire_round_trip_matches_reference():
    """TopKWire (index, value) pairs and their decode == the reference's, on
    distinct magnitudes (torch.topk does not promise lax.top_k's tie order),
    and the decode is the sparsified tensor."""
    rng = np.random.default_rng(2)
    x = (rng.permutation(3 * 17 * 23).astype(np.float32) + 1.0).reshape(3, 17, 23)
    x = (x * rng.choice([-1.0, 1.0], x.shape) / 100.0).astype(np.float32)
    jcfg, tcfg = _ccfgs(kind="topk", topk_frac=0.1, collective="gather")
    jw = jax.jit(lambda x: jwire.encode_leaf(x, jcfg, batch_ndim=1))(jnp.asarray(x))
    tw = twire.encode_leaf(_t(x), tcfg, batch_ndim=1)
    _assert_packets_equal(tw, jw)
    dense = twire.decode_leaf(tw)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jax.jit(jwire.decode_leaf)(jw)))
    want = torch.stack([tcomp.topk_sparsify(v, 0.1) for v in _t(x)])
    np.testing.assert_array_equal(dense.numpy(), want.numpy())


@pytest.mark.parametrize("kind,kw", [
    ("quant", dict(bits=4, rowwise=True)),
    ("quant", dict(bits=2, wire_impl="jnp")),
    ("topk", dict(topk_frac=0.25, collective="gather")),
    ("quant", dict(bits=3, quant_mode="statistical")),
], ids=["quant_rowwise", "quant_global_jnp", "topk", "statistical"])
def test_ef_residual_equals_acc_minus_wire_reconstruction(kind, kw):
    """The EF stage's residual is acc - decode(wire) exactly, with acc the
    fused ef_decay * e + d; the packets and residuals equal the reference's
    jitted stage bitwise. Statistical quantization holds its residual to one
    ulp of the largest level: XLA forms the reference's residual from levels
    it recomputes in another fusion (ROADMAP.md, Queue 3)."""
    jcfg, tcfg = _ccfgs(kind=kind, error_feedback=True, ef_decay=0.9, **kw)
    rng = np.random.default_rng(4)
    d = (rng.standard_normal((2, 8, 12)) * 1e-2).astype(np.float32)
    e = (rng.standard_normal((2, 8, 12)) * 1e-3).astype(np.float32)
    comm, new_res = tcomp.error_feedback(tcfg).update({"w": _t(d)}, {"w": _t(e)}, None)
    acc = tcomp.ef_accumulate(tcfg, _t(d), _t(e))
    recon = twire.decode_leaf(comm["w"], impl=tcfg.wire_impl)
    assert torch.equal(new_res["w"], acc - recon)
    jcomm, jres = jax.jit(lambda d, e: jcomp.error_feedback(jcfg).update(
        {"w": d}, {"w": e}, None))(jnp.asarray(d), jnp.asarray(e))
    _assert_packets_equal(comm["w"], jcomm["w"])
    if kind == "quant" and kw.get("quant_mode") == "statistical":
        ulp = np.spacing(np.abs(comm["w"].levels.numpy()).max())
        np.testing.assert_allclose(new_res["w"].numpy(), np.asarray(jres["w"]), atol=ulp, rtol=0)
    else:
        np.testing.assert_array_equal(new_res["w"].numpy(), np.asarray(jres["w"]))


@pytest.mark.parametrize("kw", [
    dict(kind="quant", bits=4, rowwise=True, error_feedback=True),
    dict(kind="quant", bits=4, rowwise=True),
    dict(kind="quant", bits=2, error_feedback=True),
    dict(kind="topk", topk_frac=0.25, collective="gather", error_feedback=True),
], ids=["quant_ef", "quant", "quant_global_ef", "topk_ef"])
def test_leaf_wire_pipeline_matches_stage_chain(kw):
    """_leaf_wire_pipeline (the segment sync's per-leaf path) == the worker
    stage + reduce chain bitwise, and both == the reference's pipeline."""
    tcfg = CompressionConfig(**kw)
    jcfg = JCompressionConfig(**kw)
    rng = np.random.default_rng(0)
    d = (rng.standard_normal((3, 6, 8)) * 1e-2).astype(np.float32)
    e = (rng.standard_normal((3, 6, 8)) * 1e-3).astype(np.float32)
    ef = tcfg.error_feedback
    stage = tcomp.error_feedback(tcfg) if ef else tcomp.compress(tcfg)
    comm, res = stage.update({"w": _t(d)}, {"w": _t(e)} if ef else (), None)
    psi_chain = tcoll.reduce_pseudogradients(comm, tcfg)["w"]
    psi_leaf, res_leaf = tcoll._leaf_wire_pipeline(_t(d), _t(e) if ef else None, tcfg)
    assert torch.equal(psi_chain, psi_leaf)
    jpsi, jres = jax.jit(lambda d, e: jcoll._leaf_wire_pipeline(d, e if ef else None, jcfg))(
        jnp.asarray(d), jnp.asarray(e))
    np.testing.assert_array_equal(psi_leaf.numpy(), np.asarray(jpsi))
    if ef:
        assert torch.equal(res["w"], res_leaf)
        np.testing.assert_array_equal(res_leaf.numpy(), np.asarray(jres))


def test_segment_sync_update_subsets_rows_exactly():
    """For row-wise quantization the segment sync encodes only the owned
    L-rows: psi equals the full-size masked pipeline on owned rows and is
    zero elsewhere, unowned residual rows come back unchanged, and psi and
    residuals equal the reference's segment sync bitwise."""
    tcfg = CompressionConfig(kind="quant", bits=4, rowwise=True, error_feedback=True)
    jcfg = JCompressionConfig(kind="quant", bits=4, rowwise=True, error_feedback=True)
    K = 3
    rng = np.random.default_rng(0)
    shapes = {"layers": {"w": (4, 6, 8)}, "embed": (10, 4)}
    deltas = jax.tree.map(lambda s: rng.standard_normal((K, *s)).astype(np.float32), shapes,
                          is_leaf=lambda s: isinstance(s, tuple))
    ef = jax.tree.map(lambda d: rng.standard_normal(d.shape).astype(np.float32), deltas)
    tparams = {"layers": {"w": torch.zeros(4, 6, 8)}, "embed": torch.zeros(10, 4)}
    m = tstreaming.streaming_masks(tparams, 2)[0]
    jm = jstreaming.streaming_masks(jax.tree.map(jnp.asarray, jax.tree.map(
        lambda t: t.numpy(), tparams)), 2)[0]
    masked = {"layers": {"w": m["layers"]["w"][None] * _t(deltas["layers"]["w"])},
              "embed": m["embed"] * _t(deltas["embed"])}
    t_ef = jax.tree.map(_t, ef)
    psi_s, ef_s = tcoll.segment_sync_update(masked, t_ef, m, tcfg)
    psi_l, ef_l = tcoll._leaf_wire_pipeline(masked["layers"]["w"], t_ef["layers"]["w"], tcfg)
    owned = m["layers"]["w"].reshape(4).numpy() > 0
    assert owned.any() and not owned.all()
    w = psi_s["layers"]["w"].numpy()
    np.testing.assert_array_equal(w[owned], psi_l.numpy()[owned])
    np.testing.assert_array_equal(ef_s["layers"]["w"].numpy()[:, owned],
                                  ef_l.numpy()[:, owned])
    assert not w[~owned].any()
    np.testing.assert_array_equal(ef_s["layers"]["w"].numpy()[:, ~owned],
                                  ef["layers"]["w"][:, ~owned])
    jpsi, jef = jax.jit(lambda d, e: jcoll.segment_sync_update(d, e, jm, jcfg))(
        jax.tree.map(lambda t: jnp.asarray(t.numpy()), masked), jax.tree.map(jnp.asarray, ef))
    _assert_tree_equal(psi_s, jpsi, "psi")
    _assert_tree_equal(ef_s, jef, "ef")


def _abstract(cfg):
    """Full shapes of a model's params, allocating nothing: the reference's
    eval_shape tree and the port's (zero-stride expanded scalars)."""
    jabs = jax.eval_shape(lambda: build_model(cfg).init(jax.random.PRNGKey(0)))
    return jabs, jax.tree.map(lambda s: torch.empty(()).expand(*s.shape), jabs)


def _stream_params():
    return {"layers": {"w": np.zeros((4, 6, 8), np.float32), "b": np.zeros((4, 8), np.float32)},
            "embed": np.zeros((10, 4), np.float32), "scale": np.zeros((8,), np.float32)}


@pytest.mark.parametrize("J", [2, 3])
def test_streaming_masks_equal_reference(J):
    """streaming_masks on the reduced smollm-135m tree and a hand-sized tree
    == the reference's (the whole-leaf owners hash the same path strings);
    the masks tile the parameters exactly once."""
    jcfg, _ = _cfgs()
    jparams = jax.tree.map(np.asarray, build_model(jcfg).init(jax.random.PRNGKey(0)))
    for tree in (jparams, _stream_params()):
        tmasks = tstreaming.streaming_masks(params_from_numpy(tree, "cpu"), J)
        jmasks = jstreaming.streaming_masks(jax.tree.map(jnp.asarray, tree), J)
        for tm, jm in zip(tmasks, jmasks):
            _assert_tree_equal(tm, jm, f"J={J} mask")
        assert tstreaming.assert_masks_partition(tmasks)


_BYTES_CFGS = [dict(kind="quant", bits=4, rowwise=True), dict(kind="quant", bits=2),
               dict(kind="quant", bits=3, quant_mode="statistical", rowwise=True),
               dict(kind="topk", topk_frac=0.1, collective="gather"), dict(kind="none"),
               dict(kind="quant", bits=8, collective="gather")]


@pytest.mark.parametrize("kw", _BYTES_CFGS, ids=lambda kw: "-".join(map(str, kw.values())))
def test_measured_sync_bytes_equal_reference(kw):
    """measured_sync_bytes (closed form from shapes) == the reference's
    (jax.eval_shape over the real encode path) on hand-sized trees, for the
    single sync and for each streaming segment at J = 2 and 3, and the
    segments sum to the single sync; also the DP form (outer_enabled=False)
    and the measured compression ratio."""
    jcfg, tcfg = _ccfgs(**kw)
    params = _stream_params()
    tp, jp = params_from_numpy(params, "cpu"), jax.tree.map(jnp.asarray, params)
    for K in (1, 2, 3):
        full = jcoll.measured_sync_bytes(jp, jcfg, K)
        assert tcoll.measured_sync_bytes(tp, tcfg, K) == full
        assert tcoll.measured_sync_bytes(tp, tcfg, K, outer_enabled=False) == \
            jcoll.measured_sync_bytes(jp, jcfg, K, outer_enabled=False)
        for J in (2, 3):
            segs = [tcoll.measured_sync_bytes(tp, tcfg, K, mask=m)
                    for m in tstreaming.streaming_masks(tp, J)]
            assert segs == [jcoll.measured_sync_bytes(jp, jcfg, K, mask=m)
                            for m in jstreaming.streaming_masks(jp, J)]
    assert tcoll.measured_compression_ratio(tp, tcfg, 2) == \
        jcoll.measured_compression_ratio(jp, jcfg, 2)
    assert tcoll.collective_bytes_tree(tp, tcfg, 2) == jcoll.collective_bytes_tree(jp, jcfg, 2)
    assert tcfg.compression_ratio() == jcfg.compression_ratio()


@pytest.mark.parametrize("run,kw,J,want", [
    ("a", dict(kind="quant", bits=2, error_feedback=True), 1, [67_257_680]),
    ("b", dict(kind="quant", bits=2, rowwise=True, error_feedback=True), 2,
     [27_749_584, 42_691_488]),
    ("dense", dict(kind="none"), 1, [1_076_120_064]),
])
def test_measured_sync_bytes_full_width(run, kw, J, want):
    """The wire bytes per worker per round of the two compressed runs
    chip_smoke.py drives, and of the dense sync, on the full-width
    smollm-135m tree (K = 2): equal to the reference's, segment by segment,
    without allocating a parameter."""
    jcfg, tcfg = _ccfgs(**kw)
    jabs, tabs = _abstract(get_config("smollm-135m"))
    tmasks = tstreaming.streaming_masks(tabs, J) if J > 1 else [None]
    jmasks = jstreaming.streaming_masks(jabs, J) if J > 1 else [None]
    got = [tcoll.measured_sync_bytes(tabs, tcfg, 2, mask=m) for m in tmasks]
    assert got == [jcoll.measured_sync_bytes(jabs, jcfg, 2, mask=m) for m in jmasks] == want
    dcfg = DiLoCoConfig(n_workers=2, compression=tcfg, streaming_partitions=J)
    from repro_torch.core import comm_bytes
    assert comm_bytes(tabs, dcfg, tmasks if J > 1 else None) == sum(want)


def test_quantize_plan_covers_the_compressed_runs_wire_shapes():
    """Every (rows, cols) quantize call of the two compressed runs
    chip_smoke.py drives (full-width smollm-135m, K = 2, its
    ``wire_shapes``) maps to a regime of the quantize kernel and a scratch
    size: the row-wise calls (rows of 192 to 1536 entries) are held on chip
    and read once, with no scratch; the global rows longer than a block
    holds are read twice by `parts` blocks a row, each with at least one
    step of LONG_MIN_GROUPS float4 groups, fewer than LONG_BLOCKS + rows
    blocks in all, with 2 * rows * parts fp32 of scratch."""
    import importlib.util

    from repro_torch.kernels import quantize as tq

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    _, tabs = _abstract(get_config("smollm-135m"))
    globals_, rowwise = chip_smoke.wire_shapes(tabs, 1, False), chip_smoke.wire_shapes(tabs, 2, True)
    assert len(globals_ | rowwise) == 24
    for rows, cols in sorted(globals_ | rowwise):
        regime, parts = tq.quantize_plan(rows, cols)
        if (rows, cols) in rowwise or cols <= tq.BLOCK_ROW_MAX:
            assert regime == ("warp" if cols <= tq.WARP_ROW_MAX else "block") and parts == 1
            continue
        assert regime == "long" and parts >= 1, (rows, cols)
        assert rows * parts < tq.LONG_BLOCKS + rows
        assert parts * tq.LONG_MIN_GROUPS <= -(-cols // 4), (rows, cols, parts)
    assert {tq.quantize_plan(r, c)[0] for r, c in rowwise} == {"warp"}
    assert {tq.quantize_plan(r, c)[0] for r, c in globals_} == {"warp", "long"}


@pytest.mark.parametrize("K", [2, 3, 5])
def test_psi_mean_bitwise_matches_reference(K):
    """Psi of the dense sync (kind 'none') == the reference's
    reduce_pseudogradients bitwise at K = 2, 3 and 5: the K-mean is
    sum * (1 / K), as jnp.mean compiles (a true division, like torch.mean's,
    differs in the last ulp when 1/K is inexact); the masked form too."""
    rng = np.random.default_rng(K)
    deltas = {"a": (rng.standard_normal((K, 64, 33)) * 1e-2).astype(np.float32),
              "b": {"c": rng.standard_normal((K, 1001)).astype(np.float32)}}
    jcfg, tcfg = _ccfgs(kind="none")
    jpsi = jax.jit(lambda d: jcoll.reduce_pseudogradients(d, jcfg))(
        jax.tree.map(jnp.asarray, deltas))
    _assert_tree_equal(tcoll.reduce_pseudogradients(jax.tree.map(_t, deltas), tcfg), jpsi, "psi")
    p = np.ones((K,), np.float32)
    p[0] = 0.0
    jm = jax.jit(lambda d, p: jcoll.participation_mean(d, p))(jnp.asarray(deltas["a"]),
                                                             jnp.asarray(p))
    np.testing.assert_array_equal(tcoll.participation_mean(_t(deltas["a"]), _t(p)).numpy(),
                                  np.asarray(jm))


_SYNCS = [
    (2, dict(kind="quant", bits=2, error_feedback=True), 1),
    (3, dict(kind="quant", bits=2, error_feedback=True), 1),
    (2, dict(kind="quant", bits=4, rowwise=True, error_feedback=True), 2),
    (3, dict(kind="quant", bits=4, rowwise=True), 2),
    (2, dict(kind="topk", topk_frac=0.1, collective="gather", error_feedback=True), 1),
]
_SYNC_IDS = ["global2-ef-K2", "global2-ef-K3", "rowwise4-ef-J2", "rowwise4-J2-K3", "topk-ef"]


def _compressed_configs(K, ckw, J):
    """AdamW inner steps and the plain outer Nesterov: the sync under test is
    the same, and the reference compiles it without Newton-Schulz and the
    Pallas outer update in interpret mode."""
    dkw = dict(n_workers=K, sync_interval=2, inner_name="adamw", streaming_partitions=J)
    jc, tc = _ccfgs(**ckw)
    return JDiLoCoConfig(compression=jc, **dkw), DiLoCoConfig(compression=tc, **dkw)


@pytest.mark.parametrize("K,ckw,J", _SYNCS, ids=_SYNC_IDS)
def test_compressed_sync_bitwise_matches_reference(K, ckw, J):
    """The compressed outer sync from one TrainState (workers moved off the
    outer params, nonzero EF residuals): Psi and the new residuals == the
    reference's jitted outer_step bitwise, for every streaming segment. The
    outer params and momentum differ only by the outer Nesterov's FMA
    contraction (1 ulp in u, 3 in theta; ROADMAP.md, Queue 3)."""
    jd, td = _compressed_configs(K, ckw, J)
    jcfg, _ = _cfgs()
    jstate = jdiloco_init(build_model(jcfg), jd, JOptimizerConfig(), jax.random.PRNGKey(0))
    rng = np.random.default_rng(K + J)
    jstate = jstate.replace(
        worker_params=jax.tree.map(lambda w: w + jnp.asarray(
            rng.standard_normal(w.shape).astype(np.float32) * 1e-3), jstate.worker_params),
        ef=None if jstate.ef is None else jax.tree.map(lambda e: jnp.asarray(
            rng.standard_normal(e.shape).astype(np.float32) * 1e-4), jstate.ef))
    jmasks = jmake_streaming_masks(jstate, jd)
    for j in range(J):
        tstate = train_state(**state_from_numpy(_jstate_numpy(jstate), "cpu"))
        tmasks = make_streaming_masks(tstate, td)
        jm = None if J == 1 else jmasks[j]
        jnew, jpsi = jax.jit(lambda st: jouter_step(jd, st, mask=jm, outer=jmake_outer(jd)))(
            jstate)
        tnew, tpsi = outer_step(td, tstate, mask=None if J == 1 else tmasks[j],
                                outer=make_outer(td))
        _assert_tree_equal(tpsi, jpsi, f"segment {j} psi")
        if "ef" in tnew:
            _assert_tree_equal(tnew["ef"], jnew.ef, f"segment {j} ef")
        jo, ju = _flat(jnew.outer_params), _flat(jnew.outer_opt["u"])
        for path, t in tree_leaves_with_paths(tnew["outer_params"]):
            u = dict(tree_leaves_with_paths(tnew["outer_opt"]["u"]))[path].numpy()
            assert np.all(np.abs(u - ju[path]) <= np.spacing(np.abs(ju[path]))), path
            np.testing.assert_allclose(t.numpy(), jo[path], rtol=0,
                                       atol=3 * np.spacing(np.abs(jo[path]).max()), err_msg=path)
        assert int(tnew["round"]) == int(jnew.round)


def _grid_codes(v: np.ndarray, rows: int, nlevels: int) -> np.ndarray:
    """Recover a dequantized leaf's codes: per row, the grid from its min
    (code 0) to its max (code nlevels)."""
    v = v.reshape(rows, -1).astype(np.float64)
    lo = v.min(axis=1, keepdims=True)
    step = (v.max(axis=1, keepdims=True) - lo) / nlevels
    return np.round((v - lo) / np.where(step > 0, step, 1.0)), step


@pytest.mark.parametrize("K,ckw,J", [
    (2, dict(kind="quant", bits=2, error_feedback=True), 1),
    (3, dict(kind="quant", bits=2, error_feedback=True), 1),
    (2, dict(kind="quant", bits=4, rowwise=True, error_feedback=True), 2),
    (2, dict(kind="topk", topk_frac=0.1, collective="gather", error_feedback=True), 1),
], ids=["global2-ef-K2", "global2-ef-K3", "rowwise4-ef-J2", "topk-gather-ef"])
def test_compressed_round_matches_reference(K, ckw, J):
    """One compressed round (H = 2 inner steps and the sync(s)) from the same
    TrainState, port against the reference's engine: comm_bytes exactly;
    losses as test_one_diloco_round_matches_reference holds them, the
    workers of a single sync reset to the new outer params; Psi's codes
    (the selected entries for top-k) equal on at least 99.9% of the entries
    (measured: 99.98% and up) and its values within one quantization step
    everywhere; the outer params and momentum within lr * (1 + mu) steps;
    the EF residuals within 1.01 times their range over a worker's leaf
    (measured: 1.0014): a Q1 code flip moves a residual by one Q1 step,
    which the residuals of a leaf nearly span.

    Codes may differ at all because the two frameworks' inner steps differ
    in fp32 rounding and a quantizer flips a code where a value sits on a
    rounding boundary; the sync alone is bitwise
    (test_compressed_sync_bitwise_matches_reference). AdamW's eps is 1e-3 on
    both sides: at 1e-8 Adam maps near-eps gradient entries to anything in
    (-1, 1) (see assert_tree_close), which is not what this test holds. The
    inner optimizer is AdamW and attention the dense path: the sync under
    test is the same, and both sides run the round faster."""
    jd, td = _compressed_configs(K, ckw, J)
    jcfg, tcfg = _cfgs()
    okw = dict(lr=2e-2, weight_decay=1e-4, schedule="cosine", warmup_steps=1, total_steps=4,
               eps=1e-3)
    jo, to = JOptimizerConfig(**okw), OptimizerConfig(**okw)
    jmodel = build_model(jcfg)
    jstate = jdiloco_init(jmodel, jd, jo, jax.random.PRNGKey(0))
    tstate = train_state(**state_from_numpy(_jstate_numpy(jstate), "cpu"))
    stream = JMarkovStream(JDataConfig(vocab=jcfg.vocab, seq_len=16, batch_per_worker=2,
                                       n_workers=K, seed=3))
    batches = {k: np.array(v) for k, v in stream.batch_stack(0, 2).items()}
    jnew, jinfo = JTrainEngine(jmodel, jd, jo).step(
        jstate, {k: jnp.asarray(v) for k, v in batches.items()})
    engine = TrainEngine(tbuild_model(tcfg), td, to)
    tnew, tinfo = engine.step(tstate, {k: torch.from_numpy(v) for k, v in batches.items()})

    assert float(tinfo["comm_bytes"]) == float(jinfo["comm_bytes"])
    assert_tree_close(tinfo["loss"], jinfo["loss"], "loss", atol=2e-5, rtol=1e-4)
    if J == 1:  # every worker reset (a streaming round resets each partition at its sync)
        for o, w in zip(tree_leaves_with_paths(tnew["outer_params"]),
                        tree_leaves_with_paths(tnew["worker_params"])):
            assert all(torch.equal(o[1], wk) for wk in w[1]), o[0]
    ccfg = td.compression
    nlevels = (1 << ccfg.bits) - 1
    jpsi, jout, ju = _flat(jinfo["psi"]), _flat(jnew.outer_params), _flat(jnew.outer_opt["u"])
    jef = _flat(jnew.ef)
    tu = dict(tree_leaves_with_paths(tnew["outer_opt"]["u"]))
    tout = dict(tree_leaves_with_paths(tnew["outer_params"]))
    tef = dict(tree_leaves_with_paths(tnew["ef"]))
    same = total = 0
    for path, t in tree_leaves_with_paths(tinfo["psi"]):
        t, j = t.numpy(), jpsi[path]
        if ccfg.kind == "quant":
            rows, _ = twire._row_layout(j.shape, ccfg.rowwise, 0)
            tc, _ = _grid_codes(t, rows, nlevels)
            jc, step = _grid_codes(j, rows, nlevels)
            same += int((tc == jc).sum())
            step = np.broadcast_to(step, (rows, j.size // rows)).reshape(j.shape)
        else:
            same += int(((t != 0) == (j != 0)).sum())
            step = np.full(j.shape, np.abs(j).max())
        total += j.size
        assert np.all(np.abs(t - j) <= 1.001 * step + 1e-9), path
        lr_step = td.outer_lr * (1 + td.outer_momentum) * step + 1e-6
        assert np.all(np.abs(tu[path].numpy() - ju[path]) <= lr_step), path
        assert np.all(np.abs(tout[path].numpy() - jout[path]) <= lr_step), path
        e, je = tef[path].numpy().reshape(K, -1), jef[path].reshape(K, -1)
        e_step = je.max(axis=1, keepdims=True) - je.min(axis=1, keepdims=True)
        assert np.all(np.abs(e - je) <= 1.01 * e_step + 1e-9), path
    assert same / total >= 0.999, (same, total)
    assert int(tnew["round"]) == int(jnew.round) == J  # one count per sync


def test_wire_launches_per_round_formula(monkeypatch):
    """quantize / dequantize launches of one round, as TrainEngine counts
    them, == the wrapper calls a CPU round makes (the wire path's codes-only
    quantize and its dequantize; each wrapper call is one launch on the
    card): J = 1 with EF is Q1 + Q2 and D1 + D1 + D2 per leaf
    (the EF stage and the reduce each decode Q1); a streaming segment decodes
    once, with or without EF, Q1 + Q2 and D1 + D2 per leaf it does not skip;
    the 'jnp' wire launches nothing. At full width these are 22 and 33 (run
    a) and 40 and 40 (run b, whose EF changes no count)."""
    calls = {"quantize": 0, "dequantize": 0}
    real_q, real_d = twire.rowwise_quantize_codes, tops.dequantize_rowwise

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(twire, "rowwise_quantize_codes", count("quantize", real_q))
    monkeypatch.setattr(tops, "dequantize_rowwise", count("dequantize", real_d))
    _, tcfg = _cfgs()
    model = tbuild_model(tcfg)
    stream = MarkovStream(DataConfig(vocab=tcfg.vocab, seq_len=8, batch_per_worker=1,
                                     n_workers=2))
    cases = [(dict(kind="quant", bits=2, error_feedback=True), 1, (22, 33)),
             (dict(kind="quant", bits=2, rowwise=True), 2, (40, 40)),
             (dict(kind="quant", bits=4, wire_impl="jnp"), 1, None)]
    for ckw, J, full in cases:
        dcfg = DiLoCoConfig(n_workers=2, sync_interval=2, inner_name="adamw",
                            compression=CompressionConfig(**ckw), streaming_partitions=J)
        engine = TrainEngine(model, dcfg, OptimizerConfig(lr=1e-2))
        state = engine.init(torch.Generator().manual_seed(0), "cpu")
        calls.update(quantize=0, dequantize=0)
        engine.step(state, batches_for_round(stream, 0, 2))
        per_round = engine.launches_per_round(state["outer_params"])
        assert (per_round["quantize"], per_round["dequantize"]) == \
            (calls["quantize"], calls["dequantize"]), ckw
        if full is not None:
            assert (calls["quantize"], calls["dequantize"]) != (0, 0)
            fw = TrainEngine(tbuild_model(tconfigs.get_config("smollm-135m")), dcfg,
                             OptimizerConfig())
            assert fw.wire_launches_per_round(_abstract(get_config("smollm-135m"))[1]) == full
            assert fw.launches_per_round(_abstract(get_config("smollm-135m"))[1])[
                "nesterov"] == 0


@pytest.mark.parametrize("flags", [
    ["--compression", "quant", "--bits", "2", "--error-feedback"],
    ["--compression", "quant", "--rowwise", "--error-feedback", "--streaming", "2"],
    ["--compression", "topk", "--topk-frac", "0.1", "--error-feedback"],
    ["--compression", "quant", "--quant-mode", "statistical", "--bits", "3"],
], ids=["quant2-ef", "rowwise-streaming", "topk", "statistical"])
def test_train_cli_compressed_runs(tmp_path, flags):
    """The compression, error-feedback and streaming flags run on the CPU:
    metrics.csv logs each round's comm_bytes, equal to the reference's
    measured bytes for the same config on the same tree, and the losses are
    finite."""
    out = ttrain.train(_args(tmp_path, *flags, "--rounds", "1"))
    with open(os.path.join(tmp_path, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [r["round"] for r in rows] == ["0"]
    jargs = jtrain.build_parser().parse_args(["--workers", "2", *flags])
    jd = jtrain.make_diloco_cfg(jargs)
    assert ttrain.make_diloco_cfg(_args(tmp_path, *flags)).compression == \
        CompressionConfig(**dataclasses.asdict(jd.compression))
    jcfg, _ = _cfgs()
    jabs = jax.eval_shape(lambda: build_model(jcfg).init(jax.random.PRNGKey(0)))
    masks = jstreaming.streaming_masks(jabs, jd.streaming_partitions) \
        if jd.streaming_partitions > 1 else [None]
    want = sum(jcoll.measured_sync_bytes(jabs, jd.compression, 2, mask=m) for m in masks)
    assert all(int(r["comm_bytes"]) == want for r in rows)
    assert all(math.isfinite(v) for v in out["losses"])
    assert "ef" in out["state"] if "--error-feedback" in flags else "ef" not in out["state"]
