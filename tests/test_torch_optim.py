"""PyTorch port: the optimizer stack against the JAX package.

Parameters are the reference's reduced smollm-135m init; gradients are
numpy draws from a seed. Both cross to the port through numpy, and each
optimizer takes two steps on both sides (the second from the first's
state), so momenta, bias corrections and the schedule's counter are held
too. Every state leaf and every ``None`` hole is compared.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import get_config, reduce_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.optim import base as tbase  # noqa: E402
from repro_torch.utils.tree import (  # noqa: E402
    params_from_numpy,
    state_from_numpy,
    tree_leaves_with_paths,
    tree_map,
)

from test_torch_train import assert_tree_close  # noqa: E402


def _params_and_grads(seed=0):
    jparams = build_model(reduce_config(get_config("smollm-135m"))).init(jax.random.PRNGKey(seed))
    np_params = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(seed)
    np_grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 1e-2).astype(np.float32),
                             np_params) for _ in range(2)]
    return np_params, np_grads


def _two_steps(jopt, topt, np_params, np_grads):
    jp = jax.tree.map(jnp.asarray, np_params)
    js = jopt.init(jp)
    tp = params_from_numpy(np_params, "cpu")
    ts = topt.init(tp)
    assert_tree_close(ts, jax.tree.map(np.asarray, js), "init", atol=0, rtol=0)
    for g in np_grads:
        jp, js = jopt.step(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = topt.step(tp, params_from_numpy(g, "cpu"), ts)
    return (tp, ts), (jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))


CFG = dict(lr=2e-2, weight_decay=1e-4, schedule="cosine", warmup_steps=1, total_steps=4)


def test_adamw_steps_match_reference():
    """AdamW, fp32: atol 1e-6 + rtol 1e-5 (the frameworks' sqrt, pow and
    division round alike to within an ulp; N(0, 1e-2) gradients keep every
    entry far from eps, where Adam's direction would amplify an ulp)."""
    np_params, np_grads = _params_and_grads(0)
    (tp, ts), (jp, js) = _two_steps(joptim.adamw(joptim.OptimizerConfig(**CFG)),
                                    toptim.adamw(toptim.OptimizerConfig(**CFG)),
                                    np_params, np_grads)
    assert_tree_close(tp, jp, "params", atol=1e-6, rtol=1e-5)
    assert_tree_close(ts, js, "state", atol=1e-6, rtol=1e-5)


def test_muon_pallas_steps_match_reference():
    """Muon with ns_impl='pallas' on both sides: fp32 Newton-Schulz (the
    port's matmul-epilogue kernel as its plain version, the reference's in
    interpret mode). Tight: atol 2e-6 + rtol 1e-5 on params (the update is
    lr * sqrt(n/m) * O(0.1) entries, whose 2e-5 fp32 NS differences shrink
    by lr), 1e-6 on the momenta and Adam moments. The state holes (None
    where partition masked a group out) match."""
    np_params, np_grads = _params_and_grads(1)
    (tp, ts), (jp, js) = _two_steps(
        joptim.muon(joptim.OptimizerConfig(**CFG), ns_impl="pallas"),
        toptim.muon(toptim.OptimizerConfig(**CFG), ns_impl="pallas"), np_params, np_grads)
    assert_tree_close(tp, jp, "params", atol=2e-6, rtol=1e-5)
    assert_tree_close(ts, js, "state", atol=1e-6, rtol=1e-5)
    m = ts["tx"]["muon"][0]["m"]
    assert m["embed"] is None and m["layers"]["ln1_scale"] is None
    assert m["layers"]["attn"]["wq"] is not None
    assert ts["tx"]["adamw"]["m"]["layers"]["mlp"]["w_in"] is None
    assert int(ts["count"]) == int(js["count"]) == 2


def test_muon_bf16_newton_schulz_steps_match_reference():
    """Muon with ns_impl='jnp': Newton-Schulz iterated in bf16 on both
    sides. The two frameworks round the bf16 products at other points (XLA
    on the CPU may keep a fused chain in fp32; PyTorch rounds every bf16
    op), and the quintic's cancelling terms (coefficients up to 4.8) turn
    that into differences of a few bf16 ulps of O(1) intermediates. So the
    bar is relative to bf16 itself: on every hidden matrix, the port's
    update differs from the reference's by at most twice as much as the
    reference's bf16 update differs from the fp32 one. AdamW leaves and all
    momenta (no NS in their path) stay within atol 1e-6 + rtol 1e-5."""
    np_params, np_grads = _params_and_grads(2)
    (tp, ts), (jp, js) = _two_steps(
        joptim.muon(joptim.OptimizerConfig(**CFG), ns_impl="jnp"),
        toptim.muon(toptim.OptimizerConfig(**CFG), ns_impl="jnp"), np_params, np_grads)
    (t32, _), _ = _two_steps(
        joptim.muon(joptim.OptimizerConfig(**CFG), ns_impl="pallas"),
        toptim.muon(toptim.OptimizerConfig(**CFG), ns_impl="pallas"), np_params, np_grads)
    tflat, f32 = dict(tree_leaves_with_paths(tp)), dict(tree_leaves_with_paths(t32))
    jflat = dict(tree_leaves_with_paths(params_from_numpy(jp, "cpu")))
    for path, t in tflat.items():
        t, j = t.numpy(), jflat[path].numpy()
        if toptim.muon_label(path, tflat[path]) == "muon":
            bf16_gap = np.abs(j - f32[path].numpy()).max()
            assert np.abs(t - j).max() <= 2 * bf16_gap, path
        else:
            np.testing.assert_allclose(t, j, atol=1e-6, rtol=1e-5, err_msg=path)
    assert_tree_close(ts, js, "state", atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("shape", [(3, 24, 10), (2, 64, 48)])
def test_newton_schulz_bf16_matches_reference(shape):
    """The bf16 newton_schulz alone (m > n and m < n): the port's result is
    at most 1.25x as far from the fp32 oracle as the reference's bf16
    result is, and within twice that distance of the reference's (see the
    test above for why bf16 results differ across the frameworks)."""
    g = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    j = np.asarray(joptim.newton_schulz(jnp.asarray(g)))
    t = toptim.newton_schulz(torch.from_numpy(g)).numpy()
    r = np.asarray(jref.ns_orthogonalize_ref(jnp.asarray(g)))
    gap = np.abs(j - r).max()
    assert 0 < gap < 0.1
    assert np.abs(t - r).max() <= 1.25 * gap
    assert np.abs(t - j).max() <= 2 * gap


# ---------------------------------------------------------------- transforms

def _small():
    rng = np.random.default_rng(5)
    p = {"embed": rng.standard_normal((8, 4)), "layers": {"w": rng.standard_normal((2, 4, 6)),
                                                          "ln_scale": rng.standard_normal((2, 4))}}
    return jax.tree.map(lambda x: x.astype(np.float32), p)


def test_partition_chain_stateless_and_schedule_match_reference():
    """partition routes by muon_label with None holes, chain threads the
    stage states, stateless lifts a function, scale_by_schedule keeps its
    own counter, and apply_updates adds in fp32 — each against the
    reference's combinator on the same tree."""
    p = _small()
    g = jax.tree.map(lambda x: x * 0.5, p)

    def build(o):
        cfg = o.OptimizerConfig(b1=0.8)
        return o.chain(o.stateless(lambda u, _p: u),
                       o.partition(o.muon_label, {"muon": o.trace_momentum(cfg),
                                                  "adamw": o.scale_by_adam(cfg)}),
                       o.scale_by_schedule(lambda c: 0.5 * c))

    jt, tt = build(joptim), build(toptim)
    js, ts = jt.init(jax.tree.map(jnp.asarray, p)), tt.init(params_from_numpy(p, "cpu"))
    assert_tree_close(ts, jax.tree.map(np.asarray, js), "init", atol=0, rtol=0)
    for _ in range(2):
        ju, js = jt.update(jax.tree.map(jnp.asarray, g), js, jax.tree.map(jnp.asarray, p))
        tu, ts = tt.update(params_from_numpy(g, "cpu"), ts, params_from_numpy(p, "cpu"))
    assert_tree_close(tu, jax.tree.map(np.asarray, ju), "updates", atol=1e-6, rtol=1e-6)
    assert_tree_close(ts, jax.tree.map(np.asarray, js), "state", atol=1e-6, rtol=1e-6)
    assert ts[1]["muon"]["m"]["embed"] is None and ts[1]["adamw"]["m"]["layers"]["w"] is None
    tp = toptim.apply_updates(params_from_numpy(p, "cpu"), tu)
    jp = joptim.apply_updates(jax.tree.map(jnp.asarray, p), ju)
    assert_tree_close(tp, jax.tree.map(np.asarray, jp), "applied", atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="terminal"):
        toptim.chain(toptim.nesterov(0.1, 0.9), toptim.stateless(lambda u, _p: u))
    with pytest.raises(ValueError, match="no transform"):
        toptim.partition(lambda path, x: "other", {"muon": toptim.stateless(lambda u, _p: u)}).init(
            params_from_numpy(p, "cpu"))


@pytest.mark.parametrize("step", [1, 2, 5, 9, 40, 100])
def test_schedules_match_reference(step):
    cfg = dict(lr=3e-2, schedule="cosine", warmup_steps=5, total_steps=50, min_lr_ratio=0.1)
    j = float(joptim.make_schedule(joptim.OptimizerConfig(**cfg))(jnp.int32(step)))
    t = float(tbase.make_schedule(toptim.OptimizerConfig(**cfg))(torch.tensor(step,
                                                                             dtype=torch.int32)))
    np.testing.assert_allclose(t, j, rtol=1e-6)
    c = toptim.constant_schedule(0.1)(torch.tensor(step))
    assert c.dtype == torch.float32 and float(c) == np.float32(0.1)


def test_outer_transforms_match_reference():
    """nesterov (plain and kernel=True, whose plain version runs on CPU) and
    outer_sgd against the reference's; atol 1e-6 on O(1) values."""
    p = _small()
    psi = jax.tree.map(lambda x: 0.1 * x, p)
    for name in ("nesterov", "sgd"):
        for kernel in (False, True):
            jt = joptim.make_outer_transform(name, 0.7, 0.9, kernel=False)
            tt = toptim.make_outer_transform(name, 0.7, 0.9, kernel=kernel)
            js = jt.init(jax.tree.map(jnp.asarray, p))
            ts = tt.init(params_from_numpy(p, "cpu"))
            jp, js = jt.apply(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, psi), js)
            tp, ts = tt.apply(params_from_numpy(p, "cpu"), params_from_numpy(psi, "cpu"), ts)
            assert_tree_close(tp, jax.tree.map(np.asarray, jp), name, atol=1e-6, rtol=0)
            assert_tree_close(ts, jax.tree.map(np.asarray, js), name, atol=1e-6, rtol=0)


def test_registries_name_the_reference_optimizers():
    assert toptim.INNER_OPTIMIZERS == joptim.INNER_OPTIMIZERS
    assert toptim.OUTER_OPTIMIZERS == joptim.OUTER_OPTIMIZERS
    for name in ("muon_bp", "normuon"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            toptim.make_inner_optimizer(name, toptim.OptimizerConfig())
    with pytest.raises(ValueError):
        toptim.make_inner_optimizer("sgd", toptim.OptimizerConfig())
    np_state = jax.tree.map(np.asarray, joptim.muon(joptim.OptimizerConfig()).init(
        jax.tree.map(jnp.asarray, _small())))
    bridged = state_from_numpy(np_state, "cpu")
    assert_tree_close(bridged, np_state, "bridge", atol=0, rtol=0)
    assert tree_map(lambda x: x.dtype, bridged)["count"] == torch.int32
