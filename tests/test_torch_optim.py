"""PyTorch port: the optimizer stack against the JAX package.

Parameters are the reference's reduced smollm-135m init; gradients are
numpy draws from a seed. Both cross to the port through numpy, and each
optimizer takes two steps on both sides (the second from the first's
state), so momenta, bias corrections and the schedule's counter are held
too. Every state leaf and every ``None`` hole is compared.
"""
import dataclasses
import sys

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
    p = _small()
    for name in ("muon_bp", "normuon"):
        for period in (1, 4):
            cfg = dict(ns_period=period)
            jst = jax.tree.map(np.asarray, joptim.make_inner_optimizer(
                name, joptim.OptimizerConfig(**cfg)).init(jax.tree.map(jnp.asarray, p)))
            tst = toptim.make_inner_optimizer(name, toptim.OptimizerConfig(**cfg)).init(
                params_from_numpy(p, "cpu"))
            assert_tree_close(tst, jst, f"{name} init", atol=0, rtol=0)
            assert tree_map(lambda x: x.dtype, tst)["count"] == torch.int32
    with pytest.raises(ValueError):
        toptim.make_inner_optimizer("sgd", toptim.OptimizerConfig())
    np_state = jax.tree.map(np.asarray, joptim.muon(joptim.OptimizerConfig()).init(
        jax.tree.map(jnp.asarray, _small())))
    bridged = state_from_numpy(np_state, "cpu")
    assert_tree_close(bridged, np_state, "bridge", atol=0, rtol=0)
    assert tree_map(lambda x: x.dtype, bridged)["count"] == torch.int32


# ------------------------------------------------------------ Muon variants

def _variant_tree(seed):
    """A small tree with Muon leaves of both orientations (m < n and m > n,
    at most 64 x 96) and AdamW leaves, plus N(0, 1e-2) gradients."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": (16, 8), "layers": {"w_in": (2, 64, 96), "w_out": (2, 96, 64),
                                           "ln1_scale": (2, 64)}}
    p = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32) * 0.1, shapes,
                     is_leaf=lambda x: isinstance(x, tuple))
    return p, lambda: jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 1e-2)
                                   .astype(np.float32), p)


def _run_steps(jopt, topt, p, draw, n):
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    out = []
    for _ in range(n):
        g = draw()
        jp, js = jopt.step(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = topt.step(tp, params_from_numpy(g, "cpu"), ts)
        out.append(((tp, ts), (jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js))))
    return out


@pytest.mark.parametrize("ns_impl", ["jnp", "pallas"])
def test_muon_bp_period_one_is_muon_bitwise(ns_impl):
    """At ns_period 1 the periodic stage is bypassed: muon_bp is muon, every
    param and state leaf bitwise over three steps, bf16 and fp32 NS (the
    reference's docstring pins the same)."""
    p, draw = _variant_tree(7)
    cfg = toptim.OptimizerConfig(**CFG, ns_period=1)
    a, b = toptim.muon_bp(cfg, ns_impl=ns_impl), toptim.muon(cfg, ns_impl=ns_impl)
    pa, pb = params_from_numpy(p, "cpu"), params_from_numpy(p, "cpu")
    sa, sb = a.init(pa), b.init(pb)
    for _ in range(3):
        g = params_from_numpy(draw(), "cpu")
        pa, sa = a.step(pa, g, sa)
        pb, sb = b.step(pb, g, sb)
        for (path, x), (_, y) in zip(tree_leaves_with_paths((pa, sa)),
                                     tree_leaves_with_paths((pb, sb))):
            assert torch.equal(x, y), path


def _reference_plain_fp32_ns(monkeypatch):
    """Route the reference's ns_impl='pallas' through its own plain fp32
    oracle (``kernels/ref.py``, which its tests hold its Pallas kernel to):
    the same fp32 iterations without interpret mode's cost."""
    jmuon = sys.modules["repro.optim.muon"]  # the module (repro.optim.muon is the function)

    def ns_plain(g, iters=5, eps=1e-7):
        *_, m, n = g.shape
        return jref.ns_orthogonalize_ref(g.reshape(-1, m, n), iters, eps).reshape(g.shape)

    monkeypatch.setattr(jmuon, "newton_schulz_pallas", ns_plain)


def test_muon_bp_periodic_steps_match_reference(monkeypatch):
    """ns_period 3 over 7 steps with fp32 Newton-Schulz on both sides (the
    reference's through its plain oracle): NS on steps 1, 4 and 7, the fp32
    momentum on the others. Params within atol 2e-6 + rtol 1e-5 and state
    within 1e-6 + 1e-5 at every step (the Muon test's tolerances); the own
    counter equals the reference's."""
    _reference_plain_fp32_ns(monkeypatch)
    p, draw = _variant_tree(8)
    jcfg = joptim.OptimizerConfig(**CFG, ns_period=3)
    tcfg = toptim.OptimizerConfig(**CFG, ns_period=3)
    steps = _run_steps(joptim.muon_bp(jcfg, ns_impl="pallas"),
                       toptim.muon_bp(tcfg, ns_impl="pallas"), p, draw, 7)
    for i, ((tp, ts), (jp, js)) in enumerate(steps):
        assert_tree_close(tp, jp, f"step {i + 1} params", atol=2e-6, rtol=1e-5)
        assert_tree_close(ts, js, f"step {i + 1} state", atol=1e-6, rtol=1e-5)
    assert int(ts["tx"]["muon"][1]["count"]) == 7


def test_normuon_steps_match_reference(monkeypatch):
    """NorMuon over 3 steps, fp32 Newton-Schulz on both sides (the
    reference's through its plain oracle): the neuron-wise second moment v
    [..., m, 1] and the restored per-matrix norm. Params within atol 2e-6 +
    rtol 1e-5, state (momenta, v, counters) within 1e-6 + 1e-5."""
    _reference_plain_fp32_ns(monkeypatch)
    p, draw = _variant_tree(9)
    steps = _run_steps(joptim.normuon(joptim.OptimizerConfig(**CFG), ns_impl="pallas"),
                       toptim.normuon(toptim.OptimizerConfig(**CFG), ns_impl="pallas"),
                       p, draw, 3)
    for i, ((tp, ts), (jp, js)) in enumerate(steps):
        assert_tree_close(tp, jp, f"step {i + 1} params", atol=2e-6, rtol=1e-5)
        assert_tree_close(ts, js, f"step {i + 1} state", atol=1e-6, rtol=1e-5)
    v = ts["tx"]["muon"][2]["v"]
    assert v["layers"]["w_in"].shape == (2, 64, 1) and v["embed"] is None


# ------------------------------------------------------------ core/analysis

def _delta_trees(seed, K=3):
    rng = np.random.default_rng(seed)
    shapes = {"embed": (16, 8), "layers": {"w_in": (2, 48, 64), "w_out": (2, 64, 48),
                                           "ln1_scale": (2, 48)}, "proj": (40, 24)}
    return [jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                         is_leaf=lambda x: isinstance(x, tuple)) for _ in range(K)]


def test_analysis_tree_functions_match_reference():
    """hidden_matrix_leaves (through muon_label), per_matrix_cosines (one
    cosine per [L, m, n] slice, keys ``path[i]``) and frobenius_norms
    against the reference's on the same numpy trees: the same keys, values
    within 1e-6 (fp32 dot products of ~3,000 terms)."""
    from repro.core import analysis as janalysis
    from repro_torch.core import analysis as tanalysis

    a, b = _delta_trees(11, K=2)
    ja = [(pth, np.asarray(x)) for pth, x in
          janalysis.hidden_matrix_leaves(jax.tree.map(jnp.asarray, a))]
    ta = tanalysis.hidden_matrix_leaves(params_from_numpy(a, "cpu"))
    assert sorted(pth for pth, _ in ja) == [pth for pth, _ in ta] == [
        "layers/w_in", "layers/w_out", "proj"]
    jc = janalysis.per_matrix_cosines(jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, b))
    tc = tanalysis.per_matrix_cosines(params_from_numpy(a, "cpu"), params_from_numpy(b, "cpu"))
    assert sorted(jc) == sorted(tc) and "layers/w_in[1]" in tc
    for key in jc:
        np.testing.assert_allclose(tc[key], jc[key], atol=1e-6, err_msg=key)
    jf = janalysis.frobenius_norms(jax.tree.map(jnp.asarray, a))
    tf = tanalysis.frobenius_norms(params_from_numpy(a, "cpu"))
    assert sorted(jf) == sorted(tf)
    for key in jf:
        np.testing.assert_allclose(tf[key], jf[key], rtol=1e-6, err_msg=key)
    x = torch.from_numpy(a["proj"])
    np.testing.assert_allclose(float(tanalysis.cosine(x, 2 * x)), 1.0, rtol=1e-6)


@pytest.mark.parametrize("shape", [(4, 32, 48), (3, 64, 40)])
def test_analysis_spectral_functions_match_reference(shape):
    """singular_values, orthonormal_factor, nuclear_norm and the top-S
    interference gap (Def. 4.1) on [K, m, n] worker matrices (m < n and
    m > n), against the reference's jnp.linalg results: singular values and
    nuclear norms within rtol 1e-5, U V^T within 1e-5 (distinct singular
    values, so the factor is unique), the gap within 1e-4 of the top-S mass."""
    from repro.core import analysis as janalysis
    from repro_torch.core import analysis as tanalysis

    w = np.random.default_rng(12).standard_normal(shape).astype(np.float32)
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    np.testing.assert_allclose(tanalysis.singular_values(tw[0]).numpy(),
                               np.asarray(janalysis.singular_values(jw[0])), rtol=1e-5)
    np.testing.assert_allclose(tanalysis.orthonormal_factor(tw[0]).numpy(),
                               np.asarray(janalysis.orthonormal_factor(jw[0])), atol=1e-5)
    np.testing.assert_allclose(float(tanalysis.nuclear_norm(tw[1])),
                               float(janalysis.nuclear_norm(jw[1])), rtol=1e-5)
    for s_frac in (0.05, 0.25):
        jg = float(janalysis.interference_gap(jw, s_frac))
        tg = float(tanalysis.interference_gap(tw, s_frac))
        mass = float(janalysis.nuclear_norm(jw[0]))
        assert abs(tg - jg) <= 1e-4 * mass, (s_frac, tg, jg)


def test_prop42_identity_matches_reference():
    """Proposition 4.2 on a [K, H, m, n] stack of steps with uneven alphas:
    the port's (lhs, rhs) equal the reference's within rtol 1e-5, and lhs
    equals rhs within 1e-4 relative (the identity is exact)."""
    from repro.core import analysis as janalysis
    from repro_torch.core import analysis as tanalysis

    rng = np.random.default_rng(13)
    steps = rng.standard_normal((3, 4, 32, 48)).astype(np.float32)
    alphas = np.array([1.0, 0.5, 0.25, 2.0], np.float32)
    jl, jr = janalysis.prop42_nuclear_identity(jnp.asarray(steps), jnp.asarray(alphas))
    tl, tr = tanalysis.prop42_nuclear_identity(torch.from_numpy(steps), torch.from_numpy(alphas))
    np.testing.assert_allclose([float(tl), float(tr)], [float(jl), float(jr)], rtol=1e-5)
    assert abs(float(tl) - float(tr)) <= 1e-4 * float(tl)


# -------------------------------------------------------- core/scaling_laws

def _power_law_points(seed):
    rng = np.random.default_rng(seed)
    C = np.logspace(17, 21, 7)
    return C, 30.0 * C ** -0.08 + 1.6 + rng.normal(0, 1e-3, C.shape)


def test_scaling_law_fits_match_reference():
    """fit_power_law (fixed and fitted irreducible), fit_joint_irreducible,
    optimal_and_critical_batch and iso_loss_time_ratio on fixed synthetic
    points: the port's copy of the reference's numpy/scipy code gives the
    reference's numbers exactly with the same seed (8 restarts at most)."""
    from repro.core import scaling_laws as jsl
    from repro_torch.core import scaling_laws as tsl

    C, L = _power_law_points(14)
    asdict = dataclasses.asdict
    for kw in (dict(irr=1.6, restarts=8), dict(fit_irr=True, restarts=8)):
        assert asdict(tsl.fit_power_law(C, L, **kw)) == asdict(jsl.fit_power_law(C, L, **kw))
    data = {"muon": (C, L), "adamw": _power_law_points(15)}
    kw = dict(n_grid=3, restarts=2)
    (ti, tfits), (ji, jfits) = tsl.fit_joint_irreducible(data, **kw), \
        jsl.fit_joint_irreducible(data, **kw)
    assert ti == ji and {k: asdict(f) for k, f in tfits.items()} == {
        k: asdict(f) for k, f in jfits.items()}
    np.testing.assert_array_equal(tsl.huber(L - 2.0), jsl.huber(L - 2.0))
    batches, losses = [64, 128, 256, 512, 1024], [3.1, 3.0, 3.01, 3.05, 3.2]
    assert tsl.optimal_and_critical_batch(batches, losses) == \
        jsl.optimal_and_critical_batch(batches, losses)
    fits = [tsl.PowerLawFit(a=30.0, alpha=-0.08, irr=1.6, objective=0.0),
            tsl.PowerLawFit(a=2.0, alpha=0.3, irr=0.0, objective=0.0),
            tsl.PowerLawFit(a=28.0, alpha=-0.08, irr=1.6, objective=0.0),
            tsl.PowerLawFit(a=2.5, alpha=0.3, irr=0.0, objective=0.0)]
    jfits = [jsl.PowerLawFit(**asdict(f)) for f in fits]
    assert tsl.iso_loss_time_ratio(*fits, target_loss=2.5) == \
        jsl.iso_loss_time_ratio(*jfits, target_loss=2.5)


def test_descend_keeps_state_that_aliases_its_updates():
    """A stage may return one dict as both its updates and its state (as
    optax's ``trace`` does): the descent frees directions from dicts of its
    own, so the state comes back whole and the step is p - lr * u."""
    from repro_torch.optim.transform import Transform

    alias = Transform(init=lambda p: tree_map(torch.zeros_like, p),
                      update=lambda g, s, p: (g, g))
    opt = tbase.descend(alias, toptim.OptimizerConfig(lr=0.5))
    params = {"a": torch.ones(3), "b": {"c": torch.full((2, 2), 2.0)}}
    grads = {"a": torch.full((3,), 4.0), "b": {"c": torch.ones(2, 2)}}
    new_params, state = opt.step(params, grads, opt.init(params))
    assert set(state["tx"]) == {"a", "b"} and set(state["tx"]["b"]) == {"c"}
    torch.testing.assert_close(state["tx"]["b"]["c"], torch.ones(2, 2), atol=0, rtol=0)
    torch.testing.assert_close(new_params["a"], torch.full((3,), -1.0), atol=0, rtol=0)
    torch.testing.assert_close(new_params["b"]["c"], torch.full((2, 2), 1.5), atol=0, rtol=0)
