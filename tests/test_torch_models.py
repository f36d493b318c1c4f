"""PyTorch port: the dense LM against the JAX package, reduced smollm-135m.

Parameters come from the reference's ``model.init`` and cross through
``params_from_numpy``; tokens are numpy draws from a seed. Each function
runs with ``attn_impl`` both ``xla`` (plain torch) and ``pallas`` (the
kernels' plain versions on CPU; the reference's Pallas kernels in interpret
mode). Tolerances: fp32 atol 1e-4 (summation order differs across the two
frameworks over 2 layers); bf16 logits atol 5e-2 (about 3 bf16 ulps at
the logits' typical scale of 1-2) plus rtol 2**-7, one bf16 ulp of the
value: the largest logits reach ~12, where one ulp is 0.0625 and the two
frameworks, which round at different points, differ by that ulp.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.models import build_model, common as jcommon, lm as jlm  # noqa: E402
from repro.serving.paging import PageAllocator, pages_needed  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import build_model as tbuild_model, common as tcommon  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.utils.tree import params_from_numpy  # noqa: E402

TOL = {"float32": dict(atol=1e-4, rtol=0), "bfloat16": dict(atol=5e-2, rtol=2.0 ** -7)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Reduced models: one torch thread computes them faster than a pool of
    threads that spin beside the other files of a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def _pair(impl: str, dtype: str = "float32", window: int = 0):
    upd = dict(attn_impl=impl, dtype=dtype, sliding_window=window)
    jcfg = reduce_config(get_config("smollm-135m")).replace(**upd)
    tcfg = tconfigs.reduce_config(tconfigs.get_config("smollm-135m")).replace(**upd)
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, tbuild_model(tcfg), tparams


# the paper's ladder at a narrow hd-128 width (post-norms, QK-norm at hd 128,
# MHA, the untied head), built the same way in both packages
LADDER_SMALL = dict(n_layers=2, d_model=256, n_heads=2, n_kv_heads=2, head_dim=128, d_ff=512,
                    vocab=512, dtype="float32", remat=False)


def _ladder_pair(impl: str):
    jcfg = get_config("paper-150m").replace(attn_impl=impl, **LADDER_SMALL)
    tcfg = tconfigs.get_config("paper-150m").replace(attn_impl=impl, **LADDER_SMALL)
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, tbuild_model(tcfg), tparams


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


# ----------------------------------------------------------------- primitives

def test_primitives_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal((16,)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(tcommon.rms_norm(tx, torch.from_numpy(scale)).numpy(),
                               np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
                               atol=1e-6, rtol=1e-6)
    for p in (pos, np.stack([pos, pos + 3])):
        np.testing.assert_allclose(
            tcommon.apply_rope(tx, torch.from_numpy(p), 10_000.0).numpy(),
            np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(p), 10_000.0)),
            atol=1e-5, rtol=1e-5)
    g = rng.standard_normal(x.shape).astype(np.float32)
    for name in ("swiglu", "relu2", "gelu"):
        np.testing.assert_allclose(
            tcommon.activation_fn(name, tx, torch.from_numpy(g)).numpy(),
            np.asarray(jcommon.activation_fn(name, jnp.asarray(x), jnp.asarray(g))),
            atol=1e-6, rtol=1e-5)


# ------------------------------------------------------------ forward/prefill

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_lm_logits_match_reference(impl, dtype):
    jmodel, jparams, tmodel, tparams = _pair(impl, dtype)
    toks = _tokens(1, (2, 12), jmodel.cfg.vocab)
    jl, _ = jax.jit(jmodel.forward)(jparams, jnp.asarray(toks))
    tl, _ = tmodel.forward(tparams, torch.from_numpy(toks))
    assert tl.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL[dtype])
    if dtype == "float32":
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), np.asarray(jl.argmax(-1)))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_prefill_lm_kv_match_reference(impl):
    jmodel, jparams, tmodel, tparams = _pair(impl)
    toks = _tokens(2, (2, 9), jmodel.cfg.vocab)
    jl, jk, jv = jax.jit(lambda p, t: jlm.prefill_lm(jmodel.cfg, p, t))(jparams, jnp.asarray(toks))
    tl, tk, tv = tlm.prefill_lm(tmodel.cfg, tparams, torch.from_numpy(toks))
    assert tuple(tk.shape) == jk.shape == (2, 2, 9, 1, 64)
    for t, j in ((tl, jl), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_f32(t), _f32(j), atol=1e-4, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ladder_forward_and_prefill_match_reference(impl):
    """The paper's ladder at hd 128 (post-norms, QK-norm, MHA, untied head):
    logits of the forward and the prefill's per-layer K/V == the reference's
    at fp32 atol 1e-4 (test_forward_lm_logits_match_reference's bound), the
    same greedy tokens; the post-norm scales and the head really act (a
    change to either changes the logits)."""
    jmodel, jparams, tmodel, tparams = _ladder_pair(impl)
    assert tmodel.cfg.post_norm and tmodel.cfg.hd == 128 and "head" in tparams
    toks = _tokens(11, (2, 12), jmodel.cfg.vocab)
    jl, _ = jax.jit(jmodel.forward)(jparams, jnp.asarray(toks))
    tl, _ = tmodel.forward(tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL["float32"])
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), np.asarray(jl.argmax(-1)))
    jl, jk, jv = jax.jit(lambda p, t: jlm.prefill_lm(jmodel.cfg, p, t))(jparams, jnp.asarray(toks))
    tl, tk, tv = tlm.prefill_lm(tmodel.cfg, tparams, torch.from_numpy(toks))
    assert tuple(tk.shape) == jk.shape == (2, 2, 12, 2, 128)
    for t, j in ((tl, jl), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_f32(t), _f32(j), **TOL["float32"])
    base = tmodel.forward(tparams, torch.from_numpy(toks))[0]
    for path in ("ln1_post_scale", "ln2_post_scale"):
        moved = dict(tparams, layers=dict(tparams["layers"], **{
            path: tparams["layers"][path] + 0.5}))
        assert not torch.allclose(tmodel.forward(moved, torch.from_numpy(toks))[0], base), path
    moved = dict(tparams, head=tparams["head"] * 2)
    assert not torch.allclose(tmodel.forward(moved, torch.from_numpy(toks))[0], base)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ladder_paged_decode_step_logits_match_reference(impl):
    """Paged prefill, then 3 decode steps of the ladder at hd 128 fed the
    reference's greedy tokens: per-step logits within fp32 atol 1e-4 and the
    same greedy tokens."""
    jmodel, jparams, tmodel, tparams = _ladder_pair(impl)
    B, P, ps, steps = 2, 6, 4, 3
    alloc, table = _paged_setup(B, P, steps, ps, seed=7)
    toks = _tokens(12, (B, P), jmodel.cfg.vocab)
    lens = np.asarray([P, P - 2], np.int32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    jcache = jmodel.init_paged_cache(alloc.n_pages, ps)
    jl, jcache = jax.jit(jmodel.paged_prefill)(jparams, jcache, jnp.asarray(toks), jt,
                                               jnp.asarray(lens))
    tcache = tmodel.init_paged_cache(alloc.n_pages, ps, "cpu")
    tl, tcache = tmodel.paged_prefill(tparams, tcache, torch.from_numpy(toks), tt,
                                      torch.from_numpy(lens))
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL["float32"])
    tok = np.asarray(jl)[np.arange(B), lens - 1].argmax(-1).astype(np.int32)
    jstep = jax.jit(lambda p, c, t, n: jmodel.paged_decode_step(p, c, t, jt, n, impl=impl))
    for t in range(steps):
        n = lens + t
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.asarray(n))
        tlog, tcache = tmodel.paged_decode_step(tparams, tcache, torch.from_numpy(tok), tt,
                                                torch.from_numpy(n), impl=impl)
        np.testing.assert_allclose(_f32(tlog), _f32(jlog), **TOL["float32"])
        np.testing.assert_array_equal(tlog.argmax(-1).numpy(), np.asarray(jlog.argmax(-1)))
        tok = np.asarray(jlog.argmax(-1)).astype(np.int32)


# ------------------------------------------------------------- paged serving

def _paged_setup(B, P, steps, ps=4, seed=3):
    n = pages_needed(P + steps, ps)
    alloc = PageAllocator(n_pages=1 + B * n, page_size=ps)
    rng = np.random.default_rng(seed)
    for b in rng.permutation(B):  # interleaved page ids
        alloc.alloc(int(b), n)
    return alloc, alloc.page_table(range(B), n)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_paged_prefill_pool_matches_reference(impl):
    jmodel, jparams, tmodel, tparams = _pair(impl)
    B, P, ps = 2, 7, 4
    alloc, table = _paged_setup(B, P, 1, ps)
    toks = _tokens(4, (B, P), jmodel.cfg.vocab)
    lens = np.asarray([P, P - 3], np.int32)  # row 1 is right-padded
    jcache = jmodel.init_paged_cache(alloc.n_pages, ps)
    jl, jcache = jax.jit(jmodel.paged_prefill)(jparams, jcache, jnp.asarray(toks),
                                               jnp.asarray(table), jnp.asarray(lens))
    tcache = tmodel.init_paged_cache(alloc.n_pages, ps, "cpu")
    tl, tcache = tmodel.paged_prefill(tparams, tcache, torch.from_numpy(toks),
                                      torch.from_numpy(table), torch.from_numpy(lens))
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-4, rtol=0)
    for key in ("k", "v"):  # page 0 is the null page: garbage by design
        np.testing.assert_allclose(_f32(tcache[key])[:, 1:], _f32(jcache[key])[:, 1:],
                                   atol=1e-4, rtol=0)
        assert _f32(tcache[key])[:, 1:].any()  # the prompt really landed in the pool


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_paged_decode_step_logits_match_reference(impl, dtype, window):
    """Paged prefill, then 4 decode steps fed the reference's greedy tokens:
    per-step logits within tolerance, and in fp32 the same greedy tokens."""
    jmodel, jparams, tmodel, tparams = _pair(impl, dtype, window)
    B, P, ps, steps = 2, 6, 4, 4
    alloc, table = _paged_setup(B, P, steps, ps, seed=5)
    toks = _tokens(6, (B, P), jmodel.cfg.vocab)
    lens = np.asarray([P, P - 2], np.int32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    jcache = jmodel.init_paged_cache(alloc.n_pages, ps)
    jl, jcache = jax.jit(jmodel.paged_prefill)(jparams, jcache, jnp.asarray(toks), jt,
                                               jnp.asarray(lens))
    tcache = tmodel.init_paged_cache(alloc.n_pages, ps, "cpu")
    tl, tcache = tmodel.paged_prefill(tparams, tcache, torch.from_numpy(toks), tt,
                                      torch.from_numpy(lens))
    tok = np.asarray(jl)[np.arange(B), lens - 1].argmax(-1).astype(np.int32)
    jstep = jax.jit(lambda p, c, t, n: jmodel.paged_decode_step(p, c, t, jt, n, impl=impl))
    for t in range(steps):
        n = lens + t
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.asarray(n))
        tlog, tcache = tmodel.paged_decode_step(tparams, tcache, torch.from_numpy(tok), tt,
                                                torch.from_numpy(n), impl=impl)
        np.testing.assert_allclose(_f32(tlog), _f32(jlog), **TOL[dtype])
        if dtype == "float32":
            np.testing.assert_array_equal(tlog.argmax(-1).numpy(), np.asarray(jlog.argmax(-1)))
        tok = np.asarray(jlog.argmax(-1)).astype(np.int32)


# -------------------------------------------------------- blockwise attention

def _qkv(seed, B=2, S=64, H=4, KV=2, hd=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 0)],
                         ids=["causal", "sliding-window", "full"])
def test_blockwise_attention_matches_reference(causal, window):
    """_blockwise_attention (q blocks of 16, kv blocks of 32, S = 64, GQA
    4:2) against the reference's, jitted: the output and the gradients of
    sum(o * g) in q, k and v within 2e-6 (fp32, the same recurrence in
    another summation order); block skipping bitwise equal to the full
    sweep, forward and gradients."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn

    jcfg = reduce_config(get_config("smollm-135m")).replace(sliding_window=window)
    tcfg = tconfigs.reduce_config(tconfigs.get_config("smollm-135m")).replace(
        sliding_window=window)
    q, k, v = _qkv(7)
    g = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)

    def jrun(q, k, v):
        return jattn._blockwise_attention(jcfg, q, k, v, causal=causal, block_q=16,
                                          block_kv=32)

    jo, jvjp = jax.vjp(jax.jit(jrun), *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = jvjp(jnp.asarray(g))
    outs = {}
    for skip in (True, False):
        tq, tk, tv = (torch.from_numpy(x.copy()).requires_grad_(True) for x in (q, k, v))
        o = tattn._blockwise_attention(tcfg, tq, tk, tv, causal=causal, block_q=16,
                                       block_kv=32, skip_blocks=skip)
        grads = torch.autograd.grad((o * torch.from_numpy(g)).sum(), (tq, tk, tv))
        outs[skip] = (o.detach(), *grads)
    for a, b in zip(outs[True], outs[False]):
        assert torch.equal(a, b)
    np.testing.assert_allclose(outs[True][0].numpy(), np.asarray(jo), atol=2e-6, rtol=0)
    for name, t, j in zip("qkv", outs[True][1:], jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-6, rtol=0, err_msg=name)


@pytest.mark.parametrize("window", [0, 5])
def test_attend_xla_blockwise_matches_reference_and_dense(window):
    """attend with attn_impl='xla' at S = 32 >= blockwise_threshold = 32
    (blocks 8 x 16) runs the blockwise path: its output and input gradient
    equal the reference's attend on the same config within 1e-5, and the
    port's own dense path (threshold above S) within 1e-5."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn

    upd = dict(attn_impl="xla", sliding_window=window, blockwise_threshold=32,
               attn_block_q=8, attn_block_kv=16)
    jmodel, jparams, tmodel, tparams = _pair("xla", window=window)
    jcfg, tcfg = jmodel.cfg.replace(**upd), tmodel.cfg.replace(**upd)
    lp_j = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    lp_t = {k: v[0] for k, v in tparams["layers"]["attn"].items()}
    x = np.random.default_rng(9).standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    pos = np.arange(32, dtype=np.int32)

    def jf(xx):
        return jattn.attend(lp_j, jcfg, xx, jnp.asarray(pos)).sum()

    jout = jax.jit(lambda xx: jattn.attend(lp_j, jcfg, xx, jnp.asarray(pos)))(jnp.asarray(x))
    jgx = jax.jit(jax.grad(jf))(jnp.asarray(x))
    outs = []
    for cfg in (tcfg, tcfg.replace(blockwise_threshold=4096)):
        tx = torch.from_numpy(x.copy()).requires_grad_(True)
        o = tattn.attend(lp_t, cfg, tx, torch.from_numpy(pos))
        outs.append((o.detach(), torch.autograd.grad(o.sum(), tx)[0]))
    (ob, gb), (od, gd) = outs
    np.testing.assert_allclose(ob.numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jgx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ob.numpy(), od.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(gb.numpy(), gd.numpy(), atol=1e-5, rtol=0)


# ------------------------------------------------ dense cache (naive engine)

@pytest.mark.parametrize("window", [0, 6])
def test_attend_decode_matches_reference(window):
    """One layer's attend_decode on the same cache and token, at positions
    that wrap the 6-slot ring (window 6) or fill the absolute cache: the
    output within fp32 atol 1e-5 of the reference's; every cache slot but
    the written one bitwise the reference's, the written one within 1e-5
    (the K/V projections round differently across the two frameworks)."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn

    jmodel, jparams, tmodel, tparams = _pair("xla", window=window)
    lp_j = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    lp_t = {k: v[0] for k, v in tparams["layers"]["attn"].items()}
    cfg = tmodel.cfg
    B, W = 2, 6 if window else 14
    rng = np.random.default_rng(13)
    ck = rng.standard_normal((B, W, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    jstep = jax.jit(lambda x, c, pos: jattn.attend_decode(lp_j, jmodel.cfg, x, c, pos))
    for pos in (3, 5, 9, 13):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jo, jc = jstep(jnp.asarray(x), {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                       jnp.int32(pos))
        tc = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
        to, tc = tattn.attend_decode(lp_t, cfg, torch.from_numpy(x), tc, pos)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
        slot = pos % W
        for key in ("k", "v"):
            got, want = tc[key].numpy(), np.asarray(jc[key])
            rest = np.arange(W) != slot
            np.testing.assert_array_equal(got[:, rest], want[:, rest])
            np.testing.assert_allclose(got[:, slot], want[:, slot], atol=1e-5, rtol=0)
            assert not np.array_equal(got[:, slot], (ck if key == "k" else cv)[:, slot])
        ck, cv = np.asarray(jc["k"]), np.asarray(jc["v"])


@pytest.mark.parametrize("window", [0, 6])
def test_dense_cache_prefill_and_decode_match_reference(window):
    """init_cache_lm, prefill_with_cache_lm and five decode_step_lm steps
    fed the reference's greedy tokens, reduced smollm-135m in fp32, 9 prompt
    tokens: with window 6 the ring holds the last 6 prompt positions and
    wraps again while decoding. Logits within atol 1e-5 and the same greedy
    tokens; the caches within 1e-5 of the reference's, their unwritten slots
    zero in both; the port's ring bitwise the port's own prefill K/V at
    slot pos % W."""
    jmodel, jparams, tmodel, tparams = _pair("xla", window=window)
    B, P, new = 2, 9, 5
    toks = _tokens(14, (B, P), jmodel.cfg.vocab)
    jc = jmodel.init_cache(jparams, B, P + new)
    tc = tmodel.init_cache(tparams, B, P + new)
    W = 6 if window else P + new
    assert tuple(tc["k"].shape) == jc["k"].shape == (2, B, W, 1, 64)
    jl, jc = jax.jit(jmodel.prefill_with_cache)(jparams, jc, jnp.asarray(toks))
    tl, tc = tmodel.prefill_with_cache(tparams, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    _, k, v = tlm.prefill_lm(tmodel.cfg, tparams, torch.from_numpy(toks))
    first = max(0, P - W)
    for key, kv in (("k", k), ("v", v)):
        got, want = tc[key].numpy(), np.asarray(jc[key])
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got == 0, want == 0)
        for pos in range(first, P):
            np.testing.assert_array_equal(got[:, :, pos % W], kv[:, :, pos].numpy())
    tok = np.asarray(jl[:, -1].argmax(-1)).astype(np.int32)
    jstep = jax.jit(jmodel.decode_step)
    for t in range(P, P + new):
        jlog, jc = jstep(jparams, jc, jnp.asarray(tok), jnp.int32(t))
        tlog, tc = tmodel.decode_step(tparams, tc, torch.from_numpy(tok), t)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(tlog.argmax(-1).numpy(), np.asarray(jlog.argmax(-1)))
        for key in ("k", "v"):
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), atol=1e-5,
                                       rtol=0)
        tok = np.asarray(jlog.argmax(-1)).astype(np.int32)
    assert tmodel.supports_batched_prefill
    assert tmodel.fill_context(tparams, tc, None) is tc
    np.testing.assert_allclose(tmodel.prefill(tparams, torch.from_numpy(toks)).numpy(),
                               np.asarray(jmodel.prefill(jparams, jnp.asarray(toks))),
                               atol=1e-5, rtol=0)


# ------------------------------------------------------------- nemotron-4-15b

# nemotron-4-15b's head dim (128) and group size (G = 6: 6 query heads a kv
# head) at a narrow width, built the same way in both packages
# (reduce_config gives it 4:4 heads of 64)
NEMOTRON_G6 = dict(n_layers=2, d_model=256, n_heads=6, n_kv_heads=1, head_dim=128, d_ff=512,
                   vocab=512, dtype="float32", remat=False)


def _nemotron_pair(impl: str, g6: bool):
    jcfg, tcfg = get_config("nemotron-4-15b"), tconfigs.get_config("nemotron-4-15b")
    if g6:
        jcfg, tcfg = jcfg.replace(**NEMOTRON_G6), tcfg.replace(**NEMOTRON_G6)
    else:
        jcfg, tcfg = reduce_config(jcfg), tconfigs.reduce_config(tcfg)
    jmodel = build_model(jcfg.replace(attn_impl=impl))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, tbuild_model(tcfg.replace(attn_impl=impl)), tparams


@pytest.mark.parametrize("g6", [False, True], ids=["reduced", "hd128-G6"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_nemotron_logits_match_reference(impl, g6):
    """nemotron-4-15b (squared ReLU, untied head, no QK-norm), reduced and
    at hd 128 with G = 6: forward logits within fp32 atol 1e-4 and the same
    greedy tokens; then a paged prefill and three decode steps fed the
    reference's greedy tokens, per-step logits within 1e-4."""
    jmodel, jparams, tmodel, tparams = _nemotron_pair(impl, g6)
    cfg = tmodel.cfg
    assert cfg.activation == "relu2" and "head" in tparams and "w_gate" not in tparams[
        "layers"]["mlp"]
    assert (cfg.hd, cfg.n_heads // cfg.n_kv_heads) == ((128, 6) if g6 else (64, 1))
    toks = _tokens(15, (2, 10), cfg.vocab)
    jl, _ = jax.jit(jmodel.forward)(jparams, jnp.asarray(toks))
    tl, _ = tmodel.forward(tparams, torch.from_numpy(toks))
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL["float32"])
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), np.asarray(jl.argmax(-1)))
    B, P, ps, steps = 2, 6, 4, 3
    alloc, table = _paged_setup(B, P, steps, ps, seed=9)
    lens = np.asarray([P, P - 1], np.int32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    jcache = jmodel.init_paged_cache(alloc.n_pages, ps)
    jl, jcache = jax.jit(jmodel.paged_prefill)(jparams, jcache, jnp.asarray(toks[:, :P]), jt,
                                               jnp.asarray(lens))
    tcache = tmodel.init_paged_cache(alloc.n_pages, ps, "cpu")
    tl, tcache = tmodel.paged_prefill(tparams, tcache, torch.from_numpy(toks[:, :P]), tt,
                                      torch.from_numpy(lens))
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL["float32"])
    tok = np.asarray(jl)[np.arange(B), lens - 1].argmax(-1).astype(np.int32)
    jstep = jax.jit(lambda p, c, t, n: jmodel.paged_decode_step(p, c, t, jt, n, impl=impl))
    for t in range(steps):
        n = lens + t
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.asarray(n))
        tlog, tcache = tmodel.paged_decode_step(tparams, tcache, torch.from_numpy(tok), tt,
                                                torch.from_numpy(n), impl=impl)
        np.testing.assert_allclose(_f32(tlog), _f32(jlog), **TOL["float32"])
        tok = np.asarray(jlog.argmax(-1)).astype(np.int32)


# ------------------------------------------------------------------------ MoE

# deepseek-moe-16b at a narrow width (both packages): 2 layers, d 64, 8
# routed experts top-2 plus one shared, 2 token groups
MOE_SMALL = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, d_ff=32,
                 vocab=128, n_experts=8, experts_per_token=2, n_shared_experts=1, moe_groups=2,
                 dtype="float32", remat=False)
MOE_LAYERS = {
    # tests/test_models.py::test_moe_capacity_overflow_drops_gracefully: C = 4 of 8
    # tokens x 2 slots a group, so most pairs drop
    "overflow": (dict(d_model=16, d_ff=32, n_experts=4, experts_per_token=2,
                      n_shared_experts=1, capacity_factor=0.01, moe_groups=2), (2, 8, 16)),
    # G = 4 groups of 8 tokens, 8 experts top-2, two shared experts; C = 4, some drops
    "grouped-shared": (dict(d_model=32, d_ff=24, n_experts=8, experts_per_token=2,
                            n_shared_experts=2, moe_groups=4), (2, 16, 32)),
}


def _assert_no_topk_ties(gates: np.ndarray, k: int):
    """torch.topk and lax.top_k may order tied gates differently: the inputs
    are drawn so that the k-th and (k+1)-th gates of every token differ."""
    s = np.sort(gates, axis=-1)[..., ::-1]
    assert (s[..., k - 1] - s[..., k]).min() > 1e-6


@pytest.mark.parametrize("case", sorted(MOE_LAYERS))
def test_moe_layer_matches_reference(case):
    """The MoE layer's grouped capacity dispatch (top-k, renormalised gates,
    the per-expert rank and keep mask, dropped pairs, shared experts, the
    Switch aux) against the reference's, fp32: output and aux within 1e-5,
    and the gradients of sum(out * r) + aux with respect to every weight and
    to x within 1e-5."""
    from repro.models.common import ModelConfig as JModelConfig
    from repro.models.mlp import init_moe as jinit_moe, moe as jmoe
    from repro_torch.models.mlp import _n_groups, moe as tmoe

    kw, shape = MOE_LAYERS[case]
    jcfg = JModelConfig(arch_type="moe", dtype="float32", **kw)
    tcfg = tcommon.ModelConfig(arch_type="moe", dtype="float32", **kw)
    jp = jax.tree.map(np.asarray, jinit_moe(jax.random.PRNGKey(0), jcfg, n_layers=None))
    rng = np.random.default_rng(21)
    x = rng.standard_normal(shape).astype(np.float32)
    r = rng.standard_normal(shape).astype(np.float32)
    G = _n_groups(tcfg, shape[0] * shape[1])
    logits = x.reshape(G, -1, shape[2]) @ jp["router"]
    gates = np.exp(logits - logits.max(-1, keepdims=True))
    _assert_no_topk_ties(gates / gates.sum(-1, keepdims=True), tcfg.experts_per_token)

    def jf(p, x):
        out, aux = jmoe(p, jcfg, x)
        return jnp.sum(out * r) + aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1),
                                                                has_aux=True))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(True), jp)
    tx = torch.from_numpy(x).requires_grad_(True)
    tout, taux = tmoe(tp, tcfg, tx)
    (torch.sum(tout * torch.from_numpy(r)) + taux).backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-5, rtol=0)
    for (path, g), (_, t) in zip(jax.tree_util.tree_flatten_with_path(jgp)[0],
                                 jax.tree_util.tree_flatten_with_path(tp)[0]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5, rtol=0,
                                   err_msg=str(path))
    assert torch.isfinite(tout).all() and tout.shape == shape


@functools.lru_cache(maxsize=1)
def _moe_params():
    """The narrow deepseek-moe-16b's reference init as numpy (attn_impl does
    not enter the init): one compile for the file's MoE tests."""
    jmodel = build_model(get_config("deepseek-moe-16b").replace(**MOE_SMALL))
    return jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0)))


def _moe_pair(impl: str):
    jcfg = get_config("deepseek-moe-16b").replace(attn_impl=impl, **MOE_SMALL)
    tcfg = tconfigs.get_config("deepseek-moe-16b").replace(attn_impl=impl, **MOE_SMALL)
    jparams = jax.tree.map(jnp.asarray, _moe_params())
    return build_model(jcfg), jparams, tbuild_model(tcfg), params_from_numpy(_moe_params(), "cpu")


def test_moe_lm_forward_loss_and_grads_match_reference():
    """A narrow deepseek-moe-16b (fp32, reference params): the forward's
    logits and summed aux within 1e-5, the loss with router_aux_coef x aux
    within 1e-6 and its ``moe_aux`` metric, and every gradient leaf within
    1e-6 (~1e-7 measured)."""
    jmodel, jparams, tmodel, tparams = _moe_pair("xla")
    toks = _tokens(22, (2, 17), 128)
    jl, jaux = jax.jit(jmodel.forward)(jparams, jnp.asarray(toks[:, :-1]))
    tl, taux = tmodel.forward(tparams, torch.from_numpy(toks[:, :-1]))
    np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-5, rtol=0)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    (jloss, jm), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(jparams, jb)
    leaves = jax.tree.map(lambda t: t.clone().requires_grad_(True), tparams)
    tloss, tm = tmodel.loss(leaves, tb)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tm["moe_aux"].item(), float(jm["moe_aux"]), atol=1e-5, rtol=0)
    assert tloss.item() > tm["loss"].item()  # the aux term is in the loss
    for (path, g), (_, t) in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                                 jax.tree_util.tree_flatten_with_path(leaves)[0]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-6, rtol=0,
                                   err_msg=str(path))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_moe_paged_decode_step_logits_match_reference(impl):
    """The narrow deepseek-moe-16b through a paged prefill (a right-padded
    row) and 3 decode steps fed the reference's greedy tokens: logits within
    fp32 atol 1e-4 and the same greedy tokens (the MoE routes the pads and
    both slots of a step together, on both sides)."""
    jmodel, jparams, tmodel, tparams = _moe_pair(impl)
    B, P, ps, steps = 2, 6, 4, 3
    alloc, table = _paged_setup(B, P, steps, ps, seed=8)
    toks = _tokens(23, (B, P), jmodel.cfg.vocab)
    lens = np.asarray([P, P - 2], np.int32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    jcache = jmodel.init_paged_cache(alloc.n_pages, ps)
    jl, jcache = jax.jit(jmodel.paged_prefill)(jparams, jcache, jnp.asarray(toks), jt,
                                               jnp.asarray(lens))
    tcache = tmodel.init_paged_cache(alloc.n_pages, ps, "cpu")
    tl, tcache = tmodel.paged_prefill(tparams, tcache, torch.from_numpy(toks), tt,
                                      torch.from_numpy(lens))
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL["float32"])
    tok = np.asarray(jl)[np.arange(B), lens - 1].argmax(-1).astype(np.int32)
    jstep = jax.jit(lambda p, c, t, n: jmodel.paged_decode_step(p, c, t, jt, n, impl=impl))
    for t in range(steps):
        n = lens + t
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.asarray(n))
        tlog, tcache = tmodel.paged_decode_step(tparams, tcache, torch.from_numpy(tok), tt,
                                                torch.from_numpy(n), impl=impl)
        np.testing.assert_allclose(_f32(tlog), _f32(jlog), **TOL["float32"])
        np.testing.assert_array_equal(tlog.argmax(-1).numpy(), np.asarray(jlog.argmax(-1)))
        tok = np.asarray(jlog.argmax(-1)).astype(np.int32)


# ------------------------------------------- kimi-k2-1t-a32b, mistral-large-123b
#
# narrow widths at the full models' head dims and group sizes, built the same
# way in both packages (reduce_config gives both hd 64): kimi-k2's hd 112 with
# 8:1 heads (G = 8, QK-norm, untied), 6 routed experts top-2 plus one shared in
# 2 token groups; mistral-large's 12:1 heads of 128 (G = 12, no QK-norm, rope
# theta 1e6). fp32, the port's flash path (the kernels' plain versions) against
# the reference's XLA attention, and its paged decode against the reference's
# Pallas kernel in interpret mode. Tolerances as the dense and MoE tests':
# logits fp32 atol 1e-4, the loss 1e-5 and each gradient leaf 1e-5 (the two
# attention paths sum in other orders).

# (the narrow widths of tests/test_torch_{config,serving,engine}.py too)
LAST_SMALL = {
    "kimi-k2-1t-a32b": dict(n_layers=2, d_model=128, n_heads=8, n_kv_heads=1, head_dim=112,
                            d_ff=32, vocab=256, n_experts=6, experts_per_token=2,
                            n_shared_experts=1, moe_groups=2, dtype="float32", remat=False),
    "mistral-large-123b": dict(n_layers=2, d_model=256, n_heads=12, n_kv_heads=1, head_dim=128,
                               d_ff=512, vocab=512, dtype="float32", remat=False)}


@functools.lru_cache(maxsize=2)
def _last_params(name: str):
    """The reference's init of the narrow model as numpy (one compile)."""
    jmodel = build_model(get_config(name).replace(**LAST_SMALL[name]))
    return jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0)))


def _last_pair(name: str, ref_impl: str = "xla"):
    """The reference (its XLA attention unless ``ref_impl`` says otherwise:
    test_torch_kernels.py holds the plain kernels at hd 112 and G = 12 to
    the interpret-mode Pallas ones) and the port on the flash path."""
    jcfg = get_config(name).replace(attn_impl=ref_impl, **LAST_SMALL[name])
    tcfg = tconfigs.get_config(name).replace(attn_impl="pallas", **LAST_SMALL[name])
    params = _last_params(name)
    return (build_model(jcfg), jax.tree.map(jnp.asarray, params), tbuild_model(tcfg),
            params_from_numpy(params, "cpu"))


@pytest.mark.parametrize("name", sorted(LAST_SMALL))
def test_last_models_forward_loss_and_grads_match_reference(name):
    """The narrow kimi-k2 (hd 112, G = 8, MoE) and mistral-large (G = 12):
    the forward's logits within fp32 atol 1e-4 and the same greedy tokens,
    kimi-k2's summed aux within 1e-5, the loss (with the aux term) within
    1e-5 and every gradient leaf within 1e-5, through the flash path (the
    plain forward and backward at G = 8 and 12)."""
    jmodel, jparams, tmodel, tparams = _last_pair(name)
    cfg = tmodel.cfg
    moe = cfg.arch_type == "moe"
    assert (cfg.hd, cfg.n_heads // cfg.n_kv_heads) == ((112, 8) if moe else (128, 12))
    toks = _tokens(24, (2, 17), cfg.vocab)
    jl, jaux = jax.jit(jmodel.forward)(jparams, jnp.asarray(toks[:, :-1]))
    tl, taux = tmodel.forward(tparams, torch.from_numpy(toks[:, :-1]))
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL["float32"])
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), np.asarray(jl.argmax(-1)))
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-5, rtol=0)
    assert (float(taux) > 0) == moe
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    (jloss, _), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(jparams, jb)
    leaves = jax.tree.map(lambda t: t.clone().requires_grad_(True), tparams)
    tloss, _ = tmodel.loss(leaves, tb)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=1e-5, rtol=0)
    for (path, g), (_, t) in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                                 jax.tree_util.tree_flatten_with_path(leaves)[0]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5, rtol=0,
                                   err_msg=str(path))


@pytest.mark.parametrize("name", sorted(LAST_SMALL))
def test_last_models_paged_decode_steps_match_reference(name):
    """The narrow kimi-k2 and mistral-large through a paged prefill (a
    right-padded row) and 3 decode steps through the paged kernel's plain
    version (hd 112 at G = 8; G = 12 at hd 128) fed the reference's greedy
    tokens: logits within fp32 atol 1e-4 and the same greedy tokens."""
    jmodel, jparams, tmodel, tparams = _last_pair(name)
    B, P, ps, steps = 2, 6, 4, 3
    alloc, table = _paged_setup(B, P, steps, ps, seed=12)
    toks = _tokens(25, (B, P), jmodel.cfg.vocab)
    lens = np.asarray([P, P - 2], np.int32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    jcache = jmodel.init_paged_cache(alloc.n_pages, ps)
    jl, jcache = jax.jit(jmodel.paged_prefill)(jparams, jcache, jnp.asarray(toks), jt,
                                               jnp.asarray(lens))
    tcache = tmodel.init_paged_cache(alloc.n_pages, ps, "cpu")
    tl, tcache = tmodel.paged_prefill(tparams, tcache, torch.from_numpy(toks), tt,
                                      torch.from_numpy(lens))
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL["float32"])
    tok = np.asarray(jl)[np.arange(B), lens - 1].argmax(-1).astype(np.int32)
    jstep = jax.jit(lambda p, c, t, n: jmodel.paged_decode_step(p, c, t, jt, n, impl="pallas"))
    for t in range(steps):
        n = lens + t
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(tok), jnp.asarray(n))
        tlog, tcache = tmodel.paged_decode_step(tparams, tcache, torch.from_numpy(tok), tt,
                                                torch.from_numpy(n), impl="pallas")
        np.testing.assert_allclose(_f32(tlog), _f32(jlog), **TOL["float32"])
        np.testing.assert_array_equal(tlog.argmax(-1).numpy(), np.asarray(jlog.argmax(-1)))
        tok = np.asarray(jlog.argmax(-1)).astype(np.int32)


# ------------------------------------------------------- SSM and hybrid (mamba2, zamba2)
#
# Tolerances: the SSD's primitives and a layer at rtol 1e-4 / atol 1e-5, the
# reference's own chunk-invariance tolerance (the port's pairs of products sum
# in another order than the reference's three-operand einsums); the reduced
# models' logits, loss and gradients as the dense ones' (fp32 atol 1e-4).

from repro.models import ssm as jssm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

SSM_TOL = dict(rtol=1e-4, atol=1e-5)
SSM_ARCHS = {"ssm": "mamba2-370m", "hybrid": "zamba2-2.7b"}


def _ssm_cfgs(**upd):
    base = dict(arch_type="ssm", d_model=32, ssm_state=8, ssm_head_dim=8, ssm_chunk=4, vocab=16,
                dtype="float32")
    base.update(upd)
    return jcommon.ModelConfig(**base), tcommon.ModelConfig(**base)


def _mamba_params(jcfg, seed=0):
    jp = jssm.init_mamba(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def test_ssm_primitives_match_reference():
    """_segsum and _causal_conv against the reference's; the gradient through
    _segsum's masked exponentials is finite (exactly 0 at the masked entries)."""
    rng = np.random.default_rng(30)
    x = -np.abs(rng.standard_normal((2, 3, 8))).astype(np.float32)
    np.testing.assert_allclose(torch.exp(tssm._segsum(torch.from_numpy(x))).numpy(),
                               np.asarray(jnp.exp(jssm._segsum(jnp.asarray(x)))), **SSM_TOL)
    tx = torch.from_numpy(x).requires_grad_(True)
    torch.exp(tssm._segsum(tx)).sum().backward()
    assert torch.isfinite(tx.grad).all()
    jg = jax.grad(lambda v: jnp.exp(jssm._segsum(v)).sum())(jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), **SSM_TOL)
    xbc = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal((12,)).astype(np.float32)
    np.testing.assert_allclose(
        tssm._causal_conv(*map(torch.from_numpy, (xbc, w, b))).numpy(),
        np.asarray(jssm._causal_conv(*map(jnp.asarray, (xbc, w, b)))), **SSM_TOL)


def test_mamba_forward_and_decode_match_reference():
    """One Mamba2 layer: the chunked SSD forward (4 chunks), and three
    recurrent decode steps from a zero state, against the reference's."""
    jcfg, tcfg = _ssm_cfgs()
    jp, tp = _mamba_params(jcfg)
    x = np.random.default_rng(31).standard_normal((2, 16, 32)).astype(np.float32)
    jfwd = jax.jit(jssm.mamba_forward, static_argnums=1)
    jdecode = jax.jit(jssm.mamba_decode, static_argnums=1)
    np.testing.assert_allclose(tssm.mamba_forward(tp, tcfg, torch.from_numpy(x)).numpy(),
                               np.asarray(jfwd(jp, jcfg, jnp.asarray(x))), **SSM_TOL)
    with pytest.raises(AssertionError, match="divisible by ssm_chunk"):
        tssm.mamba_forward(tp, tcfg, torch.from_numpy(x[:, :6]))
    jst = jax.tree.map(lambda t: t[0], jssm.init_ssm_state(jcfg, 2, 1))
    tst = jax.tree.map(lambda t: t[0], tssm.init_ssm_state(tcfg, 2, 1, "cpu"))
    for t in range(3):
        jo, jst = jdecode(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jst)
        to, tst = tssm.mamba_decode(tp, tcfg, torch.from_numpy(x[:, t:t + 1]), tst)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **SSM_TOL)
        for k in ("h", "conv"):
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), **SSM_TOL)


def test_mamba_chunk_invariance():
    """The port's chunked SSD is invariant to the chunk size (the twin of
    tests/test_models.py's), on the reference's params and input."""
    jcfg, tcfg = _ssm_cfgs()
    _, tp = _mamba_params(jcfg)
    x = torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 32, 32))))
    y4 = tssm.mamba_forward(tp, tcfg, x).numpy()
    for q in (8, 16):
        np.testing.assert_allclose(y4, tssm.mamba_forward(tp, tcfg.replace(ssm_chunk=q),
                                                          x).numpy(), **SSM_TOL)


@functools.lru_cache(maxsize=2)
def _ssm_params(kind: str):
    """The reduced config's reference init as numpy (one compile a family)."""
    jmodel = build_model(reduce_config(get_config(SSM_ARCHS[kind])))
    return jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0)))


def _ssm_pair(kind: str, impl: str = "xla", remat: bool = False):
    name = SSM_ARCHS[kind]
    jcfg = reduce_config(get_config(name)).replace(attn_impl=impl)
    tcfg = tconfigs.reduce_config(tconfigs.get_config(name)).replace(attn_impl=impl,
                                                                      remat=remat)
    jparams = jax.tree.map(jnp.asarray, _ssm_params(kind))
    return build_model(jcfg), jparams, tbuild_model(tcfg), params_from_numpy(_ssm_params(kind),
                                                                              "cpu")


@pytest.mark.parametrize("kind", sorted(SSM_ARCHS))
def test_ssm_family_forward_loss_and_grads_match_reference(kind):
    """The reduced mamba2-370m and zamba2-2.7b (fp32, reference params, S = 32
    = 4 chunks; zamba2's window 16 masks): logits, the fused loss and every
    gradient leaf (the shared block's summed over its 2 invocations) within
    fp32 atol 1e-4, the port's side with remat on (torch.utils.checkpoint
    per layer or superblock)."""
    jmodel, jparams, tmodel, tparams = _ssm_pair(kind, remat=True)
    toks = _tokens(32, (2, 33), jmodel.cfg.vocab)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}

    @jax.jit  # one compile for the forward and the loss's gradients
    def jrun(p, b):
        return jmodel.forward(p, b["tokens"])[0], jax.value_and_grad(jmodel.loss,
                                                                     has_aux=True)(p, b)

    jl, ((jloss, _), jg) = jrun(jparams, jb)
    tl, _ = tmodel.forward(tparams, tb["tokens"])
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL["float32"])
    leaves = jax.tree.map(lambda t: t.clone().requires_grad_(True), tparams)
    tloss, _ = tmodel.loss(leaves, tb)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL["float32"])
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    tflat = jax.tree_util.tree_flatten_with_path(leaves)[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (path, g), (_, t) in zip(jflat, tflat):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL["float32"],
                                   err_msg=str(path))


@pytest.mark.parametrize("kind", sorted(SSM_ARCHS))
def test_ssm_family_stepped_decode_matches_forward_and_reference(kind):
    """Stepping decode_step over 20 tokens (past zamba2's reduced window of
    16, so the ring cache wraps): each step's logits equal the full forward's
    at that position and the reference's decode_step, fp32 atol 1e-4."""
    jmodel, jparams, tmodel, tparams = _ssm_pair(kind)
    B, T = 2, 20
    toks = _tokens(33, (B, 24), jmodel.cfg.vocab)
    tfull, _ = tmodel.forward(tparams, torch.from_numpy(toks))
    jcache = jmodel.init_cache(jparams, B, T)
    tcache = tmodel.init_cache(tparams, B, T)
    jstep = jax.jit(jmodel.decode_step)
    for t in range(T):
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t]), jnp.int32(t))
        tlog, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(toks[:, t]), t)
        np.testing.assert_allclose(_f32(tlog), _f32(jlog), **TOL["float32"])
        np.testing.assert_allclose(_f32(tlog), _f32(tfull[:, t]), **TOL["float32"])


# ------------------------------------------------- the audio and VLM families
#
# whisper-large-v3 and llama-3.2-vision-90b at reduce_config (fp32) on the
# reference's params, the VLM's tanh gates opened (zero-init would make its
# cross path exactly zero), and a narrow hand-built VLM at hd 128 with
# G = 8 (VLM_G8: 64:8 heads as the full model, so the flash path runs at
# the model's G). Contexts are numpy normal draws. Tolerances as
# the dense ones' (fp32 atol 1e-4).

from repro.models import attention as jattn  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

CONTEXT_ARCHS = {"audio": "whisper-large-v3", "vlm": "llama-3.2-vision-90b"}
VLM_G8 = dict(n_layers=2, vlm_period=2, d_model=256, n_heads=8, n_kv_heads=1, head_dim=128,
              d_ff=256, vocab=256, n_image_tokens=8, dtype="float32", remat=False)


def _open_gates(params):
    """The VLM's tanh gates set to 1 (in place on a dict of numpy leaves)."""
    cl = params["cross_layers"]
    cl["attn"]["gate"] = np.ones_like(cl["attn"]["gate"])
    cl["mlp_gate"] = np.ones_like(cl["mlp_gate"])
    return params


@functools.lru_cache(maxsize=3)
def _context_params(kind: str, g8: bool = False):
    """The reference's init as numpy, gates opened (one compile a family)."""
    jcfg = _context_cfgs(kind, "xla", g8)[0]
    params = jax.tree.map(np.asarray, jax.jit(build_model(jcfg).init)(jax.random.PRNGKey(0)))
    return _open_gates(params) if kind == "vlm" else params


def _context_cfgs(kind: str, impl: str, g8: bool = False, remat: bool = False):
    name = CONTEXT_ARCHS[kind]
    if g8:
        return (get_config(name).replace(attn_impl=impl, **VLM_G8),
                tconfigs.get_config(name).replace(attn_impl=impl, **{**VLM_G8, "remat": remat}))
    return (reduce_config(get_config(name)).replace(attn_impl=impl),
            tconfigs.reduce_config(tconfigs.get_config(name)).replace(attn_impl=impl,
                                                                      remat=remat))


def _context_pair(kind: str, impl: str = "xla", g8: bool = False, remat: bool = False):
    jcfg, tcfg = _context_cfgs(kind, impl, g8, remat)
    params = _context_params(kind, g8)
    return (build_model(jcfg), jax.tree.map(jnp.asarray, params), tbuild_model(tcfg),
            params_from_numpy(params, "cpu"))


def _context(cfg, B: int, seed: int) -> np.ndarray:
    n = cfg.n_audio_frames if cfg.arch_type == "audio" else cfg.n_image_tokens
    return np.random.default_rng(seed).standard_normal((B, n, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("n,d", [(1500, 1280), (16, 256), (5, 2)])
def test_sinusoidal_positions_match_reference(n, d):
    """Whisper's fixed encoder embeddings, at the full model's [1500, 1280],
    the reduced one's and the degenerate d = 2 (one frequency). The two
    libraries' fp32 ``exp`` differ by an ulp in some frequencies (43 of
    640 at d 1280), and position p multiplies that into the angle, so the
    tolerance is atol n * 2**-23 + 1e-6 (1.8e-4 at n = 1500, where the two
    differ by 1.2e-4; 3e-6 at n = 16)."""
    t = tcommon.sinusoidal_positions(n, d)
    assert t.shape == (n, d) and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(jcommon.sinusoidal_positions(n, d)),
                               atol=n * 2.0 ** -23 + 1e-6, rtol=0)


@pytest.mark.parametrize("case", ["plain", "gated", "qk_norm-bf16"])
def test_cross_attend_and_cross_kv_match_reference(case):
    """cross_attend from context states and from cross_kv's precomputed
    (k, v) (the decode path), GQA 4:2, against the reference's: plain, the
    VLM's tanh gate (0.7), and QK-norm in bf16 (atol 5e-2 + one bf16 ulp,
    as the dense logits)."""
    dtype = "bfloat16" if case.endswith("bf16") else "float32"
    kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, qk_norm=case != "plain",
              dtype=dtype)
    jcfg, tcfg = jcommon.ModelConfig(**kw), tcommon.ModelConfig(**kw)
    jp = jattn.init_attention(jax.random.PRNGKey(3), jcfg, cross=True)
    jp = {**jp, "gate": jnp.float32(0.7)}
    if jcfg.qk_norm:
        jp["q_norm_scale"] = jnp.full((8,), 0.3)
        jp["k_norm_scale"] = jnp.full((8,), -0.2)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(34)
    x, ctx = (rng.standard_normal(s).astype(np.float32) for s in ((2, 5, 32), (2, 7, 32)))
    cast = getattr(torch, dtype)
    tx, tctx = torch.from_numpy(x).to(cast), torch.from_numpy(ctx).to(cast)
    jx, jctx = jnp.asarray(x, jcfg.compute_dtype), jnp.asarray(ctx, jcfg.compute_dtype)
    gated = case == "gated"
    jk, jv = jattn.cross_kv(jp, jcfg, jctx)
    tk, tv = tattn.cross_kv(tp, tcfg, tctx)
    want = jattn.cross_attend(jp, jcfg, jx, jctx, gated=gated)
    for t, j in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(_f32(t), _f32(j), **TOL[dtype])
    for kv in (tctx, (tk, tv)):
        out = tattn.cross_attend(tp, tcfg, tx, kv, gated=gated)
        assert out.dtype == cast and out.shape == (2, 5, 32)
        np.testing.assert_allclose(_f32(out), _f32(want), **TOL[dtype])
    if gated:
        plain = tattn.cross_attend(tp, tcfg, tx, tctx)
        np.testing.assert_allclose(_f32(out), np.tanh(0.7) * _f32(plain), atol=1e-6)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("kind", sorted(CONTEXT_ARCHS))
def test_context_family_forward_loss_and_grads_match_reference(kind, impl):
    """The reduced whisper-large-v3 (2 + 2 layers, 16 frames, the encoder's
    attention non-causal) and llama-3.2-vision-90b (2 superblocks, 16 image
    tokens, gates open), fp32, on a context: logits, the fused loss from
    ``batch["context"]`` and every gradient leaf within fp32 atol 1e-4, the
    port's side with remat on (a layer or superblock under
    torch.utils.checkpoint); the forward without a context raises the
    reference's assertion."""
    jmodel, jparams, tmodel, tparams = _context_pair(kind, impl, remat=True)
    cfg = tmodel.cfg
    toks = _tokens(35, (2, 13), cfg.vocab)
    ctx = _context(cfg, 2, 36)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:]),
          "context": jnp.asarray(ctx)}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:]),
          "context": torch.from_numpy(ctx)}

    @jax.jit
    def jrun(p, b):
        return (jmodel.forward(p, b["tokens"], context=b["context"])[0],
                jax.value_and_grad(jmodel.loss, has_aux=True)(p, b))

    jl, ((jloss, _), jg) = jrun(jparams, jb)
    tl, _ = tmodel.forward(tparams, tb["tokens"], context=tb["context"])
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL["float32"])
    leaves = jax.tree.map(lambda t: t.clone().requires_grad_(True), tparams)
    tloss, _ = tmodel.loss(leaves, tb)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL["float32"])
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    tflat = jax.tree_util.tree_flatten_with_path(leaves)[0]
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (path, g), (_, t) in zip(jflat, tflat):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL["float32"],
                                   err_msg=str(path))
    with pytest.raises(AssertionError, match="requires .* context"):
        tmodel.forward(tparams, tb["tokens"])


@pytest.mark.parametrize("kind", sorted(CONTEXT_ARCHS))
def test_context_family_stepped_decode_matches_forward_and_reference(kind):
    """fill_context (whisper: the encoder once, every decoder layer's cross
    K/V; the VLM: the projected patches' K/V a superblock), then decode_step
    over 12 tokens: each step's logits equal the full forward's at that
    position and the reference's fill_context + decode_step (fp32 atol
    1e-4), and the cross K/V equal the reference's."""
    jmodel, jparams, tmodel, tparams = _context_pair(kind)
    B, T = 2, 12
    toks = _tokens(37, (B, T), tmodel.cfg.vocab)
    ctx = _context(tmodel.cfg, B, 38)
    tfull, _ = tmodel.forward(tparams, torch.from_numpy(toks), context=torch.from_numpy(ctx))
    jcache = jax.jit(jmodel.fill_context)(jparams, jmodel.init_cache(jparams, B, T),
                                          jnp.asarray(ctx))
    tcache = tmodel.init_cache(tparams, B, T)
    assert tmodel.fill_context(tparams, tcache, torch.from_numpy(ctx)) is tcache
    for k in ("cross_k", "cross_v"):
        np.testing.assert_allclose(_f32(tcache[k]), _f32(jcache[k]), **TOL["float32"])
    jstep = jax.jit(jmodel.decode_step)
    for t in range(T):
        jlog, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t]), jnp.int32(t))
        tlog, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(toks[:, t]), t)
        np.testing.assert_allclose(_f32(tlog), _f32(jlog), **TOL["float32"])
        np.testing.assert_allclose(_f32(tlog), _f32(tfull[:, t]), **TOL["float32"])


def test_vlm_g8_hd128_matches_reference():
    """A narrow llama-3.2-vision (``VLM_G8``: 8:1 heads of 128, so G = 8 as
    the full model's 64:8; one superblock of 1 cross + 1 self layer, gates
    open), fp32, attn_impl 'pallas': loss and gradients as the test above
    (the reference's flash kernel in interpret mode, the port's plain
    versions of flash_fwd / flash_dq / flash_dkv at G = 8, hd 128)."""
    jmodel, jparams, tmodel, tparams = _context_pair("vlm", "pallas", g8=True)
    cfg = tmodel.cfg
    assert (cfg.hd, cfg.n_heads // cfg.n_kv_heads, tmodel.attention_layers) == (128, 8, 1)
    toks = _tokens(39, (1, 17), cfg.vocab)
    ctx = _context(cfg, 1, 40)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:]),
          "context": jnp.asarray(ctx)}
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    (jloss, _), jg = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True))(jparams, jb)
    leaves = jax.tree.map(lambda t: t.clone().requires_grad_(True), tparams)
    tloss, _ = tmodel.loss(leaves, tb)
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss), **TOL["float32"])
    for (path, g), (_, t) in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                                 jax.tree_util.tree_flatten_with_path(leaves)[0]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL["float32"],
                                   err_msg=str(path))


def test_remat_recomputation_sees_the_forwards_tensor_parallel_axis(monkeypatch):
    """With ``remat`` a block's forward runs again inside the backward, and
    on the card autograd runs that recomputation on its own thread, which
    sees no ContextVar: the dense LM's checkpointed blocks recompute in the
    forward's context, so a tensor-parallel round's 'model' axis (and its
    sums) is there both times. Here the backward runs on another thread."""
    import threading

    from repro_torch.configs import get_config as tget
    from repro_torch.configs import reduce_config as treduce
    from repro_torch.core import collectives as C
    from repro_torch.models import build_model as tbuild
    from repro_torch.models import lm
    from repro_torch.utils.tree import tree_map

    cfg = treduce(tget("paper-150m")).replace(remat=True)
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    group = object()  # the sums are stood in for: no process group runs
    monkeypatch.setattr(C, "_model_sum", lambda x, group: x)
    seen, block = [], lm._block

    def spy(*a, **kw):
        seen.append(C.model_group())
        return block(*a, **kw)

    monkeypatch.setattr(lm, "_block", spy)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)))
    with C.mesh_groups(C.MeshGroups(model=group)):
        loss, _ = model.loss(leaves, {"tokens": tokens, "labels": tokens})
    done = []
    worker = threading.Thread(target=lambda: done.append(torch.autograd.grad(
        loss, [leaves["layers"]["mlp"]["w_in"]])))
    worker.start()
    worker.join()
    assert done and len(seen) == 2 * cfg.n_layers and all(g is group for g in seen), seen
