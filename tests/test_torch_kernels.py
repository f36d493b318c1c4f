"""PyTorch port: the kernels' plain versions against the JAX package.

On CPU tensors the port's wrappers take each Hopper kernel's plain PyTorch
version, so these tests hold that arithmetic against the reference's Pallas
kernels run as the reference's own tests run them (``interpret=True``) and
against its plain paths. Inputs are made with numpy from a seed and handed
to both sides. fp32 throughout, at atol = rtol = 1e-5 (the reference's own
bound for its interpret-mode kernel, tests/test_serving.py) unless a test
states another bound and its reason.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.optim.nesterov import nesterov as jnesterov  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.matmul import matmul_epilogue  # noqa: E402
from repro_torch.optim.nesterov import nesterov as tnesterov  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------ flash forward

@pytest.mark.parametrize("S", [16, 13])
@pytest.mark.parametrize("H,KV", [(4, 1), (4, 4)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_flash_fwd_plain_matches_pallas(causal, window, H, KV, S):
    """o and lse of the port's plain flash forward == the reference's Pallas
    ``_fwd`` in interpret mode, on the kernel layout [B*KV, S, G, hd]."""
    rng = np.random.default_rng(S * 100 + H * 10 + KV + window)
    B, hd = 2, 16
    G = H // KV
    q, k, v = _np(rng, (B * KV, S, G, hd)), _np(rng, (B * KV, S, hd)), _np(rng, (B * KV, S, hd))
    scale = 1.0 / math.sqrt(hd)
    b = jfa.clamp_block(8, S)
    jo, jlse = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                        window=window, bq=b, bkv=b, scale=scale, interpret=True, skip=True)
    to, tlse = tfa._fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        causal=causal, window=window, scale=scale)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_gqa_flash_attention_matches_reference_layout(causal, window):
    """The model-layout entry point == the reference's gqa_flash_attention
    (interpret mode) and both oracles: query head h reads kv head h // G."""
    rng = np.random.default_rng(7 + window)
    B, S, H, KV, hd = 2, 12, 6, 2, 16
    q, k, v = _np(rng, (B, S, H, hd)), _np(rng, (B, S, KV, hd)), _np(rng, (B, S, KV, hd))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    j = jfa.gqa_flash_attention(jq, jk, jv, causal=causal, window=window, block_q=4,
                                block_kv=4, interpret=True)
    t = tfa.gqa_flash_attention(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    jr = jref.gqa_attention_ref(jq, jk, jv, causal=causal, window=window)
    tr = tref.gqa_attention_ref(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)
    np.testing.assert_allclose(t.numpy(), tr.numpy(), **TOL)


# ------------------------------------------------------------- paged decode

def _paged_inputs(seed):
    """Ragged allocations (1, 3 and 4 pages), null-padded rows and an idle
    slot (all-null row), GQA 4:2 — the reference's oracle workload plus
    one idle slot."""
    rng = np.random.default_rng(seed)
    B, H, KV, hd, ps, max_pages = 4, 4, 2, 8, 4, 4
    n_pool = 1 + B * max_pages
    q = _np(rng, (B, H, hd))
    kp, vp = _np(rng, (n_pool, ps, KV, hd)), _np(rng, (n_pool, ps, KV, hd))
    perm = rng.permutation(np.arange(1, n_pool)).astype(np.int32)
    table = np.zeros((B, max_pages), np.int32)
    for b, n in enumerate([1, 3, 4]):
        table[b, :n] = perm[b * max_pages: b * max_pages + n]
    lengths = np.asarray([2, 11, 16, 1], np.int32)  # include the current token
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("window", [0, 5])
def test_paged_decode_plain_matches_pallas_and_xla(window):
    q, kp, vp, table, lengths = _paged_inputs(11 + window)
    j_in = tuple(map(jnp.asarray, (q, kp, vp, table, lengths)))
    t_in = tuple(map(torch.from_numpy, (q, kp, vp, table, lengths)))
    j_pal = jfa.paged_decode_attention(*j_in, window=window, impl="pallas", interpret=True)
    j_xla = jfa.paged_decode_attention(*j_in, window=window, impl="xla")
    t_pal = tfa.paged_decode_attention(*t_in, window=window, impl="pallas")
    t_xla = tfa.paged_decode_attention(*t_in, window=window, impl="xla")
    np.testing.assert_allclose(t_pal.numpy(), np.asarray(j_pal), **TOL)
    np.testing.assert_allclose(t_xla.numpy(), np.asarray(j_xla), **TOL)
    np.testing.assert_allclose(t_pal.numpy(), np.asarray(j_xla), **TOL)
    t_ref = tref.paged_attention_ref(*t_in, window=window)
    j_ref = jref.paged_attention_ref(*j_in, window=window)
    np.testing.assert_allclose(t_ref.numpy(), np.asarray(j_ref), **TOL)
    np.testing.assert_allclose(t_pal.numpy(), t_ref.numpy(), **TOL)


def test_paged_decode_null_page_is_inert():
    """Garbage in the null page and in pages past a slot's length changes
    nothing for the live slots (the idle slot's output is discarded)."""
    q, kp, vp, table, lengths = _paged_inputs(3)
    t_in = list(map(torch.from_numpy, (q, kp, vp, table, lengths)))
    base = tfa.paged_decode_attention(*t_in, impl="pallas")
    t_in[1] = t_in[1].clone()
    t_in[2] = t_in[2].clone()
    t_in[1][0] = 1e4
    t_in[2][0] = -1e4
    t_in[1][int(table[1, 2]), 3:] = 1e4  # slot 1 holds 11 positions: page 2 slot 3 is past it
    out = tfa.paged_decode_attention(*t_in, impl="pallas")
    np.testing.assert_array_equal(out[:3].numpy(), base[:3].numpy())


# ------------------------------------------------------- schedule helpers

def test_schedule_helpers_equal_reference():
    for S in (1, 7, 12, 16, 64, 100):
        for blk in (1, 4, 8, 16, 512):
            assert tfa.clamp_block(blk, S) == jfa.clamp_block(blk, S)
            for causal in (True, False):
                for window in (0, 3, 10):
                    assert tfa.visited_fraction(S, blk, 2 * blk, causal, window) == \
                        jfa.visited_fraction(S, blk, 2 * blk, causal, window)
    for nq, nkv, bq, bkv in [(4, 4, 8, 8), (8, 4, 4, 8), (4, 8, 8, 4), (3, 5, 16, 8)]:
        for causal in (True, False):
            for window in (0, 5, 17):
                for skip in (True, False):
                    assert tfa.attention_schedule(nq, nkv, bq, bkv, causal, window, skip) == \
                        jfa.attention_schedule(nq, nkv, bq, bkv, causal, window, skip)
                for qi in range(nq):
                    assert tfa.visited_kv_range(qi, nkv, bq, bkv, causal, window) == \
                        jfa.visited_kv_range(qi, nkv, bq, bkv, causal, window)


def test_kernel_tiles_visit_contiguous_ranges():
    """The flash kernel walks [lo, hi) of visited_kv_range at its own tiles;
    at the serving prefill shape the causal walk is about half the grid."""
    S = 512
    nq, nkv = -(-S // tfa.FLASH_BLOCK_Q), -(-S // tfa.FLASH_BLOCK_KV)
    tiles = sum(hi - lo for lo, hi in (
        tfa.visited_kv_range(qi, nkv, tfa.FLASH_BLOCK_Q, tfa.FLASH_BLOCK_KV, True, 0)
        for qi in range(nq)))
    assert tiles == len(tfa.attention_schedule(nq, nkv, tfa.FLASH_BLOCK_Q,
                                               tfa.FLASH_BLOCK_KV, True, 0))
    assert tiles < 0.6 * nq * nkv


# ------------------------------------------------------- wrapper contract

def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    tfa.reset_launch_counts()
    q, kp, vp, table, lengths = map(torch.from_numpy, _paged_inputs(5))
    tfa.paged_decode_attention(q, kp, vp, table, lengths, impl="pallas")
    x = torch.randn(1, 8, 4, 16)
    tfa.gqa_flash_attention(x, x[:, :, :1], x[:, :, :1])
    y = torch.randn(2, 6, 5)
    tops.ns_orthogonalize(y)
    tops.nesterov_update(y, y, y, lr=0.5, momentum=0.9)
    assert set(tfa.LAUNCHES) == {"flash_fwd", "paged_decode", "flash_dq", "flash_dkv",
                                 "matmul_epilogue", "nesterov"}
    assert all(n == 0 for n in tfa.LAUNCHES.values()), tfa.LAUNCHES
    with pytest.raises(ValueError, match="impl"):
        tfa.paged_decode_attention(q, kp, vp, table, lengths, impl="triton")


# ----------------------------------------------------------- flash backward

@pytest.mark.parametrize("S", [16, 13])
@pytest.mark.parametrize("H,KV", [(3, 3), (6, 2)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_flash_backward_matches_jax_grad(causal, window, H, KV, S):
    """dq, dk and dv of the port's FlashAttention (its plain backward on CPU)
    == jax.grad through the reference's gqa_flash_attention (Pallas forward
    and both backward sweeps in interpret mode), for G = 1 and G = 3, at an
    odd S, a sliding window and non-causal. fp32; atol 1e-5 plus rtol 1e-5
    (gradients reach ~10, and the frameworks sum in another order)."""
    rng = np.random.default_rng(1000 + S * 10 + H + window)
    B, hd = 2, 16
    q, k, v = _np(rng, (B, S, H, hd)), _np(rng, (B, S, KV, hd)), _np(rng, (B, S, KV, hd))
    do = _np(rng, (B, S, H, hd))

    def jloss(q, k, v):
        o = jfa.gqa_flash_attention(q, k, v, causal=causal, window=window, block_q=4,
                                    block_kv=4, interpret=True)
        return jnp.sum(o * jnp.asarray(do))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = tfa.gqa_flash_attention(tq, tk, tv, causal=causal, window=window)
    tgrads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    for name, t, j in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 7), (False, 0)])
def test_flash_plain_backward_matches_autograd(causal, window):
    """The plain backward (the kernels' CPU twin, recomputing p from lse) ==
    autograd through the plain forward, on the kernel layout with G = 3."""
    rng = np.random.default_rng(21 + window)
    BKV, S, G, hd = 3, 19, 3, 16
    q, k, v = _np(rng, (BKV, S, G, hd)), _np(rng, (BKV, S, hd)), _np(rng, (BKV, S, hd))
    do = torch.from_numpy(_np(rng, (BKV, S, G, hd)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    kw = dict(causal=causal, window=window, scale=0.25)
    got = torch.autograd.grad(tfa.FlashAttention.apply(tq, tk, tv, causal, window, 0.25),
                              (tq, tk, tv), do)
    o, _ = tfa._fwd_plain(tq, tk, tv, **kw)
    want = torch.autograd.grad(o, (tq, tk, tv), do)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=f"d{name}", **TOL)


# ---------------------------------------------------- matmul with epilogue

@pytest.mark.parametrize("m,k,n,alpha,beta,with_d", [
    (16, 16, 16, 1.0, 0.0, False), (37, 50, 23, 2.0, 0.5, True),
    (9, 130, 129, -1.5, 3.0, True), (20, 7, 33, 0.25, 0.0, True)])
def test_matmul_matches_reference_ops(m, k, n, alpha, beta, with_d):
    """The port's ops.matmul (plain version on CPU) == the reference's
    ops.matmul (padded Pallas kernel, interpret mode) on ragged shapes, with
    alpha, beta and d=None; and with beta = 0 the d operand is ignored."""
    rng = np.random.default_rng(m * k + n)
    a, b = _np(rng, (m, k)), _np(rng, (k, n))
    d = _np(rng, (m, n)) if with_d else None
    j = jops.matmul(jnp.asarray(a), jnp.asarray(b), None if d is None else jnp.asarray(d),
                    alpha=alpha, beta=beta, block=16)
    t = tops.matmul(torch.from_numpy(a), torch.from_numpy(b),
                    None if d is None else torch.from_numpy(d), alpha=alpha, beta=beta)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
    tr = tref.matmul_epilogue_ref(torch.from_numpy(a), torch.from_numpy(b),
                                  None if d is None else torch.from_numpy(d),
                                  alpha=alpha, beta=beta)
    np.testing.assert_allclose(tr.numpy(), t.numpy(), **TOL)


def test_matmul_epilogue_reads_transposed_and_stacked_operands():
    """A stacked call on a transposed view == the per-matrix products."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_np(rng, (3, 6, 10)))
    d = torch.from_numpy(_np(rng, (3, 6, 6)))
    c = matmul_epilogue(x, x.transpose(-1, -2), d, alpha=2.0, beta=-1.0)
    for i in range(3):
        want = 2.0 * (x[i] @ x[i].T) - d[i]
        np.testing.assert_allclose(c[i].numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("shape", [(4, 12, 20), (3, 24, 10), (2, 3, 16, 16)])
def test_ns_orthogonalize_matches_reference(shape):
    """fp32 Newton-Schulz through the matmul kernel's plain version == the
    reference's ops.ns_orthogonalize (Pallas, interpret) and both oracles,
    on stacked inputs with m < n, m > n and two batch dims. atol 2e-5: five
    iterations of three chained products grow the 1e-7 relative rounding
    differences of the two frameworks to ~1e-5 on O(1) entries."""
    rng = np.random.default_rng(sum(shape))
    g = _np(rng, shape)
    j = jops.ns_orthogonalize(jnp.asarray(g), block=8)
    t = tops.ns_orthogonalize(torch.from_numpy(g))
    tol = dict(atol=2e-5, rtol=0)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)
    np.testing.assert_allclose(t.numpy(), tref.ns_orthogonalize_ref(torch.from_numpy(g)).numpy(),
                               **tol)
    g3 = jnp.asarray(g.reshape(-1, *shape[-2:]))  # the reference's oracle takes one stack axis
    np.testing.assert_allclose(np.asarray(jref.ns_orthogonalize_ref(g3)),
                               t.numpy().reshape(g3.shape), **tol)
    assert t.shape == g.shape


# ------------------------------------------------------- outer Nesterov

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nesterov_update_matches_reference(dtype):
    """The port's ops.nesterov_update (plain version on CPU) against the
    reference's (Pallas, interpret), at the scales of an outer step (theta
    ~1, psi ~1e-2, u ~1e-1). The ulp is taken at each expression's largest
    term. u' is within 1 ulp: XLA contracts mu*u + (lr*psi) into one FMA,
    the port rounds the product on its own. theta' is within 3 ulps: that
    1-ulp u' difference times mu, plus the same contraction in each of its
    two subtractions. In bf16, theta' may also straddle one bf16 rounding
    step (2^-8 of the value)."""
    rng = np.random.default_rng(9)
    n = 3007
    theta, psi, u = (_np(rng, (n,)) * s for s in (1.0, 1e-2, 1e-1))
    jt, ju = jops.nesterov_update(jnp.asarray(theta, dtype), jnp.asarray(psi),
                                  jnp.asarray(u), lr=0.7, momentum=0.9)
    tt, tu = tops.nesterov_update(torch.from_numpy(theta).to(getattr(torch, dtype)),
                                  torch.from_numpy(psi), torch.from_numpy(u),
                                  lr=0.7, momentum=0.9)
    ju = np.asarray(ju)
    jt32 = np.asarray(jnp.asarray(jt, jnp.float32))
    theta_in = np.asarray(jnp.asarray(jnp.asarray(theta, dtype), jnp.float32))
    ulp_u = np.spacing(np.maximum.reduce([np.abs(0.9 * u), np.abs(0.7 * psi), np.abs(ju)]))
    ulp_t = np.spacing(np.maximum.reduce([np.abs(theta_in), np.abs(0.9 * ju),
                                          np.abs(0.7 * psi), np.abs(jt32)]))
    assert tu.dtype == torch.float32
    assert np.all(np.abs(tu.numpy() - ju) <= ulp_u)
    bound = 3 * ulp_t if dtype == "float32" else 3 * ulp_t + np.abs(jt32) * 2.0 ** -8
    assert np.all(np.abs(tt.float().numpy() - jt32) <= bound)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nesterov_kernel_plain_equals_unfused_transform(dtype):
    """The kernel's plain version (what the kernel matches bitwise on the
    card) == the port's own unfused optim/nesterov.py path, exactly."""
    rng = np.random.default_rng(10)
    params = {"a": torch.from_numpy(_np(rng, (5, 7))).to(dtype),
              "b": {"c": torch.from_numpy(_np(rng, (13,))).to(dtype)}}
    psi = {"a": torch.from_numpy(_np(rng, (5, 7))), "b": {"c": torch.from_numpy(_np(rng, (13,)))}}
    fused, unfused = tnesterov(0.7, 0.9, kernel=True), tnesterov(0.7, 0.9)
    state = {"u": {"a": torch.from_numpy(_np(rng, (5, 7))),
                   "b": {"c": torch.from_numpy(_np(rng, (13,)))}}}
    pf, sf = fused.apply(params, psi, state)
    pu, su = unfused.apply(params, psi, state)
    for a, b in [(pf["a"], pu["a"]), (pf["b"]["c"], pu["b"]["c"]),
                 (sf["u"]["a"], su["u"]["a"]), (sf["u"]["b"]["c"], su["u"]["b"]["c"])]:
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the reference's own unfused path returns the same dtypes and state layout
    jp, js = jnesterov(0.7, 0.9).apply(
        {"a": jnp.asarray(params["a"].float().numpy())}, {"a": jnp.asarray(psi["a"].numpy())},
        {"u": {"a": jnp.asarray(state["u"]["a"].numpy())}})
    assert set(js) == set(su) == {"u"} and np.asarray(js["u"]["a"]).dtype == np.float32
