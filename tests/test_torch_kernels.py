"""PyTorch port: the attention kernels' plain versions against the JAX package.

On CPU tensors the port's wrappers take each Hopper kernel's plain PyTorch
version, so these tests hold that arithmetic against the reference's Pallas
kernels run as the reference's own tests run them (``interpret=True``) and
against its gather path. Inputs are made with numpy from a seed and handed
to both sides. fp32 throughout, at atol = rtol = 1e-5 (the reference's own
bound for its interpret-mode kernel, tests/test_serving.py).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

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
    assert tfa.LAUNCHES == {"flash_fwd": 0, "paged_decode": 0}
    with pytest.raises(ValueError, match="impl"):
        tfa.paged_decode_attention(q, kp, vp, table, lengths, impl="triton")
