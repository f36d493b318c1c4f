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
from repro.kernels import quantize as jquantize  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import topk_pack as jtopk  # noqa: E402
from repro.optim.nesterov import nesterov as jnesterov  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import matmul as tmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import quantize as tquantize  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import topk_pack as ttopk  # noqa: E402
from repro_torch.kernels.matmul import matmul_epilogue  # noqa: E402
from repro_torch.optim.nesterov import nesterov as tnesterov  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Reduced models: one torch thread computes them faster than a pool of
    threads that spin beside the other files of a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------ flash forward

@pytest.mark.parametrize("S", [16, 13])
@pytest.mark.parametrize("H,KV", [(4, 1), (4, 4)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_flash_fwd_plain_matches_pallas(causal, window, H, KV, S):
    """o and lse of the port's plain flash forward == the reference's Pallas
    ``_fwd`` in interpret mode, on the kernel layout [B*KV, S, G, hd]."""
    _check_flash_fwd_plain(causal, window, H, KV, S, hd=16)


@pytest.mark.parametrize("S", [16, 13])
@pytest.mark.parametrize("H,KV", [(2, 2), (4, 2)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_flash_fwd_plain_matches_pallas_hd128(causal, window, H, KV, S):
    """As above at head dim 128 (every rung of the paper's ladder), G = 1
    (the ladder's MHA) and G = 2."""
    _check_flash_fwd_plain(causal, window, H, KV, S, hd=128)


@pytest.mark.parametrize("H,KV", [(2, 2), (4, 2)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_flash_fwd_plain_matches_pallas_hd80(causal, window, H, KV):
    """As above at head dim 80 (zamba2's shared block), G = 1 (its 32:32
    heads) and G = 2, odd S."""
    _check_flash_fwd_plain(causal, window, H, KV, 13, hd=80)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_flash_fwd_plain_matches_pallas_hd112(causal, window):
    """As above at head dim 112 and G = 8 (kimi-k2's 64:8 heads), odd S."""
    _check_flash_fwd_plain(causal, window, 8, 1, 13, hd=112)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_flash_fwd_plain_matches_pallas_g12(causal, window):
    """As above at G = 12 and head dim 128 (mistral-large's 96:8 heads), odd
    S: past G = 8 the fp32 sweep's block takes half the positions."""
    _check_flash_fwd_plain(causal, window, 12, 1, 13, hd=128)


def _check_flash_fwd_plain(causal, window, H, KV, S, hd):
    rng = np.random.default_rng(S * 100 + H * 10 + KV + window)
    B = 2
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


@pytest.mark.parametrize("window", [0, 5])
def test_paged_decode_plain_matches_pallas_hd128(window):
    """The paged decode at head dim 128, MHA (KV = H = 2) and G = 2 (H = 4,
    KV = 2): the port's plain version == the reference's Pallas kernel in
    interpret mode and its gather path; ragged allocations, null-padded rows
    and an idle slot."""
    rng = np.random.default_rng(41 + window)
    B, hd, ps, max_pages = 4, 128, 4, 4
    n_pool = 1 + B * max_pages
    for H, KV in ((2, 2), (4, 2)):
        q = _np(rng, (B, H, hd))
        kp, vp = _np(rng, (n_pool, ps, KV, hd)), _np(rng, (n_pool, ps, KV, hd))
        perm = rng.permutation(np.arange(1, n_pool)).astype(np.int32)
        table = np.zeros((B, max_pages), np.int32)
        for b, n in enumerate([1, 3, 4]):
            table[b, :n] = perm[b * max_pages: b * max_pages + n]
        lengths = np.asarray([2, 11, 16, 1], np.int32)
        j_in = tuple(map(jnp.asarray, (q, kp, vp, table, lengths)))
        t_in = tuple(map(torch.from_numpy, (q, kp, vp, table, lengths)))
        j_pal = jfa.paged_decode_attention(*j_in, window=window, impl="pallas", interpret=True)
        j_xla = jfa.paged_decode_attention(*j_in, window=window, impl="xla")
        t_pal = tfa.paged_decode_attention(*t_in, window=window, impl="pallas")
        np.testing.assert_allclose(t_pal.numpy(), np.asarray(j_pal), **TOL)
        np.testing.assert_allclose(t_pal.numpy(), np.asarray(j_xla), **TOL)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("H,hd", [(8, 112), (12, 128)], ids=["hd112-G8", "hd128-G12"])
def test_paged_decode_plain_matches_pallas_kimi_and_mistral_heads(H, hd, window):
    """The paged decode at kimi-k2's head dim 112 with G = 8 and at
    mistral-large's G = 12 with head dim 128 (one kv head): the port's plain
    version == the reference's Pallas kernel in interpret mode and its
    gather path, and the split-K mirror at the kernel's split (32 positions
    at both) == the plain version; ragged allocations, null-padded rows and
    an idle slot."""
    rng = np.random.default_rng(61 + H + window)
    B, KV, ps, max_pages = 4, 1, 4, 4
    n_pool = 1 + B * max_pages
    q = _np(rng, (B, H, hd))
    kp, vp = _np(rng, (n_pool, ps, KV, hd)), _np(rng, (n_pool, ps, KV, hd))
    perm = rng.permutation(np.arange(1, n_pool)).astype(np.int32)
    table = np.zeros((B, max_pages), np.int32)
    for b, n in enumerate([1, 3, 4]):
        table[b, :n] = perm[b * max_pages: b * max_pages + n]
    lengths = np.asarray([2, 11, 16, 1], np.int32)
    j_in = tuple(map(jnp.asarray, (q, kp, vp, table, lengths)))
    t_in = tuple(map(torch.from_numpy, (q, kp, vp, table, lengths)))
    j_pal = jfa.paged_decode_attention(*j_in, window=window, impl="pallas", interpret=True)
    j_xla = jfa.paged_decode_attention(*j_in, window=window, impl="xla")
    t_pal = tfa.paged_decode_attention(*t_in, window=window, impl="pallas")
    np.testing.assert_allclose(t_pal.numpy(), np.asarray(j_pal), **TOL)
    np.testing.assert_allclose(t_pal.numpy(), np.asarray(j_xla), **TOL)
    split = tfa.PAGED_SPLITS[hd]
    qg = t_in[0].reshape(B, KV, H // KV, hd)
    merged = tfa._paged_decode_split_merge(qg, *t_in[1:], window=window, split=split)
    np.testing.assert_allclose(merged.reshape(B, H, hd).numpy(), t_pal.numpy(), **TOL)


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


def _split_inputs(seed, ps, table_w, split, window):
    """Slots for the split-K mirror: the idle slot (length 1, an all-null
    row), a slot whose length ends exactly at a split boundary, one whose
    window starts inside a split, a short one and a full table."""
    rng = np.random.default_rng(seed)
    B, KV, G, hd = 5, 2, 3, 16
    n_pool = 1 + B * table_w
    q = _np(rng, (B, KV, G, hd))
    kp, vp = _np(rng, (n_pool, ps, KV, hd)), _np(rng, (n_pool, ps, KV, hd))
    lengths = np.asarray([1, 2 * split, table_w * ps - ps // 2, 7, table_w * ps], np.int32)
    perm = rng.permutation(np.arange(1, n_pool)).astype(np.int32)
    table = np.zeros((B, table_w), np.int32)
    for b in range(1, B):
        n = -(-int(lengths[b]) // ps)
        table[b, :n] = perm[b * table_w: b * table_w + n]
    return tuple(map(torch.from_numpy, (q, kp, vp, table, lengths)))


@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("ps,table_w,split", [(4, 40, 6), (4, 40, 8), (16, 37, tfa.PAGED_SPLIT)])
def test_paged_split_merge_equals_plain(ps, table_w, split, window):
    """paged_decode.cu's schedule (splits of ``split`` positions folded into
    (m, l, acc), empty splits as m = NEG_INF, l = 0, acc = 0, then merged in
    order by exp(m_s - M)), mirrored in fp32 by _paged_decode_split_merge,
    == _paged_decode_plain at 1e-5: splits that end inside a page (6
    positions on pages of 4), splits of whole pages, the kernel's own at the
    serving table width; window 0 and 100; the idle slot; a slot whose
    length ends exactly at a split boundary."""
    q, kp, vp, table, lengths = _split_inputs(7 + split + window, ps, table_w, split, window)
    got = tfa._paged_decode_split_merge(q, kp, vp, table, lengths, window=window, split=split)
    want = tfa._paged_decode_plain(q, kp, vp, table, lengths, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    n_split = tfa.paged_splits(table_w, ps, split)
    assert (n_split - 1) * split < table_w * ps <= n_split * split
    empty = [sum(p0 >= p1 for p0, p1 in (
        tfa.paged_split_range(s, int(n), window, table_w, ps, split) for s in range(n_split)))
        for n in lengths.tolist()]
    # the idle slot folds split 0 only; the full table's window leaves lo // split
    assert empty[0] == n_split - 1
    assert empty[-1] == ((table_w * ps - window) // split if window else 0)
    p0, p1 = tfa.paged_split_range(1, 2 * split, window, table_w, ps, split)
    assert p1 == 2 * split and tfa.paged_split_range(2, 2 * split, window, table_w, ps,
                                                     split)[0] >= 2 * split


def test_paged_splits_at_the_serving_shape():
    """16 slots, 3 kv heads and a table of 37 pages of 16 give 10 splits of
    64 positions: 480 blocks for the split-K pass."""
    assert tfa.paged_splits(37, 16) == 10
    assert 16 * 3 * tfa.paged_splits(37, 16) == 480


def test_paged_splits_per_head_dim():
    """At hd 128 a split folds 32 positions (the same bytes of K and V a
    block as 64 at hd 64): 19 splits a (slot, kv head) at the serving table
    of 37 pages of 16, and the split-K mirror at that split == the plain
    version at hd 128. hd 112 folds 32 too: 4096 / 112 = 36 positions would
    be neither whole pages of 16 nor whole lanes of the softmax step's
    warp."""
    assert tfa.PAGED_SPLITS == {64: 64, 112: 32, 128: 32}
    assert all(tfa.PAGED_SPLITS[hd] * hd == 4096 for hd in (64, 128))
    assert all(s % 16 == 0 and s % 32 == 0 for s in tfa.PAGED_SPLITS.values())
    assert tfa.paged_splits(37, 16, tfa.PAGED_SPLITS[128]) == 19
    assert tfa.paged_splits(37, 16, tfa.PAGED_SPLITS[112]) == 19
    q, kp, vp, table, lengths = _split_inputs(9, 16, 37, 32, 0)
    rng = np.random.default_rng(10)
    q = torch.from_numpy(_np(rng, (*q.shape[:3], 128)))
    kp, vp = (torch.from_numpy(_np(rng, (*kp.shape[:3], 128))) for _ in "kv")
    for window in (0, 100):
        got = tfa._paged_decode_split_merge(q, kp, vp, table, lengths, window=window, split=32)
        want = tfa._paged_decode_plain(q, kp, vp, table, lengths, window=window)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_paged_cuda_wrapper_refuses_unaligned_pool_rows():
    """The split-K pass reads K/V rows as 16-byte vectors: a pool whose
    position stride is not a multiple of 16 bytes raises before any launch."""
    q = torch.zeros((2, 3, 3, 64))
    table, lengths = torch.ones((2, 4), dtype=torch.int32), torch.full((2,), 9, dtype=torch.int32)
    padded = torch.zeros((8, 16, 3, 65))[..., :-1]
    tfa.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        tfa._paged_decode_cuda(q, padded, padded, table, lengths, window=0)
    assert all(n == 0 for n in tfa.LAUNCHES.values())


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
    """The fp32 flash forward (flash_fwd.cu's CUDA-core sweep) walks [lo, hi)
    of visited_kv_range at its own tiles (FLASH_BLOCK_Q positions x
    FLASH_BLOCK_KV keys); at the serving prefill's S the causal walk is about
    half the grid. The bf16 sweep walks dq_kv_tiles (tested below)."""
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
    _, codes, lo, scale = tops.quantize_rowwise(y[0], bits=2)
    tquantize.rowwise_quantize_codes(y[0], bits=2)
    tops.dequantize_rowwise(codes, lo, scale)
    assert set(tfa.LAUNCHES) == {"flash_fwd", "paged_decode", "flash_dq", "flash_dkv",
                                 "matmul_epilogue", "nesterov", "quantize", "dequantize"}
    assert all(n == 0 for n in tfa.LAUNCHES.values()), tfa.LAUNCHES
    with pytest.raises(ValueError, match="impl"):
        tfa.paged_decode_attention(q, kp, vp, table, lengths, impl="triton")


def test_kernel_library_name_hashes_its_source_and_the_shared_headers(tmp_path, monkeypatch):
    """A library is rebuilt when its source or a header under csrc/ changes
    (the bf16 flash backward includes hopper_tiles.cuh)."""
    from repro_torch.kernels import _build

    for f in _build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    paths = {n: _build.lib_path(n) for n in _build.SOURCES}
    header = tmp_path / "hopper_tiles.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = {n: _build.lib_path(n) for n in _build.SOURCES}
    assert all(edited[n] != paths[n] for n in _build.SOURCES)
    src = tmp_path / "quantize.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert [n for n in _build.SOURCES if _build.lib_path(n) != edited[n]] == ["quantize"]


@pytest.mark.parametrize("lib,name,tiles", [
    ("flash_bwd", "flash_dq", (tfa.FLASH_BWD_ROWS, tfa.FLASH_BWD_KEYS, 50176, 51200, 99328,
                               100352, 99328, 100352, 99328, 100352)),
    ("flash_bwd", "flash_dkv", (tfa.FLASH_BWD_ROWS, tfa.FLASH_BWD_KEYS, 50176, 51200, 99328,
                                100352, 99328, 100352, 99328, 100352)),
    ("flash_fwd", "flash_fwd", (tfa.FLASH_BLOCK_Q, tfa.FLASH_BLOCK_KV, tfa.FLASH_BWD_ROWS,
                                tfa.FLASH_BWD_KEYS, *tfa.FP32_TILES[128], *tfa.FP32_TILES[80],
                                *tfa.FP32_TILES[112], 41984, 82944, 82944, 82944)),
    ("paged_decode", "paged_decode", (tfa.PAGED_SPLIT, 128, tfa.PAGED_SPLITS[128],
                                      tfa.PAGED_SPLITS[112])),
    ("matmul_epilogue", "matmul_epilogue", (tmm.MATMUL_TILE, tmm.MATMUL_TILE, tmm.MATMUL_BK,
                                            256)),
    ("quantize", "quantize", (tquantize.WARP_ROW_MAX, tquantize.BLOCK_ROW_MAX,
                              tquantize.LONG_BLOCKS, tquantize.LONG_MIN_GROUPS))])
def test_first_launch_checks_the_library_tiles(monkeypatch, lib, name, tiles):
    """At a library's first launch ``_build.launch`` reads ``<lib>_tiles``
    from the built library and raises, launching nothing, if its tile sizes
    differ from the constants its module registered in ``_build.TILES`` (the
    Python mirrors of the schedules assume them); then it launches and
    counts, reading the tiles once."""
    import contextlib
    import types

    from repro_torch.kernels import _build

    class Lib:
        def __init__(self, values):
            def tiles(*refs):
                for r, v in zip(refs, values):
                    r._obj.value = v
            setattr(self, f"{lib}_tiles", tiles)

    launched = []
    monkeypatch.setattr(_build, "entry", lambda n, argtypes: (
        lambda *args: launched.append(n) or 0, None))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setitem(_build.LAUNCHES, name, 0)
    monkeypatch.setattr(_build, "_TILES_CHECKED", set())
    monkeypatch.setattr(_build, "load", lambda n: Lib((tiles[0] // 2, *tiles[1:])))
    with pytest.raises(RuntimeError, match=f"{lib}.cu tiles"):
        _build.launch(name, [], "cpu")
    assert launched == [] and _build.LAUNCHES[name] == 0
    monkeypatch.setattr(_build, "load", lambda n: Lib(tiles))
    _build.launch(name, [], "cpu")
    _build.launch(name, [], "cpu")
    assert launched == [name, name] and _build._TILES_CHECKED == {lib}
    assert _build.LAUNCHES[name] == 2
    assert _build.kernel_tiles(lib) == tiles


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
    _check_flash_backward(causal, window, H, KV, S, hd=16)


@pytest.mark.parametrize("H,KV", [(2, 2), (4, 2)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_flash_backward_matches_jax_grad_hd128(causal, window, H, KV):
    """As above at head dim 128 (the paper's ladder), G = 1 and 2, odd S."""
    _check_flash_backward(causal, window, H, KV, 13, hd=128)


@pytest.mark.parametrize("H,KV", [(2, 2), (4, 2)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5)])
def test_flash_backward_matches_jax_grad_hd80(causal, window, H, KV):
    """As above at head dim 80 (zamba2's shared block, causal, windowed as
    zamba2 is), G = 1 and 2, odd S."""
    _check_flash_backward(causal, window, H, KV, 13, hd=80)


@pytest.mark.parametrize("H,KV,hd", [(8, 1, 112), (12, 1, 128)], ids=["hd112-G8", "hd128-G12"])
def test_flash_backward_matches_jax_grad_kimi_and_mistral_heads(H, KV, hd):
    """As above at kimi-k2's head dim 112 with G = 8 and at mistral-large's G
    = 12 with head dim 128, causal as both models are, odd S."""
    _check_flash_backward(True, 0, H, KV, 13, hd=hd)


def _check_flash_backward(causal, window, H, KV, S, hd):
    rng = np.random.default_rng(1000 + S * 10 + H + window)
    B = 2
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


@pytest.mark.parametrize("G", [1, 2, 3, 4, 12])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0), (False, 5)])
def test_bf16_bwd_sweeps_visit_each_unmasked_pair_once(causal, window, G):
    """The visit ranges of the bf16 tensor-core sweeps over packed rows (row
    r = position * G + head), mirrored by dq_kv_tiles and dkv_row_tiles, held
    exhaustively against _mask: each sweep covers every unmasked (row, key)
    pair exactly once and visits no tile without an unmasked pair. The
    forward's sweep (flash_fwd.cu) walks the same kv tiles per q-row tile as
    flash_bwd.cu's dq sweep (dq_kv_tiles), so the first walk checks both.
    G = 1 to 4 and 12 (mistral-large: a 64-row tile holds 5 1/3 positions),
    ragged S; small tiles (many tiles, ragged edges) and the kernels' own."""
    for rows, keys, sizes in ((4, 4, range(1, 30)), (8, 4, range(1, 30)),
                              (tfa.FLASH_BWD_ROWS, tfa.FLASH_BWD_KEYS, (1, 21, 77, 130, 200))):
        for S in sizes:
            pairs = np.repeat(tfa._mask(S, causal, window, "cpu")[0, :, 0, :].numpy(), G, axis=0)
            for name, n_blocks, walk in (
                    ("fwd and dq", -(-S * G // rows),
                     lambda t: [(t, kj) for kj in range(*tfa.dq_kv_tiles(
                         t, S, G, causal, window, rows, keys))]),
                    ("dkv", -(-S // keys),
                     lambda kt: [(t, kt) for t in range(*tfa.dkv_row_tiles(
                         kt, S, G, causal, window, rows, keys))])):
                count = np.zeros(pairs.shape, np.int64)
                for blk in range(n_blocks):
                    for t, kj in walk(blk):
                        tile = (slice(t * rows, (t + 1) * rows), slice(kj * keys, (kj + 1) * keys))
                        assert pairs[tile].any(), (name, S, rows, keys, t, kj)
                        count[tile] += 1
                assert (count[pairs] == 1).all() and count.max() <= 1, (name, S, rows, keys)


def _dkv_panel_sweep(q, k, v, do, lse, dl, *, causal: bool, window: int, scale: float,
                     rows: int = tfa.FLASH_BWD_ROWS, keys: int = tfa.FLASH_BWD_KEYS,
                     panel: int = 64):
    """flash_bwd.cu's bf16 dkv sweep at hd 128 in fp32 torch: per kv tile of
    ``keys`` positions, one warpgroup per ``panel`` columns of dk and dv, each
    walking the q-row tiles of dkv_row_tiles and recomputing the whole S^T =
    K Q^T and dP^T = V dO^T (contractions over every dim), then multiplying
    P^T and dS^T into its own panel of dO and Q."""
    BKV, S, G, hd = q.shape
    SG = S * G
    qr, dor = q.float().reshape(BKV, SG, hd), do.float().reshape(BKV, SG, hd)
    lr, dlr = lse.reshape(BKV, SG), dl.reshape(BKV, SG)
    mask = tfa._mask(S, causal, window, "cpu")[0, :, 0, :]
    pos = torch.arange(SG) // G
    dk, dv = torch.zeros(BKV, S, hd), torch.zeros(BKV, S, hd)
    for kt in range(-(-S // keys)):
        kc = slice(kt * keys, min(S, (kt + 1) * keys))
        for c0 in range(0, hd, panel):
            cols = slice(c0, c0 + panel)
            for t in range(*tfa.dkv_row_tiles(kt, S, G, causal, window, rows, keys)):
                r = slice(t * rows, min(SG, (t + 1) * rows))
                ok = mask[pos[r]][:, kc].T  # [keys, rows]
                st = k[:, kc].float() @ qr[:, r].transpose(1, 2)
                dpt = v[:, kc].float() @ dor[:, r].transpose(1, 2)
                pt = torch.where(ok, torch.exp(st * scale - lr[:, None, r]), 0.0)
                dst = pt * (dpt - dlr[:, None, r])
                dv[:, kc, cols] += pt @ dor[:, r, cols]
                dk[:, kc, cols] += scale * (dst @ qr[:, r, cols])
    return dk, dv


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0), (False, 5)])
def test_bwd_sweeps_at_hd128_equal_plain(causal, window, G):
    """At head dim 128 the bf16 dkv sweep splits dk and dv by 64-column
    panels, each panel's warpgroup recomputing the full scores; the dq sweep
    keeps one warpgroup (two accumulator panels) and walks dq_kv_tiles. Both
    schedules, mirrored in fp32, == _dq_plain / _dkv_plain at 1e-5, and
    every unmasked (row, key) pair is visited once per panel: at small tiles
    (ragged edges, many tiles) and at the kernels' own, ragged S."""
    rng = np.random.default_rng(51 + 10 * G + window)
    for rows, keys, S in ((8, 4, 13), (tfa.FLASH_BWD_ROWS, tfa.FLASH_BWD_KEYS, 77)):
        BKV, hd = 2, 128
        q, do = (torch.from_numpy(_np(rng, (BKV, S, G, hd))) for _ in "qd")
        k, v = (torch.from_numpy(_np(rng, (BKV, S, hd))) for _ in "kv")
        kw = dict(causal=causal, window=window, scale=1.0 / math.sqrt(hd))
        o, lse = tfa._fwd_plain(q, k, v, **kw)
        dl = torch.sum(do * o, dim=-1)
        args = (q, k, v, do, lse, dl)
        dk, dv = _dkv_panel_sweep(*args, rows=rows, keys=keys, **kw)
        pk, pv = tfa._dkv_plain(*args, **kw)
        np.testing.assert_allclose(dk.numpy(), pk.numpy(), err_msg=f"dk {rows}x{keys}", **TOL)
        np.testing.assert_allclose(dv.numpy(), pv.numpy(), err_msg=f"dv {rows}x{keys}", **TOL)
        # dq: per packed q-row tile, the kv tiles of dq_kv_tiles
        SG = S * G
        mask = tfa._mask(S, causal, window, "cpu")[0, :, 0, :]
        pos = torch.arange(SG) // G
        qr, dor = q.reshape(BKV, SG, hd), do.reshape(BKV, SG, hd)
        dq = torch.zeros(BKV, SG, hd)
        for t in range(-(-SG // rows)):
            r = slice(t * rows, min(SG, (t + 1) * rows))
            for kj in range(*tfa.dq_kv_tiles(t, S, G, causal, window, rows, keys)):
                kc = slice(kj * keys, min(S, (kj + 1) * keys))
                ok = mask[pos[r]][:, kc]
                p = torch.where(ok, torch.exp(qr[:, r] @ k[:, kc].transpose(1, 2) * kw["scale"]
                                              - lse.reshape(BKV, SG)[:, r, None]), 0.0)
                ds = p * (dor[:, r] @ v[:, kc].transpose(1, 2) - dl.reshape(BKV, SG)[:, r, None])
                dq[:, r] += kw["scale"] * (ds @ k[:, kc])
        np.testing.assert_allclose(dq.reshape(q.shape).numpy(),
                                   tfa._dq_plain(*args, **kw).numpy(), **TOL)


def test_fp32_sweep_tiles_at_hd128_visit_contiguous_ranges():
    """The fp32 CUDA-core sweeps shrink their tiles at hd 128 so that a
    thread keeps the registers and a block the 32 KB of static shared memory
    of hd 64: the forward's (FP32_TILES[128]) walk [lo, hi) of
    visited_kv_range at the ladder's S = 2048, about half the grid when
    causal, and hd x tile sizes stay those of hd 64."""
    bq, bkv = tfa.FP32_TILES[128]
    assert (bq, bkv) == (16, 32) and tfa.FP32_TILES[64] == (tfa.FLASH_BLOCK_Q, tfa.FLASH_BLOCK_KV)
    assert 2 * bq * 128 == tfa.FLASH_BLOCK_Q * 64 * 2 and bkv * 128 == tfa.FLASH_BLOCK_KV * 64
    S = 2048
    nq, nkv = -(-S // bq), -(-S // bkv)
    tiles = sum(hi - lo for lo, hi in (
        tfa.visited_kv_range(qi, nkv, bq, bkv, True, 0) for qi in range(nq)))
    assert tiles == len(tfa.attention_schedule(nq, nkv, bq, bkv, True, 0))
    assert tiles < 0.6 * nq * nkv


def test_bf16_operand_rounding_stays_within_phase_5a_tolerance():
    """The bf16 sweeps' arithmetic (bf16 q, k, v, do; fp32 products and sums;
    p and ds rounded to bf16 as operands of the dq, dk and dv products; bf16
    outputs) against _dq_plain / _dkv_plain (p and ds in fp32) at the
    training shape's S = 1024, G = 3, hd = 64, causal, with inputs drawn as
    chip_smoke.py phase 5a draws them: within that phase's bf16 tolerance,
    1e-2 * max(1, max |grad|). Measured headroom on this seed: the largest
    error is 0.46 (dq), 0.38 (dk) and 0.27 (dv) of the tolerance; the
    rounding of p and ds alone moves each gradient by 0.14-0.21% of its
    largest entry, the rest is the final bf16 store."""
    rng = np.random.default_rng(14)
    BKV, S, G, hd = 2, 1024, 3, 64
    q, do = (torch.from_numpy(_np(rng, (BKV, S, G, hd))).bfloat16() for _ in "qd")
    k, v = (torch.from_numpy(_np(rng, (BKV, S, hd))).bfloat16() for _ in "kv")
    kw = dict(causal=True, window=0, scale=1.0 / math.sqrt(hd))
    o, lse = tfa._fwd_plain(q, k, v, **kw)
    dl = torch.sum(do.float() * o.float(), dim=-1)
    args = (q, k, v, do, lse, dl)
    p, ds = (x.bfloat16().float() for x in tfa._probs_plain(*args, **kw))
    got = ((kw["scale"] * torch.einsum("bqgs,bsh->bqgh", ds, k.float())).bfloat16(),
           (kw["scale"] * torch.einsum("bqgs,bqgh->bsh", ds, q.float())).bfloat16(),
           torch.einsum("bqgs,bqgh->bsh", p, do.float()).bfloat16())
    plain = (tfa._dq_plain(*args, **kw), *tfa._dkv_plain(*args, **kw))
    for name, g, w in zip(("dq", "dk", "dv"), got, plain):
        tol = 1e-2 * max(1.0, w.float().abs().max().item())
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol, (name, err, tol)


def _fwd_sweep(q, k, v, *, causal: bool, window: int, scale: float, p_dtype=None,
               rows: int = tfa.FLASH_BWD_ROWS, keys: int = tfa.FLASH_BWD_KEYS):
    """flash_fwd.cu's bf16 sweep in torch: per tile of ``rows`` packed q rows,
    the kv tiles of dq_kv_tiles, each an online-softmax step in base 2 on fp32
    scores (masked after scaling, p = 0 where masked); p rounded to
    ``p_dtype`` (the kernel: bf16) as the operand of the PV product; o stored
    in q's dtype. Returns (o, lse) as _fwd_plain does."""
    BKV, S, G, hd = q.shape
    SG = S * G
    qr, kf, vf = q.float().reshape(BKV, SG, hd), k.float(), v.float()
    mask = tfa._mask(S, causal, window, "cpu")[0, :, 0, :]
    pos = torch.arange(SG) // G
    o, lse = torch.empty(BKV, SG, hd), torch.empty(BKV, SG)
    scale_log2 = scale * math.log2(math.e)
    for t in range(-(-SG // rows)):
        r = slice(t * rows, min(SG, (t + 1) * rows))
        m = torch.full((BKV, r.stop - r.start, 1), tfa.NEG_INF)
        l, acc = torch.zeros_like(m), torch.zeros(BKV, r.stop - r.start, hd)
        for kj in range(*tfa.dq_kv_tiles(t, S, G, causal, window, rows, keys)):
            kc = slice(kj * keys, min(S, (kj + 1) * keys))
            ok = mask[pos[r]][:, kc]
            s2 = torch.where(ok, (qr[:, r] @ kf[:, kc].transpose(1, 2)) * scale_log2, tfa.NEG_INF)
            m_new = torch.maximum(m, s2.amax(-1, keepdim=True))
            corr = torch.exp2(m - m_new)
            p = torch.where(ok, torch.exp2(s2 - m_new), 0.0)
            l = l * corr + p.sum(-1, keepdim=True)
            pv = p if p_dtype is None else p.to(p_dtype).float()
            acc = acc * corr + pv @ vf[:, kc]
            m = m_new
        lsum = l.clamp_min(1e-30)
        o[:, r] = acc / lsum
        lse[:, r] = (m * math.log(2) + torch.log(lsum))[..., 0]
    return o.reshape(q.shape).to(q.dtype), lse.reshape(BKV, S, G)


@pytest.mark.parametrize("G", [1, 2, 3, 4])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0), (False, 5)])
def test_fwd_sweep_online_softmax_equals_plain(causal, window, G):
    """The bf16 forward sweep's algorithm (packed q-row tiles walking
    dq_kv_tiles, an online softmax in base 2 per kv tile, explicit masking,
    tiles masked for a whole row leaving the running state as it is), with p
    kept in fp32, == _fwd_plain in fp32 at 1e-5: at small tiles (many tiles,
    ragged edges, rows whose first visited tiles are masked) and at the
    kernel's own, ragged S."""
    rng = np.random.default_rng(31 + 10 * G + window)
    for rows, keys, S in ((8, 4, 13), (4, 8, 21), (tfa.FLASH_BWD_ROWS, tfa.FLASH_BWD_KEYS, 77)):
        q, k, v = (torch.from_numpy(_np(rng, shape)) for shape in
                   ((2, S, G, 16), (2, S, 16), (2, S, 16)))
        kw = dict(causal=causal, window=window, scale=0.25)
        o, lse = _fwd_sweep(q, k, v, rows=rows, keys=keys, **kw)
        po, plse = tfa._fwd_plain(q, k, v, **kw)
        np.testing.assert_allclose(o.numpy(), po.numpy(), err_msg=f"o {rows}x{keys}", **TOL)
        np.testing.assert_allclose(lse.numpy(), plse.numpy(), err_msg=f"lse {rows}x{keys}", **TOL)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0), (False, 5)])
def test_fwd_sweep_online_softmax_equals_plain_hd128(causal, window, G):
    """The forward sweep's algorithm at head dim 128 (the ladder's; the
    kernel holds O as two 64-column panels, which changes no sum) == the
    plain forward at 1e-5, at small tiles and at the kernel's own."""
    rng = np.random.default_rng(61 + 10 * G + window)
    for rows, keys, S in ((8, 4, 13), (tfa.FLASH_BWD_ROWS, tfa.FLASH_BWD_KEYS, 77)):
        q, k, v = (torch.from_numpy(_np(rng, shape)) for shape in
                   ((2, S, G, 128), (2, S, 128), (2, S, 128)))
        kw = dict(causal=causal, window=window, scale=1.0 / math.sqrt(128))
        o, lse = _fwd_sweep(q, k, v, rows=rows, keys=keys, **kw)
        po, plse = tfa._fwd_plain(q, k, v, **kw)
        np.testing.assert_allclose(o.numpy(), po.numpy(), err_msg=f"o {rows}x{keys}", **TOL)
        np.testing.assert_allclose(lse.numpy(), plse.numpy(), err_msg=f"lse {rows}x{keys}", **TOL)


def test_bf16_rounding_at_the_ladder_training_shape_stays_within_tolerance():
    """The bf16 sweeps' arithmetic at paper-416m's training shape (S = 2048,
    G = 1, hd = 128, causal; two kv heads of the 32), inputs drawn as
    chip_smoke.py phase 12a draws them: the forward (p rounded to bf16 as the
    PV operand, o stored in bf16) within phase 3a's tolerances (o 2e-2, lse
    1e-3), the backward (p and ds rounded to bf16 as operands, bf16 outputs)
    within phase 5a's, 1e-2 * max(1, max |grad|)."""
    rng = np.random.default_rng(16)
    BKV, S, G, hd = 2, 2048, 1, 128
    q, do = (torch.from_numpy(_np(rng, (BKV, S, G, hd))).bfloat16() for _ in "qd")
    k, v = (torch.from_numpy(_np(rng, (BKV, S, hd))).bfloat16() for _ in "kv")
    kw = dict(causal=True, window=0, scale=1.0 / math.sqrt(hd))
    o, lse = _fwd_sweep(q, k, v, p_dtype=torch.bfloat16, **kw)
    po, plse = tfa._fwd_plain(q, k, v, **kw)
    assert (o.float() - po.float()).abs().max().item() <= 2e-2
    assert (lse - plse).abs().max().item() <= 1e-3
    dl = torch.sum(do.float() * po.float(), dim=-1)
    args = (q, k, v, do, plse, dl)
    p, ds = (x.bfloat16().float() for x in tfa._probs_plain(*args, **kw))
    got = ((kw["scale"] * torch.einsum("bqgs,bsh->bqgh", ds, k.float())).bfloat16(),
           (kw["scale"] * torch.einsum("bqgs,bqgh->bsh", ds, q.float())).bfloat16(),
           torch.einsum("bqgs,bqgh->bsh", p, do.float()).bfloat16())
    plain = (tfa._dq_plain(*args, **kw), *tfa._dkv_plain(*args, **kw))
    for name, g, w in zip(("dq", "dk", "dv"), got, plain):
        tol = 1e-2 * max(1.0, w.float().abs().max().item())
        assert (g.float() - w.float()).abs().max().item() <= tol, name


@pytest.mark.parametrize("S", [512, 1024])
def test_bf16_fwd_rounding_stays_within_phase_3a_tolerance(S):
    """The bf16 forward sweep's arithmetic (bf16 q, k, v; fp32 scores, online
    softmax and accumulator; p rounded to bf16 as the PV product's operand;
    o stored in bf16) against _fwd_plain (p in fp32) at the serving (S =
    512) and training (S = 1024) prefill lengths, G = 3, hd = 64, causal,
    with inputs drawn as chip_smoke.py phase 3a draws them (standard normal,
    cast to bf16): within that phase's bf16 tolerances, o 2e-2 and lse 1e-3.
    Measured headroom on this seed: the largest o error is 0.0156 at S =
    512 (0.78 of the tolerance: a one-ulp flip of a bf16 output in [2, 4))
    and 0.0078 at S = 1024 (0.39: one ulp in [1, 2)); with p kept in fp32 it
    is 0.00098. lse is within 9.6e-7 (p's rounding does not reach lse,
    whose sum stays fp32). An output of 4 or more would need one ulp of
    0.031, above the tolerance; none of the rows past position 0 (which is
    v exactly) comes near it at these draws."""
    rng = np.random.default_rng(15)
    BKV, G, hd = 4, 3, 64
    q = torch.from_numpy(_np(rng, (BKV, S, G, hd))).bfloat16()
    k, v = (torch.from_numpy(_np(rng, (BKV, S, hd))).bfloat16() for _ in "kv")
    kw = dict(causal=True, window=0, scale=1.0 / math.sqrt(hd))
    o, lse = _fwd_sweep(q, k, v, p_dtype=torch.bfloat16, **kw)
    po, plse = tfa._fwd_plain(q, k, v, **kw)
    assert o.dtype == torch.bfloat16
    assert (o.float() - po.float()).abs().max().item() <= 2e-2
    assert (lse - plse).abs().max().item() <= 1e-3


@pytest.mark.parametrize("hd", [80, 112, 256])
def test_kernels_refuse_unbuilt_head_dims_and_name_roadmap(hd):
    """The flash libraries are built for head dims 64, 80, 112 and 128 and
    paged_decode for 64, 112 and 128: any other hd raises
    NotImplementedError naming ROADMAP.md before any launch. At hd 80
    (zamba2, served through the dense-cache engine) only paged_decode
    refuses; at hd 112 (kimi-k2) none does. The head check takes hd 80 and
    112 at every G the kernels take (up to 16: mistral-large's G = 12), and
    refuses G = 17."""
    tfa.reset_launch_counts()
    q = torch.zeros((1, 8, 1, hd), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, hd), dtype=torch.bfloat16)
    lse = torch.zeros((1, 8, 1))
    kw = dict(causal=True, window=0, scale=0.125)
    pool = torch.zeros((4, 4, 1, hd), dtype=torch.bfloat16)
    table, lengths = torch.ones((1, 2), dtype=torch.int32), torch.ones((1,), dtype=torch.int32)
    flash = [lambda: tfa._fwd_cuda(q, k, k, **kw),
             lambda: tfa._dq_cuda(q, k, k, q, lse, lse, **kw),
             lambda: tfa._dkv_cuda(q, k, k, q, lse, lse, **kw)]
    paged = [lambda: tfa._paged_decode_cuda(q[:, 0:1, 0:1].reshape(1, 1, 1, hd), pool, pool,
                                            table, lengths, window=0)]
    for call in ([] if hd in tfa.PAGED_SPLITS else paged) + (
            [] if hd in tfa.KERNEL_HEAD_DIM else flash):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            call()
    if hd in (80, 112):
        names = ("flash_fwd", "flash_bwd") + (("paged_decode",) if hd == 112 else ())
        assert tfa.MAX_GROUP == 16
        for name in names:
            for dtype in (torch.float32, torch.bfloat16):
                for G in range(1, tfa.MAX_GROUP + 1):
                    tfa._check_head(name, dtype, hd, G)
            with pytest.raises(NotImplementedError, match="query heads per kv head"):
                tfa._check_head(name, torch.bfloat16, hd, 17)
    assert tfa.KERNEL_HEAD_DIM == (64, 80, 112, 128)
    assert tuple(tfa.PAGED_SPLITS) == (64, 112, 128)
    assert all(n == 0 for n in tfa.LAUNCHES.values())


@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd"])
def test_bf16_kernels_refuse_misaligned_inputs(name):
    """The bf16 sweeps stage rows with 16-byte copies: a wrapper given a bf16
    tensor that does not start on a 16-byte boundary raises before any
    launch (checked on a CPU tensor: the check precedes the launch)."""
    tfa.reset_launch_counts()
    BKV, S, G, hd = 1, 8, 3, 64
    q = torch.zeros(BKV * S * G * hd + 1, dtype=torch.bfloat16)[1:].view(BKV, S, G, hd)
    k = torch.zeros((BKV, S, hd), dtype=torch.bfloat16)
    kw = dict(causal=True, window=0, scale=0.125)
    with pytest.raises(ValueError, match="16-byte boundary"):
        if name == "flash_fwd":
            tfa._fwd_cuda(q, k, k, **kw)
        else:
            lse = torch.zeros((BKV, S, G))
            tfa._dq_cuda(q, k, k, q, lse, lse, **kw)
    assert all(n == 0 for n in tfa.LAUNCHES.values())


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


@pytest.mark.parametrize("m,tile", [(192, 96), (192, 64), (576, 96), (576, 64), (77, 96),
                                     (200, 96), (130, 64), (1, 96), (1000, 96)])
def test_sym_tile_map_covers_every_entry_once(m, tile):
    """The symmetric call's grid (matmul_epilogue.cu, mirrored by sym_tile):
    nt(nt + 1)/2 blocks visit every tile (i, j), i <= j, of the upper
    triangle once, and with each off-diagonal tile's transpose written too
    every entry of the m x m output is written exactly once. The main path's
    symmetric calls have 2, 3, 6 and 9 tiles a side (m = 192 or 576 at tiles
    of 96 or 64); the rest are ragged."""
    nt = -(-m // tile)
    tiles = [tmm.sym_tile(t, nt) for t in range(nt * (nt + 1) // 2)]
    assert tiles == [(i, j) for i in range(nt) for j in range(i, nt)]
    count = np.zeros((m, m), np.int64)
    for i, j in tiles:
        rows, cols = slice(i * tile, (i + 1) * tile), slice(j * tile, (j + 1) * tile)
        count[rows, cols] += 1
        if i != j:
            count[cols, rows] += 1
    assert (count == 1).all()


def test_ns_iteration_passes_symmetric_on_its_first_two_products(monkeypatch):
    """_ns_iteration asks for the triangle on X Xᵀ and on c·A·A + b·A, and
    for the full product on B X + a·X: per iteration, on m <= n and on a
    transposed (m > n) stack."""
    calls = []

    def record(a, b, d=None, **kw):
        calls.append(kw.get("symmetric", False))
        return matmul_epilogue(a, b, d, **kw)

    monkeypatch.setattr(tops, "matmul_epilogue", record)
    rng = np.random.default_rng(8)
    for shape in ((2, 6, 10), (2, 10, 6)):
        calls.clear()
        tops.ns_orthogonalize(torch.from_numpy(_np(rng, shape)), iters=3)
        assert calls == [True, True, False] * 3, (shape, calls)


def test_matmul_symmetric_refuses_a_non_square_product():
    """symmetric=True on a non-square product raises ValueError on any
    device; on a square one the plain version ignores it."""
    rng = np.random.default_rng(9)
    a, b = torch.from_numpy(_np(rng, (3, 4, 5))), torch.from_numpy(_np(rng, (3, 5, 6)))
    with pytest.raises(ValueError, match="symmetric"):
        matmul_epilogue(a, b, symmetric=True)
    with pytest.raises(ValueError, match="symmetric"):
        tops.matmul(a[0], b[0], symmetric=True)
    x = torch.from_numpy(_np(rng, (3, 4, 7)))
    d = x @ x.transpose(-1, -2)
    full = matmul_epilogue(x, x.transpose(-1, -2), d, alpha=2.0, beta=-1.0)
    tri = matmul_epilogue(x, x.transpose(-1, -2), d, alpha=2.0, beta=-1.0, symmetric=True)
    assert torch.equal(full, tri)


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


# ------------------------------------------------- row-wise quantize / dequantize

def _quant_rows(layout, seed):
    """Rows whose magnitudes span 1e-4 to 10; the ragged layout (13 rows, not
    a multiple of the reference's 8-row blocks) holds a constant row."""
    rng = np.random.default_rng(seed)
    rows, cols = {"ragged": (13, 97), "long_row": (1, 100_003)}[layout]
    mag = np.exp(rng.uniform(np.log(1e-4), np.log(10.0), (rows, 1)))
    x = (rng.standard_normal((rows, cols)) * mag).astype(np.float32)
    if rows > 3:
        x[3] = np.float32(0.375)
    return x


@pytest.mark.parametrize("layout", ["ragged", "long_row"])
@pytest.mark.parametrize("bits", range(1, 9))
def test_quantize_plain_bitwise_matches_pallas(bits, layout):
    """The plain quantize and dequantize (the kernels' CPU path) == the
    reference's ops.quantize_rowwise / dequantize_rowwise (Pallas, interpret
    mode, jitted), bitwise on codes, lo, scale, deq and the dequantized
    values: the port reproduces XLA's reciprocal scale and fused
    multiply-add on purpose. The torch oracle == the reference's jitted
    oracle, bitwise. A constant row gets scale 1 and codes 0."""
    x = _quant_rows(layout, 100 + bits)
    j = [np.asarray(a) for a in jops.quantize_rowwise(jnp.asarray(x), bits=bits)]
    t = [a.numpy() for a in tops.quantize_rowwise(torch.from_numpy(x), bits=bits)]
    for name, a, b in zip(("deq", "codes", "lo", "scale"), t, j):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    jv = np.asarray(jops.dequantize_rowwise(*map(jnp.asarray, j[1:])))
    tv = tops.dequantize_rowwise(*map(torch.from_numpy, t[1:])).numpy()
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tv, t[0])
    jr = jax.jit(lambda v: jref.rowwise_quantize_ref(v, bits))(jnp.asarray(x))
    tr = tref.rowwise_quantize_ref(torch.from_numpy(x), bits)
    for a, b in zip(tr, jr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        tref.rowwise_dequantize_ref(*map(torch.from_numpy, t[1:])).numpy(), tv)
    if layout == "ragged":
        assert t[3][3, 0] == 1.0 and not t[1][3].any() and (t[0][3] == x[3]).all()
    assert t[1].max() <= (1 << bits) - 1


@pytest.mark.parametrize("layout", ["ragged", "long_row"])
@pytest.mark.parametrize("bits", range(1, 9))
def test_quantize_codes_plain_bitwise_matches_pallas(bits, layout):
    """rowwise_quantize_codes (the wire path's codes-only quantize; on the
    CPU its plain version) == the codes, lo and scale of the reference's
    ops.quantize_rowwise (Pallas, interpret mode, jitted), bitwise, and
    returns no dequantized values."""
    x = _quant_rows(layout, 200 + bits)
    j = [np.asarray(a) for a in jops.quantize_rowwise(jnp.asarray(x), bits=bits)[1:]]
    t = [a.numpy() for a in tquantize.rowwise_quantize_codes(torch.from_numpy(x), bits)]
    assert len(t) == 3
    for name, a, b in zip(("codes", "lo", "scale"), t, j):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_quantize_plan_constants_match_the_kernel_source():
    """kernels/quantize.py's plan constants are the ones csrc/quantize.cu
    compiles in (its file-scope constexpr ints, evaluated), and the plan
    cuts at them: a warp holds rows up to WARP_ROW_MAX entries, a block up to
    BLOCK_ROW_MAX, longer rows are read twice by about LONG_BLOCKS blocks,
    each at least one step of LONG_MIN_GROUPS float4 groups."""
    import re

    from repro_torch.kernels import _build

    src = (_build.CSRC / "quantize.cu").read_text()
    consts: dict = {k: int(v) for k, v in  # the defaults of the build variants' defines
                    re.findall(r"#ifndef (\w+)\n#define \1 (\d+)\n#endif", src)}
    for name, expr in re.findall(r"^constexpr (?:int|long long) (\w+) = ([^;]+);", src, re.M):
        consts[name] = eval(expr, {}, dict(consts))
    assert (consts["kWarpRowMax"], consts["kBlockRowMax"], consts["kLongBlocks"],
            consts["kLongMinGroups"]) == (tquantize.WARP_ROW_MAX, tquantize.BLOCK_ROW_MAX,
                                          tquantize.LONG_BLOCKS, tquantize.LONG_MIN_GROUPS)
    assert consts["kThreads"] * consts["kMaxGroups"] * 4 == tquantize.BLOCK_ROW_MAX
    plan = tquantize.quantize_plan
    assert [plan(1, c)[0] for c in (1, 2048, 2049, 16384, 16385)] == [
        "warp", "warp", "block", "block", "long"]
    assert plan(34_560, 1536) == ("warp", 1) and plan(1, 16385) == ("long", 4)
    assert plan(2, 28_311_552) == ("long", 264) and plan(1, 28_311_552) == ("long", 528)
    assert plan(1000, 100_000) == ("long", 1)
    with pytest.raises(ValueError):
        plan(0, 5)


def _round_to_f32(exact):
    """The fp32 nearest to a Fraction, ties to even."""
    from fractions import Fraction

    f = np.float32(float(exact))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))):
        d = abs(Fraction(float(c)) - exact)
        even = int(np.array(c).view(np.int32)) % 2 == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, c)
    return best[1]


def test_fma_f32_rounds_once():
    """fma_f32 == the exactly rounded fp32 a * b + c (Python fractions), on
    random triples and on triples built so that rounding the fp64 sum to fp32
    would round twice: c has an odd last bit, and a * b is half an ulp of c
    less 2^-46 of that, so the exact sum lies just short of the midpoint
    between c and its even neighbour, while its fp64 rounding is that
    midpoint and ties to the neighbour."""
    from fractions import Fraction

    rng = np.random.default_rng(17)
    a = rng.standard_normal(400).astype(np.float32)
    b = (rng.standard_normal(400) * 10.0 ** rng.integers(-6, 6, 400)).astype(np.float32)
    c = rng.standard_normal(400).astype(np.float32)
    odd = (rng.integers(1 << 22, 1 << 23, 200) * 2 + 1).astype(np.float64)  # 24-bit odd
    exp = rng.integers(-60, 60, 200).astype(np.float64)
    sign = rng.choice([-1.0, 1.0], 200)
    c[:200] = sign * odd * 2.0 ** exp
    a[:200] = sign * 2.0 ** (exp - 1) * (1 + 2.0 ** -23)  # half an ulp of c, times 1 + 2^-23
    b[:200] = 1 - 2.0 ** -23
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    got = tquantize.fma_f32(*map(torch.from_numpy, (a, b, c))).numpy()
    want = np.array([_round_to_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    assert (naive[:200] != want[:200]).all()  # the cases do catch a double rounding


@pytest.mark.parametrize("bits", range(1, 9))
def test_pack_codes_bitwise_matches_reference(bits):
    """pack_codes / unpack_codes == the reference's bytes for every width and
    odd code counts; the round trip is lossless."""
    rng = np.random.default_rng(bits)
    for n in (7, 129, 1000):
        codes = rng.integers(0, 1 << bits, (3, n)).astype(np.uint8)
        jp = np.asarray(jquantize.pack_codes(jnp.asarray(codes), bits))
        tp = tquantize.pack_codes(torch.from_numpy(codes), bits)
        np.testing.assert_array_equal(tp.numpy(), jp)
        assert tp.shape[-1] == tquantize.packed_width(n, bits) == jquantize.packed_width(n, bits)
        np.testing.assert_array_equal(tquantize.unpack_codes(tp, bits, n).numpy(), codes)


def test_pack_topk_matches_reference():
    """pack_topk / unpack_topk == the reference's on distinct magnitudes
    (torch.topk does not promise lax.top_k's order among ties)."""
    rng = np.random.default_rng(5)
    x = (rng.permutation(1000).astype(np.float32) + 1.0) * rng.choice([-1.0, 1.0], 1000)
    x = x.astype(np.float32).reshape(25, 40) / 7.0
    ji, jv = jtopk.pack_topk(jnp.asarray(x), 37)
    ti, tv = ttopk.pack_topk(torch.from_numpy(x), 37)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ttopk.unpack_topk(ti, tv, 1000).numpy(),
                                  np.asarray(jtopk.unpack_topk(ji, jv, 1000)))


# ------------------------------------------------------------- autotune

from repro.kernels import autotune as jat  # noqa: E402
from repro_torch.kernels import _build as tbuild  # noqa: E402
from repro_torch.kernels import autotune as tat  # noqa: E402


@pytest.fixture
def autotune_default():
    """Restore both packages' process-wide autotune routing after a test
    that calls ``configure`` (directly or through a train CLI)."""
    yield
    jat.configure()
    tat.configure()


@pytest.mark.parametrize("kernel,shape,dtype,backend", [
    ("quantize", (512, 256, 4), "float32", "cpu"),
    ("quantize", tuple(np.int64([512, 256, 4])), "float32", "cpu"),
    ("ns", (30, 576, 1536), "float32", "cuda"),
    ("ns", tuple(np.int32([256, 64])), "bfloat16", "cpu"),
    ("attention", (128, 4, 1, 64), "float32", "tpu")])
def test_autotune_key_matches_reference(kernel, shape, dtype, backend):
    """The port's table keys are the reference's, numpy ints included."""
    assert tat.autotune_key(kernel, shape, dtype, backend) == \
        jat.autotune_key(kernel, shape, dtype, backend)


def test_autotune_table_round_trips_like_reference(tmp_path):
    """record / lookup (hit and miss) / save / load give the port's table
    the reference's entries and the same bytes on disk."""
    tables = {}
    for tag, mod in (("ref", jat), ("port", tat)):
        t = mod.AutotuneTable()
        t.record("quantize", (64, 32, 4), "float32", "cpu", {"block_rows": 16}, {"speedup": 2.0})
        t.record("ns", (2, 64, 96), "float32", "cuda", dict(tmm.DEFAULT_TILE), {"x": 1})
        assert t.lookup("quantize", (64, 32, 4), "float32", "cpu") == {"block_rows": 16}
        assert t.lookup("quantize", (64, 33, 4), "float32", "cpu") is None
        assert t.lookup("ns", (2, 64, 96), "float32", "cuda") == tmm.DEFAULT_TILE
        path = str(tmp_path / f"{tag}.json")
        t.save(path)
        tables[tag] = mod.AutotuneTable.load(path)
        assert tables[tag].entries == t.entries
    assert tables["ref"].entries == tables["port"].entries
    assert (tmp_path / "ref.json").read_bytes() == (tmp_path / "port.json").read_bytes()


def test_autotune_scope_and_configure_route_like_reference(tmp_path, autotune_default):
    """Scoped and process-wide routing: a table given by path is consulted,
    a miss and ``enabled=False`` give None, in both packages alike; the
    card's entries key the whole stack and return the kernel's knobs."""
    path = str(tmp_path / "t.json")
    t = tat.AutotuneTable(path=path)
    t.record("quantize", (8, 4, 4), "float32", "cpu", {"block_rows": 2})
    t.record("ns", (16, 32), "float32", "cpu", {"block": 64})
    t.record("ns", (3, 16, 32), "float32", "cuda", dict(tmm.TILE_CANDIDATES[0]))
    t.record("quantize", (8, 4, 4), "float32", "cuda", dict(tquantize.TILE_CANDIDATES[0]))
    t.save()
    calls = [("quantize_block_rows", (8, 4, 4, "float32")), ("quantize_block_rows", (9, 4, 4, "float32")),
             ("ns_block", (16, 32, "float32")), ("ns_block", (16, 33, "float32"))]
    for scope in (dict(enabled=True, table_path=path), dict(enabled=False)):
        with jat.autotune_scope(**scope), tat.autotune_scope(**scope):
            got = [getattr(tat, f)(*a) for f, a in calls]
            assert got == [getattr(jat, f)(*a) for f, a in calls]
            assert got == ([2, None, 64, None] if scope["enabled"] else [None] * 4)
            cuda = (tat.ns_block(16, 32, "float32", "cuda", stack=3),
                    tat.quantize_block_rows(8, 4, 4, "float32", "cuda"))
            assert cuda == ((tmm.TILE_CANDIDATES[0], tquantize.TILE_CANDIDATES[0])
                            if scope["enabled"] else (None, None))
    for mod in (jat, tat):
        mod.configure(enabled=True, table_path=path)
    assert tat.quantize_block_rows(8, 4, 4, "float32") == jat.quantize_block_rows(8, 4, 4, "float32") == 2
    for mod in (jat, tat):
        mod.configure(enabled=False)
    assert tat.active_table() is None and jat.active_table() is None
    assert tat.ns_block(16, 32, "float32") is None


def test_ops_resolve_the_card_tile_through_the_table(tmp_path, monkeypatch, autotune_default):
    """The wrappers' resolution on a CUDA device (a lookup only: nothing
    launches): ``block=None`` reads the table's cuda entry for the stack or
    the wire shape (dequantize under bits 4), a miss and the table off give
    the default (None), an int knob raises on the card and is ignored on the
    CPU; and the wire encode passes ``ops.quantize_tile``'s tile."""
    from repro_torch.core import wire as twire

    path = str(tmp_path / "t.json")
    t = tat.AutotuneTable(path=path)
    t.record("quantize", (8, 4, 2), "float32", "cuda", dict(tquantize.TILE_CANDIDATES[1]))
    t.record("quantize", (8, 4, 4), "float32", "cuda", dict(tquantize.TILE_CANDIDATES[2]))
    t.save()
    cuda = torch.device("cuda")
    with tat.autotune_scope(enabled=True, table_path=path):
        assert tops._quantize_tile(None, 8, 4, 2, torch.float32, cuda) == \
            tquantize.TILE_CANDIDATES[1]
        assert tops._quantize_tile(None, 8, 5, 2, torch.float32, cuda) is None
        assert tops._quantize_tile(None, 8, 4, 2, torch.float32, torch.device("cpu")) is None
        with pytest.raises(TypeError):
            tops._quantize_tile(8, 8, 4, 2, torch.float32, cuda)
        assert tops._quantize_tile(8, 8, 4, 2, torch.float32, torch.device("cpu")) is None
    with tat.autotune_scope(enabled=False):
        assert tops._quantize_tile(None, 8, 4, 2, torch.float32, cuda) is None
    seen = []
    real = twire.rowwise_quantize_codes
    sentinel = dict(tquantize.TILE_CANDIDATES[3])
    monkeypatch.setattr(twire, "rowwise_quantize_codes",
                        lambda x, bits, tile=None: seen.append(tile) or real(x, bits))
    monkeypatch.setattr(tops, "quantize_tile", lambda x, bits, block_rows=None: sentinel)
    twire.quant_encode(torch.ones(4, 6), 2, True)
    assert seen == [sentinel]
    g = torch.from_numpy(_np(np.random.default_rng(3), (2, 6, 10)))
    want = tops.ns_orthogonalize(g)
    for block in (128, tmm.TILE_CANDIDATES[5]):  # the plain version takes no tile
        assert torch.equal(tops.ns_orthogonalize(g, block=block), want)
    with pytest.raises(ValueError, match="not a candidate"):
        tops.ns_orthogonalize(g, block={"tile": 100, "bk": 16, "ty": 16, "tx": 16})


def _reduced_configs():
    from repro.configs import get_config as jget_config
    from repro.configs import reduce_config as jreduce_config
    from repro_torch.configs import get_config as tget_config
    from repro_torch.configs import reduce_config as treduce_config

    return (jreduce_config(jget_config("smollm-135m")),
            treduce_config(tget_config("smollm-135m")))


@pytest.mark.parametrize("table", ["reference", "tmp"])
@pytest.mark.parametrize("S", [64, 128])
def test_tuned_model_config_and_evidence_match_reference(S, table, tmp_path):
    """tuned_model_config and autotune_evidence of reduced smollm at S 64 and
    128 equal the reference's, on the reference's committed table given by
    path and on a tmp table, in scope and off."""
    jcfg, tcfg = _reduced_configs()
    jcfg, tcfg = jcfg.replace(max_seq_len=S), tcfg.replace(max_seq_len=S)
    path = jat.DEFAULT_TABLE_PATH
    if table == "tmp":
        path = str(tmp_path / "t.json")
        t = jat.AutotuneTable(path=path)
        t.record("attention", (S, 4, 1, 64), "float32", "cpu",
                 {"attn_block_q": 16, "attn_block_kv": 32, "junk_knob": 7})
        t.save()
    knobs = ("attn_block_q", "attn_block_kv", "blockwise_threshold")
    for enabled in (True, False):
        with jat.autotune_scope(enabled=enabled, table_path=path), \
                tat.autotune_scope(enabled=enabled, table_path=path):
            jt, tt = jat.tuned_model_config(jcfg, S), tat.tuned_model_config(tcfg, S)
            assert [getattr(tt, k) for k in knobs] == [getattr(jt, k) for k in knobs]
            assert tat.autotune_evidence(tcfg, S) == jat.autotune_evidence(jcfg, S)
            assert (tt is tcfg) == (jt is jcfg)
    assert not hasattr(tt, "junk_knob")


def test_committed_table_carries_the_reference_cpu_entries():
    """Every CPU entry of the port's committed table is the reference's key
    with its config unchanged, and there is no other CPU entry."""
    ref = jat.AutotuneTable.load().entries
    port = tat.AutotuneTable.load().entries
    cpu = {k: v for k, v in port.items() if k.endswith("/cpu")}
    assert set(cpu) == set(ref) and len(ref) == 14
    for key, ent in cpu.items():
        assert ent["config"] == ref[key]["config"], key
        assert ent["evidence"]["source"] == "src/repro/kernels/autotune_table.json", key


def test_committed_table_is_wellformed():
    """The port's committed JSON: every entry a known kernel with a config
    and the bitwise gate's evidence; every cuda entry keys a stack (ns) or a
    (rows, cols, bits) shape (quantize), names a candidate of its kernel's
    grid, and records the card and its power limit."""
    entries = tat.AutotuneTable.load().entries
    assert entries
    grids = {"ns": tmm.TILE_CANDIDATES, "quantize": tquantize.TILE_CANDIDATES}
    for key, ent in entries.items():
        kernel, dims, dtype, backend = key.split("/")
        assert kernel in ("attention", "quantize", "ns") and ent["config"], key
        assert ent["evidence"].get("verified_bitwise") is True, key
        assert backend in ("cpu", "cuda") and dtype in ("float32", "bfloat16"), key
        if backend == "cuda":
            assert kernel in grids and len(dims.split("x")) == 3, key
            assert ent["config"] in grids[kernel], key
            ev = ent["evidence"]
            assert ev["device"] and ev["power_limit"] and ev["best_s"] <= ev["default_s"], key


def test_sweep_gate_rejects_candidates_that_are_not_bitwise(monkeypatch):
    """The port's _sweep, as the reference's: a candidate whose output
    differs in a value, a dtype or a shape never wins, whatever its time;
    the fastest bitwise-equal candidate does."""
    seconds = {1: 5.0, 2: 1.0, 3: 1.0, 4: 1.0, 5: 3.0, 6: 4.0}
    last = [None]

    def fake_time(fn, reps=3, device=None, warmup=True):
        fn()
        return seconds[last[0]]

    monkeypatch.setattr(tat, "_time_best", fake_time)

    def run(knob):
        last[0] = knob
        out = {1: torch.ones(3), 2: torch.tensor([1.0, 1.0, 2.0]), 3: torch.ones(3).double(),
               4: torch.ones(4), 5: torch.ones(3), 6: torch.ones(3)}[knob]
        return (out, torch.zeros(2))

    best, ev = tat._sweep(run, {"knob": 1}, [{"knob": k} for k in (2, 3, 4, 5, 6)], reps=1)
    assert best == {"knob": 5} and ev["rejected_not_bitwise"] == 3
    assert ev["verified_bitwise"] is True and ev["candidates"] == 5
    jbest, jev = jat._sweep(lambda knob: jnp.array([1.0 if knob == 1 else 2.0]), {"knob": 1},
                            [{"knob": 2}], reps=1)
    tbest, tev = tat._sweep(lambda knob: torch.tensor([1.0 if knob == 1 else 2.0]),
                            {"knob": 1}, [{"knob": 2}], reps=1)
    assert tbest == jbest == {"knob": 1}
    assert tev["rejected_not_bitwise"] == jev["rejected_not_bitwise"] == 1


class _Resolved(Exception):
    pass


def _resolved_cfg(monkeypatch, module, argv):
    """The ModelConfig a train CLI resolves before it builds the model."""
    def stop(cfg):
        raise _Resolved(cfg)

    monkeypatch.setattr(module, "build_model", stop)
    with pytest.raises(_Resolved) as e:
        module.train(module.build_parser().parse_args(argv))
    return e.value.args[0]


@pytest.mark.parametrize("extra", [[], ["--attn-block-q", "64"]], ids=["table", "explicit"])
@pytest.mark.parametrize("autotune", ["on", "off"])
def test_train_cli_resolves_blocks_in_the_reference_order(monkeypatch, autotune, extra,
                                                          autotune_default):
    """``--autotune on|off`` plus an explicit ``--attn-block-q``: the port's
    train CLI resolves the attention knobs of reduced smollm at S 128 as the
    reference's does (table first, then the explicit flags over it; off
    restores the config's constants), each on its own committed table."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    argv = ["--arch", "smollm-135m", "--reduced", "--seq-len", "128", "--autotune", autotune,
            *extra]
    jcfg = _resolved_cfg(monkeypatch, jtrain, argv)
    tcfg = _resolved_cfg(monkeypatch, ttrain, argv + ["--device", "cpu"])
    knobs = ("attn_block_q", "attn_block_kv", "blockwise_threshold", "max_seq_len")
    assert [getattr(tcfg, k) for k in knobs] == [getattr(jcfg, k) for k in knobs]
    want_q = 64 if extra else (32 if autotune == "on" else 512)
    assert tcfg.attn_block_q == want_q
    assert tat.active_table() is None if autotune == "off" else tat.active_table() is not None


def test_cuda_sources_default_to_the_default_tiles():
    """The ``#ifndef`` defaults of csrc/matmul_epilogue.cu and csrc/quantize.cu
    are the defines of each module's DEFAULT_TILE (the default variant builds
    with no define), and every candidate's defines are distinct."""
    import re

    for src, mod in (("matmul_epilogue.cu", tmm), ("quantize.cu", tquantize)):
        text = (tbuild.CSRC / src).read_text()
        defaults = {k: int(v) for k, v in
                    re.findall(r"#ifndef (\w+)\n#define \1 (\d+)\n#endif", text)}
        assert defaults == mod.tile_defines(mod.DEFAULT_TILE), src
        seen = {tuple(sorted(mod.tile_defines(c).items())) for c in mod.TILE_CANDIDATES}
        assert len(seen) == len(mod.TILE_CANDIDATES) and mod.DEFAULT_TILE in mod.TILE_CANDIDATES


def test_variant_builds_hash_their_defines_and_count_launches(monkeypatch, tmp_path):
    """A variant's library file hashes its defines (each its own file, the
    default's name unchanged), nvcc gets them as -D flags, and a launch of a
    variant counts under its entry name and its key; a capture's counts carry
    both and add back per replay."""
    import contextlib
    import types
    from pathlib import Path

    key = tbuild.variant_key("matmul_epilogue", tmm.tile_variant(tmm.TILE_CANDIDATES[0]))
    assert tbuild.split_key(key) == ("matmul_epilogue", tmm.tile_variant(tmm.TILE_CANDIDATES[0]))
    paths = {tbuild.lib_path(tbuild.variant_key("matmul_epilogue", tmm.tile_variant(c)))
             for c in tmm.TILE_CANDIDATES}
    assert len(paths) == len(tmm.TILE_CANDIDATES)
    assert tbuild.lib_path("matmul_epilogue").name.count("-") == 1
    with pytest.raises(KeyError, match="no variant"):
        tbuild.lib_path("matmul_epilogue@nope")
    cmds = []

    class Proc:
        def __init__(self, cmd, **kw):
            cmds.append(cmd)
            kw["stdout"].write("ptxas info : Used 1 registers\n")
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
            self.returncode = 0

        def poll(self):
            return 0

    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tbuild, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(tbuild.subprocess, "Popen", Proc)
    report = tbuild.build([key, "quantize"], jobs=1)
    assert "-DMM_TILE=64" in cmds[0] and not any(a.startswith("-D") for a in cmds[1])
    assert report[key]["log"].startswith("ptxas info") and Path(report[key]["path"]).exists()
    monkeypatch.setattr(tbuild, "entry", lambda k, argtypes: (lambda *a: 0, None))
    monkeypatch.setattr(tbuild, "check_tiles", lambda k: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(tbuild, "LAUNCHES", dict(tbuild.LAUNCHES))
    monkeypatch.setattr(tbuild, "VARIANT_LAUNCHES", {})
    tbuild.reset_launch_counts()
    variant = tbuild.split_key(key)[1]
    tbuild.launch("matmul_epilogue", [], "cpu", variant=variant)
    tbuild.launch("matmul_epilogue", [], "cpu")
    assert tbuild.LAUNCHES["matmul_epilogue"] == 2
    assert tbuild.VARIANT_LAUNCHES == {key: 1, "matmul_epilogue": 1}
    counts = tbuild.LaunchCounts({"matmul_epilogue": 2}, {key: 2})
    assert counts == {"matmul_epilogue": 2}
    tbuild.add_launch_counts(counts)
    assert tbuild.LAUNCHES["matmul_epilogue"] == 4 and tbuild.VARIANT_LAUNCHES[key] == 3


def test_concurrent_builds_compile_a_library_once(monkeypatch, tmp_path):
    """Two builds of one library started together (two ranks of a mesh, or
    two processes on one card): the second waits on the library's file lock
    while the first runs nvcc (here a stub that takes a second), then finds
    the library built and compiles nothing; nvcc ran once."""
    import os
    import stat
    import threading
    import time

    csrc, counter = tmp_path / "csrc", tmp_path / "nvcc_runs"
    csrc.mkdir()
    (csrc / "stub.cu").write_text("// a stub source\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do [ \"$1\" = -o ] && out=$2; shift; done\n"
                    f"echo run >> {counter}\nsleep 1\n: > \"$out\"\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(tbuild, "CSRC", csrc)
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setitem(tbuild.SOURCES, "stub", "stub.cu")
    monkeypatch.setattr(tbuild, "_nvcc", lambda: str(nvcc))
    ends, reports = {}, {}

    def run(name):
        reports[name] = tbuild.build(["stub"])
        ends[name] = time.perf_counter()

    first = threading.Thread(target=run, args=("first",))
    t0 = time.perf_counter()
    first.start()
    while not (tmp_path / "build").exists() or not list((tmp_path / "build").glob("*.lock")):
        time.sleep(0.01)
    second = threading.Thread(target=run, args=("second",))
    second.start()
    first.join(30)
    second.join(30)
    assert counter.read_text().splitlines() == ["run"]
    assert os.path.exists(reports["first"]["stub"]["path"])
    assert reports["second"]["stub"]["path"] == reports["first"]["stub"]["path"]
    assert ends["second"] >= ends["first"] - 0.1 and ends["second"] - t0 >= 0.9
    assert reports["second"]["stub"]["log"] == ""  # it compiled nothing


def _brute_sym(m, t):
    """Every (i, j), i <= j, of an m x m grid of t x t tiles, row by row."""
    nt = -(-m // t)
    return [(i, j) for i in range(nt) for j in range(nt) if i <= j]


@pytest.mark.parametrize("tile", tmm.TILE_CANDIDATES, ids=lambda c: tmm.tile_variant(c) or "default")
def test_matmul_candidate_layouts_and_triangle(tile):
    """Every matmul candidate: its thread tiles cover the block tile with
    whole warps (csrc's static_asserts), its register tile is 4, 6 or 8 a
    side, its shared memory fits a block's 227 KB, its register budget a
    whole SM; and its symmetric grid (``sym_grid``) visits the upper
    triangle of tiles once, row by row, at the main path's widths."""
    d = tmm.tile_defines(tile)
    tm, tn = 4 * d["MM_MG"] + 2 * d["MM_MT"], 4 * d["MM_NG"] + 2 * d["MM_NT"]
    assert d["MM_TY"] * tm == d["MM_TILE"] == d["MM_TX"] * tn and tm == tn in (4, 6, 8)
    assert d["MM_TY"] % 4 == 0 and d["MM_TX"] % 8 == 0 and d["MM_BK"] % 4 == 0
    threads = d["MM_TY"] * d["MM_TX"]
    assert threads <= 1024 and threads * d["MM_MIN_BLOCKS"] <= 2048
    assert tmm.smem_bytes(tile) <= 227 * 1024
    for m in (64, 192, 576, 1024, 1280, 1408, 2560, 100):
        assert tmm.sym_grid(m, tile) == _brute_sym(m, tile["tile"]), m


@pytest.mark.parametrize("tile", tquantize.TILE_CANDIDATES,
                         ids=lambda c: tquantize.tile_variant(c) or "default")
def test_quantize_candidate_plan_covers_every_step(tile):
    """Every quantize candidate's plan mirror at the compressed path's shapes,
    against a brute-force walk of its long-row schedule: the regime cuts at
    the candidate's warp and block row limits; pass 1's ``parts`` blocks a
    row each own at least one step of ``LONG_MIN_GROUPS`` float4 groups and
    together visit every step once (so the scratch of 2 x rows x parts fp32
    holds every partial), about ``LONG_BLOCKS`` blocks in all."""
    warp_max, block_max, blocks, groups = tquantize.plan_sizes(tile)
    assert tquantize.plan_sizes(tile) == tbuild.TILES[
        tbuild.variant_key("quantize", tquantize.tile_variant(tile))][1]
    assert block_max == tile["threads"] * tquantize.MAX_GROUPS * 4 and warp_max == 2048
    for rows, cols in ((2, 28_311_552), (1, 28_311_552), (34_560, 1536), (98_304, 576),
                       (1000, 10_000), (3, 40_000), (1, block_max + 1)):
        regime, parts = tquantize.quantize_plan(rows, cols, tile)
        if cols <= block_max:
            assert regime == ("warp" if cols <= warp_max else "block") and parts == 1
            continue
        assert regime == "long"
        steps = -(-(-(-cols // 4)) // groups)
        seen = [0] * steps
        for part in range(parts):
            mine = list(range(part, steps, parts))
            assert mine, (rows, cols, part)
            for st in mine:
                seen[st] += 1
        assert seen == [1] * steps
        assert rows * parts < blocks + rows and parts * groups <= -(-cols // 4)
