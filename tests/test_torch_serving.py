"""PyTorch port: the paged serving engine against the JAX package.

The port's ``PagedEngine.run`` must emit exactly the reference engine's
greedy tokens (reduced smollm-135m, fp32, reference params) for each
``attn_impl``, on the reference's continuous-batching workloads: more
requests than slots, staggered arrivals, decode spans of 2 and 3; so must
its ``naive_generate`` (the dense and the ring cache), and nemotron-4-15b
through both engines. The span's static-buffer path (the steps a CUDA graph
captures) runs eagerly here and equals a plain loop bitwise. The allocator
tests mirror tests/test_serving.py. ``chip_smoke.py`` must refuse to run
without CUDA.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from test_torch_models import LAST_SMALL  # noqa: E402  (kimi-k2's and mistral-large's narrow widths)

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import PagedEngine as JPagedEngine, Request as JRequest  # noqa: E402
from repro.serving import naive_generate as jnaive_generate  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build_model as tbuild_model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    OutOfPages,
    PageAllocator,
    PagedEngine,
    Request,
    naive_generate,
    pages_needed,
)
from repro_torch.serving import decode as tdecode  # noqa: E402
from repro_torch.utils.tree import params_from_numpy  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Reduced models: one torch thread computes them faster than a pool of
    threads that spin beside the other files of a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- allocator

def test_allocator_no_double_allocation():
    a = PageAllocator(n_pages=8, page_size=4)
    seen = set(a.alloc("a", 3))
    more = a.alloc("b", 4)
    assert not seen & set(more)
    assert 0 not in seen | set(more)  # null page never handed out
    assert a.n_free == 0


def test_allocator_release_returns_pages():
    a = PageAllocator(n_pages=8, page_size=4)
    a.alloc("a", 3)
    a.alloc("b", 2)
    assert a.n_free == 2
    assert a.release("a") == 3
    assert a.n_free == 5
    assert a.pages_for("a") == []
    assert len(a.alloc("c", 5)) == 5


def test_allocator_out_of_pages_raises():
    a = PageAllocator(n_pages=4, page_size=4)
    a.alloc("a", 2)
    with pytest.raises(OutOfPages):
        a.alloc("b", 2)
    assert a.n_free == 1
    assert a.can_admit(4) and not a.can_admit(5)


def test_allocator_ensure_grows_on_demand():
    a = PageAllocator(n_pages=8, page_size=4)
    a.alloc("a", 1)
    assert a.capacity("a") == 4
    assert a.ensure("a", 4) == []
    assert len(a.ensure("a", 9)) == 2
    assert a.capacity("a") == 12
    assert pages_needed(9, 4) == 3


def test_allocator_page_table_layout():
    a = PageAllocator(n_pages=8, page_size=4)
    pages = a.alloc("a", 2)
    tbl = a.page_table(["a", None], max_pages=4)
    assert tbl.shape == (2, 4) and tbl.dtype == np.int32
    assert tbl[0, :2].tolist() == pages and tbl[0, 2:].tolist() == [0, 0]
    assert tbl[1].tolist() == [0, 0, 0, 0]


# ------------------------------------------------------- engine == reference

def _models(impl):
    jcfg = reduce_config(get_config("smollm-135m")).replace(attn_impl=impl)
    tcfg = tconfigs.reduce_config(tconfigs.get_config("smollm-135m")).replace(attn_impl=impl)
    jmodel = build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, tbuild_model(tcfg), tparams


def _prompt(seed, n, vocab):
    return tuple(int(t) for t in np.random.default_rng(seed).integers(0, vocab, n))


WORKLOADS = {
    # test_serving.py::test_engine_matches_naive_batch: 3 requests, 2 slots, span 3
    "batch": (3, [(_p, 8, 0) for _p in (6, 6, 6)]),
    # test_serving.py::test_engine_late_join_matches_solo: staggered arrivals, span 2
    "late_join": (2, [(3, 7, 0), (9, 4, 1), (5, 9, 4)]),
}


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_engine_tokens_equal_reference(impl, workload):
    span, shape = WORKLOADS[workload]
    jmodel, jparams, tmodel, tparams = _models(impl)
    vocab = jmodel.cfg.vocab
    specs = [(f"r{i}", _prompt(20 + i, n, vocab), new, arr)
             for i, (n, new, arr) in enumerate(shape)]
    kw = dict(slots=2, page_size=4, max_pages=32, decode_steps_per_dispatch=span)
    ref = JPagedEngine(jmodel, jparams, attn_impl=impl, **kw).run(
        [JRequest(*s) for s in specs])
    eng = PagedEngine(tmodel, tparams, attn_impl=impl, device="cpu", **kw)
    out = eng.run([Request(*s) for s in specs])
    assert sorted(out) == sorted(ref)
    for rid in ref:
        np.testing.assert_array_equal(out[rid], np.asarray(ref[rid]))
    assert eng.stats["decode_steps"] == span * eng.stats["spans"]
    assert eng.stats["prefill_dispatches"] >= 2  # slots < requests: more than one admission


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_ladder_engine_tokens_equal_reference(impl):
    """The paper's ladder at a narrow hd-128 width (post-norms, QK-norm, MHA,
    the untied head; fp32, reference params, built the same way in both
    packages) through the engine on the staggered-arrival workload: greedy
    tokens equal the reference engine's."""
    small = dict(n_layers=2, d_model=256, n_heads=2, n_kv_heads=2, head_dim=128, d_ff=512,
                 vocab=512, dtype="float32", remat=False, attn_impl=impl)
    jmodel = build_model(get_config("paper-150m").replace(**small))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = tbuild_model(tconfigs.get_config("paper-150m").replace(**small))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    span, shape = WORKLOADS["late_join"]
    specs = [(f"r{i}", _prompt(30 + i, n, 512), new, arr)
             for i, (n, new, arr) in enumerate(shape)]
    kw = dict(slots=2, page_size=4, max_pages=32, decode_steps_per_dispatch=span)
    ref = JPagedEngine(jmodel, jparams, attn_impl=impl, **kw).run(
        [JRequest(*s) for s in specs])
    out = PagedEngine(tmodel, tparams, attn_impl=impl, device="cpu", **kw).run(
        [Request(*s) for s in specs])
    assert sorted(out) == sorted(ref)
    for rid in ref:
        np.testing.assert_array_equal(out[rid], np.asarray(ref[rid]))


def test_engine_releases_pages_and_rejects_oversized():
    _, _, tmodel, tparams = _models("pallas")
    eng = PagedEngine(tmodel, tparams, slots=1, page_size=4, max_pages=8,
                      decode_steps_per_dispatch=2, attn_impl="pallas", device="cpu")
    out = eng.run([Request(f"q{i}", (1, 2, 3), 4) for i in range(3)])
    assert sorted(out) == ["q0", "q1", "q2"]
    for rid in ("q1", "q2"):
        np.testing.assert_array_equal(out[rid], out["q0"])  # identical prompts
    with pytest.raises(OutOfPages):
        eng.run([Request("big", tuple(range(1, 40)), 8)])


def test_engine_temperature_sampling_is_seeded():
    _, _, tmodel, tparams = _models("xla")
    reqs = [Request(f"t{i}", (5, 6, 7, 8), 6) for i in range(2)]
    runs = [PagedEngine(tmodel, tparams, slots=2, page_size=4, max_pages=16,
                        decode_steps_per_dispatch=3, temperature=1.0, device="cpu",
                        seed=seed).run(reqs) for seed in (1, 1)]
    for rid in runs[0]:
        np.testing.assert_array_equal(runs[0][rid], runs[1][rid])
        assert ((runs[0][rid] >= 0) & (runs[0][rid] < tmodel.cfg.vocab)).all()


# ------------------------------------------------------------------ launchers

def test_serve_main_runs_reduced_on_cpu(capsys):
    out = tserve.main(["--reduced", "--device", "cpu", "--batch", "3", "--prompt-len", "6",
                       "--max-new", "5", "--slots", "2", "--page-size", "4",
                       "--max-pages", "32", "--decode-steps-per-dispatch", "2"])
    assert sorted(out) == ["req0", "req1", "req2"]
    assert all(v.shape == (5,) for v in out.values())
    assert "tok/s" in capsys.readouterr().out


def test_serve_main_runs_naive_on_cpu(capsys):
    """``--engine naive`` runs (it raised before the naive engine was
    ported), and its greedy tokens equal the paged engine's on the same
    seeded weights and prompts."""
    argv = ["--reduced", "--device", "cpu", "--batch", "3", "--prompt-len", "6",
            "--max-new", "5", "--slots", "2", "--page-size", "4", "--max-pages", "32"]
    naive = tserve.main(argv + ["--engine", "naive"])
    assert "[naive] generated 15 tokens" in capsys.readouterr().out
    paged = tserve.main(argv + ["--engine", "paged"])
    assert sorted(naive) == sorted(paged) == ["req0", "req1", "req2"]
    for rid in naive:
        assert naive[rid].shape == (5,) and naive[rid].dtype == np.int32
        np.testing.assert_array_equal(naive[rid], paged[rid])


def test_serve_parser_defaults_to_the_kernels_on_cuda():
    args = tserve.build_parser().parse_args([])
    assert args.attn_impl == "pallas" and args.device == "cuda" and args.engine == "paged"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda(alone, tmp_path):
    """No CUDA here: chip_smoke.py exits nonzero and prints no result line,
    both in the checkout and copied alone into an empty directory."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, script], capture_output=True, text=True, cwd=cwd,
                         env=env, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


# -------------------------------------------------------------- naive engine

@pytest.mark.parametrize("window", [0, 4], ids=["dense", "ring"])
@pytest.mark.parametrize("batched", [True, False], ids=["batched-prefill", "stepped-prefill"])
def test_naive_generate_matches_reference_and_paged(batched, window):
    """naive_generate's greedy tokens (3 prompts of 7, 6 new, fp32) equal the
    reference's naive_generate with the same ``batched_prefill``, and (no
    window) the port's PagedEngine on the same prompts: the reference's
    test_paged_decode_matches_dense, held across packages. With window 4
    the cache is the 4-slot ring, wrapped by prefill and decode."""
    jmodel, jparams, tmodel, tparams = _models("xla")
    if window:
        jmodel = build_model(jmodel.cfg.replace(sliding_window=window))
        tmodel = tbuild_model(tmodel.cfg.replace(sliding_window=window))
    B, P, new = 3, 7, 6
    prompts = np.random.default_rng(16).integers(0, 512, (B, P)).astype(np.int32)
    ref = np.asarray(jnaive_generate(jmodel, jparams, jax.numpy.asarray(prompts), new,
                                     batched_prefill=batched))
    out = naive_generate(tmodel, tparams, torch.from_numpy(prompts), new,
                         batched_prefill=batched)
    assert out.dtype == torch.int32 and tuple(out.shape) == (B, P + new)
    np.testing.assert_array_equal(out.numpy(), ref)
    if window:
        assert tmodel.init_cache(tparams, B, P + new)["k"].shape[2] == window
        return
    eng = PagedEngine(tmodel, tparams, slots=2, page_size=4, max_pages=32,
                      decode_steps_per_dispatch=2, device="cpu")
    paged = eng.run([Request(f"n{i}", tuple(prompts[i].tolist()), new) for i in range(B)])
    for i in range(B):
        np.testing.assert_array_equal(paged[f"n{i}"], ref[i, P:])


# nemotron-4-15b's head dim 128 and G = 6 at a narrow width (test_torch_models.py's)
NEMOTRON_G6 = dict(n_layers=2, d_model=256, n_heads=6, n_kv_heads=1, head_dim=128, d_ff=512,
                   vocab=512, dtype="float32", remat=False)


def _nemotron(g6: bool):
    jcfg, tcfg = get_config("nemotron-4-15b"), tconfigs.get_config("nemotron-4-15b")
    if g6:
        jcfg, tcfg = jcfg.replace(**NEMOTRON_G6), tcfg.replace(**NEMOTRON_G6)
    else:
        jcfg, tcfg = reduce_config(jcfg), tconfigs.reduce_config(tcfg)
    jmodel = build_model(jcfg.replace(attn_impl="pallas"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jmodel, jparams, tbuild_model(tcfg.replace(attn_impl="pallas")), tparams


@pytest.mark.parametrize("g6", [False, True], ids=["reduced", "hd128-G6"])
def test_nemotron_engines_match_reference(g6):
    """nemotron-4-15b, reduced and at hd 128 with G = 6 (fp32, the kernels'
    plain versions): the PagedEngine's greedy token streams on the
    staggered-arrival workload equal the reference engine's, and
    naive_generate's equal the reference's naive_generate."""
    jmodel, jparams, tmodel, tparams = _nemotron(g6)
    span, shape = WORKLOADS["late_join"]
    specs = [(f"r{i}", _prompt(40 + i, n, 512), new, arr)
             for i, (n, new, arr) in enumerate(shape)]
    kw = dict(slots=2, page_size=4, max_pages=32, decode_steps_per_dispatch=span)
    ref = JPagedEngine(jmodel, jparams, attn_impl="pallas", **kw).run(
        [JRequest(*s) for s in specs])
    out = PagedEngine(tmodel, tparams, attn_impl="pallas", device="cpu", **kw).run(
        [Request(*s) for s in specs])
    assert sorted(out) == sorted(ref)
    for rid in ref:
        np.testing.assert_array_equal(out[rid], np.asarray(ref[rid]))
    prompts = np.random.default_rng(17).integers(0, 512, (2, 5)).astype(np.int32)
    jtoks = jnaive_generate(jmodel, jparams, jax.numpy.asarray(prompts), 4)
    ttoks = naive_generate(tmodel, tparams, torch.from_numpy(prompts), 4)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))


# ---------------------------------------------------------- the decode span

def test_span_static_buffers_equal_the_python_loop():
    """span_steps, the body a CUDA graph captures (tokens written into a
    static [span, B] buffer, the inputs only read), run eagerly on the CPU:
    tokens and pool bitwise equal to the plain loop it replaced, with a
    sampled span repeating bitwise from the same seed; the inputs are left
    as they were."""
    _, _, tmodel, tparams = _models("pallas")
    B, span, ps = 3, 4, 4
    table = torch.tensor([[1, 2, 3, 0], [4, 5, 6, 0], [0, 0, 0, 0]], dtype=torch.int32)
    lengths = torch.tensor([5, 2, 1], dtype=torch.int32)
    tok = torch.tensor([7, 8, 9], dtype=torch.int32)
    pool = tmodel.init_paged_cache(8, ps, "cpu")
    for key in pool:
        pool[key].copy_(torch.randn(pool[key].shape, generator=torch.Generator().manual_seed(3)))

    def plain_loop(cache, gen, temperature):
        t, n, toks = tok, lengths, []
        for _ in range(span):
            logits, cache = tmodel.paged_decode_step(tparams, cache, t, table, n, impl="pallas")
            t = tdecode.sample_tokens(logits, gen, temperature)
            n = n + 1
            toks.append(t)
        return cache, torch.stack(toks)

    for temperature in (0.0, 1.0):
        runs = []
        for body in ("loop", "static", "static"):
            cache = {k: v.clone() for k, v in pool.items()}
            gen = torch.Generator().manual_seed(5)
            inputs = [x.clone() for x in (tok, lengths, table)]
            if body == "loop":
                cache, toks = plain_loop(cache, gen, temperature)
            else:
                toks = torch.full((span, B), -1, dtype=torch.int32)
                cache = tdecode.span_steps(tmodel, tparams, cache, *inputs, gen, toks,
                                           temperature, "pallas")
                for a, b in zip(inputs, (tok, lengths, table)):
                    assert torch.equal(a, b)
            runs.append((toks, cache))
        for toks, cache in runs[1:]:
            assert torch.equal(toks, runs[0][0])
            for key in pool:
                assert torch.equal(cache[key][:, 1:], runs[0][1][key][:, 1:])


def test_span_fn_eager_on_cpu_and_capture_needs_cuda():
    """SpanFn on CPU tensors runs eagerly (no graph, no capture counted), and
    an engine asked to capture off the card raises; a second run on one
    engine reuses its pool and gives the same tokens."""
    _, _, tmodel, tparams = _models("pallas")
    with pytest.raises(ValueError, match="CUDA graphs"):
        PagedEngine(tmodel, tparams, device="cpu", capture=True)
    eng = PagedEngine(tmodel, tparams, slots=2, page_size=4, max_pages=16,
                      decode_steps_per_dispatch=3, attn_impl="pallas", device="cpu")
    reqs = [Request(f"s{i}", (3 + i, 4, 5), 7) for i in range(3)]
    first = eng.run(reqs)
    pool = eng._pool
    second = eng.run(reqs)
    assert eng._pool is pool and not eng._span_fn.graphs
    for rid in first:
        np.testing.assert_array_equal(first[rid], second[rid])
    st = eng.stats
    assert st["captures"] == st["replays"] == 0 and st["spans"] > 0
    L = tmodel.cfg.n_layers
    assert eng.launches() == {"flash_fwd": L * st["prefill_dispatches"],
                              "paged_decode": L * 3 * st["spans"]}


# ------------------------------------------------------------------------ MoE

# deepseek-moe-16b at a narrow width (test_torch_models.py's MOE_SMALL)
MOE_SMALL = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, d_ff=32,
                 vocab=128, n_experts=8, experts_per_token=2, n_shared_experts=1, moe_groups=2,
                 dtype="float32", remat=False, attn_impl="pallas")


def test_moe_engines_match_reference():
    """The narrow deepseek-moe-16b (fp32, reference params, the kernels'
    plain versions) through the PagedEngine on the staggered-arrival
    workload: greedy tokens equal the reference engine's. A slot's MoE
    output depends on its group's other rows (idle slots and prompt pads
    included), so this also holds that both engines fill those alike. Then
    naive_generate against the reference's naive_generate."""
    jmodel = build_model(get_config("deepseek-moe-16b").replace(**MOE_SMALL))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))  # one compile, not one a draw
    tmodel = tbuild_model(tconfigs.get_config("deepseek-moe-16b").replace(**MOE_SMALL))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    span, shape = WORKLOADS["late_join"]
    specs = [(f"r{i}", _prompt(50 + i, n, 128), new, arr)
             for i, (n, new, arr) in enumerate(shape)]
    kw = dict(slots=2, page_size=4, max_pages=32, decode_steps_per_dispatch=span)
    ref = JPagedEngine(jmodel, jparams, attn_impl="pallas", **kw).run(
        [JRequest(*s) for s in specs])
    out = PagedEngine(tmodel, tparams, attn_impl="pallas", device="cpu", **kw).run(
        [Request(*s) for s in specs])
    assert sorted(out) == sorted(ref)
    for rid in ref:
        np.testing.assert_array_equal(out[rid], np.asarray(ref[rid]))
    prompts = np.random.default_rng(18).integers(0, 128, (2, 5)).astype(np.int32)
    jtoks = jnaive_generate(jmodel, jparams, jax.numpy.asarray(prompts), 4)
    ttoks = naive_generate(tmodel, tparams, torch.from_numpy(prompts), 4)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))


@pytest.mark.parametrize("name", sorted(LAST_SMALL))
def test_last_models_engines_match_reference(name):
    """The narrow kimi-k2 and mistral-large (fp32, reference params, the
    kernels' plain versions: flash_fwd and paged_decode at hd 112 with G = 8
    and at G = 12) through the PagedEngine on the staggered-arrival
    workload: greedy tokens equal the reference engine's (for kimi-k2 the
    MoE routes each decode step's slots together on both sides)."""
    small = dict(LAST_SMALL[name], attn_impl="pallas")
    jmodel = build_model(get_config(name).replace(**small))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tmodel = tbuild_model(tconfigs.get_config(name).replace(**small))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    vocab = tmodel.cfg.vocab
    span, shape = WORKLOADS["late_join"]
    specs = [(f"r{i}", _prompt(60 + i, n, vocab), new, arr)
             for i, (n, new, arr) in enumerate(shape)]
    kw = dict(slots=2, page_size=4, max_pages=32, decode_steps_per_dispatch=span)
    ref = JPagedEngine(jmodel, jparams, attn_impl="pallas", **kw).run(
        [JRequest(*s) for s in specs])
    out = PagedEngine(tmodel, tparams, attn_impl="pallas", device="cpu", **kw).run(
        [Request(*s) for s in specs])
    assert sorted(out) == sorted(ref)
    for rid in ref:
        np.testing.assert_array_equal(out[rid], np.asarray(ref[rid]))


SSM_ARCHS = {"ssm": "mamba2-370m", "hybrid": "zamba2-2.7b"}


@pytest.mark.parametrize("kind", sorted(SSM_ARCHS))
def test_ssm_naive_generate_matches_reference(kind, capsys):
    """The reduced mamba2-370m and zamba2-2.7b (fp32, reference params)
    through naive_generate, which steps the decode path through the prompt
    (neither family has a batched prefill): greedy tokens (2 prompts of 12,
    8 new, past zamba2's reduced window of 16) equal the reference's
    naive_generate. The paged engine refuses both with the reference's
    message, and ``launch.serve --engine naive`` serves them on the CPU."""
    name = SSM_ARCHS[kind]
    jmodel = build_model(reduce_config(get_config(name)))
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tmodel = tbuild_model(tconfigs.reduce_config(tconfigs.get_config(name)))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    assert not (tmodel.supports_batched_prefill or tmodel.supports_paged_decode)
    prompts = np.random.default_rng(19).integers(0, 512, (2, 12)).astype(np.int32)
    ref = np.asarray(jnaive_generate(jmodel, jparams, jax.numpy.asarray(prompts), 8))
    out = naive_generate(tmodel, tparams, torch.from_numpy(prompts), 8)
    np.testing.assert_array_equal(out.numpy(), ref)
    with pytest.raises(ValueError, match="serve it with --engine naive"):
        PagedEngine(tmodel, tparams, device="cpu")
    tserve.main(["--arch", name, "--reduced", "--engine", "naive", "--batch", "2",
                 "--prompt-len", "8", "--max-new", "4", "--device", "cpu"])
    assert "[naive] generated 8 tokens" in capsys.readouterr().out


CONTEXT_ARCHS = {"audio": "whisper-large-v3", "vlm": "llama-3.2-vision-90b"}


@pytest.mark.parametrize("kind", sorted(CONTEXT_ARCHS))
def test_context_naive_generate_matches_reference(kind, capsys):
    """The reduced whisper-large-v3 and llama-3.2-vision-90b (fp32,
    reference params; the VLM's tanh gates opened, as the reference's
    tests/test_serving.py opens them, so the context reaches the logits)
    through naive_generate, which fills the context into the cache and
    steps the decode path through the prompt: greedy tokens (2 prompts of
    5, 6 new) equal the reference's naive_generate on the same context;
    the same context twice gives the same tokens and another context other
    tokens (the reference's context-threading regression). The paged
    engine refuses both families, and ``launch.serve --engine naive``
    serves them on the CPU with the reference's zero context."""
    name = CONTEXT_ARCHS[kind]
    jmodel = build_model(reduce_config(get_config(name)))
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    if kind == "vlm":
        cl = params["cross_layers"]
        cl["attn"]["gate"] = np.ones_like(cl["attn"]["gate"])
        cl["mlp_gate"] = np.ones_like(cl["mlp_gate"])
    cfg = jmodel.cfg
    tmodel = tbuild_model(tconfigs.reduce_config(tconfigs.get_config(name)))
    tparams = params_from_numpy(params, "cpu")
    assert not (tmodel.supports_batched_prefill or tmodel.supports_paged_decode)
    n = cfg.n_audio_frames if kind == "audio" else cfg.n_image_tokens
    rng = np.random.default_rng(20)
    prompts = rng.integers(0, cfg.vocab, (2, 5)).astype(np.int32)
    ctx_a, ctx_b = (rng.standard_normal((2, n, cfg.d_model)).astype(np.float32)
                    for _ in "ab")
    ref = np.asarray(jnaive_generate(jmodel, jax.tree.map(jax.numpy.asarray, params),
                                     jax.numpy.asarray(prompts), 6,
                                     context=jax.numpy.asarray(ctx_a)))
    out_a, out_a2, out_b = (
        naive_generate(tmodel, tparams, torch.from_numpy(prompts), 6,
                       context=torch.from_numpy(c)).numpy() for c in (ctx_a, ctx_a, ctx_b))
    np.testing.assert_array_equal(out_a, ref)
    np.testing.assert_array_equal(out_a, out_a2)
    assert not np.array_equal(out_a[:, 5:], out_b[:, 5:])
    with pytest.raises(ValueError, match="serve it with --engine naive"):
        PagedEngine(tmodel, tparams, device="cpu")
    assert tuple(tserve.zero_context(tmodel.cfg, 3, "cpu").shape) == (3, n, cfg.d_model)
    tserve.main(["--arch", name, "--reduced", "--engine", "naive", "--batch", "2",
                 "--prompt-len", "4", "--max-new", "3", "--device", "cpu"])
    assert "[naive] generated 6 tokens" in capsys.readouterr().out
