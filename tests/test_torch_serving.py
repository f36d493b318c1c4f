"""PyTorch port: the paged serving engine against the JAX package.

The port's ``PagedEngine.run`` must emit exactly the reference engine's
greedy tokens (reduced smollm-135m, fp32, reference params) for each
``attn_impl``, on the reference's continuous-batching workloads: more
requests than slots, staggered arrivals, decode spans of 2 and 3. The
allocator tests mirror tests/test_serving.py. ``chip_smoke.py`` must refuse
to run without CUDA.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.serving import PagedEngine as JPagedEngine, Request as JRequest  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build_model as tbuild_model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    OutOfPages,
    PageAllocator,
    PagedEngine,
    Request,
    pages_needed,
)
from repro_torch.utils.tree import params_from_numpy  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tserve.main(["--reduced", "--device", "cpu", "--engine", "naive"])


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
