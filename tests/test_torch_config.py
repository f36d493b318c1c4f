"""PyTorch port: package hygiene, configs, the weight bridge and the
roofline tooling.

The port (``src/repro_torch``) must equal the JAX reference's configs field
for field, import neither ``jax`` nor anything of ``repro``, and carry
parameter trees across the numpy bridge exactly.

The roofline tooling (``repro_torch.roofline``) and the assigned input
shapes of ``repro_torch.configs``: every count equals the reference's
exactly (``==``) on the same config at full width. The port's trees are
built on the ``meta`` device, the reference's with ``jax.eval_shape``, so
nothing is allocated. Then the analytic forward count is held against
``torch.utils.flop_counter`` on the port's plain forward, with the two known
differences taken out explicitly.
"""
import ast
import dataclasses
import json
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ASSIGNED_ARCHS as JASSIGNED  # noqa: E402
from repro.configs import INPUT_SHAPES as JSHAPES  # noqa: E402
from repro.configs import config_for_shape as jconfig_for_shape  # noqa: E402
from repro.configs import get_config, reduce_config  # noqa: E402
from repro.configs import shape_supported as jshape_supported  # noqa: E402
from repro.core.diloco import DiLoCoConfig as JDiLoCoConfig  # noqa: E402
from repro.core.diloco import diloco_init as jdiloco_init  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro.optim import OptimizerConfig as JOptimizerConfig  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro.roofline import flops as jflops  # noqa: E402
from repro.roofline import report as jreport  # noqa: E402
from repro.utils.tree import tree_count_params as jcount  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.diloco import DiLoCoConfig, diloco_init  # noqa: E402
from repro_torch.models import build_model as tbuild_model  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.optim import OptimizerConfig  # noqa: E402
from repro_torch.optim.muon import muon_label  # noqa: E402
from repro_torch.roofline import analysis, flops, report, terms  # noqa: E402
from repro_torch.utils.tree import (  # noqa: E402
    params_from_numpy,
    params_to_numpy,
    tree_bytes,
    tree_count_params,
    tree_leaves_with_paths,
    tree_paths,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _port_files() -> list[str]:
    files = [os.path.join(REPO, "chip_smoke.py")]
    files += [os.path.join(REPO, "tools", n) for n in os.listdir(os.path.join(REPO, "tools"))
              if n.endswith(".py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize("reduced", [False, True])
def test_smollm_config_equals_reference(reduced):
    ref = get_config("smollm-135m")
    port = tconfigs.get_config("smollm-135m")
    if reduced:
        ref, port = reduce_config(ref), tconfigs.reduce_config(port)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.hd == ref.hd
    assert str(port.compute_dtype) == f"torch.{ref.compute_dtype}"
    if reduced:
        assert (port.d_model, port.n_heads, port.n_kv_heads, port.n_layers, port.vocab) == (
            256, 4, 1, 2, 512)


LADDER = ["paper-150m", "paper-416m", "paper-914m", "paper-1.76b", "paper-3.07b",
          "paper-15.23b"]
# the paper's ladder at a narrow hd-128 width, built the same way in both
# packages (reduce_config would give it hd 64)
LADDER_SMALL = dict(n_layers=2, d_model=256, n_heads=2, n_kv_heads=2, head_dim=128, d_ff=512,
                    vocab=512, dtype="float32", remat=False)


def test_unported_arch_names_roadmap():
    """The port registers every configuration of the reference (kimi-k2 and
    mistral-large came last), and a name neither package registers raises
    the registry's KeyError naming ROADMAP.md."""
    from repro.configs import list_configs as jlist_configs

    with pytest.raises(KeyError, match="ROADMAP.md"):
        tconfigs.get_config("no-such-arch-7b")
    assert tconfigs.list_configs() == jlist_configs() == sorted(
        ["smollm-135m", "nemotron-4-15b", *LADDER, *MOE, *SSM, *CONTEXT, *LAST])


@pytest.mark.parametrize("reduced", [False, True])
def test_nemotron_config_equals_reference(reduced):
    """nemotron-4-15b equals the reference's config field for field (and
    reduced): 32 layers, d 6144, 48:8 heads (G = 6) of 128, relu2 d_ff
    24576, vocab 256,000, untied, no QK-norm; ~15.6B parameters."""
    ref, port = get_config("nemotron-4-15b"), tconfigs.get_config("nemotron-4-15b")
    if reduced:
        ref, port = reduce_config(ref), tconfigs.reduce_config(port)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.hd == ref.hd
    if reduced:
        return
    assert (port.n_heads // port.n_kv_heads, port.hd, port.activation) == (6, 128, "relu2")
    assert not port.tie_embeddings and not port.qk_norm
    d, L, F, V = port.d_model, port.n_layers, port.d_ff, port.vocab
    layer = 2 * d * port.n_heads * port.hd + 2 * d * port.n_kv_heads * port.hd + 2 * d * F
    n = 2 * V * d + d + L * (layer + 2 * d)
    assert 15.5e9 < n < 15.7e9, n


def test_narrow_leaves_are_drawn_a_piece_at_a_time(monkeypatch):
    """dense_init and embed_init draw an fp32 leaf whole, as before (smollm's
    and the ladder's draws do not move), and a bf16 leaf in pieces of whole
    rows of its first axis: each piece the fp32 draw of its own shape, cast.
    A row of more entries than ``_PIECE`` is one piece when it is one
    matrix (mistral-large's [12288, 28672]), and a stacked row (a layer of
    kimi-k2's expert bank) is drawn in pieces of its own first axis, each
    again the fp32 draw of its own shape, cast."""
    from repro_torch.models import common

    monkeypatch.setattr(common, "_PIECE", 2 * 16 * 8)

    def gen():
        return torch.Generator().manual_seed(4)

    shape = (5, 16, 8)
    whole = common._truncated_normal(gen(), shape, "cpu") / 4.0
    assert torch.equal(common.dense_init(gen(), shape, fan_in=16), whole)
    g = gen()
    pieces = [common._truncated_normal(g, (n, 16, 8), "cpu") / 4.0 for n in (2, 2, 1)]
    want = torch.cat(pieces).to(torch.bfloat16)
    assert torch.equal(common.dense_init(gen(), shape, fan_in=16, dtype=torch.bfloat16), want)
    emb = common.embed_init(gen(), (6, 64), dtype=torch.bfloat16)  # 4 rows a piece
    g = gen()
    want = torch.cat([common._truncated_normal(g, (n, 64), "cpu") / 8.0 for n in (4, 2)])
    assert torch.equal(emb, want.to(torch.bfloat16))
    # a row of 3 x 16 x 8 = 384 > _PIECE entries that is one matrix: a row a piece
    g = gen()
    want = torch.cat([common._truncated_normal(g, (1, 24, 16), "cpu") / 4.0 for _ in range(3)])
    assert torch.equal(common.dense_init(gen(), (3, 24, 16), fan_in=16, dtype=torch.bfloat16),
                       want.to(torch.bfloat16))
    # stacked rows of 5 x 16 x 8 = 640 > _PIECE entries: each row in pieces of 2
    # matrices of its second axis (2 x 16 x 8 = _PIECE), in order
    g = gen()
    want = torch.stack([torch.cat([common._truncated_normal(g, (n, 16, 8), "cpu") / 4.0
                                   for n in (2, 2, 1)]) for _ in range(2)])
    bank = common.dense_init(gen(), (2, 5, 16, 8), fan_in=16, dtype=torch.bfloat16)
    assert torch.equal(bank, want.to(torch.bfloat16))
    # a stacked row within _PIECE keeps today's pieces of whole rows
    g = gen()
    want = torch.cat([common._truncated_normal(g, (1, 2, 16, 8), "cpu") / 4.0 for _ in range(3)])
    assert torch.equal(common.dense_init(gen(), (3, 2, 16, 8), fan_in=16, dtype=torch.bfloat16),
                       want.to(torch.bfloat16))


@pytest.mark.parametrize("name", LADDER)
def test_ladder_config_equals_reference(name):
    """Every rung of the paper's Tab. 1 ladder equals the reference's field
    for field: full MHA at head dim 128, SwiGLU, QK-norm, post-norms, an
    untied head, vocab 128256."""
    ref, port = get_config(name), tconfigs.get_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.hd == ref.hd == 128 and port.n_kv_heads == port.n_heads
    assert port.post_norm and port.qk_norm and not port.tie_embeddings
    assert port.vocab == 128256 and port.activation == "swiglu"


def test_ladder_tree_paths_labels_and_roundtrip():
    """The ladder's parameter tree at the narrow hd-128 width (post-norm
    scales, q/k norm scales, the untied head): the reference's init crosses
    the numpy bridge and back exactly, the port's own init has the same
    paths, shapes and dtypes, and muon_label labels every path as the
    reference's does (the head and the norms AdamW, the hidden matrices
    Muon)."""
    from repro.optim.muon import muon_label as jmuon_label
    from repro_torch.optim import muon_label

    jcfg = get_config("paper-150m").replace(**LADDER_SMALL)
    tcfg = tconfigs.get_config("paper-150m").replace(**LADDER_SMALL)
    ref = jax.tree.map(np.asarray, build_model(jcfg).init(jax.random.PRNGKey(0)))
    back = params_to_numpy(params_from_numpy(ref, "cpu"))
    ref_leaves = {"/".join(str(k.key) for k in p): x
                  for p, x in jax.tree_util.tree_flatten_with_path(ref)[0]}
    back_leaves = dict(tree_leaves_with_paths(back))
    own = dict(tree_leaves_with_paths(params_to_numpy(
        tbuild_model(tcfg).init(torch.Generator().manual_seed(0), "cpu"))))
    assert sorted(ref_leaves) == sorted(back_leaves) == sorted(own)
    for path in ("head", "layers/ln1_post_scale", "layers/ln2_post_scale",
                 "layers/attn/q_norm_scale", "layers/attn/k_norm_scale"):
        assert path in ref_leaves, path
    assert ref_leaves["layers/attn/wq"].shape == (2, 256, 2 * 128)
    for path, x in ref_leaves.items():
        np.testing.assert_array_equal(back_leaves[path], x)
        assert back_leaves[path].dtype == x.dtype
        assert own[path].shape == x.shape and own[path].dtype == x.dtype, path
        assert muon_label(path, x) == jmuon_label(path, x), path
    assert muon_label("head", ref_leaves["head"]) == "adamw"
    assert muon_label("layers/mlp/w_out", ref_leaves["layers/mlp/w_out"]) == "muon"


@pytest.mark.parametrize("arch_type", ["moe", "ssm", "hybrid", "audio", "vlm"])
def test_unported_family_names_roadmap(arch_type):
    """Every family of the reference builds (each case raised naming
    ROADMAP.md until its family was ported; ``audio`` and ``vlm`` came
    last), and an arch_type the reference does not know raises."""
    cfg = tconfigs.get_config("smollm-135m").replace(arch_type=arch_type)
    assert tbuild_model(cfg).cfg.arch_type == arch_type
    with pytest.raises(ValueError, match="unknown arch_type"):
        tbuild_model(cfg.replace(arch_type="diffusion"))


MOE = ["deepseek-moe-16b", "moonshot-v1-16b-a3b"]
SSM = ["mamba2-370m", "zamba2-2.7b"]
CONTEXT = ["whisper-large-v3", "llama-3.2-vision-90b"]
LAST = ["kimi-k2-1t-a32b", "mistral-large-123b"]


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", MOE)
def test_moe_config_equals_reference(name, reduced):
    """The MoE configs equal the reference's field for field (and reduced:
    4 experts, top-2, one shared). deepseek-moe-16b: 28 layers, d 2048,
    16:16 heads of 128, 64 routed experts of d_ff 1408 top-6 plus 2 shared,
    vocab 102,400, untied, ~16.9B parameters; moonshot-v1-16b-a3b ~28.9B
    (CPU, reduced widths only)."""
    ref, port = get_config(name), tconfigs.get_config(name)
    if reduced:
        ref, port = reduce_config(ref), tconfigs.reduce_config(port)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.hd == ref.hd
    if reduced:
        assert (port.n_experts, port.experts_per_token, port.n_shared_experts) == (4, 2, 1)
        return
    assert (port.arch_type, port.hd, port.n_heads // port.n_kv_heads) == ("moe", 128, 1)
    d, L, F, V, E = port.d_model, port.n_layers, port.d_ff, port.vocab, port.n_experts
    layer = 4 * d * port.n_heads * port.hd + d * E + 3 * E * d * F + 3 * d * F * 2 + 2 * d
    layer += 2 * port.hd  # q/k norm scales
    n = 2 * V * d + d + L * layer
    lo, hi = (16.8e9, 17.0e9) if name == "deepseek-moe-16b" else (28.8e9, 29.0e9)
    assert lo < n < hi, n


def test_moe_tree_paths_labels_and_roundtrip():
    """A reduced deepseek-moe-16b tree: the reference's init crosses the
    numpy bridge and back exactly, the port's own init has the same paths
    (layers/moe/router, layers/moe/experts/*, layers/moe/shared/*), shapes
    and dtypes, and muon_label labels each as the reference's does (the
    router and the expert banks Muon)."""
    from repro.optim.muon import muon_label as jmuon_label
    from repro_torch.optim.muon import muon_label

    jcfg = reduce_config(get_config("deepseek-moe-16b"))
    tcfg = tconfigs.reduce_config(tconfigs.get_config("deepseek-moe-16b"))
    ref = jax.tree.map(np.asarray, jax.jit(build_model(jcfg).init)(jax.random.PRNGKey(0)))
    back = dict(tree_leaves_with_paths(params_to_numpy(params_from_numpy(ref, "cpu"))))
    own = dict(tree_leaves_with_paths(params_to_numpy(
        tbuild_model(tcfg).init(torch.Generator().manual_seed(0), "cpu"))))
    ref_leaves = {"/".join(str(k.key) for k in p): x
                  for p, x in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert sorted(ref_leaves) == sorted(back) == sorted(own)
    assert ref_leaves["layers/moe/experts/w_in"].shape == (2, 4, 256, 512)
    for path, x in ref_leaves.items():
        np.testing.assert_array_equal(back[path], x)
        assert own[path].shape == x.shape and own[path].dtype == x.dtype, path
        assert muon_label(path, x) == jmuon_label(path, x), path
    for path in ("layers/moe/router", "layers/moe/experts/w_out", "layers/moe/shared/w_gate"):
        assert muon_label(path, ref_leaves[path]) == "muon", path


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_no_jax_and_no_reference(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            root = m.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), f"{path}: imports {m}"


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        "repro_torch." + os.path.relpath(os.path.join(r, n), PORT)[:-3].replace(os.sep, ".")
        for r, _, ns in os.walk(PORT) for n in ns if n.endswith(".py") and n != "__init__.py")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
            "from repro_torch.kernels import _build\n"
            "assert not _build._LIBS\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]


def test_params_bridge_roundtrip_is_exact():
    model = build_model(reduce_config(get_config("smollm-135m")))
    ref = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    port = params_from_numpy(ref, "cpu")
    back = params_to_numpy(port)
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert tree_paths(port) == sorted(
        "/".join(str(k.key) for k in path) for path in flat_ref)
    for path, leaf in flat_ref.items():
        got = back
        for k in path:
            got = got[k.key]
        assert got.dtype == leaf.dtype and got.shape == leaf.shape
        np.testing.assert_array_equal(got, leaf)


def test_port_init_matches_reference_tree():
    """The port's own seeded init has the reference's paths, shapes and dtypes."""
    cfg = reduce_config(get_config("smollm-135m"))
    ref = jax.tree.map(np.asarray, build_model(cfg).init(jax.random.PRNGKey(0)))
    tmodel = tbuild_model(tconfigs.reduce_config(tconfigs.get_config("smollm-135m")))
    port = params_to_numpy(tmodel.init(torch.Generator().manual_seed(0), "cpu"))
    ref_leaves = {"/".join(str(k.key) for k in p): x
                  for p, x in jax.tree_util.tree_flatten_with_path(ref)[0]}
    port_leaves = dict(tree_leaves_with_paths(port))
    assert sorted(ref_leaves) == sorted(port_leaves)
    for p, x in ref_leaves.items():
        assert port_leaves[p].shape == x.shape and port_leaves[p].dtype == x.dtype, p
    w = port_leaves["layers/attn/wq"]
    assert abs(w.std() * np.sqrt(cfg.d_model) - 0.98) < 0.05 and np.abs(w).max() <= 3.0 / 16


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", SSM)
def test_ssm_config_equals_reference(name, reduced):
    """mamba2-370m and zamba2-2.7b equal the reference's configs field for
    field, full and reduced. mamba2-370m: 48 layers, d 1024, 32 SSD heads of
    64, N 128, ~420M parameters in the reference's layout; zamba2-2.7b: 54
    mamba layers of d 2560 (80 SSD heads, N 64) in 9 superblocks of 6, one
    shared block of 32:32 heads at hd 80 with window 4096, ~2.42B."""
    ref, port = get_config(name), tconfigs.get_config(name)
    if reduced:
        ref, port = reduce_config(ref), tconfigs.reduce_config(port)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.hd, port.d_inner, port.ssm_heads) == (ref.hd, ref.d_inner, ref.ssm_heads)
    if reduced:
        return
    d, di, N, H, V = port.d_model, port.d_inner, port.ssm_state, port.ssm_heads, port.vocab
    mamba = (d * (2 * di + 2 * N + H) + (port.conv_width + 1) * (di + 2 * N) + 3 * H + di
             + di * d + d)
    n = 2 * V * d + d + port.n_layers * mamba
    if name == "mamba2-370m":
        assert (port.arch_type, H, port.ssm_head_dim) == ("ssm", 32, 64)
        assert 4.1e8 < n < 4.3e8, n
    else:
        assert (port.arch_type, port.hd, port.n_heads, port.n_kv_heads) == ("hybrid", 80, 32, 32)
        assert (port.sliding_window, port.n_layers // port.hybrid_period, H) == (4096, 9, 80)
        n += 4 * d * port.n_heads * port.hd + 2 * port.hd + 3 * d * port.d_ff + 2 * d
        assert 2.40e9 < n < 2.44e9, n


@pytest.mark.parametrize("name", SSM)
def test_ssm_tree_paths_labels_and_roundtrip(name):
    """A reduced mamba2-370m / zamba2-2.7b tree: the reference's init
    crosses the numpy bridge and back exactly, the port's own init has the
    same paths, shapes and dtypes (zamba2's mamba leaves [ns, period, ...],
    its shared block unstacked), and muon_label labels each as the
    reference's does: in_proj, out_proj and the shared block's matrices
    Muon; conv_*, a_log, dt_bias, d_skip, the scales, embed and head AdamW."""
    from repro.optim.muon import muon_label as jmuon_label
    from repro_torch.optim.muon import muon_label

    jcfg = reduce_config(get_config(name))
    tcfg = tconfigs.reduce_config(tconfigs.get_config(name))
    ref = jax.tree.map(np.asarray, jax.jit(build_model(jcfg).init)(jax.random.PRNGKey(0)))
    back = dict(tree_leaves_with_paths(params_to_numpy(params_from_numpy(ref, "cpu"))))
    own = dict(tree_leaves_with_paths(params_to_numpy(
        tbuild_model(tcfg).init(torch.Generator().manual_seed(0), "cpu"))))
    ref_leaves = {"/".join(str(k.key) for k in p): x
                  for p, x in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert sorted(ref_leaves) == sorted(back) == sorted(own)
    for path, x in ref_leaves.items():
        np.testing.assert_array_equal(back[path], x)
        assert own[path].shape == x.shape and own[path].dtype == x.dtype, path
        assert muon_label(path, x) == jmuon_label(path, x), path
    muon = {p for p, x in ref_leaves.items() if muon_label(p, x) == "muon"}
    want = {"layers/mamba/in_proj", "layers/mamba/out_proj"}
    if name == "zamba2-2.7b":
        assert ref_leaves["layers/mamba/in_proj"].shape == (2, 2, 256, 2 * 512 + 2 * 16 + 32)
        want |= {f"shared_block/attn/{w}" for w in ("wq", "wk", "wv", "wo")}
        want |= {f"shared_block/mlp/{w}" for w in ("w_in", "w_gate", "w_out")}
    assert muon == want, sorted(muon)


# ----------------------------------------------- the audio and VLM families


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", CONTEXT)
def test_context_config_equals_reference(name, reduced):
    """whisper-large-v3 and llama-3.2-vision-90b equal the reference's
    configs field for field, full and reduced. whisper: 32 encoder and 32
    decoder layers of d 1280, 20:20 heads of 64, gelu, no QK-norm, 1500
    frames; the VLM: 100 layers (20 superblocks of 1 gated cross + 4 self)
    of d 8192, 64:8 heads of 128 (G = 8), 1600 image tokens."""
    ref, port = get_config(name), tconfigs.get_config(name)
    if reduced:
        ref, port = reduce_config(ref), tconfigs.reduce_config(port)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.hd == ref.hd
    if reduced:
        assert (port.n_layers, port.d_model) == (2 if name == CONTEXT[0] else 4, 256)
    elif name == CONTEXT[0]:
        assert (port.arch_type, port.n_encoder_layers, port.hd, port.n_audio_frames) == (
            "audio", 32, 64, 1500)
    else:
        assert (port.arch_type, port.n_heads // port.n_kv_heads, port.hd,
                port.n_layers // port.vlm_period) == ("vlm", 8, 128, 20)


@pytest.mark.parametrize("name", CONTEXT)
def test_context_full_tree_matches_reference(name):
    """At full size, the port's init (on the meta device: shapes only) has
    the reference's ``init_abstract`` paths, shapes and dtypes, and each
    leaf the reference's muon_label: whisper 1,602,629,120 parameters in 26
    leaves, its 16 [32, ...] stacks and frontend_proj Muon; the VLM
    87,733,929,000 in 28, its self layers [20, 4, ...] and cross layers
    [20, ...], the tanh gates [20] AdamW."""
    from repro.optim.muon import muon_label as jmuon_label
    from repro_torch.optim.muon import muon_label

    ref = {"/".join(str(k.key) for k in p): x for p, x in jax.tree_util.tree_flatten_with_path(
        build_model(get_config(name)).init_abstract())[0]}
    own = dict(tree_leaves_with_paths(tbuild_model(tconfigs.get_config(name)).init(
        torch.Generator().manual_seed(0), "meta")))
    assert sorted(own) == sorted(ref)
    for path, x in ref.items():
        assert tuple(own[path].shape) == x.shape, path
        assert str(own[path].dtype) == f"torch.{x.dtype}", path
        assert muon_label(path, own[path]) == jmuon_label(path, x), path
    n = sum(int(np.prod(x.shape)) for x in ref.values())
    muon = sorted(p for p, x in ref.items() if jmuon_label(p, x) == "muon")
    if name == CONTEXT[0]:
        assert (n, len(ref), len(muon)) == (1_602_629_120, 26, 17)
        assert ref["decoder/layers/mlp/w_out"].shape == (32, 5120, 1280)
    else:
        assert (n, len(ref)) == (87_733_929_000, 28)
        assert ref["self_layers/attn/wq"].shape == (20, 4, 8192, 8192)
        assert ref["cross_layers/attn/gate"].shape == ref["cross_layers/mlp_gate"].shape == (20,)
        assert "cross_layers/attn/gate" not in muon and "image_proj" in muon


# ------------------------------------------- kimi-k2-1t-a32b, mistral-large-123b

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", LAST)
def test_last_configs_equal_reference(name, reduced):
    """kimi-k2-1t-a32b and mistral-large-123b equal the reference's configs
    field for field, full and reduced. kimi-k2: 61 layers, d 7168, 64:8
    heads of 112, 384 routed experts of d_ff 2048 top-8 plus one shared,
    capacity factor 1.25, vocab 163,840, QK-norm, untied; mistral-large: 88
    layers, d 12288, 96:8 heads of 128 (G = 12), SwiGLU d_ff 28672, vocab
    32,768, rope theta 1e6, no QK-norm."""
    ref, port = get_config(name), tconfigs.get_config(name)
    if reduced:
        ref, port = reduce_config(ref), tconfigs.reduce_config(port)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.hd == ref.hd
    if reduced:
        assert (port.n_layers, port.d_model, port.hd) == (2, 256, 64)
    elif name == LAST[0]:
        assert (port.arch_type, port.hd, port.n_heads // port.n_kv_heads) == ("moe", 112, 8)
        assert (port.n_experts, port.experts_per_token, port.n_shared_experts) == (384, 8, 1)
        assert port.qk_norm and not port.tie_embeddings and port.capacity_factor == 1.25
    else:
        assert (port.arch_type, port.hd, port.n_heads // port.n_kv_heads) == ("dense", 128, 12)
        assert (port.d_ff, port.vocab, port.rope_theta, port.qk_norm) == (
            28672, 32768, 1e6, False)


@pytest.mark.parametrize("name", LAST)
def test_last_full_trees_match_reference(name):
    """At full size, the port's init (on the meta device: shapes only) has
    the reference's ``init_abstract`` paths, shapes and dtypes and each leaf
    the reference's muon_label: kimi-k2 1,043,853,453,664 parameters, its
    expert bank [61, 384, 7168, 2048]; mistral-large 122,610,069,504. A
    bf16 init draws kimi-k2's bank a piece of experts at a time
    (``_scaled_draw``), so one layer (19.42B with the embedding and the
    head) fits a card."""
    from repro.optim.muon import muon_label as jmuon_label
    from repro_torch.optim.muon import muon_label

    ref = {"/".join(str(k.key) for k in p): x for p, x in jax.tree_util.tree_flatten_with_path(
        build_model(get_config(name)).init_abstract())[0]}
    own = dict(tree_leaves_with_paths(tbuild_model(tconfigs.get_config(name)).init(
        torch.Generator().manual_seed(0), "meta")))
    assert sorted(own) == sorted(ref)
    for path, x in ref.items():
        assert tuple(own[path].shape) == x.shape, path
        assert str(own[path].dtype) == f"torch.{x.dtype}", path
        assert muon_label(path, own[path]) == jmuon_label(path, x), path
    n = sum(int(np.prod(x.shape)) for x in ref.values())
    if name == LAST[0]:
        assert n == 1_043_853_453_664
        assert ref["layers/moe/experts/w_in"].shape == (61, 384, 7168, 2048)
        assert ref["layers/attn/wk"].shape == (61, 7168, 8 * 112)
    else:
        assert n == 122_610_069_504
        assert ref["layers/attn/wq"].shape == (88, 12288, 96 * 128)


@pytest.mark.parametrize("name", LAST)
def test_last_narrow_tree_paths_labels_and_roundtrip(name):
    """The narrow kimi-k2 (hd 112, G = 8, 6 experts) and mistral-large (G =
    12 at hd 128) trees of test_torch_models.py's ``LAST_SMALL``: the
    reference's init crosses the numpy bridge and back exactly, the port's
    own init has the same paths, shapes and dtypes, and muon_label labels
    each as the reference's does (kimi-k2's router, expert banks and shared
    matrices Muon, its q/k norm scales AdamW; mistral-large's four attention
    and three MLP matrices Muon)."""
    from repro.optim.muon import muon_label as jmuon_label
    from repro_torch.optim.muon import muon_label

    from test_torch_models import LAST_SMALL

    small = LAST_SMALL[name]
    jcfg, tcfg = get_config(name).replace(**small), tconfigs.get_config(name).replace(**small)
    ref = jax.tree.map(np.asarray, jax.jit(build_model(jcfg).init)(jax.random.PRNGKey(0)))
    back = dict(tree_leaves_with_paths(params_to_numpy(params_from_numpy(ref, "cpu"))))
    own = dict(tree_leaves_with_paths(params_to_numpy(
        tbuild_model(tcfg).init(torch.Generator().manual_seed(0), "cpu"))))
    ref_leaves = {"/".join(str(k.key) for k in p): x
                  for p, x in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert sorted(ref_leaves) == sorted(back) == sorted(own)
    for path, x in ref_leaves.items():
        np.testing.assert_array_equal(back[path], x)
        assert own[path].shape == x.shape and own[path].dtype == x.dtype, path
        assert muon_label(path, x) == jmuon_label(path, x), path
    muon = {p for p, x in ref_leaves.items() if muon_label(p, x) == "muon"}
    attn = {f"layers/attn/{w}" for w in ("wq", "wk", "wv", "wo")}
    if name == LAST[0]:
        assert ref_leaves["layers/attn/wq"].shape == (2, 128, 8 * 112)
        assert ref_leaves["layers/moe/experts/w_in"].shape == (2, 6, 128, 32)
        assert muon == attn | {"layers/moe/router"} | {
            f"layers/moe/{g}/{w}" for g in ("experts", "shared")
            for w in ("w_in", "w_gate", "w_out")}
        assert "layers/attn/q_norm_scale" in ref_leaves
    else:
        assert ref_leaves["layers/attn/wq"].shape == (2, 256, 12 * 128)
        assert muon == attn | {f"layers/mlp/{w}" for w in ("w_in", "w_gate", "w_out")}


# ------------------------------------------------------------- the roofline

# the archs the reference's dry run takes (launch/dryrun.py --arch)
ARCHS = list(JASSIGNED) + ["paper-416m", "paper-15.23b"]
K, H = 2, 4
TRAIN, DECODE = "train_4k", "decode_32k"


def _reference_analytic_terms():
    """The reference's ``_analytic_terms``. Importing ``repro.launch.dryrun``
    sets ``XLA_FLAGS`` to a 512-device world; the backend is initialised
    first (so this process keeps its one device) and the variable restored
    (so no later subprocess inherits it)."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import _analytic_terms
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return _analytic_terms


_TREES: dict = {}


def _trees(name: str) -> types.SimpleNamespace:
    """Both packages' config, parameter tree, K = 2 training state and
    decode_32k cache of ``name`` at full width, abstract (built once)."""
    if name not in _TREES:
        jcfg, tcfg = get_config(name), tconfigs.get_config(name)
        jm, tm = build_model(jcfg), tbuild_model(tcfg)
        key = jax.random.PRNGKey(0)
        jp = jax.eval_shape(lambda: jm.init(key))
        tp = terms.abstract_params(tcfg)
        jstate = jax.eval_shape(lambda: jdiloco_init(
            jm, JDiLoCoConfig(n_workers=K, sync_interval=H), JOptimizerConfig(), key))
        tstate = diloco_init(tm, DiLoCoConfig(n_workers=K, sync_interval=H), OptimizerConfig(),
                             torch.Generator(), torch.device("meta"))
        spec = JSHAPES[DECODE]
        jcache = jax.eval_shape(lambda: jm.init_cache(jp, spec.global_batch, spec.seq_len))
        tcache = tm.init_cache(tp, spec.global_batch, spec.seq_len)
        _TREES[name] = types.SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jstate=jstate,
                                             tstate=tstate, jcache=jcache, tcache=tcache)
    return _TREES[name]


@pytest.mark.parametrize("name", ARCHS)
def test_param_counts_and_model_flops_equal_reference(name):
    t = _trees(name)
    n = terms.param_count(t.tcfg)
    assert n == jcount(t.jp) == tree_count_params(t.tp)
    assert analysis.active_params(t.tcfg, n) == janalysis.active_params(t.jcfg, n)
    n_active = analysis.active_params(t.tcfg, n)
    for kind in ("train", "round", "superstep", "prefill", "decode", "sync"):
        for tokens in (256 * 4096, 128):
            assert (analysis.model_flops(kind, n_active, tokens)
                    == janalysis.model_flops(kind, n_active, tokens)), kind


@pytest.mark.parametrize("name", ARCHS)
def test_forward_flops_equal_reference(name):
    """train_4k (B = 256, and one sequence, where the visit schedule
    applies), prefill_32k and decode_32k, plus the flash impl's count."""
    t = _trees(name)
    cases = [dict(S=4096, B=256), dict(S=4096, B=1), dict(S=32768, B=32),
             dict(S=32768, B=1), dict(S=32768, B=128, T=1, kv_len=32768),
             dict(S=524288, B=1, T=1, kv_len=524288)]
    for impl in ("xla", "pallas"):
        jcfg, tcfg = t.jcfg.replace(attn_impl=impl), t.tcfg.replace(attn_impl=impl)
        for c in cases:
            assert flops.forward_flops(tcfg, **c) == jflops.forward_flops(jcfg, **c), (impl, c)


@pytest.mark.parametrize("inner", ["muon", "adamw"])
@pytest.mark.parametrize("name", ARCHS)
def test_train_step_flops_equal_reference(name, inner):
    t = _trees(name)
    got = flops.train_step_flops(t.tcfg, 4096, 256, t.tp, inner)
    want = jflops.train_step_flops(t.jcfg, 4096, 256, t.jp, inner)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.total == want.total
    assert flops.optimizer_flops(t.tp, inner) == jflops.optimizer_flops(t.jp, inner)


@pytest.mark.parametrize("name", ARCHS)
def test_newton_schulz_and_hbm_bytes_equal_reference(name):
    """newton_schulz_flops at every Muon leaf's trailing shape (and its
    transpose), and newton_schulz_part equal to optimizer_flops less its
    elementwise terms; hbm_bytes of each kind at the tree's sizes."""
    t = _trees(name)
    leaves = [(p, x) for p, x in tree_leaves_with_paths(t.tp) if muon_label(p, x) == "muon"]
    assert leaves
    elementwise = 0.0
    for path, leaf in tree_leaves_with_paths(t.tp):
        size = math.prod(leaf.shape)
        elementwise += 6.0 * size if muon_label(path, leaf) == "muon" else 12.0 * size
    for _, x in leaves:
        m, n = int(x.shape[-2]), int(x.shape[-1])
        assert flops.newton_schulz_flops(m, n) == jflops.newton_schulz_flops(m, n)
        assert flops.newton_schulz_flops(n, m, 3) == jflops.newton_schulz_flops(n, m, 3)
    ns = terms.newton_schulz_part(t.tp, "muon")
    assert ns > 0 and terms.newton_schulz_part(t.tp, "adamw") == 0.0
    assert math.isclose(ns + elementwise, flops.optimizer_flops(t.tp, "muon"), rel_tol=1e-12)
    pb, ob = float(tree_bytes(t.tp)), float(tree_bytes(t.tstate["inner_state"]))
    for kind in ("train", "prefill", "decode", "sync"):
        kw = dict(param_bytes_chip=pb, opt_state_bytes_chip=ob, act_bytes_chip=3.0e9,
                  cache_bytes_chip=7.0e9)
        assert flops.hbm_bytes(kind, **kw) == jflops.hbm_bytes(kind, **kw), kind
    with pytest.raises(ValueError):
        flops.hbm_bytes("nope", param_bytes_chip=pb, opt_state_bytes_chip=0.0,
                        act_bytes_chip=0.0)


@pytest.mark.parametrize("kind", ["train", "round", "superstep", "sync", "prefill", "decode"])
@pytest.mark.parametrize("name", ARCHS)
def test_analytic_terms_equal_reference(name, kind):
    """analytic_terms against the reference's dry-run arithmetic, handed a
    stub plan that carries ``meta`` and ``args`` as the dry run's plans do:
    the training kinds at train_4k (K = 2 workers, H = 4, R = 3 for the
    superstep) on 2 and 256 chips, the serving kinds at prefill_32k and
    decode_32k (the state's and the cache's bytes from each package's own
    trees)."""
    t = _trees(name)
    ref = _reference_analytic_terms()
    shape = {"prefill": "prefill_32k", "decode": DECODE}.get(kind, TRAIN)
    R = 3 if kind == "superstep" else 1
    dcfg = JDiLoCoConfig(n_workers=K, sync_interval=H, inner_name="muon")
    meta = {"kind": kind, "dcfg": dcfg, "cfg": t.jcfg}
    if kind == "superstep":
        meta["rounds_per_dispatch"] = R
    args = (t.jp, t.jcache) if kind == "decode" else (t.jstate,)
    plan = types.SimpleNamespace(meta=meta, args=args)
    for chips in (1, 2, 256):
        want = ref(plan, t.jcfg, t.jp, chips, shape)
        got = terms.analytic_terms(kind, t.tcfg, t.tp, shape=shape,
                                   inner_state=t.tstate["inner_state"],
                                   outer_opt=t.tstate["outer_opt"], cache=t.tcache,
                                   chips=chips, inner_name="muon", n_workers=K, H=H, R=R)
        assert got == want, (chips, got, want)
    spec = JSHAPES[shape]
    explicit = terms.analytic_terms(kind, t.tcfg, t.tp, seq_len=spec.seq_len,
                                    global_batch=spec.global_batch,
                                    inner_state=t.tstate["inner_state"],
                                    outer_opt=t.tstate["outer_opt"], cache=t.tcache,
                                    chips=1, n_workers=K, H=H, R=R)
    assert explicit == ref(plan, t.jcfg, t.jp, 1, shape)


def test_analytic_terms_refuses_what_the_reference_cannot_mean():
    t = _trees("smollm-135m")
    with pytest.raises(ValueError, match="plan kind"):
        terms.analytic_terms("step", t.tcfg, t.tp, shape=TRAIN)
    with pytest.raises(ValueError, match="shape name"):
        terms.analytic_terms("prefill", t.tcfg, t.tp, seq_len=4096)
    with pytest.raises(ValueError, match="superstep"):
        terms.analytic_terms("round", t.tcfg, t.tp, shape=TRAIN, R=2)


@pytest.mark.parametrize("name", ARCHS)
def test_roofline_terms_as_dict_equal_reference(name, monkeypatch):
    """RooflineTerms of one train_4k round at the H100's peaks: the
    reference's class, with its TPU peaks swapped for the port's, gives the
    same dict."""
    for attr in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(janalysis, attr, getattr(analysis, attr))
    t = _trees(name)
    f, b = terms.analytic_terms("round", t.tcfg, t.tp, shape=TRAIN,
                                inner_state=t.tstate["inner_state"],
                                outer_opt=t.tstate["outer_opt"], n_workers=K, H=H)
    n = terms.param_count(t.tcfg)
    mf = analysis.model_flops("round", analysis.active_params(t.tcfg, n), 256 * 4096 * H)
    for amortize, coll, wire in ((1.0, 0.0, 0.0), (float(H), 3.0e9, 1.1e9)):
        kw = dict(flops=f, hlo_bytes=b, collective_bytes=coll, chips=1, model_flops=mf,
                  amortize=amortize, wire_bytes=wire)
        got, want = analysis.RooflineTerms(**kw).as_dict(), janalysis.RooflineTerms(**kw).as_dict()
        assert got == want
        assert list(got) == list(want)


def test_peaks_are_the_h100_data_sheet_and_bound_reads_them():
    from repro_torch.core.wallclock import HardwareModel

    assert (analysis.PEAK_FLOPS, analysis.PEAK_FP32_FLOPS, analysis.HBM_BW,
            analysis.LINK_BW) == (989e12, 67e12, 3.35e12, 450e9)
    hw = HardwareModel()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12, 450e9)
    assert analysis.bound(989e9, 3.35e9) == dict(bound_ms=1.0, bound_by="operations")
    assert analysis.bound(67e9, 6.7e9, analysis.PEAK_FP32_FLOPS) == dict(
        bound_ms=2.0, bound_by="bytes")


def test_input_shapes_and_shape_policy_equal_reference():
    assert tconfigs.ASSIGNED_ARCHS == JASSIGNED
    assert set(JASSIGNED) <= set(tconfigs.list_configs())
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    windowed = 0
    for name in tconfigs.list_configs():
        for shape in JSHAPES:
            jc, tc = get_config(name), tconfigs.get_config(name)
            for j, p in ((jc, tc), (reduce_config(jc), tconfigs.reduce_config(tc))):
                assert dataclasses.asdict(tconfigs.config_for_shape(p, shape)) == \
                    dataclasses.asdict(jconfig_for_shape(j, shape)), (name, shape)
                assert tconfigs.shape_supported(p, shape) == jshape_supported(j, shape)
            windowed += tconfigs.config_for_shape(tc, shape).sliding_window != tc.sliding_window
    assert windowed > 0  # the long_500k policy changed some config


def _synthetic_records() -> list:
    """Records of every status the tables render, on both meshes of the
    reference and on one card."""
    recs = []
    for i, (arch, shape, mesh) in enumerate([
            ("smollm-135m", "train_4k", "16x16"), ("smollm-135m", "decode_32k", "16x16"),
            ("kimi-k2-1t-a32b", "train_4k", "2x16x16"), ("mamba2-370m", "long_500k", "16x16"),
            ("zamba2-2.7b", "prefill_32k", terms.MESH), ("whisper-large-v3", "train_4k", "16x16")]):
        t = analysis.RooflineTerms(flops=1.5e15 * (i + 1), hlo_bytes=2.5e12 / (i + 1),
                                   collective_bytes=3.0e10 * i, chips=256,
                                   model_flops=1.0e17 * (i + 2), wire_bytes=1e9 * i)
        recs.append({"arch": arch, "shape": shape, "plan": f"plan{i}", "mesh": mesh,
                     "status": "ok", "compile_s": 12.5 * i, "roofline": t.as_dict(),
                     "memory": {"argument_bytes": 3 * 2**30 + i, "temp_bytes": 2**29 * i,
                                "peak_per_chip_gib": 1.25 * i},
                     "collectives": {"total": 2**31 * i, "flat_total": 2**30 * i}})
    recs.append({"arch": "mistral-large-123b", "shape": "long_500k", "mesh": "16x16",
                 "status": "skipped", "reason": "long_500k not applicable"})
    recs.append({"arch": "nemotron-4-15b", "shape": "train_4k", "plan": "superstep",
                 "mesh": "16x16", "status": "error", "error": "RuntimeError: " + "x" * 100})
    return recs


def test_report_tables_equal_reference(tmp_path):
    recs = _synthetic_records()
    for mesh in ("16x16", "2x16x16", terms.MESH):
        assert report.roofline_table(recs, mesh=mesh) == jreport.roofline_table(recs, mesh=mesh)
    assert report.dryrun_table(recs) == jreport.dryrun_table(recs)
    assert report.roofline_table(recs) == jreport.roofline_table(recs, mesh=terms.MESH)
    assert report.summarize_bottlenecks(recs, "16x16") == jreport.summarize_bottlenecks(recs)
    assert "zamba2-2.7b/prefill_32k/plan4" in report.summarize_bottlenecks(recs)
    (tmp_path / "a.json").write_text(json.dumps(recs[:3]))
    (tmp_path / "b.json").write_text(json.dumps(recs[3:]))
    assert report.load_records(str(tmp_path)) == jreport.load_records(str(tmp_path)) == recs


def test_card_record_renders_in_the_reference_tables():
    """A record of terms.card_record (one measured round) carries the keys
    the reference's tables read, and its shares are the measured ones."""
    cfg = tconfigs.get_config("smollm-135m").replace(attn_impl="pallas")
    params = terms.abstract_params(cfg)
    f, b = terms.analytic_terms("round", cfg, params, seq_len=1024, global_batch=16,
                                n_workers=2, H=4)
    ns = 4 * terms.newton_schulz_part(params, "muon")
    rec = terms.card_record(arch=cfg.name, shape="K2 H4 B8 S1024", plan="round_step",
                            kind="round", cfg=cfg, params=params, flops=f, hbm=b,
                            tokens=16 * 1024 * 4, seconds=1.0, setup_s=0.42,
                            argument_bytes=10 * 2**30, alias_bytes=9 * 2**30,
                            peak_bytes=20 * 2**30, wire_bytes=1.0e9, inner="muon",
                            ns_flops=ns, card="NVIDIA H100 80GB HBM3, 700.00 W")
    assert rec["mesh"] == terms.MESH and rec["compile_s"] == 0.4
    assert rec["memory"]["temp_bytes"] == 10 * 2**30 and rec["memory"]["peak_per_chip_gib"] == 20
    m, r = rec["measured"], rec["roofline"]
    assert m["mfu"] == 6.0 * rec["n_active_params"] * 16 * 1024 * 4 / analysis.PEAK_FLOPS
    assert m["roofline_share"] == max(r["compute_s"], r["memory_s"])
    assert m["compute_fp32_ns_s"] == (f - ns) / analysis.PEAK_FLOPS + ns / analysis.PEAK_FP32_FLOPS
    assert m["compute_fp32_ns_s"] > r["compute_s"]
    assert r["wire_comm_s"] == 1.0e9 / analysis.LINK_BW and r["collective_s"] == 0.0
    for table in (report.roofline_table, jreport.roofline_table):
        assert "| smollm-135m | K2 H4 B8 S1024 | round_step |" in table([rec], mesh=terms.MESH)
    assert report.dryrun_table([rec]) == jreport.dryrun_table([rec])
    # a round that folds in an eval forward of 8 x 1024 tokens: its model
    # FLOPs gain that forward's 2 N_active a token
    fe, be = terms.analytic_terms("prefill", cfg, params, seq_len=1024, global_batch=8)
    ev = terms.card_record(arch=cfg.name, shape="K2 H4 B8 S1024 eval B8 S1024",
                           plan="round_step", kind="round", cfg=cfg, params=params,
                           flops=f + fe, hbm=b + be, tokens=16 * 1024 * 4, seconds=1.0,
                           setup_s=0.42, argument_bytes=10 * 2**30, alias_bytes=9 * 2**30,
                           peak_bytes=20 * 2**30, forward_tokens=8 * 1024)
    assert ev["roofline"]["model_flops"] == (r["model_flops"]
                                             + 2.0 * rec["n_active_params"] * 8 * 1024)
    assert ev["measured"]["mfu"] > m["mfu"] and ev["roofline"]["compute_s"] > r["compute_s"]


# ------------------------------------------------ the count against the port

DENSE_SMALL = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=384,
                   vocab=512, dtype="float32", remat=False)
MOE_SMALL = dict(DENSE_SMALL, d_ff=96)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("family", ["dense", "moe"])
def test_forward_flops_count_what_the_port_computes(family, B):
    """forward_flops against FlopCounterMode on the port's plain forward (the
    'xla' path, S below the blockwise threshold), at a narrow dense and MoE
    config. The projection, MLP, router, shared-expert and head terms agree
    exactly. Two differences are taken out explicitly:

    * the attention scores: the plain forward multiplies the whole S x S
      score and probability matrices (4 B S^2 H hd a layer); the reference
      counts the causal half at B = 1 (``ctx / 2``, flops.py:48-49) and, at
      B > 1, the whole context (its ``full_seq`` test compares the B S
      tokens with S), so at B = 2 the counts agree with nothing taken out;
    * the routed experts: the port's capacity dispatch runs every expert
      over its C capacity slots of each token group (G E C rows), where the
      reference counts the k routed rows of each token (B S k).

    Tolerance: none, the counts are integers well below 2^53."""
    from torch.utils.flop_counter import FlopCounterMode

    base = tconfigs.get_config("smollm-135m" if family == "dense" else "deepseek-moe-16b")
    cfg = base.replace(**(DENSE_SMALL if family == "dense" else MOE_SMALL))
    if family == "moe":
        cfg = cfg.replace(n_experts=8, experts_per_token=2, n_shared_experts=1)
    S = 64
    assert S < cfg.blockwise_threshold and cfg.attn_impl == "xla"
    model = tbuild_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.forward(params, tokens)
    counted = counter.get_total_flops()
    T = B * S
    model_scores = 2.0 * T * cfg.n_heads * cfg.hd * (S / 2.0 if B == 1 else S) * 2.0
    plain_scores = 4.0 * B * S * S * cfg.n_heads * cfg.hd
    want = flops.forward_flops(cfg, S, B) + cfg.n_layers * (plain_scores - model_scores)
    if family == "moe":
        G = tmlp._n_groups(cfg, T)
        C = max(int(T // G * cfg.experts_per_token / cfg.n_experts * cfg.capacity_factor), 4)
        per_row = 3.0 * 2.0 * cfg.d_model * cfg.d_ff
        want += cfg.n_layers * per_row * (G * cfg.n_experts * C - T * cfg.experts_per_token)
    if B == 2:
        assert plain_scores == model_scores
    assert counted == want, (counted, want)


def test_round_counts_one_replicas_optimizer_step():
    """The reference's round counts the optimizer once a step for the whole
    global batch (``train_step_flops`` over one replica's tree), however
    many workers take that step: on one card K = 2 workers each run it, so
    the round's FLOPs at K = 2 equal K = 1's at the same global batch and the
    optimizer's part is a lower bound there (ROADMAP Queue 3). The bytes
    grow with K: each worker's parameters are read."""
    cfg = tconfigs.get_config("smollm-135m")
    params = terms.abstract_params(cfg)
    one = terms.analytic_terms("round", cfg, params, seq_len=1024, global_batch=16,
                               n_workers=1, H=4)
    two = terms.analytic_terms("round", cfg, params, seq_len=1024, global_batch=16,
                               n_workers=2, H=4)
    assert one[0] == two[0] and two[1] > one[1]
    opt = flops.optimizer_flops(params, "muon")
    fwd = flops.forward_flops(cfg, 1024, 16)
    assert one[0] == 4 * (fwd + 2.0 * fwd + opt + fwd) + 10.0 * 3.0 * tree_count_params(params)


# ---------------------------------------------------------------------------
# The mesh's layout rules (launch/sharding.py, launch/steps.py,
# kernels/partition.py) against the reference's, per leaf
# ---------------------------------------------------------------------------

MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _fake_mesh(sizes: dict):
    """What the reference's rules read of a jax Mesh: its axis names and the
    shape of its device array (no 256-device world is made)."""
    return types.SimpleNamespace(axis_names=tuple(sizes),
                                 devices=np.empty(tuple(sizes.values()), dtype=object))


@pytest.fixture
def jsharding(monkeypatch):
    """The reference's sharding module with NamedSharding(mesh, spec)
    answering its spec, so its tree builders return trees of specs."""
    from repro.launch import sharding

    monkeypatch.setattr(sharding, "NamedSharding", lambda mesh, spec: spec)
    return sharding


def _jspecs(tree) -> dict:
    from jax.sharding import PartitionSpec
    from repro.utils.tree import path_str

    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {path_str(p): tuple(s) for p, s in flat}


def _tspecs(tree) -> dict:
    return {p: tuple(s) for p, s in tree_leaves_with_paths(tree)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_state_and_serving_specs_equal_reference(name, mesh, jsharding):
    """The port's specs of the K = 2 full-width TrainState (every group of
    ``diloco_state_shardings``: the worker groups, the outer ZeRO groups,
    the replicated rest; with and without tensor parallelism), of the
    parameters in the serving layout (expert parallel on and off) and of
    the decode_32k cache == the reference's, leaf for leaf, at the sizes
    of 16x16 and 2x16x16."""
    from repro_torch.launch import sharding as tsharding

    t, sizes, fake = _trees(name), MESHES[mesh], _fake_mesh(MESHES[mesh])
    for tp in (True, False):
        want = jsharding.diloco_state_shardings(fake, t.jstate, tensor_parallel=tp)
        got = tsharding.diloco_state_shardings(sizes, t.tstate, tensor_parallel=tp)
        assert set(got) == set(want.keys())
        for field in got:
            assert _tspecs(got[field]) == _jspecs(want[field]), (field, tp)
        for ep in (False, True):
            assert _tspecs(tsharding.params_shardings(sizes, t.tp, tensor_parallel=tp,
                                                      expert_parallel=ep)) == \
                _jspecs(jsharding.params_shardings(fake, t.jp, tensor_parallel=tp,
                                                   expert_parallel=ep)), (tp, ep)
    B = JSHAPES[DECODE].global_batch
    assert _tspecs(tsharding.cache_shardings(sizes, t.tcache, B)) == \
        _jspecs(jsharding.cache_shardings(fake, t.jcache, B))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", ARCHS)
def test_batch_specs_rules_and_kernel_axes_equal_reference(name, mesh, jsharding):
    """The batch spec of a step's [K, B, S] batch, a round's [H, ...] and a
    superstep's [R, H, ...] (with the audio and VLM families' context
    leaf), and the K-less serving batch; ``tp_friendly``;
    ``activation_rules`` for training and serving; and the axes of
    ``kernel_specs`` == the reference's."""
    from repro.launch import steps as jsteps
    from repro_torch.launch import sharding as tsharding
    from repro_torch.launch import steps as tsteps

    t, sizes, fake = _trees(name), MESHES[mesh], _fake_mesh(MESHES[mesh])
    spec = JSHAPES[TRAIN]
    B, S = spec.global_batch // K, spec.seq_len
    lead = {0: (K, B, S), 1: (H, K, B, S), 2: (3, H, K, B, S)}
    for n_lead, shape in lead.items():
        batch = {"tokens": shape}
        if t.jcfg.arch_type in ("audio", "vlm"):
            n = t.jcfg.n_audio_frames if t.jcfg.arch_type == "audio" else t.jcfg.n_image_tokens
            batch["context"] = (*shape[:-1], n, t.jcfg.d_model)
        jbatch = {k: jax.ShapeDtypeStruct(v, np.int32) for k, v in batch.items()}
        tbatch = {k: torch.empty(v, device="meta") for k, v in batch.items()}
        assert _tspecs(tsharding.batch_shardings(sizes, tbatch, True, n_lead)) == \
            _jspecs(jsharding.batch_shardings(fake, jbatch, True, n_lead)), n_lead
    serve = {"tokens": (128, 32768)}
    assert _tspecs(tsharding.batch_shardings(
        sizes, {k: torch.empty(v, device="meta") for k, v in serve.items()}, False)) == \
        _jspecs(jsharding.batch_shardings(
            fake, {k: jax.ShapeDtypeStruct(v, np.int32) for k, v in serve.items()}, False))
    assert tsteps.tp_friendly(t.tcfg, sizes) == jsteps.tp_friendly(t.jcfg, fake)
    for train, b in ((True, B), (False, 128), (False, 1)):
        got = tsteps.activation_rules(sizes, b, t.tcfg, train=train)
        want = jsteps.activation_rules(fake, b, t.jcfg, train=train)
        assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}
    got, want = tsharding.kernel_specs(sizes, t.tcfg), jsharding.kernel_specs(fake, t.jcfg)
    for axes in ("flash_axes", "quantize_axes", "ns_axes", "paged_axes", "outer_tp"):
        assert getattr(got, axes) == getattr(want, axes), axes


AXES_SIZES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
              {"pod": 2, "data": 2, "model": 1}, {"pod": 2, "data": 1, "model": 1},
              {"data": 2, "model": 2}, {"pod": 4, "data": 3, "model": 2}]
PREFERENCES = [("data", "model"), ("pod", "data"), ("data",), ("model", "data"),
               ("pod", "data", "model"), ("model",)]


@pytest.mark.parametrize("sizes", AXES_SIZES, ids=lambda s: "x".join(map(str, s.values())))
def test_axes_for_and_kernel_specs_equal_reference(sizes):
    """``axes_for`` (the longest prefix of the preference whose product
    divides the dim; size-1 axes passed over) and each kernel's spec
    function (flash, paged decode, quantize rows, the Newton-Schulz stack,
    the outer update's shape-preserving spec, TP-friendly or not) == the
    reference's, over dims 1..1024 and leaf shapes of every layout."""
    from repro.kernels import flash_attention as jfa
    from repro.kernels import matmul as jmm
    from repro.kernels import outer_update as jou
    from repro.kernels import partition as jpart
    from repro.kernels import quantize as jq
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import matmul as tmm
    from repro_torch.kernels import outer_update as tou
    from repro_torch.kernels import partition as tpart
    from repro_torch.kernels import quantize as tq

    fake = _fake_mesh(sizes)
    dims = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 256, 512, 1000, 1024]
    for tp in (True, False):
        jp = jpart.KernelPartitioning(mesh=fake, outer_tp=tp)
        tp_ = tpart.KernelPartitioning(mesh=sizes, outer_tp=tp)
        for prefer in PREFERENCES:
            for d in dims:
                assert tpart.axes_for(tp_, d, prefer) == jpart.axes_for(jp, d, prefer), (prefer, d)
        for d in dims:
            assert tuple(map(tuple, tfa.flash_specs(tp_, d))) == \
                tuple(map(tuple, jfa.flash_specs(jp, d))), d
            assert tuple(map(tuple, tfa.paged_specs(tp_, d))) == \
                tuple(map(tuple, jfa.paged_specs(jp, d))), d
            assert tuple(map(tuple, tq.rowwise_specs(tp_, d))) == \
                tuple(map(tuple, jq.rowwise_specs(jp, d))), d
            assert tuple(tmm.ns_stack_spec(tp_, d)) == tuple(jmm.ns_stack_spec(jp, d)), d
            for shape in ((d,), (d, 64), (30, d, 576), (64, d), (4, 8, d, 32)):
                assert tuple(tou.outer_update_spec(tp_, shape)) == \
                    tuple(jou.outer_update_spec(jp, shape)), shape


# (arch, mesh axis sizes, whether a mesh round splits each worker over 'model')
TP_RULES = [("paper-416m", {"data": 1, "model": 2}, True),
            ("paper-416m", {"pod": 2, "data": 1, "model": 4}, True),
            ("paper-416m", {"data": 16, "model": 16}, False),  # 8 heads
            ("smollm-135m", {"data": 1, "model": 2}, False),  # 9 heads
            ("smollm-135m", {"data": 2, "model": 3}, True),
            ("nemotron-4-15b", {"data": 1, "model": 16}, False),  # 8 kv heads
            ("mistral-large-123b", {"data": 2, "model": 8}, True),
            ("deepseek-moe-16b", {"data": 1, "model": 2}, False),  # the MoE family
            ("mamba2-370m", {"data": 1, "model": 2}, False),  # the SSM family
            ("whisper-large-v3", {"data": 1, "model": 2}, False),  # the audio family
            ("paper-416m", {"data": 4, "model": 1}, False)]


@pytest.mark.parametrize("name,sizes,split", TP_RULES,
                         ids=lambda v: "x".join(map(str, v.values())) if isinstance(v, dict)
                         else str(v))
def test_tp_compute_rule(name, sizes, split, jsharding):
    """``launch/steps.tp_compute``: a mesh round splits each worker over
    'model' only for the dense LM whose heads split by the reference's
    ``tp_friendly`` and whose kv heads, d_model and d_ff divide the axis; a
    refusal says why. Where it splits, every leaf it splits
    (``collectives.split_dim``) rests with dim -1 on 'model' in the
    reference's ``param_spec`` (column-parallel leaves keep that block,
    row-parallel ones move to dim -2) and every leaf it keeps whole is not
    a [.., m, n] block matrix of the split layers."""
    from repro.launch import steps as jsteps
    from repro_torch.launch import steps as tsteps
    from repro_torch.core.collectives import split_dim

    tcfg, fake = tconfigs.get_config(name), _fake_mesh(sizes)
    on, why = tsteps.tp_compute(tcfg, sizes)
    assert on == split and (why == "") == split, (on, why)
    assert tsteps.tp_friendly(tcfg, sizes) == jsteps.tp_friendly(get_config(name), fake)
    if not on:
        return
    assert jsteps.tp_friendly(get_config(name), fake)
    jcfg = get_config(name)
    jparams = jax.eval_shape(lambda: build_model(jcfg).init(jax.random.PRNGKey(0)))
    specs = jsharding.params_shardings(fake, jparams, tensor_parallel=True)
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))[0]
    split_leaves = 0
    for path, spec in flat:
        p = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        if split_dim(p) is not None:
            split_leaves += 1
            assert tuple(spec)[-1] == "model", (p, spec)
    assert split_leaves == 7, split_leaves


@pytest.mark.parametrize("path,dim", [
    ("layers/attn/wq", -1), ("layers/attn/wk", -1), ("layers/attn/wv", -1),
    ("layers/mlp/w_in", -1), ("layers/mlp/w_gate", -1), ("layers/attn/wo", -2),
    ("layers/mlp/w_out", -2), ("tx/muon/0/m/layers/attn/wq", -1),
    ("tx/adamw/0/nu/layers/mlp/w_out", -2), ("layers/attn/q_norm_scale", None),
    ("embed", None), ("head", None), ("layers/moe/shared/w_in", None),
    ("layers/attn/wqx", None)])
def test_tensor_parallel_split_dims(path, dim, monkeypatch):
    """``core/collectives.split_dim``: column-parallel leaves split dim -1,
    row-parallel dim -2, a state leaf follows its param's path, and every
    other leaf stays whole; with no 'model' group installed the exchanges
    are the identity and ``whole_shape`` the shape given. With one (rank 1
    of 2, the group's size and rank faked), ``whole_shape`` and
    ``model_block`` read the split."""
    import torch.distributed as dist

    from repro_torch.core import collectives as C

    assert C.split_dim(path) == dim
    x = torch.ones(2, 3)
    assert C.model_group() is None
    assert C.copy_in(x) is x and C.reduce_out(x) is x and C.shared_weight(x) is x
    assert C.whole_shape(path, (4, 6)) == (4, 6)
    group = object()
    monkeypatch.setattr(dist, "get_world_size", lambda g=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda g=None: 1)
    with C.mesh_groups(C.MeshGroups(model=group)):
        assert C.model_group() is group
        want = {None: (4, 6), -1: (4, 12), -2: (8, 6)}[dim]
        assert C.whole_shape(path, (4, 6)) == want
        if dim is not None:
            w = torch.arange(48.0).reshape(8, 6) if dim == -2 else torch.arange(48.0).reshape(4, 12)
            assert torch.equal(C.model_block(w, dim, group), w.chunk(2, dim=dim)[1])
