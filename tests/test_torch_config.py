"""PyTorch port: package hygiene, configs and the weight bridge.

The port (``src/repro_torch``) must equal the JAX reference's configs field
for field, import neither ``jax`` nor anything of ``repro``, and carry
parameter trees across the numpy bridge exactly.
"""
import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config, reduce_config  # noqa: E402
from repro.models import build_model  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import build_model as tbuild_model  # noqa: E402
from repro_torch.utils.tree import (  # noqa: E402
    params_from_numpy,
    params_to_numpy,
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
