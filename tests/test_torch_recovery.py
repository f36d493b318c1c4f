"""PyTorch port: crash safety. Checksummed checkpoints, the health sentinel
against the reference's, rollback, escalation and preemption in the
driver, and the train CLI's crash drills on ``--reduced --device cpu``.

Invariants (those of tests/test_recovery.py, held by the port):

* every checkpoint leaf carries a CRC32: a flipped bit raises
  ``CheckpointError``; a zero-length file is invalid;
* ``load_latest_valid`` walks newest to oldest past damaged files, and
  retention keeps ``keep`` files with a consistent ``LATEST`` manifest;
* the health sentinel's flags and running stats equal the reference's
  ``health_update`` on the same losses and Psi;
* an injected NaN (or loss spike) is rolled back to the last checkpoint and
  its round skipped; no checkpoint to roll back to, or a spent budget, ends
  in ``TrainingAborted``;
* ``should_stop`` preemption leaves a state that resumes to the bitwise
  same trajectory;
* SIGKILL the CLI, resume with ``--resume auto``: metrics.csv, less its
  wall-clock column, is byte-identical to an uninterrupted run's.
"""
import csv
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import HealthConfig as JHealthConfig  # noqa: E402
from repro.core import health_init as jhealth_init  # noqa: E402
from repro.core import health_update as jhealth_update  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    CheckpointError,
    checkpoint_path,
    list_checkpoints,
    load_checkpoint,
    load_latest_valid,
    read_manifest,
    save_checkpoint,
    save_round_checkpoint,
)
from repro_torch.core import DiLoCoConfig, HealthConfig, health_init, health_update  # noqa: E402
from repro_torch.core.faults import CrashPlan, corrupt_file, truncate_file  # noqa: E402
from repro_torch.data import (  # noqa: E402
    DataConfig,
    MarkovStream,
    batches_for_round,
    batches_for_span,
)
from repro_torch.engine import (  # noqa: E402
    RecoveryPolicy,
    TrainEngine,
    TrainingAborted,
    run_rounds,
)
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.optim import OptimizerConfig  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are tiny: one torch thread computes them as fast and
    leaves the cores to the other files of a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------ checksummed checkpoints

def _tree(seed=0, big=False):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((128, 128) if big else (4, 3), generator=g)
    return {"w": w, "inner": {"b": torch.randn((5,), generator=g),
                              "n": torch.arange(4, dtype=torch.int32),
                              "h": torch.randn((3,), generator=g).to(torch.bfloat16)}}


def _assert_trees_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checksum_roundtrip(tmp_path):
    tree = _tree()
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, tree, step=7)
    loaded, step = load_checkpoint(path, tree)
    assert step == 7
    _assert_trees_equal(tree, loaded)


def test_on_disk_bit_flip_raises_checkpoint_error(tmp_path):
    tree = _tree(big=True)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, tree, step=3)
    corrupt_file(path, offset=os.path.getsize(path) // 2)
    with pytest.raises(CheckpointError):
        load_checkpoint(path, tree)


def test_leaf_checksum_catches_tamper_behind_valid_zip(tmp_path):
    """Re-zip with one payload byte flipped: the zip layer is valid again,
    so only the per-leaf CRC32 in the meta record sees it."""
    tree = _tree()
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, tree, step=3)
    with np.load(path) as z:
        members = {k: np.array(z[k]) for k in z.files}
    members["leaf_0"].view(np.uint8).reshape(-1)[0] ^= 0xFF
    np.savez(path, **members)
    with pytest.raises(CheckpointError, match="checksum mismatch"):
        load_checkpoint(path, tree)
    assert load_checkpoint(path, tree, verify=False)


def test_zero_length_file_is_invalid(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, _tree(), step=1)
    truncate_file(path, keep_bytes=0)
    with pytest.raises(CheckpointError):
        load_checkpoint(path, _tree())


def test_retention_prunes_to_keep_and_manifest_tracks(tmp_path):
    d = str(tmp_path)
    for r in (2, 4, 6, 8):
        save_round_checkpoint(d, _tree(seed=r), r, keep=2)
    assert [os.path.basename(p) for _, p in list_checkpoints(d)] == ["ckpt_8.npz", "ckpt_6.npz"]
    man = read_manifest(d)
    assert man["latest"] == "ckpt_8.npz" and man["round"] == 8
    assert sorted(man["retained"]) == ["ckpt_6.npz", "ckpt_8.npz"]
    assert checkpoint_path(d, 8) == os.path.join(d, "ckpt_8.npz")


@pytest.mark.parametrize("damage", [
    lambda p: truncate_file(p, keep_bytes=100),
    lambda p: truncate_file(p, keep_bytes=0),
    lambda p: corrupt_file(p, offset=os.path.getsize(p) // 2),
], ids=["truncated", "zero-length", "bit-flipped"])
def test_load_latest_valid_falls_back_past_damaged_newest(tmp_path, damage):
    d = str(tmp_path)
    good = _tree(seed=4, big=True)
    save_round_checkpoint(d, _tree(seed=2, big=True), 2, keep=3)
    save_round_checkpoint(d, good, 4, keep=3)
    save_round_checkpoint(d, _tree(seed=6, big=True), 6, keep=3)
    damage(checkpoint_path(d, 6))
    tree, step, path = load_latest_valid(d, good)
    assert step == 4 and os.path.basename(path) == "ckpt_4.npz"
    _assert_trees_equal(good, tree)


def test_load_latest_valid_returns_none_when_all_damaged(tmp_path):
    d = str(tmp_path)
    for r in (2, 4):
        save_round_checkpoint(d, _tree(seed=r, big=True), r, keep=3)
        corrupt_file(checkpoint_path(d, r), offset=os.path.getsize(checkpoint_path(d, r)) // 2)
    assert load_latest_valid(d, _tree(big=True)) is None
    assert load_latest_valid(str(tmp_path / "missing"), _tree()) is None


# ------------------------------------------------------- health sentinel

_HKW = dict(enabled=True, spike_factor=3.0, ema_alpha=0.2, warmup_rounds=2)
_HCFG, _JHCFG = HealthConfig(**_HKW), JHealthConfig(**_HKW)


class _Both:
    """The port's and the reference's sentinel fed the same rounds; each
    step asserts equal flags and running stats."""

    def __init__(self):
        self.t, self.j = health_init(_HCFG), jhealth_init(_JHCFG)

    def step(self, losses, psi_val=0.0) -> int:
        losses = np.asarray(losses, np.float32)
        psi = np.full((2,), psi_val, np.float32)
        self.t, tf = health_update(_HCFG, self.t, torch.from_numpy(losses),
                                   {"w": torch.from_numpy(psi)})
        self.j, jf = jhealth_update(_JHCFG, self.j, jnp.asarray(losses),
                                    {"w": jnp.asarray(psi)})
        assert float(tf) == float(jf)
        assert int(self.t["n"]) == int(self.j["n"])
        np.testing.assert_array_equal(self.t["ema"].numpy(), np.asarray(self.j["ema"]))
        return int(tf)


def test_health_disabled_is_none_and_noop():
    assert health_init(HealthConfig()) is None
    assert "health" not in _engine()[1]


def test_health_flags_nonfinite_loss_and_psi():
    h = _Both()
    assert h.step([1.0, np.nan]) & 1
    assert h.step([1.0, 1.0], psi_val=np.inf) & 2
    assert h.step([1.0, 1.0]) == 0


def test_health_spike_fires_only_after_warmup():
    assert _Both().step([100.0, 100.0]) == 0  # round 0: in warmup
    h = _Both()
    for _ in range(3):
        assert h.step([2.0, 2.0]) == 0
    assert h.step([20.0, 20.0]) & 4  # 10x the EMA, past warmup
    for _ in range(8):  # a finite spike updates the EMA: a plateau stops flagging
        flag = h.step([20.0, 20.0])
    assert flag == 0


# ------------------------------------- driver: rollback, escalation, stop

_CFG = ModelConfig(arch_type="dense", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                   d_ff=64, vocab=64, remat=False, dtype="float32", qk_norm=True)


def _engine(health=False):
    dcfg = DiLoCoConfig(n_workers=2, sync_interval=2, inner_name="adamw",
                        health=HealthConfig(enabled=health, warmup_rounds=1))
    engine = TrainEngine(build_model(_CFG), dcfg, OptimizerConfig(lr=1e-2, weight_decay=0.0))
    return engine, engine.init(torch.Generator().manual_seed(0), "cpu")


def _run(engine, state, rounds, start=0, **kw):
    data = MarkovStream(DataConfig(vocab=_CFG.vocab, seq_len=16, batch_per_worker=2,
                                   n_workers=2, seed=3))
    return run_rounds(engine, state, lambda r: batches_for_round(data, r, 2), rounds,
                      start=start, rounds_per_dispatch=1,
                      span_batches_for=lambda r0, n: batches_for_span(data, r0, 2, n), **kw)


def test_nan_fault_rolls_back_and_skips_offending_round(tmp_path):
    engine, state = _engine(health=True)
    template = _engine(health=True)[1]
    d = str(tmp_path)
    save_round_checkpoint(d, state, 0)
    telemetry: dict = {}
    recovery = RecoveryPolicy(restore=lambda: load_latest_valid(d, template)[:2])
    state, history = _run(engine, state, 4, telemetry=telemetry, recovery=recovery,
                          inject=CrashPlan(nan_round=2).apply,
                          on_state=lambda r, st: save_round_checkpoint(d, st, r + 1),
                          on_state_every=1)
    assert [h["round"] for h in history] == [0, 1, 3]  # round 2 skipped
    assert telemetry["rollbacks"] == 1 and telemetry["skipped_rounds"] == 1
    assert all(np.isfinite(h["train_loss"]) and h["health"] == 0 for h in history)
    assert int(state["round"]) == 4
    assert all(torch.isfinite(x).all() for x in tree_leaves(state["outer_params"]))


def test_recovery_without_valid_checkpoint_aborts():
    engine, state = _engine(health=True)
    with pytest.raises(TrainingAborted, match="no valid checkpoint"):
        _run(engine, state, 3, recovery=RecoveryPolicy(restore=lambda: None),
             inject=CrashPlan(nan_round=1).apply, telemetry={})


def test_escalation_exhausts_rollbacks_then_aborts(tmp_path):
    """Every retry is poisoned again, so the rollback budget bounds the loop
    and, with no scale_lr, the run aborts."""
    engine, state = _engine(health=True)
    template = _engine(health=True)[1]
    d = str(tmp_path)
    save_round_checkpoint(d, state, 0)
    always = CrashPlan(nan_round=0)
    recovery = RecoveryPolicy(restore=lambda: load_latest_valid(d, template)[:2],
                              max_rollbacks=2)
    telemetry: dict = {}
    with pytest.raises(TrainingAborted, match="budgets exhausted"):
        _run(engine, state, 3, recovery=recovery, telemetry=telemetry,
             inject=lambda r0, n, b, s: always.apply(0, n, b, s))
    assert telemetry["rollbacks"] == 2


def test_escalation_backs_off_the_lr_through_scale_lr(tmp_path):
    """With scale_lr the spent budget first rebuilds the engine at half the
    LR and refills; the rebuilt engine runs the rest."""
    engine, state = _engine(health=True)
    template = _engine(health=True)[1]
    d = str(tmp_path)
    save_round_checkpoint(d, state, 0)
    built = []

    def scale_lr(scale):
        built.append(scale)
        return TrainEngine(engine.model, engine.dcfg,
                           OptimizerConfig(lr=1e-2 * scale, weight_decay=0.0))

    recovery = RecoveryPolicy(restore=lambda: load_latest_valid(d, template)[:2],
                              max_rollbacks=1, scale_lr=scale_lr)
    nan_at = iter([0, 1])  # the first two dispatches are poisoned
    telemetry: dict = {}
    state, hist = _run(engine, state, 3, recovery=recovery, telemetry=telemetry,
                       max_in_flight=0,  # drain each dispatch before the next
                       inject=lambda r0, n, b, s: CrashPlan(nan_round=next(nan_at, -1))
                       .apply(r0, n, b, s))
    assert built == [0.5] and telemetry["lr_scale"] == 0.5
    assert telemetry["rollbacks"] == 2
    assert [h["round"] for h in hist] == [2]


def test_should_stop_preempts_and_resumes_bitwise():
    engine, state = _engine()
    full_hist = _run(engine, _engine()[1], 4)[1]
    probes = iter([False, False, True])  # stop before the third dispatch
    telemetry: dict = {}
    state, hist = _run(engine, state, 4, telemetry=telemetry,
                       should_stop=lambda: next(probes, True))
    assert telemetry["preempted"] is True
    done = int(state["round"])
    assert done == 2 and [h["round"] for h in hist] == [0, 1]
    state, tail = _run(engine, state, 4, start=done)
    assert [h["round"] for h in tail] == [2, 3]
    for a, b in zip(full_hist, hist + tail):
        assert a["train_loss"] == b["train_loss"]  # bitwise


def test_crash_plan_dispatch_pinning_and_in_place_poison():
    assert CrashPlan().is_trivial
    assert not CrashPlan(kill_round=3).needs_single_round_dispatch
    assert CrashPlan(nan_round=1).needs_single_round_dispatch
    assert CrashPlan(spike_round=1).needs_single_round_dispatch
    _, state = _engine()
    leaf = state["worker_params"]["embed"]  # the first path, as jax.tree.leaves orders it
    b, s = CrashPlan(spike_round=2).apply(2, 1, {"tokens": 0}, state)
    assert s is state and b == {"tokens": 0}
    assert float(leaf[0, 0, 0]) == 100.0 and float(leaf[1, 0, 0]) != 100.0


# ------------------------------------------------------ the train CLI

_BASE = ["--reduced", "--device", "cpu", "--inner", "adamw", "--lr", "4e-3", "--workers", "2",
         "--sync-interval", "2", "--rounds", "4", "--batch-per-worker", "2", "--seq-len", "16",
         "--seed", "0", "--checkpoint-every", "1"]


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("flag,code", [("--inject-nan-round", 3), ("--inject-spike-round", 4)])
def test_train_cli_injection_rolls_back_and_completes(tmp_path, capsys, flag, code):
    """--health-sentinel on with a NaN (flag bits 1 and 2: loss and Psi) or a
    finite spike (bit 4) injected at round 2: one rollback to ckpt_2, round 2 skipped and never
    logged, the run completes with finite losses."""
    out = ttrain.train(ttrain.build_parser().parse_args(
        _BASE + ["--health-sentinel", "on", "--health-warmup", "1", flag, "2",
                 "--out", str(tmp_path)]))
    text = capsys.readouterr().out
    assert f"recovery: round 2 flagged (code {code})" in text
    assert out["telemetry"]["rollbacks"] == 1 and out["telemetry"]["skipped_rounds"] == 1
    assert np.isfinite(out["final_loss"])
    rows = _rows(tmp_path / "metrics.csv")
    assert [int(r["round"]) for r in rows] == [0, 1, 3]
    assert all(r["health"] == "0" for r in rows) and rows[-1]["rollbacks"] == "1"


def test_train_cli_checkpoint_in_program(tmp_path, capsys):
    """--checkpoint-in-program: the whole run is one dispatch ("auto") and
    the checkpoints equal, byte for byte, those of a run that checkpoints
    between dispatches; --keep-checkpoints prunes them."""
    args = [a if a != "1" else "2" for a in _BASE] + ["--keep-checkpoints", "5"]
    ttrain.train(ttrain.build_parser().parse_args(args + ["--out", str(tmp_path / "host")]))
    host = capsys.readouterr().out
    ttrain.train(ttrain.build_parser().parse_args(
        args + ["--checkpoint-in-program", "--out", str(tmp_path / "prog")]))
    prog = capsys.readouterr().out
    assert "dispatches=2 rounds_per_dispatch=2 in_program_checkpoints=False" in host
    assert "dispatches=1 rounds_per_dispatch=4 in_program_checkpoints=True" in prog
    names = [os.path.basename(p) for _, p in list_checkpoints(str(tmp_path / "prog"))]
    assert names == ["ckpt_4.npz", "ckpt_2.npz"]
    for n in names:
        with np.load(tmp_path / "host" / n) as a, np.load(tmp_path / "prog" / n) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert read_manifest(str(tmp_path / "prog"))["latest"] == "ckpt_4.npz"


def _cli(args, out):
    # one thread a run: the three runs of a drill compute alike, and they do
    # not crowd the cores of a parallel test run
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "OMP_NUM_THREADS": "1",
           "MKL_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args,
                           "--out", str(out)], capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=600)


def _rows_sans_wall(path):
    with open(path, newline="") as f:
        return [row[:-1] for row in csv.reader(f)]


@pytest.mark.parametrize("inner", ["adamw", "muon"])
def test_sigkill_resume_metrics_bitwise(tmp_path, inner):
    """SIGKILL at round 2 (--checkpoint-every 1 --inject-kill-round 2), then
    --resume auto: metrics.csv, less wall_s, is byte-identical to an
    uninterrupted run's."""
    base = [a if a != "adamw" else inner for a in _BASE]
    ref = _cli(base, tmp_path / "ref")
    assert ref.returncode == 0, ref.stderr
    killed = _cli(base + ["--inject-kill-round", "2"], tmp_path / "crash")
    assert killed.returncode == -signal.SIGKILL
    assert os.path.exists(tmp_path / "crash" / "ckpt_2.npz")
    assert not os.path.exists(tmp_path / "crash" / "ckpt_3.npz")
    resumed = _cli(base + ["--resume", "auto"], tmp_path / "crash")
    assert resumed.returncode == 0, resumed.stderr
    assert "resume telemetry: resumed_from=ckpt_2.npz start_round=2" in resumed.stdout
    got = _rows_sans_wall(tmp_path / "crash" / "metrics.csv")
    assert got == _rows_sans_wall(tmp_path / "ref" / "metrics.csv")
    assert [r[0] for r in got[1:]] == ["0", "1", "2", "3"]


def test_resume_from_explicit_checkpoint_and_preempt_checkpoint(tmp_path, capsys):
    """--resume <file> restarts at the file's round; a preempted run (the
    SIGTERM handler's flag) drains and writes a resumable checkpoint."""
    args = ttrain.build_parser().parse_args(_BASE + ["--out", str(tmp_path)])
    ttrain.train(args)
    full = _rows_sans_wall(tmp_path / "metrics.csv")
    ttrain.train(ttrain.build_parser().parse_args(
        _BASE + ["--resume", str(tmp_path / "ckpt_3.npz"), "--out", str(tmp_path)]))
    assert "resume telemetry: resumed_from=ckpt_3.npz start_round=3" in capsys.readouterr().out
    assert _rows_sans_wall(tmp_path / "metrics.csv") == full
    # preemption: the driver's should_stop sees the handler's flag set
    orig = ttrain.run_rounds

    def stopped(*a, **kw):
        probes = iter([False, True])
        kw["should_stop"] = lambda: next(probes, True)
        return orig(*a, **kw)

    ttrain.run_rounds = stopped
    try:
        ttrain.train(ttrain.build_parser().parse_args(
            [a if a != "--checkpoint-every" else "--rounds-per-dispatch" for a in _BASE]
            + ["--out", str(tmp_path / "pre")]))
    finally:
        ttrain.run_rounds = orig
    text = capsys.readouterr().out
    assert "preempted after round 0: wrote ckpt_1.npz" in text and "preempted=True" in text
