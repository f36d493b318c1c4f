#!/usr/bin/env python3
"""Training rate of two trees in turns, in one call on one card.

    python3 tools/ab_train.py PARENT_DIR [--rounds 5]

Runs ``repro_torch.launch.train`` with ``chip_smoke.TRAIN`` (the training
main path at full width) from PARENT_DIR and from this tree in the order
parent, change, change, parent, each in a fresh process that builds its own
kernels, and prints each run's round walls, eval losses and training
tokens/s over the rounds after the first. PARENT_DIR is an unpacked checkout
of the other commit (``git archive <commit> | tar -x -C build/parent``).
Host-clock rates vary between calls, so compare two trees only within one
call. Needs one card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import TRAIN  # noqa: E402


def run(tree: Path, rounds: int, out: Path) -> tuple[list[float], list[str]]:
    argv = list(TRAIN)
    argv[argv.index("--rounds") + 1] = str(rounds)
    argv[argv.index("--out") + 1] = str(out)
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *argv],
                         capture_output=True, text=True, env=env, cwd=tree, timeout=900)
    walls = [float(w) for w in re.findall(r"wall ([0-9.]+)s", res.stdout)]
    if res.returncode or len(walls) != rounds:
        raise SystemExit(f"{tree}: exit {res.returncode}\n{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
    return walls, re.findall(r"eval ([0-9.]+)", res.stdout)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card (nvidia-smi name, power.limit): {smi}", flush=True)
    trees = {"parent": args.parent.resolve(), "change": ROOT}
    rates: dict[str, list[float]] = {name: [] for name in trees}
    for i, name in enumerate(("parent", "change", "change", "parent")):
        walls, evals = run(trees[name], args.rounds, ROOT / "build" / f"ab_train_{i}")
        tokens = 65536  # K * H * B * S of chip_smoke.TRAIN
        rates[name].append(tokens * (len(walls) - 1) / sum(walls[1:]))
        print(f"run {i} {name}: round walls {walls} s, eval {evals}: {rates[name][-1]:.1f} "
              f"tokens/s over rounds 2-{len(walls)}", flush=True)
    print(json.dumps(rates))
    return 0


if __name__ == "__main__":
    sys.exit(main())
