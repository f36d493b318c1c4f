"""Deterministic synthetic LM data with per-worker shards (port of
``repro/data/synthetic.py``).

A fixed random first-order Markov chain over the vocabulary with a Zipfian
start distribution: the data has real sequential signal (entropy well below
log V). Each DiLoCo worker draws its own chains (the paper's i.i.d. shard
setting).

The transition table is numpy, built exactly as the reference's, so the
"language" is bitwise the same in both packages. The draws are not: the
reference samples with ``jax.random`` (threefry), the port with a
``torch.Generator`` on the batches' device, seeded from (seed, step), so a
batch is still a pure function of its step (resumable, the same for any
chunking) and has the reference's shapes. Tests that compare the two
packages feed both the reference's batches through numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 256
    seq_len: int = 128
    batch_per_worker: int = 8
    n_workers: int = 1
    seed: int = 0       # sampling stream (train vs held-out eval use different seeds)
    table_seed: int = 0  # the "language" (transition table) — shared across streams
    branching: int = 8  # successors per state: entropy ~= log2(branching) bits


def _transition_table(cfg: DataConfig) -> np.ndarray:
    """[vocab, branching] successor table, keyed by ``table_seed`` (not
    ``seed``) so train and eval streams sample the same chain."""
    rng = np.random.default_rng(cfg.table_seed + 1337)
    return rng.integers(0, cfg.vocab, size=(cfg.vocab, cfg.branching), dtype=np.int32)


def _step_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed per (stream seed, global step)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)


class MarkovStream:
    def __init__(self, cfg: DataConfig, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.table = torch.from_numpy(_transition_table(cfg)).long().to(self.device)
        zipf = 1.0 / (np.arange(1, cfg.vocab + 1) ** 1.2)
        self.start_probs = torch.from_numpy(zipf / zipf.sum()).float().to(self.device)

    def batch_stack(self, start_step: int, n_steps: int) -> dict:
        """``n_steps`` consecutive batches: leaves ``[n, K, B, S]`` int32
        (tokens, and labels shifted by one)."""
        cfg = self.cfg
        K, B, length = cfg.n_workers, cfg.batch_per_worker, cfg.seq_len + 1
        states, choices = [], []
        for h in range(n_steps):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(_step_seed(cfg.seed, start_step + h))
            states.append(torch.multinomial(self.start_probs, K * B, replacement=True,
                                            generator=gen))
            choices.append(torch.randint(0, cfg.branching, (K * B, length - 1),
                                         generator=gen, device=self.device))
        state = torch.cat(states)           # [n*K*B] chain starts
        choice = torch.cat(choices)         # [n*K*B, length-1] successor picks
        toks = [state]
        for t in range(length - 1):
            state = self.table[state, choice[:, t]]
            toks.append(state)
        toks = torch.stack(toks, dim=1).to(torch.int32).reshape(n_steps, K, B, length)
        return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}

    def entropy_floor_nats(self) -> float:
        """Per-token entropy of the chain (the achievable loss floor)."""
        return float(np.log(self.cfg.branching))


def batches_for_round(stream: MarkovStream, round_idx: int, sync_interval: int) -> dict:
    """Stacked batches for one DiLoCo round: leaves [H, K, B, S]."""
    return stream.batch_stack(round_idx * sync_interval, sync_interval)
