"""Deterministic synthetic token pipeline, split by process (the port of
``repro.data.pipeline``; numpy only, so batches are bit for bit the
reference's).

Each process makes only its slice of the global batch (``process_index``
of ``process_count``, 0 of 1 by default, where the reference reads
``jax.process_index()``); a step's batch follows from (seed, step,
process) alone, which is what makes a restart from a checkpoint exact;
a background thread keeps ``prefetch`` batches ready.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeCell


@dataclass
class DataConfig:
    seed: int = 0
    prefetch: int = 2
    kind: str = "uniform"   # uniform | markov (learnable bigram structure)
    branching: int = 4      # markov: successors per token


class SyntheticLM:
    """(tokens, labels) batches as numpy arrays; labels are the tokens
    shifted by one.  An encoder-decoder config gets ``frames``/
    ``dec_tokens``, a frontend config ``patch_embeds`` in front of fewer
    tokens."""

    def __init__(self, cfg: ModelConfig, cell: ShapeCell, dcfg: DataConfig,
                 process_index: int = 0, process_count: int = 1):
        self.cfg = cfg
        self.cell = cell
        self.dcfg = dcfg
        self.pi = process_index
        self.pc = process_count
        assert cell.global_batch % self.pc == 0
        self.local_batch = cell.global_batch // self.pc
        if dcfg.kind == "markov":
            # a fixed random bigram table: each token has `branching`
            # successors, so the best cross-entropy is log(branching) <
            # log(V) and the loss falls visibly as the model learns it
            rng = np.random.default_rng(np.random.SeedSequence([dcfg.seed, 7]))
            self.succ = rng.integers(
                0, cfg.vocab_size,
                size=(cfg.vocab_size, dcfg.branching)).astype(np.int32)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.dcfg.seed, step, self.pi]))
        b, s = self.local_batch, self.cell.seq_len
        if self.dcfg.kind == "markov":
            toks = np.empty((b, s + 1), np.int32)
            toks[:, 0] = rng.integers(0, self.cfg.vocab_size, size=b)
            picks = rng.integers(0, self.dcfg.branching, size=(b, s))
            for t in range(s):
                toks[:, t + 1] = self.succ[toks[:, t], picks[:, t]]
        else:
            toks = rng.integers(0, self.cfg.vocab_size, size=(b, s + 1),
                                dtype=np.int32)
        batch = dict(tokens=toks[:, :-1], labels=toks[:, 1:])
        if self.cfg.enc_dec:
            frames = rng.standard_normal((b, s, self.cfg.d_model)).astype(
                np.float32)
            batch = dict(frames=frames, dec_tokens=toks[:, :-1],
                         labels=toks[:, 1:])
        elif self.cfg.frontend:
            p = min(self.cfg.num_frontend_tokens, s // 2)
            pe = rng.standard_normal((b, p, self.cfg.d_model)).astype(
                np.float32)
            labels = toks[:, 1:].copy()
            batch = dict(tokens=toks[:, :s - p], patch_embeds=pe,
                         labels=labels)
        return batch

    def __iter__(self) -> Iterator[dict]:
        return self.iterate(0)

    def iterate(self, start_step: int) -> Iterator[dict]:
        """Batches from ``start_step`` on, made ahead by a background
        thread."""
        q: queue.Queue = queue.Queue(maxsize=max(1, self.dcfg.prefetch))
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                try:
                    q.put(self.batch_at(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
