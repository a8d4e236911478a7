"""The training loop: the train step, the data pipeline, checkpoints and
restarts, straggler monitoring (the port of ``repro.train.loop``).

Data is keyed by step, so a run restored from a checkpoint continues
exactly as an uninterrupted one would.  The trainer runs on its bundle's
device (the card unless the bundle was built for another); params are
drawn there from a ``torch.Generator`` seeded with ``TrainConfig.seed``.
Over a mesh of more than one device the whole tree is drawn on the
mesh's first device and then cut into the policy's blocks
(:class:`~repro_torch.dist.sharding.Sharded`), so a mesh run starts from
the one-device run's weights; each step's batch is placed as each data
row's slice, and a checkpoint restores onto the trainer's mesh, whatever
the mesh that wrote it (the elastic restore).
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.dist import sharding as sh
from repro_torch.dist.steps import make_train_step, shard_state
from repro_torch.models.registry import ModelBundle, build
from repro_torch.optim import adamw
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault import FailureInjector, StragglerMonitor

log = logging.getLogger("repro_torch.train")


@dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    seed: int = 0
    data_kind: str = "uniform"     # uniform | markov
    microbatches: int = 1


class Trainer:
    def __init__(self, bundle: ModelBundle, cell: ShapeCell, mesh,
                 policy: sh.ShardingPolicy, opt_cfg: adamw.AdamWConfig,
                 tcfg: TrainConfig,
                 injector: Optional[FailureInjector] = None):
        if bundle.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA card is visible: the trainer runs on its bundle's "
                "device, 'cuda'; build the bundle with device='cpu' to "
                "train on the CPU")
        self.bundle = bundle
        self.device = bundle.device
        self.cell = cell
        self.mesh = mesh
        self.policy = policy
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.injector = injector
        (self.step_fn, self.p_shard, self.o_shard,
         self.batch_sharder) = make_train_step(
            bundle, mesh, policy, opt_cfg, microbatches=tcfg.microbatches)
        self.data = SyntheticLM(
            bundle.cfg, cell, DataConfig(seed=tcfg.seed, kind=tcfg.data_kind))
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
                     if tcfg.ckpt_dir else None)
        self.monitor = StragglerMonitor()
        self.history: list = []

    def init_state(self, generator: Optional[torch.Generator] = None):
        """(params drawn on the trainer's device, fresh AdamW state, 0);
        over a mesh both cut into the policy's blocks."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(
                self.tcfg.seed)
        params = self.bundle.init(generator)
        return shard_state(params, self.p_shard, self.mesh) + (0,)

    def restore_state(self, step: Optional[int] = None):
        """(params, optimizer state, step) of a checkpoint (None: the
        latest), onto the trainer's device, or cut onto its mesh."""
        abs_params, _ = self.bundle.abstract_params()
        opt_like = adamw.AdamWState(step=None, m=abs_params, v=abs_params)
        shardings = None
        if len(self.mesh.devices) > 1:
            shardings = dict(params=self.p_shard, opt=self.o_shard)
        restored = self.ckpt.restore(
            step, dict(params=abs_params, opt=opt_like), self.device,
            shardings=shardings, mesh=self.mesh)
        opt = restored["opt"]
        start = int(opt.step)
        return restored["params"], opt, start

    def run(self, resume: Optional[int] = None) -> int:
        """Train to ``tcfg.steps``; ``resume`` (a step, or -1 for the
        latest) restarts from a checkpoint when there is one.  Returns the
        final step; ``self._final`` holds (params, optimizer state)."""
        self._final = None
        if resume is not None and self.ckpt and self.ckpt.latest_step() is not None:
            params, opt_state, start = self.restore_state(
                None if resume == -1 else resume)
            log.info("restored at step %d", start)
        else:
            params, opt_state, start = self.init_state()
        it = self.data.iterate(start)
        step = start
        for batch in it:
            if step >= self.tcfg.steps:
                break
            if self.injector:
                self.injector.maybe_fail(step)
            t0 = time.perf_counter()
            batch = self._put(batch)
            params, opt_state, metrics = self.step_fn(params, opt_state, batch)
            loss = float(metrics["loss"])        # waits for the step
            dt = time.perf_counter() - t0
            self.monitor.record(step, dt)
            step += 1
            if step % self.tcfg.log_every == 0 or step == self.tcfg.steps:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=step, sec=dt, tok_s=self.cell.tokens / dt)
                self.history.append(m)
                log.info("step %d loss %.4f (%.3fs)", step, loss, dt)
            if self.ckpt and (step % self.tcfg.ckpt_every == 0
                              or step == self.tcfg.steps):
                self.ckpt.save(step, dict(params=params, opt=opt_state))
        if self.ckpt:
            self.ckpt.wait()
        self._final = (params, opt_state)
        return step

    def _put(self, batch: dict) -> dict:
        """A numpy batch onto the trainer's device; over a mesh, each data
        row's slice onto the row's first device
        (:func:`~repro_torch.models.sharded.place_batch`)."""
        whole = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in batch.items()}
        if len(self.mesh.devices) > 1:
            from repro_torch.dist.steps import with_policy
            from repro_torch.models.sharded import place_batch
            flags = with_policy(self.bundle, self.mesh, self.policy).flags
            return place_batch(whole, flags)
        return {k: v.to(self.device) for k, v in whole.items()}


def quick_train(cfg: ModelConfig, cell: ShapeCell, mesh, steps: int = 5,
                policy_name: str = "fsdp_tp", flags=None, device=None,
                **tkw):
    """Build, train ``steps`` steps at lr 1e-3 and return the trainer."""
    from repro_torch.models.transformer import RuntimeFlags
    bundle = build(cfg, flags or RuntimeFlags(), device=device)
    tr = Trainer(bundle, cell, mesh, sh.POLICIES[policy_name],
                 adamw.AdamWConfig(lr=1e-3), TrainConfig(steps=steps, **tkw))
    tr.run()
    return tr
