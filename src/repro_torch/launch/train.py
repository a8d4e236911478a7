"""Training launcher (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --smoke --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \
        --smoke --mesh-model 2 --devices cpu,cpu,cpu,cpu --steps 3

Trains on the card unless ``--device`` names another device.  Without
``--smoke`` the config runs in float32 (params and compute), as the
reference's launcher sets it; the flags are the reference launcher's:
``chunked`` attention with 128-token blocks, a loss chunk of 128, the
dense MoE dispatch, AdamW at ``--lr`` under ``warmup_cosine(10,
steps)``.  Failures are retried with a restore from the latest
checkpoint (``--max-failures``); data keyed by step makes the recovery
exact.  The mesh is ``(n // m, m)`` over ``("data", "model")``, ``m``
being ``--mesh-model`` and ``n`` the devices of the group: ``--devices``
names it (a group may repeat a device: ``cpu,cpu,cpu,cpu``, or
``cuda:0`` four times); without it the group is the visible cards, each
once, when ``--mesh-model`` is above 1, and ``--device`` alone
otherwise.
"""
import argparse
import logging
import sys

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, ShapeCell, override, smoke_config
from repro_torch.dist import POLICIES
from repro_torch.launch.mesh import Mesh, visible_devices
from repro_torch.models import RuntimeFlags, build
from repro_torch.optim import AdamWConfig, schedule
from repro_torch.train import TrainConfig, Trainer, run_with_recovery

FLAGS = RuntimeFlags(attn_impl="chunked", attn_bq=128, attn_bkv=128,
                     loss_chunk=128, moe_impl="dense")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--policy", default="fsdp_tp", choices=sorted(POLICIES))
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--data", default="markov", choices=["markov", "uniform"])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--max-failures", type=int, default=3)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="the device to train on (default: the card; "
                         "'cpu' runs the plain PyTorch path)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated device group of the mesh (may "
                         "repeat a device); default: the visible cards "
                         "when --mesh-model is above 1")
    return ap


def mesh_of(args) -> Mesh:
    """The ``(n // m, m)`` data x model mesh of the launcher's device
    group; exits naming the shortfall when the group has fewer than
    ``m`` devices."""
    m = args.mesh_model
    if args.devices:
        devs = [torch.device(d) for d in args.devices.split(",")]
    elif m > 1:
        devs = visible_devices()
    else:
        devs = [resolve_device(args.device)]
    if m < 1 or len(devs) < m:
        raise SystemExit(
            f"--mesh-model {m} needs {m} devices, have {len(devs)}"
            + ("" if args.devices else
               " (the visible cards; name a group with --devices, which "
               "may repeat a device)"))
    n = len(devs) // m * m
    return Mesh(("data", "model"), (n // m, m), tuple(devs[:n]))


def build_trainer(args) -> Trainer:
    """The trainer ``main`` runs, from parsed arguments."""
    mesh = mesh_of(args)
    device = mesh.devices[0]
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = smoke_config(cfg)
    else:
        cfg = override(cfg, param_dtype="float32", compute_dtype="float32")
    bundle = build(cfg, FLAGS, device=device)
    cell = ShapeCell("cli", "train", args.seq, args.batch)
    opt = AdamWConfig(lr=args.lr,
                      schedule=schedule.warmup_cosine(10, args.steps))
    tcfg = TrainConfig(steps=args.steps, ckpt_dir=args.ckpt,
                       ckpt_every=max(10, args.steps // 5), log_every=5,
                       data_kind=args.data,
                       microbatches=args.micro)
    return Trainer(bundle, cell, mesh, POLICIES[args.policy], opt, tcfg)


def main(argv=None):
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    tr = build_trainer(args)

    def run(resume):
        return tr.run(resume if resume is not None
                      else (-1 if args.resume else None))

    final = run_with_recovery(run, max_failures=args.max_failures)
    print(f"finished at step {final} on {tr.device}; last metrics: "
          f"{tr.history[-1] if tr.history else {}}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
