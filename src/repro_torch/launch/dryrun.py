"""Multi-pod dry-run on the meta device: trace every (arch x shape) cell's
step over the production meshes and account its memory, FLOPs, bytes
and collectives per device (the port of ``repro.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --roofline

The reference lowers and compiles each cell for 256 or 512 fake TPU
devices.  Here the step itself (:mod:`repro_torch.dist.steps`) runs over
a mesh of ``meta`` devices (:func:`~repro_torch.launch.mesh.
make_production_mesh`): the single controller drives all of them, each
op on shapes only, and :func:`repro_torch.core.roofline.trace_step`
attributes every op to its device.  No card and no memory are needed.
Per cell and mesh the record holds each device's argument bytes (the
blocks of params and optimizer state, or of the decode cache, and the
batch slice it holds), its peak (arguments and live tensors), its FLOPs,
bytes and received collective bytes, and the busiest device's figures
beside the card's 80 GiB (``fits_80g``).  A mesh of up to
``FULL_DEPTH_DEVICES`` devices is traced at full depth; a production
mesh at one and two pattern blocks, each per-device figure extrapolated
affinely to full depth (``depth="extrapolated"``: the blocks repeat, so
params, state, FLOPs, bytes and the layer-boundary activations are
affine in their count; one trace of 256 devices takes about 25 s a
layer on one host core, most of it in PyTorch's meta kernels).  The
roofline terms come from the single-pod mesh's counts (``--roofline``:
from two traces at one and two pattern blocks under the reference's
roofline flags, :func:`default_flags`, extrapolated, as the reference
does), over the H100's rates.

A cell that fails to trace records ``status: "fail"`` with the reason,
as a compile failure is recorded in the reference.

Records go to ``runs/dryrun_torch.json`` (the port's ``roofline`` sweep
reads it when it exists); the JAX package's ``runs/dryrun*.json`` are
never written.
"""
import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

from repro_torch.configs import (ARCHS, LM_SHAPES, SHAPES_BY_NAME, override,
                                 shape_applicable)
from repro_torch.configs.base import DECODE, PREFILL, TRAIN, ModelConfig, \
    ShapeCell
import repro_torch.core.roofline as rl
from repro_torch.dist import POLICIES
from repro_torch.dist.sharding import Sharded, cut_tree
from repro_torch.dist.steps import (make_decode_step, make_prefill_step,
                                    make_train_step, with_policy)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import RuntimeFlags, build
from repro_torch.optim import AdamWConfig, adamw
from repro_torch.tree import leaves

DEFAULT_OUT = os.path.join("runs", "dryrun_torch.json")
GIB = 2 ** 30
FULL_DEPTH_DEVICES = 16      # larger meshes are traced at 1 and 2 blocks


def default_flags(roofline: bool = False) -> RuntimeFlags:
    """The reference's deployed flags (chunked attention at 2048-token
    blocks, the sorted MoE dispatch, remat ``full``, loss chunks of 512);
    ``roofline`` gives the reference's roofline flags: the loss in one
    shot and the ``unrolled`` attention at the same blocks, which skips
    the blocks wholly in the future or out of the window and counts the
    rest's bytes apart (``bytes_flash_inner``).  So a roofline record of
    a causal or windowed cell counts fewer FLOPs and bytes than the
    ``chunked`` trace, which visits every block, and its
    ``bytes_flash_inner`` is not 0.  The reference's ``unroll_layers``
    has no counterpart: the port's block loops are Python loops."""
    if roofline:
        return RuntimeFlags(attn_impl="unrolled", attn_bq=2048,
                            attn_bkv=2048, moe_impl="sorted", loss_chunk=0,
                            remat="full")
    return RuntimeFlags(attn_impl="chunked", attn_bq=2048, attn_bkv=2048,
                        moe_impl="sorted", loss_chunk=512, remat="full")


# the reference's optimized-preset microbatch counts
TRAIN_MICRO = {
    "grok-1-314b": 32, "internlm2-20b": 4, "gemma2-27b": 8, "pixtral-12b": 4,
    "granite-moe-3b-a800m": 4, "recurrentgemma-9b": 8,
    "seamless-m4t-medium": 4, "phi4-mini-3.8b": 2, "gemma-2b": 2,
    "mamba2-130m": 1,
}


def _arguments(*trees):
    """[(tensor, device index)] of every block and tensor of ``trees``."""
    out = []
    for tree in trees:
        for x in leaves(tree):
            if isinstance(x, Sharded):
                out.extend(zip(x.blocks, x.owners))
            else:
                out.append((x, 0))
    return out


def trace_cell(cfg: ModelConfig, cell: ShapeCell, mesh, policy,
               flags: RuntimeFlags, microbatches: int = 1,
               counter: bool = True) -> rl.Trace:
    """One step of ``cell`` over ``mesh`` (meta devices) under the
    accounting: params and optimizer state (or the decode cache) cut into
    the policy's blocks, the batch placed on the data rows
    (``counter``: :func:`~repro_torch.core.roofline.trace_step`'s)."""
    from repro_torch.models.sharded import row_batches
    bundle = build(cfg, flags, device="meta")
    params, _ = bundle.abstract_params()
    inputs = bundle.input_specs(cell)
    many = len(mesh.devices) > 1
    if cell.kind == TRAIN:
        step, p_sh, _, _ = make_train_step(bundle, mesh, policy,
                                           AdamWConfig(),
                                           microbatches=microbatches)
    elif cell.kind == PREFILL:
        step, p_sh = make_prefill_step(bundle, mesh, policy, cell)
    else:
        step, p_sh, c_sh = make_decode_step(bundle, mesh, policy, cell)
    if many:
        params = cut_tree(params, p_sh, mesh)
    if cell.kind == DECODE:
        cache = bundle.cache_specs(cell)
        if many:
            cache = cut_tree(cache, c_sh, mesh)
        tokens, pos = inputs["tokens"], inputs["pos"]
        args = _arguments(params, cache, tokens, pos)
        run = lambda: step(params, cache, tokens, pos)
        return rl.trace_step(run, args, len(mesh.devices), counter)
    if many:
        rows = row_batches(inputs, with_policy(bundle, mesh, policy).flags)
        batch = {k: [b[k] for _, b, _ in rows] for k in inputs}
        args = [(t, row.home) for row, b, _ in rows for t in b.values()]
    else:
        batch, args = inputs, _arguments(inputs)
    if cell.kind == TRAIN:
        opt = adamw.init(params)
        args += _arguments(params, opt)
        run = lambda: step(params, opt, batch)
    else:
        args += _arguments(params)
        run = lambda: step(params, batch)
    return rl.trace_step(run, args, len(mesh.devices), counter)


def _affine(a: list, b: list, nb: int) -> list:
    return [x + (y - x) * (nb - 1) for x, y in zip(a, b)]


def trace_mesh(cfg: ModelConfig, cell: ShapeCell, mesh, policy,
               flags: RuntimeFlags, microbatches: int = 1):
    """(trace, depth): the full-depth trace of a mesh of up to
    ``FULL_DEPTH_DEVICES`` devices (``FlopCounterMode`` beside it), else
    traces at one and two pattern blocks extrapolated affinely to the
    config's depth."""
    if len(mesh.devices) <= FULL_DEPTH_DEVICES:
        return trace_cell(cfg, cell, mesh, policy, flags, microbatches), \
            "full"
    one, two = (trace_cell(reduced_cfg(cfg, nb), cell, mesh, policy, flags,
                           microbatches, counter=False) for nb in (1, 2))
    nb = cfg.num_pattern_blocks
    ext = rl.Trace(
        flops=_affine(one.flops, two.flops, nb),
        bytes=_affine(one.bytes, two.bytes, nb),
        recv=_affine(one.recv, two.recv, nb),
        args=_affine(one.args, two.args, nb),
        peak=_affine(one.peak, two.peak, nb),
        flash_inner=_affine(one.flash_inner, two.flash_inner, nb),
        total_flops=one.total_flops + (two.total_flops - one.total_flops)
        * (nb - 1),
        seconds=one.seconds + two.seconds)
    return ext, "extrapolated"


def model_flops_per_chip(cfg: ModelConfig, cell: ShapeCell,
                         chips: int) -> float:
    _, active = cfg.param_count()
    mult = 6 if cell.kind == TRAIN else 2
    return mult * active * cell.tokens / chips


def reduced_cfg(cfg: ModelConfig, nb: int) -> ModelConfig:
    kw = dict(num_layers=cfg.pattern_len * nb + len(cfg.remainder_specs))
    if cfg.enc_dec:
        kw["num_encoder_layers"] = nb
    return override(cfg, **kw)


def preset_for(cfg: ModelConfig, cell: ShapeCell, preset: str):
    """(policy_name, flags, microbatches) of a cell under a preset, the
    reference's: ``baseline`` the deployable default; ``opt`` sequence-
    parallel activations, loss chunks of 128 and microbatches for train
    cells, int8 KV caches for decode cells."""
    if preset == "baseline":
        return "fsdp_tp", default_flags(), 1
    if cell.kind == TRAIN:
        return ("fsdp_tp_sp",
                dataclasses.replace(default_flags(), loss_chunk=128),
                TRAIN_MICRO.get(cfg.name, 4))
    if cell.kind == DECODE:
        return ("fsdp_tp",
                dataclasses.replace(default_flags(), kv_dtype="int8"), 1)
    return "fsdp_tp", default_flags(), 1


def mesh_record(trace: rl.Trace, mesh, policy, depth: str = "full") -> dict:
    """One mesh's entry of a cell's record."""
    mem = rl.memory_summary(trace)
    cost = rl.cost_of(trace)
    peak = mem["peak_bytes_per_device"]
    return dict(
        chips=len(mesh.devices), engines=policy.engines(mesh),
        trace_s=round(trace.seconds, 1), depth=depth,
        peak_gib=round(peak / GIB, 3),
        arg_gib=round(mem["argument_size_in_bytes"] / GIB, 3),
        fits_80g=peak < rl.H100.hbm_bytes,
        flops_per_dev=cost.flops, bytes_per_dev=cost.bytes_raw,
        collective_bytes_per_dev=cost.collective,
        flops_total=sum(trace.flops), flops_counter_total=trace.total_flops,
        argument_bytes_by_device=trace.args,
        peak_bytes_by_device=trace.peak,
        flops_by_device=trace.flops,
        collective_bytes_by_device=trace.recv)


def _terms(cfg, cell, cost: rl.CellCost, chips: int, policy, mesh) -> dict:
    mf = model_flops_per_chip(cfg, cell, chips)
    terms = rl.terms_from_cost(cost, chips, mf)
    return dict(
        chips=chips, engines=policy.engines(mesh),
        hlo_flops=cost.flops, hlo_bytes_raw=cost.bytes_raw,
        hlo_bytes=cost.bytes_fused, bytes_flash_inner=cost.bytes_flash_inner,
        collective_bytes=cost.collective,
        compute_s=terms.compute_s, memory_s=terms.memory_s,
        collective_s=terms.collective_s, dominant=terms.dominant,
        model_flops=mf, useful_ratio=terms.useful_flops_ratio,
        roofline_fraction=terms.roofline_fraction)


def run_cell(cfg: ModelConfig, cell: ShapeCell, *, pods: str, roofline: bool,
             policy_name: str = "fsdp_tp", flags=None, preset=None,
             meshes=None) -> dict:
    """The record of one cell.  ``meshes`` ({key: mesh}) replaces the
    production meshes that ``pods`` picks (a test passes a small one)."""
    if preset is not None:
        policy_name, flags, micro = preset_for(cfg, cell, preset)
    else:
        micro = 1
    rec = dict(arch=cfg.name, shape=cell.name, kind=cell.kind,
               policy=policy_name, status="ok", meshes={},
               preset=preset or "baseline", microbatches=micro)
    policy = POLICIES[policy_name]
    flags = flags or default_flags()
    if meshes is None:
        todo = {"single": [False], "multi": [True],
                "both": [False, True]}[pods]
        meshes = {("multi_pod" if mp else "single_pod"):
                  make_production_mesh(["meta"] * (512 if mp else 256),
                                       multi_pod=mp) for mp in todo}
    first = None
    for key, mesh in meshes.items():
        trace, depth = trace_mesh(cfg, cell, mesh, policy, flags, micro)
        rec["meshes"][key] = m = mesh_record(trace, mesh, policy, depth)
        print(f"  [{key}] chips={m['chips']} trace={m['trace_s']}s "
              f"peak/dev={m['peak_gib']:.2f}GiB arg/dev={m['arg_gib']:.2f}GiB "
              f"flops/dev={m['flops_per_dev']:.3e} "
              f"coll/dev={m['collective_bytes_per_dev']:.3e}B", flush=True)
        first = first or (trace, mesh)
    trace, mesh = first
    chips = len(mesh.devices)
    if roofline:
        rflags = default_flags(roofline=True)
        costs = {}
        for nb in (1, 2):
            costs[nb] = rl.cost_of(trace_cell(reduced_cfg(cfg, nb), cell,
                                              mesh, policy, rflags,
                                              counter=False))
            print(f"  [roofline nb={nb}] flops={costs[nb].flops:.3e}",
                  flush=True)
        full = rl.affine_extrapolate(costs[1], costs[2], 1, 2,
                                     cfg.num_pattern_blocks)
    else:
        full = rl.cost_of(trace)
    rec["roofline"] = r = _terms(cfg, cell, full, chips, policy, mesh)
    print(f"  [roofline] dominant={r['dominant']} "
          f"compute={r['compute_s'] * 1e3:.2f}ms "
          f"memory={r['memory_s'] * 1e3:.2f}ms "
          f"collective={r['collective_s'] * 1e3:.2f}ms "
          f"useful={r['useful_ratio']:.3f} "
          f"frac={r['roofline_fraction']:.3f}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES_BY_NAME))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", dest="pods", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--roofline", action="store_true")
    ap.add_argument("--policy", default="fsdp_tp", choices=sorted(POLICIES))
    ap.add_argument("--preset", default=None, choices=["baseline", "opt"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    if not args.all and not args.arch and not args.shape:
        ap.error("pass --all or --arch/--shape")

    cells = []
    for cfg in ARCHS.values():
        if args.arch and cfg.name != args.arch:
            continue
        for cell in LM_SHAPES:
            if args.shape and cell.name != args.shape:
                continue
            ok, why = shape_applicable(cfg, cell)
            cells.append((cfg, cell, ok, why))

    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["policy"]) for r in results
            if r.get("status") == "ok" and (not args.roofline or "roofline" in r)
            and (args.pods == "single" or "multi_pod" in r.get("meshes", {}))}

    failures = 0
    for cfg, cell, ok, why in cells:
        tag = f"{cfg.name} x {cell.name}"
        if not ok:
            print(f"SKIP {tag}: {why}", flush=True)
            rec = dict(arch=cfg.name, shape=cell.name, policy=args.policy,
                       status="skip", reason=why)
            results = [r for r in results if not (
                r["arch"] == cfg.name and r["shape"] == cell.name)] + [rec]
            continue
        if (cfg.name, cell.name, args.policy) in done:
            print(f"CACHED {tag}", flush=True)
            continue
        print(f"CELL {tag}", flush=True)
        t0 = time.time()
        try:
            rec = run_cell(cfg, cell, pods=args.pods, roofline=args.roofline,
                           policy_name=args.policy, preset=args.preset)
        except Exception as e:  # noqa: BLE001
            traceback.print_exc()
            rec = dict(arch=cfg.name, shape=cell.name, policy=args.policy,
                       status="fail", error=str(e)[:500])
            failures += 1
        rec["seconds"] = round(time.time() - t0, 1)
        results = [r for r in results if not (
            r["arch"] == cfg.name and r["shape"] == cell.name
            and r["policy"] == args.policy)] + [rec]
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    print(f"done: {len(results)} records, {failures} failures", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
