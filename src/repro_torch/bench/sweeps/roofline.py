"""Roofline rows from the analytic model: the reference's analytic path.

One row per (arch x shape) cell with the three terms, the dominant
bottleneck and the useful-FLOPs ratio: flops from
``ModelConfig.flops_per_token`` (6N, the training count, for every shape,
as in the reference), bytes from the advisor's site reports, both over the
context spec (:func:`repro_torch.core.memmodel.roofline`).
``gbps_measured`` is the effective HBM bandwidth at the modelled bound
(bytes / bound); ``gbps_predicted`` is the spec's peak HBM bandwidth.
Rows carry ``source="analytic_fallback"``, the reference's name for this
path.  The reference prefers a dry-run artifact of XLA's compile when one
exists; the port has no such artifact yet, so it always takes this path.
"""
from repro_torch.bench.registry import SweepContext, register
from repro_torch.core.patterns import Pattern


def _emit_terms(ctx: SweepContext, name: str, compute_s: float,
                memory_s: float, collective_s: float, hlo_bytes: float,
                useful_ratio: float, dominant: str, **extras) -> None:
    bound = max(compute_s, memory_s, collective_s)
    ideal = compute_s * useful_ratio
    ctx.emit(name, pattern=Pattern.SEQUENTIAL,
             us=compute_s * 1e6,
             gbps_measured=(hlo_bytes / bound / 1e9) if bound else 0.0,
             gbps_predicted=ctx.spec.hbm_bw / 1e9,
             compute_ms=f"{compute_s*1e3:.2f}",
             memory_ms=f"{memory_s*1e3:.2f}",
             collective_ms=f"{collective_s*1e3:.2f}",
             dominant=dominant,
             useful_flops_ratio=f"{useful_ratio:.3f}",
             frac=f"{ideal/bound:.3f}" if bound else "0",
             **extras)


@register("roofline", "EXPERIMENTS §Roofline")
def run(ctx: SweepContext) -> None:
    """The three terms from the analytic model (advisor bytes + 6N flops),
    for a small arch subset at ``fast``."""
    from repro_torch.configs import ARCHS, SHAPES_BY_NAME, shape_applicable
    from repro_torch.core.advisor import advise_model
    from repro_torch.core.memmodel import roofline as roofline_terms

    archs = ("mamba2-130m", "gemma-2b") if ctx.fast else tuple(sorted(ARCHS))
    shapes = ("train_4k",) if ctx.fast else ("train_4k", "decode_32k")
    for arch in archs:
        cfg = ARCHS.get(arch)
        if cfg is None:
            continue
        for shape in shapes:
            cell = SHAPES_BY_NAME[shape]
            ok, why = shape_applicable(cfg, cell)
            if not ok:
                ctx.emit(f"roofline_{arch}_{shape}", status="skip", reason=why)
                continue
            reports = advise_model(cfg, cell)
            hlo_bytes = float(sum(r.bytes_moved for r in reports))
            model_flops = float(cfg.flops_per_token() * cell.tokens)
            terms = roofline_terms(hlo_flops=model_flops, hlo_bytes=hlo_bytes,
                                   collective_bytes=0.0, chips=1,
                                   model_flops=model_flops, spec=ctx.spec)
            _emit_terms(ctx, f"roofline_{arch}_{shape}", terms.compute_s,
                        terms.memory_s, terms.collective_s, hlo_bytes,
                        terms.useful_flops_ratio, terms.dominant,
                        source="analytic_fallback")
