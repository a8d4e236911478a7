"""Roofline rows: from the port's dry-run artifact when one exists, else
from the analytic model (the reference's two paths).

With ``runs/dryrun_torch.json`` (written by ``python -m
repro_torch.launch.dryrun``; ``DRYRUN_TORCH_JSON`` names another file) one
row per recorded (arch x shape) cell carries the three terms of the
traced step, the dominant bottleneck, the useful-FLOPs ratio and whether
the busiest device's peak fits the card's 80 GiB on one and on two pods
(``fits_80g_1pod``/``fits_80g_2pod``), with ``source`` the artifact's
file name.  Without it, one row per cell of a small arch subset at
``fast``: flops from ``ModelConfig.flops_per_token`` (6N, the training
count, for every shape, as in the reference), bytes from the advisor's
site reports, both over the context spec (:func:`repro_torch.core.
memmodel.roofline`), ``source="analytic_fallback"``.
``gbps_measured`` is the effective HBM bandwidth at the modelled bound
(bytes / bound); ``gbps_predicted`` is the spec's peak HBM bandwidth.
The JAX package's artifacts (``runs/dryrun.json``, ``dryrun_opt.json``)
are never read.
"""
import json
import os

from repro_torch.bench.registry import SweepContext, register
from repro_torch.core.memmodel import H100
from repro_torch.core.patterns import Pattern

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.abspath(os.path.join(_HERE, "..", "..", "..", ".."))
ARTIFACT = "dryrun_torch.json"


def artifact_path() -> str:
    """``DRYRUN_TORCH_JSON``, else ``runs/dryrun_torch.json`` under the
    working directory, else under the repo's root."""
    env = os.environ.get("DRYRUN_TORCH_JSON")
    if env:
        return env
    for base in (os.getcwd(), _REPO_ROOT):
        p = os.path.join(base, "runs", ARTIFACT)
        if os.path.exists(p):
            return p
    return os.path.join(_REPO_ROOT, "runs", ARTIFACT)


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


def _from_artifact(ctx: SweepContext, path: str) -> None:
    """One row per record of the dry-run artifact."""
    with open(path) as f:
        records = json.load(f)
    fits = H100.hbm_bytes / 2**30
    for r in sorted(records, key=lambda r: (r["arch"], r["shape"])):
        name = f"roofline_{r['arch']}_{r['shape']}"
        if r.get("status") == "skip":
            ctx.emit(name, status="skip", reason=r.get("reason", ""))
            continue
        if r.get("status") != "ok" or "roofline" not in r:
            ctx.emit(name, status=r.get("status", "missing"))
            continue
        rf = r["roofline"]
        c, m, co = rf["compute_s"], rf["memory_s"], rf["collective_s"]
        sp = r.get("meshes", {}).get("single_pod", {})
        mp = r.get("meshes", {}).get("multi_pod", {})
        ideal = c * rf["useful_ratio"]
        m_k = m - rf.get("bytes_flash_inner", 0.0) / ctx.spec.hbm_bw
        _emit_terms(
            ctx, name, c, m, co, rf.get("hlo_bytes", 0.0),
            rf["useful_ratio"], rf["dominant"],
            frac_serial=f"{ideal/(c+m+co):.3f}" if (c + m + co) else "0",
            frac_kernel=f"{ideal/max(c,m_k,co):.3f}" if max(c, m_k, co) else "0",
            peak_gib_per_dev=sp.get("peak_gib", ""),
            fits_80g_1pod=sp.get("peak_gib", 1e9) < fits,
            fits_80g_2pod=mp.get("peak_gib", 1e9) < fits,
            source=os.path.basename(path))


def _analytic_fallback(ctx: SweepContext) -> None:
    """The three terms from the analytic model (advisor bytes + 6N
    flops), for a small arch subset at ``fast``."""
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


@register("roofline", "EXPERIMENTS §Roofline")
def run(ctx: SweepContext) -> None:
    """The artifact's rows when it exists, else the analytic ones."""
    path = artifact_path()
    if os.path.exists(path):
        _from_artifact(ctx, path)
    else:
        _analytic_fallback(ctx)
