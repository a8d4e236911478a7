"""Small cells the CPU tests run: the port's smoke widths of each model,
the harness's whole path at sizes a test run holds."""
from __future__ import annotations

from dataclasses import replace

from perfbench.loadgen import Spec
from perfbench.registry import Cell

ARCH = {"dense": "phi4-mini-3.8b", "moe": "granite-moe-3b-a800m"}


def small_model(kind: str, dtype: str = "float32", **over):
    from repro_torch.configs import ARCHS, smoke_config
    cfg = replace(smoke_config(ARCHS[ARCH[kind]]), param_dtype=dtype,
                  compute_dtype=dtype, **over)
    dims = dict(num_layers=cfg.num_layers, d_model=cfg.d_model,
                num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff,
                vocab_size=cfg.vocab_size, num_experts=cfg.num_experts,
                num_experts_per_tok=cfg.num_experts_per_tok,
                rope_theta=cfg.rope_theta, tie_embeddings=cfg.tie_embeddings,
                norm_eps=1e-6)
    config = dict(arch=ARCH[kind], reference=kind, model=dims,
                  dtypes=dict(param=dtype, compute=dtype, kv=dtype),
                  flags=dict(attn_impl="chunked", attn_bq=64, attn_bkv=64,
                             moe_impl="dense", kv_dtype="native"))
    return cfg, config


def small_traffic(loop: str = "closed") -> Spec:
    d = dict(name=f"small-{loop}", loop=loop, block=8, shape_seed=5,
             prompt=dict(lo=8, hi=40), output=dict(lo=4, hi=16),
             engine=dict(batch=4, max_len=64, prefill_chunk=16,
                         window=4 if loop == "closed" else 1),
             profile_seconds=0.3)
    if loop == "closed":
        d.update(clients=4)
    else:
        d.update(rate=30.0, burst=dict(mult=3.0, mean_s=0.2, calm_mean_s=0.8),
                 prefix=dict(count=2, tokens=8, zipf=1.2), ramp_s=0.3,
                 drain_s=20.0)
        d["prompt"] = dict(lo=4, hi=32)
    return Spec.from_dict(d)


def small_cell(kind: str = "dense", loop: str = "closed",
               dtype: str = "float32", gap: float = 0.05,
               number: str = "logit_gap_max", **over):
    """A small cell whose check holds ``number`` (a gap the harness reads)
    to ``gap``."""
    cfg, config = small_model(kind, dtype, **over)
    cell = Cell(name=f"small.{kind}.{loop}", chips=1, config=config,
                traffic=small_traffic(loop),
                check={"sample_requests": 3, "min_tokens": 10, number: gap},
                end_to_end=[], per_layer=[])
    return cell, cfg
