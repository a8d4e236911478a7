"""Configuration dataclasses (the port's copy of ``repro.configs.base``).

Plain frozen dataclasses with the same fields and defaults as the
reference, so a config prints, hashes and diffs the same way in both
packages.  Every mixer and mlp kind is served; the advisor's parameter
accounting and shape cells (:meth:`ModelConfig.param_count`,
:data:`LM_SHAPES`) cover every kind.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Optional, Tuple

# mixer kinds
ATTN = "attn"            # softmax attention (GQA / MQA / MHA)
SSD = "ssd"              # Mamba-2 state-space-duality mixer
RGLRU = "rglru"          # Griffin RG-LRU recurrent mixer

# mlp kinds
DENSE = "dense"
MOE = "moe"
NONE = "none"


@dataclass(frozen=True)
class LayerSpec:
    """One decoder layer: a (mixer, mlp) pair."""

    mixer: str = ATTN
    mlp: str = DENSE
    sliding_window: Optional[int] = None     # None = full (global) attention

    @property
    def is_local_attn(self) -> bool:
        return self.mixer == ATTN and self.sliding_window is not None


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # None => d_model // num_heads

    # layer pattern (repeats to num_layers); default = uniform attn+dense
    layer_pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)

    # ffn / embedding
    activation: str = "swiglu"       # swiglu | geglu | gelu
    tie_embeddings: bool = False
    normalize_embedding: bool = False  # gemma scales embeddings by sqrt(d_model)

    # attention extras
    rope_theta: float = 10_000.0
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25

    # Mamba-2 / SSD
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4

    # RG-LRU
    lru_width: Optional[int] = None

    # encoder-decoder
    enc_dec: bool = False
    num_encoder_layers: int = 0

    # modality frontends
    frontend: Optional[str] = None   # None | "patches" | "frames"
    num_frontend_tokens: int = 0

    # dtypes
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def pattern_len(self) -> int:
        return len(self.layer_pattern)

    @property
    def num_pattern_blocks(self) -> int:
        """Full pattern repetitions (stacked on the LAYERS axis)."""
        return self.num_layers // self.pattern_len

    @property
    def remainder_specs(self) -> Tuple[LayerSpec, ...]:
        """Trailing layers beyond the stacked blocks (unstacked params)."""
        rem = self.num_layers % self.pattern_len
        return tuple(self.layer_pattern[i] for i in range(rem))

    # ------------------------------------------------------------------
    # analytic parameter / FLOP accounting (the advisor and the roofline
    # sweep read it)
    # ------------------------------------------------------------------
    def _mixer_params(self, spec: LayerSpec) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        if spec.mixer == ATTN:
            return d * hd * (nq + 2 * nkv) + nq * hd * d
        if spec.mixer == SSD:
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_head_dim
            zxbcdt = d * (2 * d_in + 2 * self.ssm_state + nheads)
            conv = (d_in + 2 * self.ssm_state) * self.ssm_conv_width
            out = d_in * d
            return zxbcdt + conv + out + 2 * nheads  # + A_log, D, dt_bias~nheads
        if spec.mixer == RGLRU:
            w = self.lru_width or self.d_model
            # in-proj (2 branches), conv1d, gates (2 diag-blocks), out-proj
            return d * 2 * w + w * 4 + 2 * w * (w // 8) * 8 // 8 + w * d + 2 * w
        raise ValueError(spec.mixer)

    def _mlp_params(self, spec: LayerSpec) -> Tuple[int, int]:
        """returns (total, active) mlp params."""
        d, f = self.d_model, self.d_ff
        if spec.mlp == NONE or f == 0:
            return 0, 0
        gates = 3 if self.activation in ("swiglu", "geglu") else 2
        dense = gates * d * f
        if spec.mlp == MOE:
            total = self.num_experts * dense + d * self.num_experts  # + router
            active = self.num_experts_per_tok * dense + d * self.num_experts
            return total, active
        return dense, dense

    def param_count(self) -> Tuple[int, int]:
        """(total, active) parameter counts, embeddings included once if tied."""
        per_total = per_active = 0
        for spec in self.layer_pattern:
            m = self._mixer_params(spec)
            t, a = self._mlp_params(spec)
            norms = 2 * self.d_model
            per_total += m + t + norms
            per_active += m + a + norms
        total = per_total * self.num_pattern_blocks
        active = per_active * self.num_pattern_blocks
        for spec in self.remainder_specs:
            m = self._mixer_params(spec)
            t, a = self._mlp_params(spec)
            total += m + t + 2 * self.d_model
            active += m + a + 2 * self.d_model
        if self.enc_dec:
            # encoder stack: self-attn + dense mlp per layer; decoder adds cross-attn
            enc = self.num_encoder_layers * (
                self._mixer_params(LayerSpec()) + self._mlp_params(LayerSpec())[0]
                + 2 * self.d_model)
            cross = self.num_layers * (self._mixer_params(LayerSpec()) + self.d_model)
            total += enc + cross
            active += enc + cross
        emb = self.vocab_size * self.d_model
        total += emb if self.tie_embeddings else 2 * emb
        active += emb if self.tie_embeddings else 2 * emb
        total += self.d_model  # final norm
        active += self.d_model
        return total, active

    def flops_per_token(self) -> int:
        """MODEL_FLOPS/token = 6·N_active (forward+backward), matmul params only."""
        _, active = self.param_count()
        return 6 * active


# ---------------------------------------------------------------------------
# Shapes (the assigned LM shape set)
# ---------------------------------------------------------------------------

TRAIN = "train"
PREFILL = "prefill"
DECODE = "decode"


@dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int       # train/prefill: tokens processed; decode: KV cache length
    global_batch: int

    @property
    def tokens(self) -> int:
        """new tokens processed per step."""
        if self.kind == DECODE:
            return self.global_batch
        return self.global_batch * self.seq_len


LM_SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", TRAIN, 4_096, 256),
    ShapeCell("prefill_32k", PREFILL, 32_768, 32),
    ShapeCell("decode_32k", DECODE, 32_768, 128),
    ShapeCell("long_500k", DECODE, 524_288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in LM_SHAPES}


def shape_applicable(cfg: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """The skip rules of the shape set.

    ``long_500k`` needs sub-quadratic attention: run for SSM/hybrid archs whose
    every attention layer is windowed; skip when any full-attention layer
    exists (the 500k KV cache is the quadratic-family cost).
    """
    if cell.name == "long_500k":
        has_full_attn = any(
            s.mixer == ATTN and s.sliding_window is None for s in cfg.layer_pattern)
        if cfg.enc_dec:
            return False, "enc-dec full attention (quadratic family)"
        if has_full_attn:
            return False, "full-attention layers present (quadratic family)"
        return True, ""
    return True, ""


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    pat = cfg.layer_pattern
    updates = dict(
        num_layers=len(pat) if not cfg.enc_dec else 2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        num_encoder_layers=2 if cfg.enc_dec else 0,
        num_frontend_tokens=8 if cfg.frontend else 0,
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.num_experts:
        updates.update(num_experts=4, num_experts_per_tok=2)
    if cfg.ssm_state:
        updates.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.lru_width:
        updates.update(lru_width=64)
    new_pat = tuple(
        replace(s, sliding_window=(16 if s.sliding_window is not None else None))
        for s in pat)
    return replace(cfg, layer_pattern=new_pat, **updates)


def override(cfg: ModelConfig, **kw) -> ModelConfig:
    return replace(cfg, **kw)


def asdict(cfg: ModelConfig) -> dict:
    return dataclasses.asdict(cfg)
