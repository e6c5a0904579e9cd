"""Config system: model architecture configs + benchmark input shapes.

A copy of ``repro.configs.base`` (it holds no framework code): the port keeps
its own so that it imports nothing of the JAX package.  The two must not
drift; ``tests/test_torch_configs.py`` compares them field for field.

Every assigned architecture gets one module in this package defining a
``ModelConfig`` with the exact published dimensions (source cited in the
module docstring).  ``reduced()`` derives the CPU-smoke-test variant
(<=2 layers, d_model<=512, <=4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description consumed by ``repro_torch.models.transformer``."""

    name: str
    arch_type: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention features -------------------------------------------------
    rope_theta: float = 10000.0
    qk_norm: bool = False                 # qwen3-style per-head RMSNorm on q,k
    attn_softcap: Optional[float] = None  # gemma2 attention logit soft-capping
    final_softcap: Optional[float] = None  # gemma2 final-logit soft-capping
    window: Optional[int] = None          # sliding-window size for local layers
    # layer attention pattern: 'global' (all full), 'local' (all windowed),
    # 'local_global' (alternating, local first — gemma2), or
    # 'hymba' (all local except first/middle/last global)
    layer_pattern: str = "global"
    post_norms: bool = False              # gemma2 post-attn/post-mlp norms
    activation: str = "swiglu"            # swiglu | geglu | gelu
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    encoder_only: bool = False            # hubert: bidirectional, no decode
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # --- mixture of experts --------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False      # arctic: dense MLP in parallel w/ MoE
    dense_d_ff: int = 0                   # arctic dense-residual hidden size
    capacity_factor: float = 1.25
    # 'tensor': expert FFN hidden dim sharded on model axis
    # 'expert': expert dim sharded on model axis (expert parallelism)
    moe_sharding: str = "tensor"

    # --- state space (mamba1) ------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    dt_rank: int = 0                      # 0 -> d_model // 16
    ssm_chunk: int = 0                    # 0 -> single associative scan

    # --- modality frontend (stub per the brief) ------------------------------
    frontend: str = "none"                # none | audio | vision
    n_patches: int = 0                    # vlm: image patch embeddings per seq

    # --- misc -----------------------------------------------------------------
    long_context: bool = False  # force windowed attention everywhere (long_500k)
    dtype: str = "bfloat16"
    remat: bool = True
    # unroll the layer scan (used by the dry-run's depth-point lowerings so
    # cost_analysis sees every layer; full-depth lowerings keep the scan)
    scan_unroll: bool = False
    # cross-entropy vocab chunking (0 = auto: chunk when vocab >= 16384;
    # <0 = force dense).  Bounds live logits memory to B*S*8192 — large-vocab
    # archs cannot fit dense fp32 logits + grads in HBM at assigned batches.
    ce_chunk: int = 0
    # query-chunked attention (0 = dense masked attention).  Dense attention
    # materializes (B,H,Sq,Sk) fp32 scores — 34 GB/device for phi3 train_4k —
    # so the production default streams query blocks of this size.
    attn_chunk: int = 256
    # gradient accumulation (microbatches per step).  The backward-over-scan
    # residual stack is n_layers * tokens_mb * d_model * ~4B per device;
    # accumulation bounds it.  Must divide the per-device batch.
    grad_accum: int = 1
    # ZeRO/FSDP-style weight sharding over the data axis, on top of model-axis
    # tensor parallelism.  Needed by the MoE giants (arctic: 960 GB bf16).
    # With fsdp=True a "worker" (the paper's m) is a full data x model slice,
    # so the ZO step's worker axis becomes the pod axis (see DESIGN.md §3).
    fsdp: bool = False
    # dispatch sequence mixing to the Pallas TPU kernels (flash attention /
    # selective scan).  Requires static windows (uniform or full) and
    # kernel-aligned shapes; used on real TPU runtimes and in interpret-mode
    # equivalence tests — the CPU dry-run lowers the jnp path.
    use_pallas: bool = False
    source: str = ""                      # citation

    # ------------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank_actual(self) -> int:
        return self.dt_rank if self.dt_rank > 0 else max(1, self.d_model // 16)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def has_attention(self) -> bool:
        return self.arch_type != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.arch_type in ("ssm", "hybrid")

    @property
    def pattern_period(self) -> int:
        """Layers are scanned in homogeneous groups of this many layers."""
        return 2 if self.layer_pattern == "local_global" else 1

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.pattern_period == 0
        return self.n_layers // self.pattern_period

    def layer_windows(self) -> Tuple[Optional[int], ...]:
        """Static per-layer window (None = full attention) before long_context."""
        if not self.has_attention:
            return tuple([None] * self.n_layers)
        if self.long_context and self.window:
            return tuple([self.window] * self.n_layers)
        if self.layer_pattern == "global":
            return tuple([None] * self.n_layers)
        if self.layer_pattern == "local":
            return tuple([self.window] * self.n_layers)
        if self.layer_pattern == "local_global":
            return tuple(
                self.window if i % 2 == 0 else None for i in range(self.n_layers)
            )
        if self.layer_pattern == "hymba":
            glb = {0, self.n_layers // 2, self.n_layers - 1}
            return tuple(
                None if i in glb else self.window for i in range(self.n_layers)
            )
        raise ValueError(self.layer_pattern)

    @property
    def subquadratic(self) -> bool:
        """True when every layer's sequence mixing is sub-quadratic in seq."""
        if self.arch_type == "ssm":
            return True
        return all(w is not None for w in self.layer_windows())

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant of the same family (brief: <=2L, d<=512, <=4e)."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        period = self.pattern_period
        return self.with_(
            name=self.name + "-reduced",
            n_layers=2 * period if period > 1 else 2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=32,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            dense_d_ff=min(self.dense_d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            window=min(self.window, 8) if self.window else None,
            dt_rank=8 if self.has_ssm else 0,
            n_patches=min(self.n_patches, 4),
            dtype="float32",
            grad_accum=1,
            fsdp=False,
            ssm_chunk=0,
        )

    # --- analytic parameter count (for MODEL_FLOPS = 6*N*D) ------------------
    def param_count(self, active_only: bool = False) -> int:
        d, f, hd = self.d_model, self.d_ff, self.head_dim
        h, kv = self.n_heads, self.n_kv_heads
        n = 0
        if self.frontend != "audio":
            n += self.vocab_size * d                       # embed
        if not self.tie_embeddings:
            n += d * self.vocab_size                       # head
        per_layer = 0
        if self.has_attention:
            per_layer += d * h * hd + 2 * d * kv * hd + h * hd * d
            if self.qk_norm:
                per_layer += 2 * hd
        if self.has_ssm:
            di, dtr, ns = self.d_inner, self.dt_rank_actual, self.ssm_state
            per_layer += d * 2 * di + di * self.ssm_conv + di
            per_layer += di * (dtr + 2 * ns) + dtr * di + di
            per_layer += di * ns + di + di * d
        if self.is_moe:
            per_layer += d * self.n_experts                # router
            e = self.top_k if active_only else self.n_experts
            per_layer += e * 3 * d * f                     # swiglu experts
            if self.moe_dense_residual:
                per_layer += 3 * d * self.dense_d_ff
        elif f:
            mult = 3 if self.activation in ("swiglu", "geglu") else 2
            per_layer += mult * d * f
        per_layer += 2 * d                                 # norms
        if self.post_norms:
            per_layer += 2 * d
        n += self.n_layers * per_layer
        n += d                                             # final norm
        return n


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Brief's skip rules. Returns (applicable, reason-if-not)."""
    if cfg.encoder_only and shape.kind == "decode":
        return False, "encoder-only architecture has no decode step"
    if shape.name == "long_500k":
        lc = cfg if cfg.subquadratic else cfg.with_(long_context=True)
        if not lc.subquadratic:
            return False, "pure full-attention arch without sliding-window variant"
    return True, ""


def config_for_shape(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """long_500k uses the sliding-window long-context variant where needed."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return cfg.with_(long_context=True, name=cfg.name + "+swa")
    return cfg
