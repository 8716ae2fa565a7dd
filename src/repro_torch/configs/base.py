"""Architecture config system (the port's own copy of ``repro.configs.base``).

Every assigned architecture is a frozen :class:`ArchConfig`.  These are
dataclasses only; the port keeps its own copy so that it never imports the
JAX package.  Tests use ``cfg.reduced()``, which shrinks every scale knob
while preserving the family-specific structure (MoE routing, sliding-window
pattern, hybrid heads, enc-dec, ...).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Input shapes (assigned; identical for every LM-family arch).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Architecture config.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- norm / mlp / attention flavour ---
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    norm_eps: float = 1e-6
    mlp: str = "swiglu"  # swiglu | geglu | gelu
    mlp_bias: bool = False
    attn_bias: bool = False  # bias on qkv projections
    attn_out_bias: bool = False
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0
    rope_theta: float = 10_000.0
    partial_rotary: float = 1.0  # fraction of head_dim rotated
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w) pairs
    tie_embeddings: bool = False
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d)

    # --- layer pattern (sliding-window / global mix) ---
    sliding_window: int = 0  # 0 => full attention everywhere
    # pattern of attention kinds, cycled over layers: "L"=local(sliding), "G"=global
    layer_pattern: str = ""  # e.g. gemma3 "LLLLLG"; "" => all global
    global_layer_ids: Tuple[int, ...] = ()  # hymba-style explicit overrides

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0  # deepseek: layer 0 keeps a dense FFN
    dense_d_ff: int = 0  # d_ff used by those first dense layers
    router_scale: bool = False  # deepseek normalises top-k weights
    moe_capacity_factor: float = 1.25

    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    slstm_every: int = 0  # xlstm: every k-th block is an sLSTM block
    hybrid_parallel: bool = False  # hymba: attention and mamba heads in parallel

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq_len: int = 1536  # padded whisper frame count (1500 -> 1536)

    # --- modality frontend stub ---
    frontend: str = "none"  # none | audio_frames | vision_patches

    # --- runtime ---
    dtype: str = "bfloat16"
    max_seq_len: int = 1_048_576
    subquadratic: bool = False  # eligible for long_500k
    source: str = ""  # provenance note

    # ------------------------------------------------------------------
    @property
    def qkv_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def attn_kind(self, layer_id: int) -> str:
        """Return "G" (global/full) or "L" (local/sliding) for a layer."""
        if layer_id in self.global_layer_ids:
            return "G"
        if self.layer_pattern:
            return self.layer_pattern[layer_id % len(self.layer_pattern)]
        if self.sliding_window and not self.global_layer_ids:
            return "L"
        if self.sliding_window:
            return "L"
        return "G"

    def n_params(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        d, hd = self.d_model, self.head_dim
        attn = d * self.qkv_dim + 2 * d * self.kv_dim + self.qkv_dim * d
        if self.attn_bias:
            attn += self.qkv_dim + 2 * self.kv_dim
        per_layer = attn + 2 * d  # norms
        total = 0
        for i in range(self.n_layers):
            ff = per_layer
            if self.family == "moe" and i >= self.first_dense_layers:
                e_ff = self.moe_d_ff
                n_e = self.n_experts + self.n_shared_experts
                ff += n_e * 3 * d * e_ff + d * self.n_experts
            else:
                dff = self.dense_d_ff if (self.family == "moe" and self.dense_d_ff) else self.d_ff
                mult = 3 if self.mlp in ("swiglu", "geglu") else 2
                ff += mult * d * dff
            total += ff
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total += d  # final norm
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: shared + top_k routed only)."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        dense = self.n_params()
        n_moe_layers = self.n_layers - self.first_dense_layers
        inactive = (self.n_experts - self.top_k) * 3 * d * self.moe_d_ff * n_moe_layers
        return dense - inactive

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Smoke-test sized config preserving the family structure."""
        changes = dict(
            n_layers=min(self.n_layers, 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            dtype="float32",
            max_seq_len=512,
        )
        if self.family == "moe":
            changes.update(n_experts=8, top_k=min(self.top_k, 2), moe_d_ff=32,
                           n_shared_experts=min(self.n_shared_experts, 1),
                           first_dense_layers=min(self.first_dense_layers, 1),
                           dense_d_ff=128 if self.dense_d_ff else 0)
        if self.sliding_window:
            changes.update(sliding_window=8)
        if self.global_layer_ids:
            changes.update(global_layer_ids=(0, 2))
        if self.layer_pattern:
            # keep the same cyclic pattern but fewer layers
            changes.update(n_layers=len(self.layer_pattern))
        if self.slstm_every:
            changes.update(n_layers=4, slstm_every=4)
        if self.is_encoder_decoder:
            changes.update(n_encoder_layers=2, n_layers=2, encoder_seq_len=32)
        if self.ssm_state:
            changes.update(ssm_state=8)
        if self.mrope_sections:
            changes.update(mrope_sections=(2, 3, 3))  # sums to head_dim//2 = 8
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> Tuple[str, ...]:
    if not _REGISTRY:
        _load_all()
    return tuple(sorted(_REGISTRY))


def bench_tiny_config(name: str = "qwen2-0.5b") -> "ArchConfig":
    """A deliberately tiny LM so the PS decision path is a visible
    fraction of the train step — the regime the paper's 158-worker
    cluster runs in (sub-second steps, controller on the critical path).
    The one config the controller/elastic benches, demos, and the elastic
    acceptance tests all share.
    """
    import dataclasses

    cfg = get_config(name).reduced()
    return dataclasses.replace(cfg, n_layers=2, d_model=32, n_heads=2,
                               n_kv_heads=1, head_dim=16, d_ff=64,
                               vocab_size=256)


def _load_all() -> None:
    from repro_torch.configs import (  # noqa: F401
        qwen2_vl_7b, deepseek_moe_16b, phi35_moe, stablelm_3b, gemma3_12b,
        starcoder2_3b, qwen2_05b, xlstm_350m, hymba_15b, whisper_base,
    )


def cells():
    """Yield every assigned (arch, shape) cell plus its run/skip decision."""
    for arch in all_archs():
        cfg = get_config(arch)
        for shape in SHAPES.values():
            skip = None
            if shape.name == "long_500k" and not cfg.subquadratic:
                skip = "full-attention arch: long_500k requires sub-quadratic attention"
            yield cfg, shape, skip
