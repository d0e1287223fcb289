"""Config system: model architecture + workload shape dataclasses and registry.

The port's own copy of ``repro.configs.base`` (the port imports nothing of
the JAX package).

Every assigned architecture gets a module in this package registering a
``ModelConfig`` via :func:`register`.  Shapes are the four assigned workload
cells (train_4k / prefill_32k / decode_32k / long_500k).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for every family in the zoo."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // num_heads

    # attention / mlp options
    qkv_bias: bool = False
    act: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    use_rope: bool = True

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    router_aux_coef: float = 0.001
    capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_width: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2-style): a shared (weight-tied) attention block is applied
    # after every `attn_every` ssm layers.
    attn_every: int = 0

    # encoder-decoder (whisper-style)
    is_encdec: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper: 30 s -> 1500 frames (stub frontend)

    # VLM (llava-style): stub frontend provides precomputed patch embeddings
    num_patches: int = 0

    dtype: str = "bfloat16"
    notes: str = ""

    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS = 6*N*D)."""
        d, L = self.d_model, self.num_layers
        hd = self.head_dim
        n = 0
        # embeddings (+ output head unless tied)
        n += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "hybrid_attn"):
            pass
        if self.family in ("dense", "moe", "vlm"):
            qkv = d * hd * (self.num_heads + 2 * self.num_kv_heads) + hd * self.num_heads * d
            if self.qkv_bias:
                qkv += hd * (self.num_heads + 2 * self.num_kv_heads)
            per_layer += qkv
            if self.family == "moe":
                per_layer += d * self.num_experts  # router
                per_layer += self.num_experts * (3 * d * self.moe_d_ff)
            else:
                per_layer += 3 * d * self.d_ff
            per_layer += 2 * d  # norms
            n += L * per_layer
        elif self.family == "ssm":
            n += L * self._ssd_layer_params()
        elif self.family == "hybrid":
            n += L * self._ssd_layer_params()
            # one shared attention block (weight tied across applications)
            qkv = d * hd * (self.num_heads + 2 * self.num_kv_heads) + hd * self.num_heads * d
            n += qkv + 3 * d * self.d_ff + 2 * d
        elif self.family == "encdec":
            attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + hd * self.num_heads * d
            mlp = 3 * d * self.d_ff if self.act == "swiglu" else 2 * d * self.d_ff
            n += self.encoder_layers * (attn + mlp + 2 * d)
            n += L * (2 * attn + mlp + 3 * d)  # self + cross attention
        return n

    def _ssd_layer_params(self) -> int:
        d, di = self.d_model, self.d_inner
        h, st = self.ssm_heads, self.ssm_state
        n = d * (2 * di + 2 * h * st + h)  # in_proj: x, z, B, C, dt
        n += self.conv_width * (di + 2 * h * st)  # conv over x,B,C
        n += h * 2  # A_log, D
        n += di * d  # out_proj
        n += d  # norm
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if self.family != "moe":
            return self.param_count()
        dense_share = self.param_count() - self.num_layers * self.num_experts * 3 * self.d_model * self.moe_d_ff
        active_moe = self.num_layers * self.experts_per_token * 3 * self.d_model * self.moe_d_ff
        return dense_share + active_moe

    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads < self.num_heads else 4,
            d_ff=128,
            d_head=16,
            vocab_size=256,
        )
        if self.family == "moe":
            kw.update(num_experts=4, experts_per_token=2, moe_d_ff=32)
        if self.family in ("ssm", "hybrid"):
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.family == "hybrid":
            kw.update(attn_every=2, num_layers=4)
        if self.family == "encdec":
            kw.update(encoder_layers=2, encoder_seq=32)
        if self.family == "vlm":
            kw.update(num_patches=8)
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Workload shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode
    # decode shapes run the SLED verify step: K draft tokens + 1 bonus position.
    spec_len: int = 4


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# long_500k requires sub-quadratic sequence mixing; only SSM/hybrid families run it.
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return model.family in LONG_CONTEXT_FAMILIES
    return True


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> List[str]:
    _load_all()
    return sorted(_REGISTRY)


_LOADED = False

# every config of the JAX package
_CONFIG_MODULES = [
    "whisper_tiny",
    "granite_34b",
    "phi3_mini_3_8b",
    "qwen15_32b",
    "qwen2_1_5b",
    "zamba2_1_2b",
    "mamba2_370m",
    "qwen3_moe_30b_a3b",
    "granite_moe_3b_a800m",
    "llava_next_mistral_7b",
    "sled_paper",
]


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    import importlib

    for m in _CONFIG_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def all_cells() -> List[Tuple[ModelConfig, ShapeConfig]]:
    """Every applicable (architecture x shape) pair — the dry-run grid."""
    _load_all()
    cells = []
    for name in list_configs():
        cfg = _REGISTRY[name]
        if cfg.notes.startswith("paper-"):
            continue  # paper draft/target pairs are not assigned grid cells
        for shape in SHAPES.values():
            if shape_applicable(cfg, shape):
                cells.append((cfg, shape))
    return cells
