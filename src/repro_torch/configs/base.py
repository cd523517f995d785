"""Model configuration dataclasses of the ported families.

The counterpart of the JAX package's ``configs/base.py`` (without its
input-shape table, which only the dry-run reads): one `ModelConfig`
describes a dense or MoE decoder, an SSM (Mamba-2), a hybrid (Mamba and
attention interleaved), a VLM or an audio encoder-decoder.
``pdtype``/``cdtype`` are ``torch.dtype``s.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import torch


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention (compressed KV)."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class AttnConfig:
    n_heads: int = 16
    n_kv_heads: int = 16              # GQA: kv groups
    head_dim: int | None = None       # default d_model // n_heads
    qk_norm: bool = False             # qwen3-style per-head RMSNorm on q,k
    rope_theta: float = 10000.0
    causal: bool = True
    window: int | None = None         # sliding-window size (None = full)
    mla: MLAConfig | None = None      # if set, use MLA instead of GQA


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8                # routed experts
    top_k: int = 2
    d_ff_expert: int = 1408           # per-expert hidden dim
    n_shared: int = 0                 # always-on shared experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    chunk: int = 128                  # SSD chunk length
    conv_width: int = 4


@dataclass(frozen=True)
class EncoderConfig:
    """Stub-frontend encoder (audio frames or vision patches)."""

    n_layers: int = 24
    n_ctx: int = 1500                 # frames/patches after the stub frontend
    d_model: int | None = None        # defaults to decoder d_model


@dataclass(frozen=True)
class VisionConfig:
    """Stubbed vision frontend for VLM cross-attention."""

    n_image_tokens: int = 1601        # e.g. 1 tile of 40x40 patches + cls
    cross_attn_every: int = 5         # a cross-attn block every Nth layer


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"             # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int = 12
    d_model: int = 768
    d_ff: int = 3072                  # dense-MLP hidden (MoE: shared path)
    vocab_size: int = 32000
    attn: AttnConfig | None = field(default_factory=AttnConfig)
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    attn_every: int | None = None     # hybrid: 1 attn layer per this many
    encoder: EncoderConfig | None = None
    vision: VisionConfig | None = None
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "swiglu"               # swiglu | gelu
    max_seq_len: int = 131072
    # numerics / execution policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True                # recompute each block in the backward
    scan_layers: bool = True          # the port always loops over layers
    source: str = ""

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def head_dim(self) -> int:
        a = self.attn
        if a is None:
            return 0
        return a.head_dim if a.head_dim is not None else self.d_model // a.n_heads

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)
