"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887].

As in the JAX package: the original uses Mamba-1 mixers; this uses the
Mamba-2 SSD block (same interface, one kernel).  MoE on every other
sublayer (Jamba's placement), 16 experts top-2.
"""
from .base import AttnConfig, MambaConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, d_ff=24576, vocab_size=65536,
    attn=AttnConfig(n_heads=64, n_kv_heads=8, head_dim=128, rope_theta=1e4),
    mamba=MambaConfig(d_state=128, headdim=64, expand=2, chunk=128,
                      conv_width=4),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576, n_shared=0,
                  capacity_factor=1.25),
    attn_every=8,                  # 1 attention sublayer per 8 (1:7)
    param_dtype="bfloat16",
    source="arXiv:2403.19887",
)


def smoke():
    return CONFIG.replace(
        n_layers=8, d_model=256, d_ff=512, vocab_size=512, attn_every=8,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=64),
        mamba=MambaConfig(d_state=32, headdim=32, expand=2, chunk=32,
                          conv_width=4),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, n_shared=0),
        param_dtype="float32",
        remat=False)
