"""qwen3-moe-30b-a3b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]."""
from .base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, d_ff=6144, vocab_size=151936,
    attn=AttnConfig(n_heads=32, n_kv_heads=4, head_dim=128, qk_norm=True,
                    rope_theta=1e6),
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768, n_shared=0,
                  capacity_factor=1.25),
    param_dtype="bfloat16",
    source="hf:Qwen/Qwen3-30B-A3B",
)


def smoke():
    return CONFIG.replace(
        n_layers=2, d_model=256, d_ff=512, vocab_size=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=64, qk_norm=True),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, n_shared=0),
        param_dtype="float32",
        remat=False)
