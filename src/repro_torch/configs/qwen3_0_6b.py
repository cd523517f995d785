"""qwen3-0.6b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B family]."""
from .base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, d_ff=3072, vocab_size=151936,
    attn=AttnConfig(n_heads=16, n_kv_heads=8, head_dim=128, qk_norm=True,
                    rope_theta=1e6),
    tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B (0.6B sibling card)",
)


def smoke():
    return CONFIG.replace(
        n_layers=2, d_model=256, d_ff=512, vocab_size=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=64, qk_norm=True),
        remat=False)
