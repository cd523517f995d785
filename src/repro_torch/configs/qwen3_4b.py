"""qwen3-4b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B family]."""
from .base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, d_ff=9728, vocab_size=151936,
    attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128, qk_norm=True,
                    rope_theta=1e6),
    param_dtype="bfloat16",
    source="hf:Qwen/Qwen3-8B (4B sibling card)",
)


def smoke():
    return CONFIG.replace(
        n_layers=2, d_model=256, d_ff=512, vocab_size=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=64, qk_norm=True),
        param_dtype="float32",
        remat=False)
