"""llama3-8b [dense] — GQA, 128k vocab [arXiv:2407.21783]."""
from .base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, d_ff=14336, vocab_size=128256,
    attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128, rope_theta=5e5),
    param_dtype="bfloat16",
    source="arXiv:2407.21783",
)


def smoke():
    return CONFIG.replace(
        n_layers=2, d_model=256, d_ff=512, vocab_size=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=64),
        param_dtype="float32",
        remat=False)
