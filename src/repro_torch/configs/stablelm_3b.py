"""stablelm-3b [dense] — MHA (kv=32) [hf:stabilityai/stablelm-2-1_6b family]."""
from .base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, d_ff=6912, vocab_size=50304,
    attn=AttnConfig(n_heads=32, n_kv_heads=32, head_dim=80, rope_theta=1e4),
    source="hf:stabilityai/stablelm-2-1_6b (3B sibling card)",
)


def smoke():
    return CONFIG.replace(
        n_layers=2, d_model=256, d_ff=512, vocab_size=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=64),
        remat=False)
