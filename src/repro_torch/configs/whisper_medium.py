"""whisper-medium [audio] — enc-dec, conv frontend stubbed
[arXiv:2212.04356].

24 encoder + 24 decoder layers, d_model=1024, MHA (kv=16), GeLU MLP.
The mel+conv frontend is stubbed: ``frames`` [B, 1500, 1024] arrive
precomputed (assignment carve-out).
"""
from .base import AttnConfig, EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, d_ff=4096, vocab_size=51865,
    attn=AttnConfig(n_heads=16, n_kv_heads=16, head_dim=64, rope_theta=1e4),
    encoder=EncoderConfig(n_layers=24, n_ctx=1500),
    act="gelu",
    source="arXiv:2212.04356",
)


def smoke():
    return CONFIG.replace(
        n_layers=2, d_model=256, d_ff=512, vocab_size=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=64),
        encoder=EncoderConfig(n_layers=2, n_ctx=30),
        remat=False)
