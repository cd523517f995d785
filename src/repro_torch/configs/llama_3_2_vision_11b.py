"""llama-3.2-vision-11b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision].

The ViT vision encoder + projector are stubbed (assignment carve-out):
``image_embeds`` [B, 1601, d_model] arrive precomputed.  A gated
cross-attention block every 5th layer, as in the model card.
"""
from .base import AttnConfig, ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, d_ff=14336, vocab_size=128256,
    attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128, rope_theta=5e5),
    vision=VisionConfig(n_image_tokens=1601, cross_attn_every=5),
    param_dtype="bfloat16",
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)


def smoke():
    return CONFIG.replace(
        n_layers=10, d_model=256, d_ff=512, vocab_size=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=64),
        vision=VisionConfig(n_image_tokens=17, cross_attn_every=5),
        param_dtype="float32",
        remat=False)
