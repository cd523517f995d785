"""mamba2-130m [ssm] — SSD (state-space duality), attn-free
[arXiv:2405.21060]."""
from .base import MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, d_ff=0, vocab_size=50280,
    attn=None,
    mamba=MambaConfig(d_state=128, headdim=64, expand=2, chunk=128,
                      conv_width=4),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)


def smoke():
    return CONFIG.replace(
        n_layers=2, d_model=256, vocab_size=512,
        mamba=MambaConfig(d_state=32, headdim=32, expand=2, chunk=32,
                          conv_width=4),
        remat=False)
