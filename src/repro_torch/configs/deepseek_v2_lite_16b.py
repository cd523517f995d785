"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 2 shared + 64 routed top-6
[arXiv:2405.04434].

Note: the assignment line lists both
"MoE 64e top-6" and "160 routed"; DeepSeek-V2-*Lite* has 64 routed experts
(160 belongs to full V2), so we implement 64 routed + 2 shared, top-6.
"""
from .base import AttnConfig, MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, d_ff=10944, vocab_size=102400,
    attn=AttnConfig(n_heads=16, n_kv_heads=16, head_dim=128, rope_theta=1e4,
                    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                                  qk_rope_head_dim=64, v_head_dim=128)),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                  capacity_factor=1.25),
    param_dtype="bfloat16",
    source="arXiv:2405.04434",
)


def smoke():
    return CONFIG.replace(
        n_layers=2, d_model=256, d_ff=512, vocab_size=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=32, rope_theta=1e4,
                        mla=MLAConfig(kv_lora_rank=64, qk_nope_head_dim=32,
                                      qk_rope_head_dim=16, v_head_dim=32)),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, n_shared=1),
        param_dtype="float32",
        remat=False)
