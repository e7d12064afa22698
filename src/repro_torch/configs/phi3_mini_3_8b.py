"""phi3-mini-3.8b — [dense] 32L d_model=3072 32H (MHA kv=32) d_ff=8192
vocab=32064. RoPE SwiGLU. [arXiv:2404.14219; unverified]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064,
)

SMOKE = CONFIG.replace(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, attn_chunk=0,
)
