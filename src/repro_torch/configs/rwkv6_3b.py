"""rwkv6-3b — [ssm] 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.
Finch: data-dependent per-channel decay. [arXiv:2404.05892; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40, head_dim=64,
    d_ff=8960, vocab_size=65536,
    block_pattern="rwkv6", ssm_head_dim=64,
)

SMOKE = CONFIG.replace(
    num_layers=3, d_model=64, d_ff=128, vocab_size=256, ssm_head_dim=16,
    num_heads=4, num_kv_heads=4, head_dim=16,
)
