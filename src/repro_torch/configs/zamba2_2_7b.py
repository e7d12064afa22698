"""zamba2-2.7b — [hybrid] 54 Mamba2 layers d_model=2560, ssm_state=64, with a
single SHARED attention+MLP block (32H, d_ff=10240) applied every 6 layers.
vocab=32000. [arXiv:2411.15242; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    block_pattern="zamba2", ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    conv_kernel=4, shared_attn_every=6,
)

SMOKE = CONFIG.replace(
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, ssm_state=16, ssm_head_dim=16,
    shared_attn_every=2, gla_chunk=8, attn_chunk=0,
)
