"""olmoe-1b-7b — [moe] 16L d_model=2048 16H (kv=16) d_ff=1024(expert)
vocab=50304, 64 experts top-8. [arXiv:2409.02060; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1024, vocab_size=50304,
    moe=True, num_experts=64, top_k=8, d_ff_expert=1024,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=32, vocab_size=256, num_experts=8, top_k=2, d_ff_expert=32,
    attn_chunk=0,
)
