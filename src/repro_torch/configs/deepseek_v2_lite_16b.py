"""deepseek-v2-lite-16b — [moe] 27L d_model=2048 16H d_ff=1408(expert)
vocab=102400, MLA kv_lora=512, 2 shared + 64 routed experts top-6, first
layer dense (d_ff=10944). [arXiv:2405.04434; hf]

The two shared experts are mathematically merged into one SwiGLU MLP of
hidden width 2*1408=2816 (exact for SwiGLU-sum)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=10944, vocab_size=102400,
    moe=True, num_experts=64, top_k=6, d_ff_expert=1408, d_ff_shared=2816,
    first_dense=1,
    mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
)

SMOKE = CONFIG.replace(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=160, vocab_size=256,
    num_experts=8, top_k=2, d_ff_expert=32, d_ff_shared=64, first_dense=1,
    kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    attn_chunk=0,
)
