"""llama-3.2-vision-11b — [vlm] 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, cross-attn image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Backbone only: the vision frontend is a stub — ``input_specs`` supplies
precomputed patch embeddings (B, num_patches, d_model)."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256,
    cross_attn_every=5, num_patches=4096,
    rope_theta=500000.0,
)

SMOKE = CONFIG.replace(
    num_layers=4, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, cross_attn_every=2, num_patches=8,
    attn_chunk=0,
)
