"""smollm-360m — [dense] 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.
llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    num_layers=32, d_model=960, num_heads=15, num_kv_heads=5, head_dim=64,
    d_ff=2560, vocab_size=49152, tie_embeddings=True,
)

SMOKE = CONFIG.replace(
    num_layers=3, d_model=48, num_heads=3, num_kv_heads=1, head_dim=16,
    d_ff=96, vocab_size=256, attn_chunk=0,
)
