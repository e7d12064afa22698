"""granite-20b — [dense] 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152. llama-arch, code. [arXiv:2405.04324; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1, head_dim=128,
    d_ff=24576, vocab_size=49152,
)

SMOKE = CONFIG.replace(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=256, attn_chunk=0,
)
