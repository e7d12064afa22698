"""musicgen-large — [audio] 48L d_model=2048 32H (kv=32) d_ff=8192
vocab=2048 (EnCodec codebook). Decoder-only over audio tokens; the EnCodec
frontend is a stub — ``input_specs`` supplies precomputed frame embeddings.
[arXiv:2306.05284; hf]"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048, embedding_inputs=True,
)

SMOKE = CONFIG.replace(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=64, attn_chunk=0,
)
