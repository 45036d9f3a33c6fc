"""command-r-35b [dense]: 40L d_model=8192 64H (GQA kv=8) d_ff=22528
vocab=256000, no bias, parallel residual block, tied embeddings.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    activation="swiglu",
    qkv_bias=False,
    parallel_block=True,  # Cohere arch: attn and FFN share the residual input
    tie_embeddings=True,
    rope_theta=8_000_000.0,
    fsdp=True,
)

REDUCED = ModelConfig(
    name="command-r-reduced",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    activation="swiglu",
    parallel_block=True,
    tie_embeddings=True,
    fsdp=False,
    dtype="float32",
)
