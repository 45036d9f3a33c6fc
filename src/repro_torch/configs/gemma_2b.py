"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000,
GeGLU, head_dim=256. [arXiv:2403.08295; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,  # MQA
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    activation="geglu",
    tie_embeddings=True,
    rope_theta=10000.0,
    fsdp=True,
)

REDUCED = ModelConfig(
    name="gemma-reduced",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    activation="geglu",
    tie_embeddings=True,
    fsdp=False,
    dtype="float32",
)
