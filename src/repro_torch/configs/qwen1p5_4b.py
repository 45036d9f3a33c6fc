"""qwen1.5-4b [dense]: 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936, QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]

20 heads are not divisible by the 16-way model axis: the sharding chooser
replicates attention projections and shards d_ff/vocab instead (see
parallel/sharding.py).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151936,
    activation="swiglu",
    qkv_bias=True,
    rope_theta=5_000_000.0,
    fsdp=True,
)

REDUCED = ModelConfig(
    name="qwen1.5-reduced",
    family="dense",
    num_layers=2,
    d_model=80,
    num_heads=5,
    num_kv_heads=5,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    activation="swiglu",
    qkv_bias=True,
    fsdp=False,
    dtype="float32",
)
