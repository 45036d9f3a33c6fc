"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16 — parallel attn+mamba heads per block; sliding-window attention
with a few global layers makes long_500k tractable. [arXiv:2411.13676; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    activation="swiglu",
    ssm_state=16,
    d_inner=3200,
    ssm_head_dim=64,
    sliding_window=1024,
    num_global_layers=3,  # first / middle / last layers use full attention
    rope_theta=10000.0,
    fsdp=True,
)

REDUCED = ModelConfig(
    name="hymba-reduced",
    family="hybrid",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    activation="swiglu",
    ssm_state=8,
    d_inner=128,
    ssm_head_dim=16,
    sliding_window=8,
    num_global_layers=1,
    fsdp=False,
    dtype="float32",
)
