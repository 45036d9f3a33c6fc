"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536.
Finch: linear attention with data-dependent per-channel decay; constant-size
recurrent state => long_500k applicable. [arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,  # wkv heads, head_size 64
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    activation="relu_sq",  # rwkv channel-mix uses squared ReLU
    ssm_state=64,  # per-head state is head_dim x head_dim
    rope_theta=0.0,  # no rope: token-shift provides positional signal
    fsdp=True,
)

REDUCED = ModelConfig(
    name="rwkv6-reduced",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    activation="relu_sq",
    ssm_state=16,
    rope_theta=0.0,
    fsdp=False,
    dtype="float32",
)
