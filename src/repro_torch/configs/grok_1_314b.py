"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    activation="geglu",  # grok-1 experts: gelu(h_v) * h_w
    num_experts=8,
    experts_per_token=2,
    rope_theta=10000.0,
    weights_2d_tp=True,  # 314B params: serving needs weights over (data, model)
    fsdp=True,
)

REDUCED = ModelConfig(
    name="grok-1-314b-reduced",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    activation="geglu",
    num_experts=4,
    experts_per_token=2,
    fsdp=False,
    dtype="float32",
)
