"""whisper-large-v3 [audio]: enc-dec, 32L(+32 enc) d_model=1280 20H (kv=20)
d_ff=5120 vocab=51866, conv frontend STUB (input_specs supplies precomputed
frame embeddings, 1500 frames). [arXiv:2212.04356; unverified]

Backbone-only fidelity: layer/head/dim counts are exact; norms/positional
encoding are unified to the framework's RMSNorm+RoPE (noted in DESIGN.md).
vocab 51866 is not divisible by the model axis => embedding padded internally.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,  # decoder layers
    encoder_layers=32,
    encoder_seq=1500,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    activation="gelu",
    qkv_bias=True,
    rope_theta=10000.0,
    fsdp=True,
)

REDUCED = ModelConfig(
    name="whisper-reduced",
    family="audio",
    num_layers=2,
    encoder_layers=2,
    encoder_seq=16,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    activation="gelu",
    qkv_bias=True,
    fsdp=False,
    dtype="float32",
)
