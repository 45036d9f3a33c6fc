"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
Pixtral-ViT frontend is a STUB (input_specs supplies patch embeddings); the
backbone is the mistral-nemo-style decoder. [hf:mistralai/Pixtral-12B-2409]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,  # mistral-nemo uses explicit head_dim=128 (not d_model/H)
    d_ff=14336,
    vocab_size=131072,
    activation="swiglu",
    rope_theta=1_000_000.0,
    num_patches=64,  # vision-tower stub emits this many patch embeddings
    fsdp=True,
)

REDUCED = ModelConfig(
    name="pixtral-reduced",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    activation="swiglu",
    num_patches=4,
    fsdp=False,
    dtype="float32",
)
