"""granite-4.0-h-small [granite_hybrid]: 40L d_model=4096, 36 Mamba-2 layers
(128 heads of 64, state 128, conv 4) and 4 GQA attention layers (32H, kv=8,
head 128, no positional encoding) at 5/15/25/35; MoE in every layer (72
experts of 768, top-10) plus a shared expert of 1536; vocab 100352, tied.
[hf:ibm-granite/granite-4.0-h-small config.json; modeling_granitemoehybrid]

Not in ``ARCH_IDS``: the reference package has no Granite, and the ids
there are held to it. ``get_config("granite-4.0-h-small")`` resolves it by
module name.
"""
from repro_torch.configs.base import GraniteHybridConfig

_TYPES = tuple("attention" if i in (5, 15, 25, 35) else "mamba" for i in range(40))

CONFIG = GraniteHybridConfig(
    name="granite-4.0-h-small",
    family="granite_hybrid",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=768,
    vocab_size=100352,
    activation="swiglu",
    tie_embeddings=True,
    rope_theta=10000.0,
    norm_eps=1e-5,
    num_experts=72,
    experts_per_token=10,
    ssm_state=128,
    d_inner=8192,
    ssm_head_dim=64,
    layer_types=_TYPES,
    conv_kernel=4,
    ssm_groups=1,
    shared_d_ff=1536,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    attention_multiplier=0.0078125,
    nope=True,
)

REDUCED = GraniteHybridConfig(
    name="granite-4.0-h-reduced",
    family="granite_hybrid",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab_size=512,
    activation="swiglu",
    tie_embeddings=True,
    norm_eps=1e-5,
    num_experts=4,
    experts_per_token=2,
    ssm_state=16,
    d_inner=128,
    ssm_head_dim=16,
    layer_types=("mamba", "attention", "mamba", "mamba"),
    conv_kernel=4,
    ssm_groups=1,
    shared_d_ff=48,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    attention_multiplier=0.0078125,
    nope=True,
    fsdp=False,
    dtype="float32",
)
