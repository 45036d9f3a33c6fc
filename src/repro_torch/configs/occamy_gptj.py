"""occamy-gptj: the paper's own LLM inference workload (Section V-C, Fig. 12).
GPT-J-6B: 28L d_model=4096 16H d_ff=16384 vocab=50400, parallel residual
block, run in FP16 (here bf16) non-autoregressive (= prefill) mode."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="occamy-gptj",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=16384,
    vocab_size=50400,
    activation="gelu",
    parallel_block=True,  # GPT-J computes attn and FFN from the same input
    rope_theta=10000.0,
    fsdp=True,
)

REDUCED = ModelConfig(
    name="occamy-gptj-reduced",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    activation="gelu",
    parallel_block=True,
    fsdp=False,
    dtype="float32",
)
