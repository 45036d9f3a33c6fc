"""Config system: model configs, input-shape specs, and the arch registry.

Every assigned architecture gets a ``src/repro/configs/<id>.py`` exposing
``CONFIG`` (the exact published config) and ``REDUCED`` (a tiny same-family
config for CPU smoke tests). ``get_config("grok-1-314b")`` resolves either.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str = "dense"  # dense | moe | vlm | hybrid | ssm | audio

    # transformer backbone
    num_layers: int = 12
    d_model: int = 512
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 0  # 0 => d_model // num_heads
    d_ff: int = 2048
    vocab_size: int = 32000
    activation: str = "swiglu"  # swiglu | geglu | gelu
    qkv_bias: bool = False
    qk_norm: bool = False
    parallel_block: bool = False  # GPT-J-style parallel attn+FFN residual
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5

    # mixture of experts
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # ssm / hybrid (rwkv6, hymba)
    ssm_state: int = 0
    d_inner: int = 0  # 0 => 2 * d_model
    ssm_head_dim: int = 64
    sliding_window: int = 0  # 0 = full attention
    num_global_layers: int = 0  # hybrid: this many layers use full attention

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0  # fixed frame count from the (stubbed) conv frontend

    # vlm (pixtral)
    num_patches: int = 0  # patch embeddings prepended by the (stubbed) vision tower

    # numerics (paper C6: multi-precision with expanding accumulation)
    dtype: str = "bfloat16"
    accum_dtype: str = "float32"
    optimizer_dtype: str = "float32"

    # distribution knobs
    fsdp: bool = True  # shard params over the data axis during training (ZeRO-3)
    weights_2d_tp: bool = False  # serving: shard big weight dims over data axis too
    remat: str = "full"  # full | dots | none
    seq_shard_activations: bool = True  # Megatron-SP style residual sharding
    scan_unroll: int = 1  # layer-scan unroll (dry-run cost extraction sets >1)
    # §Perf hillclimb knobs (beyond-paper optimizations; defaults = baseline)
    tp_reduce_bf16: bool = False  # cast expert output before the TP all-reduce
    microbatches: int = 1  # gradient accumulation (shrinks activation temps)
    gather_save_policy: bool = False  # remat policy: save TP/FSDP gathers
    explicit_attn_sharding: bool = False  # pin q seq-sharded / kv replicated
    halo_shift: bool = False  # token-shift via 1-column ppermute halo exchange

    # training hyperparameters
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100

    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    def resolved_d_inner(self) -> int:
        return self.d_inner if self.d_inner else 2 * self.d_model

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def num_params(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, f, hd = self.d_model, self.d_ff, self.resolved_head_dim()
        H, K = self.num_heads, self.num_kv_heads
        gate_mult = 2 if self.activation in ("swiglu", "geglu") else 1
        ffn = d * f * gate_mult + f * d
        if self.num_experts:
            ffn = ffn * self.num_experts + d * self.num_experts  # + router
        attn = d * (H * hd) + 2 * d * (K * hd) + (H * hd) * d
        if self.family == "ssm":
            attn = 0
        per_layer = attn + ffn + 2 * d
        if self.family in ("ssm", "hybrid"):
            di, n = self.resolved_d_inner(), self.ssm_state
            ssm = d * 2 * di + di * n * 2 + di + di * d  # in-proj, B/C, dt, out
            per_layer += ssm
        n_params = self.num_layers * per_layer + self.vocab_size * d
        if not self.tie_embeddings:
            n_params += self.vocab_size * d
        if self.encoder_layers:
            n_params += self.encoder_layers * (attn + d * f * gate_mult + f * d + 2 * d)
            n_params += self.num_layers * (d * (H * hd) + 2 * d * (K * hd) + (H * hd) * d + d)
        return n_params

    def num_active_params(self) -> int:
        """Active parameters per token (MoE: only routed experts count)."""
        if not self.num_experts:
            return self.num_params()
        d, f = self.d_model, self.d_ff
        gate_mult = 2 if self.activation in ("swiglu", "geglu") else 1
        per_expert = d * f * gate_mult + f * d
        inactive = (self.num_experts - self.experts_per_token) * per_expert
        return self.num_params() - self.num_layers * inactive


@dataclass(frozen=True)
class GraniteHybridConfig(ModelConfig):
    """A ``ModelConfig`` with what Granite-4.0-H's layers add (the
    ``granite_hybrid`` family, ``models/granite_hybrid.py``): a block kind
    per layer (``"mamba"`` or ``"attention"``), the Mamba-2 mixer's conv
    width and B/C groups, the shared expert's width, the three scalar
    multipliers, and ``nope`` (no positional encoding). The Mamba-2 sizes
    are the base's ``d_inner``, ``ssm_head_dim`` and ``ssm_state``; the
    routed experts' width is ``d_ff``. The base keeps its fields, which
    the tests hold field for field to the reference package's."""

    layer_types: tuple = ()
    conv_kernel: int = 4
    ssm_groups: int = 1
    shared_d_ff: int = 0
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    nope: bool = False
    attention_multiplier: float = dataclasses.field(kw_only=True)

    def __post_init__(self):
        object.__setattr__(self, "layer_types", tuple(self.layer_types))
        if len(self.layer_types) != self.num_layers or not set(self.layer_types) <= {
                "mamba", "attention"}:
            raise ValueError(f"{self.name}: layer_types must give 'mamba' or 'attention' "
                             f"for each of {self.num_layers} layers")

    def layers_of(self, kind: str) -> list:
        return [i for i, t in enumerate(self.layer_types) if t == kind]

    @property
    def ssm_heads(self) -> int:
        return self.resolved_d_inner() // self.ssm_head_dim

    @property
    def conv_dim(self) -> int:
        return self.resolved_d_inner() + 2 * self.ssm_groups * self.ssm_state

    def num_params(self) -> int:
        d, hd, f, E = self.d_model, self.resolved_head_dim(), self.d_ff, self.num_experts
        H, K, di, nh = self.num_heads, self.num_kv_heads, self.resolved_d_inner(), self.ssm_heads
        attn = d * (H * hd) + 2 * d * (K * hd) + (H * hd) * d
        mamba = (d * (di + self.conv_dim + nh) + self.conv_dim * (self.conv_kernel + 1)
                 + 3 * nh + di + di * d)
        ffn = E * 3 * d * f + d * E + 3 * d * self.shared_d_ff + 2 * d
        n_attn = len(self.layers_of("attention"))
        total = n_attn * attn + (self.num_layers - n_attn) * mamba + self.num_layers * ffn
        return total + self.vocab_size * d * (1 if self.tie_embeddings else 2) + d

    def num_active_params(self) -> int:
        inactive = (self.num_experts - self.experts_per_token) * 3 * self.d_model * self.d_ff
        return self.num_params() - self.num_layers * inactive


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

ARCH_IDS = [
    "grok-1-314b",
    "phi3.5-moe-42b-a6.6b",
    "pixtral-12b",
    "qwen1.5-4b",
    "gemma-2b",
    "qwen3-14b",
    "command-r-35b",
    "hymba-1.5b",
    "rwkv6-3b",
    "whisper-large-v3",
]

PAPER_CONFIG_IDS = ["occamy-gptj"]  # the paper's own LLM workload (Fig. 12)


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Which (arch x shape) cells run. long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "long_500k skipped: pure full-attention arch (quadratic regime)"
    return True, ""


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "p")


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.REDUCED if reduced else mod.CONFIG


def all_arch_ids(include_paper: bool = True) -> list[str]:
    return ARCH_IDS + (PAPER_CONFIG_IDS if include_paper else [])
