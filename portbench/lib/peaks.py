"""The card's published peaks, frozen here so that the yardstick does not
move with the program: NVIDIA H100 SXM5 at its 700 W limit, dense rates
without sparsity (NVIDIA's H100 datasheet; the whitepaper's 989.4 TFLOP/s
for bf16). A card set below 700 W reaches less; every run prints the
card's name, and PERF.md its power limit.

``tests/test_portbench_counts.py`` holds these to the port's
``core/topology.py`` and fp32 rate, so the two cannot drift apart
unnoticed."""

FLOPS = {
    "bfloat16": 989.4e12,  # tensor cores, fp32 accumulate
    "float16": 989.4e12,
    "float32": 67e12,  # FFMA outside the tensor cores: exact fp32, no TF32
}
HBM_BYTES_PER_S = 3.35e12
