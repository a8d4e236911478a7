"""Published peaks of the card, NVIDIA's data sheet for the H100 SXM part
(dense rates, at the full 700 W power limit)."""

H100 = dict(
    bf16_flops=989e12,       # bfloat16 / float16 tensor cores
    fp32_flops=67e12,        # float32 outside the tensor cores
    hbm_bytes_per_s=3.35e12,
    memory_bytes=80e9,
)
