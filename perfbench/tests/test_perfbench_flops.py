"""The yardstick's operation and byte counts against hand counts at small
shapes."""
from perfbench import flops

DENSE = dict(num_layers=2, d_model=8, num_heads=4, num_kv_heads=2,
             head_dim=2, d_ff=16, vocab_size=10, num_experts=0,
             num_experts_per_tok=0)
MOE = dict(DENSE, num_experts=4, num_experts_per_tok=2)


def test_linear_flops_dense():
    # q 8x8, k 8x4, v 8x4, o 8x8 = 192; mlp 3 * 8 * 16 = 384; x2, 2 layers
    assert flops.linear_flops_per_token(DENSE) == 2 * 2 * (192 + 384)


def test_linear_flops_moe_counts_active_experts_and_router():
    # 2 experts of 384 each, router 8 x 4 = 32
    assert flops.linear_flops_per_token(MOE) == 2 * 2 * (192 + 768 + 32)


def test_attention_and_head():
    assert flops.head_flops(DENSE) == 2 * 8 * 10
    assert flops.attention_flops(DENSE, 5) == 4 * 2 * 4 * 2 * 5


def test_decode_tick():
    per = flops.linear_flops_per_token(DENSE) + flops.head_flops(DENSE)
    got = flops.decode_tick_flops(DENSE, [3, 7])
    assert got == 2 * per + flops.attention_flops(DENSE, 10)


def test_prefill_chunk_is_causal():
    # a chunk of 3 at offset 4: queries see 5, 6 and 7 keys
    got = flops.prefill_chunk_flops(DENSE, 4, 3)
    want = (3 * flops.linear_flops_per_token(DENSE) + flops.head_flops(DENSE)
            + flops.attention_flops(DENSE, 5 + 6 + 7))
    assert got == want


def test_k1_bytes_and_flops():
    # contexts 3 and 5, bf16: K and V rows 8 x 2 heads x 2 dims x 2 x 2 B,
    # q and out 2 slots x 4 heads x 2 dims x 2 B each
    b, f = flops.k1_launch(DENSE, [3, 5], 2)
    assert b == 8 * 2 * 2 * 2 * 2 + 2 * (2 * 4 * 2 * 2)
    assert f == 4 * 4 * 2 * 8
    tb, tf = flops.k1_ticks(DENSE, [[3, 5], [], [4, 6]], 2)
    b2, f2 = flops.k1_launch(DENSE, [4, 6], 2)
    assert (tb, tf) == (2 * (b + b2), 2 * (f + f2))
