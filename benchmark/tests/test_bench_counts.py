"""The counts of operations and bytes against small cases worked by hand."""

from benchmark.lib import counts as C
from benchmark.lib.peaks import least_time

CFG = {"hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 2,
       "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 2, "vocab_size": 10,
       "sliding_window": 2}


def test_pairs_by_hand():
    # 4 queries, window 10: 1 + 2 + 3 + 4
    assert C.causal_pairs(4, 10) == 10
    # window 2 (q - k <= 2 -> at most 3 keys): 1 + 2 + 3 + 3 + 3
    assert C.causal_pairs(5, 2) == 12
    # the last 2 of those 5 queries, after 3 held: 3 + 3
    assert C.causal_pairs(2, 2, start=3) == 6
    assert C.causal_pairs(3, 2) + C.causal_pairs(2, 2, start=3) == C.causal_pairs(5, 2)
    # documents attend to themselves: 3 and 2 tokens, window 10: 6 + 3
    assert C.packed_pairs([3, 2], 10) == 9
    assert C.keys_seen(0, 2) == 1 and C.keys_seen(7, 2) == 3


def test_layer_weights_and_attention_ops_by_hand():
    # q 8x8, k and v 8x4 each, o 8x8, gate, up 8x16, down 16x8
    assert C.proj_params(CFG) == 64 + 32 + 32 + 64 + 3 * 128
    # 4 * pairs * H * d
    assert C.attn_ops(10, CFG) == 4 * 10 * 4 * 2
    f = C.flash_ops(10, CFG)
    assert (f["fwd"], f["dq"], f["dkv"]) == (2 * 2 * 2 * 10 * 4, 3 * 2 * 2 * 10 * 4,
                                              4 * 2 * 2 * 10 * 4)


def test_k1_bytes_by_hand():
    # 5 keys: 2 kv heads x (K and V: 2 int8 + one f32 scale each) = 5 * 2 * 2 * (2 + 4);
    # q read and out written, 4 heads x 2 dims x 2 bytes each
    assert C.k1_bytes(5, CFG) == 5 * 2 * 2 * (2 + 4) + 2 * 4 * 2 * 2
    assert C.k1_ops(5, CFG) == 4 * 5 * 4 * 2


def test_train_step_ops_by_hand():
    n_mm = 2 * C.proj_params(CFG) + 10 * 8
    attn = 2 * C.attn_ops(C.packed_pairs([3, 2], 2), CFG)
    assert C.train_step_ops(CFG, [3, 2])["bf16"] == 6 * n_mm * 5 + 3 * attn
    lora = {"r": 1, "targets": {"wq": (8, 8)}}
    assert C.train_step_ops(CFG, [3, 2], lora)["bf16"] == 4 * n_mm * 5 + 3 * attn + 6 * 2 * 16 * 5


def test_serve_token_ops_and_least_time():
    o = C.serve_token_ops(CFG, 3, head_cols=5)
    assert o["int8"] == 2 * 2 * C.proj_params(CFG)
    assert o["bf16"] == 2 * 4 * 3 * 4 * 2 + 2 * 8 * 5
    # bound by bytes, then by operations
    assert least_time(1.0, 3.35e12, "bf16") == 1.0
    assert least_time(989e12 * 2, 1.0, "bf16") == 2.0


def test_w8a8_pass_by_hand():
    from benchmark.lib.readers import _w8a8_pass

    big = dict(CFG, hidden_size=4096, intermediate_size=14336, num_attention_heads=32,
               num_key_value_heads=8, head_dim=128, num_hidden_layers=1)
    # one row: bound by the int8 weights (plus the row in, the int32 results out)
    P = C.proj_params(big)
    # each product reads its input row (a) and writes int32 results (4 b)
    acts = (6 * 4096 + 14336) + 4 * (4096 + 2 * 1024 + 4096 + 2 * 14336 + 4096)
    assert abs(_w8a8_pass(big, 1) - (P + acts) / 3.35e12) < 1e-15
    # 4096 rows: bound by the operations at the int8 peak
    assert abs(_w8a8_pass(big, 4096) - 2 * 4096 * P / 1979e12) < 1e-12
