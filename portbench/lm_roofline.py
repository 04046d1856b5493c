"""Operations and bytes of a request of the ``lm_records`` cells (the
hybrid with DeepSeek-V3 as its backend), from the configuration's shapes
and the counts the inputs fix, and the least time they take on the card.

Matrix products run on the tensor cores: they are counted at the card's
dense bf16 rate, 989.4 TFLOP/s (NVIDIA H100 SXM data sheet, without
sparsity, at its full power limit). Everything else is counted as
``roofline.py`` counts it: bytes over the memory rate, other operations
(the router's float32 product, the switch's B1) over the float32 rate. A
request's least time is the largest of the three, since the tensor cores,
the other cores and the memory can all be busy at once. Each input byte is
counted read once and each output byte written once: every weight the
request needs (an expert only where a token reaches it), the embedding
rows its tokens name, the rows in and the answers out; the activations
between layers are not inputs and are not counted.
"""

from __future__ import annotations

from portbench import roofline

BF16_TENSOR = 989.4e12      # FLOP/s, H100 SXM dense bf16 (data sheet)


def least_s(n_bytes: float, matrix_ops: float, other_ops: float = 0.0
            ) -> float:
    return max(n_bytes / roofline.HBM, matrix_ops / BF16_TENSOR,
               other_ops / roofline.FP32)


def _blocks(n: int, block: int) -> int:
    return -(-n // block)


def expert_bytes(cfg: dict, block: int = 128) -> int:
    """One expert's three fp8 matrices and their float32 block scales."""
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    return 3 * d * f + 3 * 4 * _blocks(d, block) * _blocks(f, block)


def b9_work(cfg: dict, tokens: int, active: int, block: int = 128) -> list:
    """The two B9 launches of one MoE layer over ``tokens`` tokens (K
    choices each), ``active`` experts reached: [(bytes, matrix ops) of
    gate_up, of down]. gate_up reads x (bf16), the gate and up codes and
    scales of the active experts, writes H (bf16); down reads H, the down
    codes and scales and the pairs' weights and rows, writes Y (bf16)."""
    d, f = cfg["hidden_size"], cfg["moe_intermediate_size"]
    k = cfg["num_experts_per_tok"]
    pairs = tokens * k
    w = expert_bytes(cfg, block) // 3 * active
    gate_up = (2 * tokens * d + 2 * w + 4 * pairs + 2 * pairs * f,
               2 * 2 * pairs * d * f)
    down = (2 * pairs * f + w + 8 * pairs + 2 * pairs * d,
            2 * pairs * f * d)
    return [gate_up, down]


def layer_weight_bytes(cfg: dict, moe: bool, active: int,
                       block: int = 128) -> int:
    """A layer's weights as served: bf16 attention (and dense FFN, shared
    expert), the float32 router and bias, the active experts in fp8."""
    c = cfg
    d, h = c["hidden_size"], c["num_attention_heads"]
    nope, r = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    ql, kvl, dv = c["q_lora_rank"], c["kv_lora_rank"], c["v_head_dim"]
    attn = (d * ql + ql * h * (nope + r) + d * (kvl + r)
            + kvl * h * (nope + dv) + h * dv * d)
    n = 2 * attn + 2 * (3 * d + ql + kvl)                 # and the norms
    if not moe:
        return n + 2 * 3 * d * c["intermediate_size"]
    e = c["n_routed_experts"]
    fs = c["moe_intermediate_size"] * c["n_shared_experts"]
    return (n + 4 * (d * e + e) + 2 * 3 * d * fs
            + expert_bytes(cfg, block) * active)


def layer_ops(cfg: dict, rows: int, seq: int, moe: bool) -> tuple:
    """A layer over ``rows`` sequences of ``seq`` tokens: (matrix ops,
    other ops). Attention's scores and values are over the causal prefix;
    the router's product is float32."""
    c = cfg
    d, h = c["hidden_size"], c["num_attention_heads"]
    nope, r = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    ql, kvl, dv = c["q_lora_rank"], c["kv_lora_rank"], c["v_head_dim"]
    t = rows * seq
    proj = (d * ql + ql * h * (nope + r) + d * (kvl + r)
            + kvl * h * (nope + dv) + h * dv * d)
    pairs_qk = rows * seq * (seq + 1) // 2
    matrix = 2 * t * proj + 2 * pairs_qk * h * (nope + r + dv)
    if not moe:
        return matrix + 2 * t * 3 * d * c["intermediate_size"], 0
    k, e = c["num_experts_per_tok"], c["n_routed_experts"]
    f = c["moe_intermediate_size"]
    fs = f * c["n_shared_experts"]
    matrix += 2 * t * 3 * d * fs + 2 * t * k * 3 * d * f
    return matrix, 2 * t * d * e


def request_work(cfg: dict, rows: int, seq: int, active: list,
                 block: int = 128) -> tuple:
    """The backend's part of a request: ``rows`` sequences of ``seq``
    tokens through the configuration's layers (``active``: the experts
    reached in each MoE layer) and the head over the last positions.
    -> (bytes, matrix ops, other ops)."""
    c = cfg
    d, v = c["hidden_size"], c["vocab_size"]
    n_bytes = 2 * rows * seq * d + 2 * d * v + 2 * d     # embed rows, head
    matrix = 2.0 * rows * d * v
    other, mi = 0.0, 0
    for li in range(c["num_hidden_layers"]):
        moe = li >= c["first_k_dense_replace"]
        n_bytes += layer_weight_bytes(c, moe, active[mi] if moe else 0,
                                      block)
        mo, oo = layer_ops(c, rows, seq, moe)
        matrix += mo
        other += oo
        mi += moe
    return n_bytes, matrix, other
