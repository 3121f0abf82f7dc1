"""The work of DeepSeek-V2-Lite's cells, counted from the configuration's
shapes alone (never from the program), against ``_yardstick``'s peaks.

A held expert's slot costs 12 products of 2·d·f a training step: 3 in the
forward (gate, up, down), 3 again in remat's recompute and 6 in the backward
(two for each weight: its input's and its own gradient).  The slots a layer
are counted at the even router's share, T·K·held/E for T tokens.  MLA's
attention is 2 products forward (QKᵀ at Dk = dn + dr, PV at Dv) and 3·Dk +
2·Dv backward, each 2·T·S·D over the causal half.
"""
from __future__ import annotations


def moe_layers(m: dict) -> int:
    return m["num_layers"] - m["first_k_dense"]


def held_slots_per_token(m: dict) -> float:
    """Slots a token sends to the held experts at the even router's share."""
    return m["experts_per_token"] * m["experts_held"] / m["num_experts"]


def expert_flops_per_slot(m: dict) -> float:
    """One training step's products for one slot of a held expert."""
    return 12 * 2 * m["d_model"] * m["moe_d_ff"]


def mla_attention_flops(m: dict, rows: int, seq: int, dk_products: int, dv_products: int) -> float:
    """One layer's attention call over ``rows`` sequences: each product
    2·T·S·D at the causal half, ``dk_products`` at Dk and ``dv_products`` at Dv."""
    dk = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
    return rows * m["num_heads"] * seq * seq * (dk_products * dk + dv_products * m["v_head_dim"])


def forward_flops_per_token(m: dict, seq: int) -> float:
    """The forward's products a token: MLA's projections and attention in
    every layer, the dense layer's SwiGLU, the shared experts, the held
    experts at ``held_slots_per_token`` evaluations, the router and the head
    over the vocabulary's slice."""
    d, H = m["d_model"], m["num_heads"]
    dn, dr, dv, r = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"], m["kv_lora_rank"]
    L, Lm = m["num_layers"], moe_layers(m)
    mla = d * H * (dn + dr) + d * (r + dr) + r * H * (dn + dv) + H * dv * d
    attn = mla_attention_flops(m, 1, seq, 1, 1) / seq
    swiglu = 3 * d
    moe = (swiglu * m["moe_d_ff"] * (m["num_shared_experts"] + held_slots_per_token(m))
           + d * m["num_experts"])
    return (L * (2 * mla + attn) + m["first_k_dense"] * 2 * swiglu * m["d_ff"]
            + Lm * 2 * moe + 2 * d * m["vocab_size"])
