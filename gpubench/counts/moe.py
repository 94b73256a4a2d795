"""Model FLOPs a token of the MoE decoder, training (forward and
backward, no recomputation): 6 times the weights on the token's path
(attention, the router, the ``top_k`` experts it goes to, the head; never
the capacity padding) plus causal attention's ``6 * S * d_attn`` a
layer."""


def active(s) -> int:
    """The weights one token multiplies by in one layer."""
    d, attn, kv = s.d, s.n_heads * s.head_dim, s.n_kv * s.head_dim
    return (2 * d * attn + 2 * d * kv + d * s.n_experts
            + s.top_k * 3 * d * s.d_expert)


def per_token(s, seq: int) -> float:
    weights = s.n_layers * active(s) + s.vocab * s.d
    return 6.0 * weights + 6.0 * seq * s.n_heads * s.head_dim * s.n_layers
