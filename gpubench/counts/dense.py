"""Model FLOPs a token of the dense decoder, training (forward and
backward, no recomputation): 6 times the weights on the token's path
(every matrix of every layer and the head, tied or not; norms and biases
are not matrices) plus causal attention's ``6 * S * d_attn`` a layer."""


def matrices(s) -> int:
    """The weights one token multiplies by in one layer."""
    d, attn, kv = s.d, s.n_heads * s.head_dim, s.n_kv * s.head_dim
    return 2 * d * attn + 2 * d * kv + 3 * d * s.d_ff


def per_token(s, seq: int) -> float:
    """``s``: a ``reference.model.Spec``; ``seq``: the sequence length."""
    weights = s.n_layers * matrices(s) + s.vocab * s.d
    return 6.0 * weights + 6.0 * seq * s.n_heads * s.head_dim * s.n_layers
