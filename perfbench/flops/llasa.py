"""Model operations of the Llasa decoder with the sigma head, per token."""
from __future__ import annotations


def layer_matmul_params(s: dict) -> int:
    h, f = s["hidden"], s["ffn"]
    q, kv = s["heads"] * s["head_dim"], s["kv_heads"] * s["head_dim"]
    return h * q + 2 * h * kv + q * h + 3 * h * f


def matmul_params(s: dict) -> int:
    """Every weight a token's forward multiplies by (the embedding is a
    gather and is left out): the layers, `audio_linear` and the head."""
    d, p = s["latent"], s["audio_proj"]
    return s["layers"] * layer_matmul_params(s) + d * p + p * d + d * d


def attention_flops(s: dict, context: int) -> float:
    """QK^T and PV of one query over `context` keys, every layer."""
    return 4.0 * s["layers"] * s["heads"] * s["head_dim"] * context


def forward_token_flops(s: dict, context: int) -> float:
    return 2.0 * matmul_params(s) + attention_flops(s, context)


def prefill_flops(s: dict, n: int) -> float:
    """A prompt of n tokens, causal."""
    return 2.0 * matmul_params(s) * n + 4.0 * s["layers"] * s["heads"] * s["head_dim"] \
        * n * (n + 1) / 2


def train_row_flops(s: dict, n: int) -> float:
    """Forward and backward of one packed row of n tokens: 6 N a token plus
    three times the causal attention's forward."""
    return 6.0 * matmul_params(s) * n + 3 * 4.0 * s["layers"] * s["heads"] \
        * s["head_dim"] * n * (n + 1) / 2
