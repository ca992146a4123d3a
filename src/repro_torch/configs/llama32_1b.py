"""Llama3.2-1B — the paper's primary edge model (Results 1/2).
16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256 [Meta 2025]."""

from repro_torch.configs import specs
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="llama3.2-1b", n_layers=16, d_model=2048, n_heads=32,
        n_kv_heads=8, head_dim=64, d_ff=8192, vocab_size=128256,
        norm="rmsnorm", mlp_kind="gated", act="silu",
        tie_embeddings=True, rope_theta=500000.0)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="llama3.2-1b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=160, vocab_size=256,
        norm="rmsnorm", mlp_kind="gated", act="silu", tie_embeddings=True)


def input_specs(shape: str):
    return specs.lm_input_specs(config(), shape)
