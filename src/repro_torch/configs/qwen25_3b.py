"""Qwen2.5-3B — the paper's second edge model (Results 1/2).
36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936 [arXiv:2412.15115]."""

from repro_torch.configs import specs
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2.5-3b", n_layers=36, d_model=2048, n_heads=16,
        n_kv_heads=2, head_dim=128, d_ff=11008, vocab_size=151936,
        norm="rmsnorm", mlp_kind="gated", act="silu", qkv_bias=True,
        tie_embeddings=True, rope_theta=1000000.0)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2.5-3b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=160, vocab_size=256,
        norm="rmsnorm", mlp_kind="gated", act="silu", qkv_bias=True,
        tie_embeddings=True)


def input_specs(shape: str):
    return specs.lm_input_specs(config(), shape)
