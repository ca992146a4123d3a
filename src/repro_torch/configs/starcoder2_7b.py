"""starcoder2-7b [dense]: 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152 — GQA, RoPE, non-gated GELU MLP with bias, LayerNorm
[arXiv:2402.19173; hf]."""

from repro_torch.configs import specs
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="starcoder2-7b", n_layers=32, d_model=4608, n_heads=36,
        n_kv_heads=4, head_dim=128, d_ff=18432, vocab_size=49152,
        norm="layernorm", mlp_kind="dense", act="gelu_tanh", use_bias=True,
        tie_embeddings=True, rope_theta=1000000.0)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="starcoder2-7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=256, vocab_size=256,
        norm="layernorm", mlp_kind="dense", act="gelu_tanh", use_bias=True,
        tie_embeddings=True)


def input_specs(shape: str):
    return specs.lm_input_specs(config(), shape)
