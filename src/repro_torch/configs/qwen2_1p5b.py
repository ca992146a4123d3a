"""qwen2-1.5b [dense]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — GQA, QKV bias [arXiv:2407.10671; hf]."""

from repro_torch.configs import specs
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-1.5b", n_layers=28, d_model=1536, n_heads=12,
        n_kv_heads=2, head_dim=128, d_ff=8960, vocab_size=151936,
        norm="rmsnorm", mlp_kind="gated", act="silu", qkv_bias=True,
        tie_embeddings=True, rope_theta=1000000.0)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-1.5b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=160, vocab_size=256,
        norm="rmsnorm", mlp_kind="gated", act="silu", qkv_bias=True,
        tie_embeddings=True)


def input_specs(shape: str):
    return specs.lm_input_specs(config(), shape)
