"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (MHA kv=16) d_ff=1024
vocab=50304, MoE 64 experts top-8, QK-norm [arXiv:2409.02060; hf]."""

from repro_torch.configs import specs
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16,
        n_kv_heads=16, head_dim=128, d_ff=1024, vocab_size=50304,
        norm="rmsnorm", mlp_kind="gated", act="silu", qk_norm=True,
        moe=MoEConfig(n_experts=64, top_k=8, d_ff=1024,
                      shard_mode="expert"),
        tie_embeddings=False, rope_theta=10000.0)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="olmoe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=64, vocab_size=256,
        norm="rmsnorm", mlp_kind="gated", act="silu", qk_norm=True,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=64, shard_mode="expert"),
        tie_embeddings=False)


def input_specs(shape: str):
    return specs.lm_input_specs(config(), shape)
