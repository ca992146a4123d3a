"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention (W=4096)
[arXiv:2401.04088; hf].

The full config is ~141 B parameters, about 281 GB in bf16, and fits no
single card: the port runs it through its smoke config only (the grouped
GEMM and ring-cached local layers).

Sharding note: 8 experts < 16 model shards, so the MoE layout is "ffn"
(tensor-parallel within every expert), as in the reference
(`distributed/sharding.py`)."""

from repro_torch.configs import specs
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="mixtral-8x22b", n_layers=56, d_model=6144, n_heads=48,
        n_kv_heads=8, head_dim=128, d_ff=16384, vocab_size=32768,
        norm="rmsnorm", mlp_kind="gated", act="silu",
        sliding_window=4096, layer_pattern=("local",),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=16384, shard_mode="ffn"),
        tie_embeddings=False, rope_theta=1000000.0)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="mixtral-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
        norm="rmsnorm", mlp_kind="gated", act="silu",
        sliding_window=8, layer_pattern=("local",),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff=128, shard_mode="ffn"),
        tie_embeddings=False)


def input_specs(shape: str):
    return specs.lm_input_specs(config(), shape)
