"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152
— llama-arch small [hf:HuggingFaceTB/SmolLM-360M; hf]."""

from repro_torch.configs import specs
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="smollm-360m", n_layers=32, d_model=960, n_heads=15,
        n_kv_heads=5, head_dim=64, d_ff=2560, vocab_size=49152,
        norm="rmsnorm", mlp_kind="gated", act="silu",
        tie_embeddings=True, rope_theta=10000.0)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="smollm-360m-smoke", n_layers=2, d_model=48, n_heads=3,
        n_kv_heads=1, head_dim=16, d_ff=128, vocab_size=256,
        norm="rmsnorm", mlp_kind="gated", act="silu", tie_embeddings=True)


def input_specs(shape: str):
    return specs.lm_input_specs(config(), shape)
