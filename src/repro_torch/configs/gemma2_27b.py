"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000 — local(4096)+global alternating, logit softcaps (attn 50,
final 30), GeGLU, sandwich norms, query scale 1/sqrt(d/h)
[arXiv:2408.00118; hf].

At full width it is 27.23 B parameters, 54.5 GB in bf16: it fits one
80 GB card with room for the engine's caches."""

from repro_torch.configs import specs
from repro_torch.models.transformer import TransformerConfig


def config() -> TransformerConfig:
    return TransformerConfig(
        name="gemma2-27b", n_layers=46, d_model=4608, n_heads=32,
        n_kv_heads=16, head_dim=128, d_ff=36864, vocab_size=256000,
        norm="rmsnorm", mlp_kind="gated", act="gelu_tanh",
        attn_softcap=50.0, final_softcap=30.0,
        query_scale=(4608 / 32) ** -0.5,
        embed_scale=True, post_norms=True,
        sliding_window=4096, layer_pattern=("local", "global"),
        tie_embeddings=True, rope_theta=10000.0)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="gemma2-27b-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=192, vocab_size=256,
        norm="rmsnorm", mlp_kind="gated", act="gelu_tanh",
        attn_softcap=50.0, final_softcap=30.0, query_scale=16.0 ** -0.5,
        embed_scale=True, post_norms=True,
        sliding_window=8, layer_pattern=("local", "global"),
        tie_embeddings=True)


def input_specs(shape: str):
    return specs.lm_input_specs(config(), shape)
