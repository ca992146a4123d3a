"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (MHA kv=32) d_ff=8192
vocab=32064 — phi3-mini backbone + CLIP patch-embedding stub
[hf:microsoft/Phi-3-vision-128k-instruct; hf].

The vision frontend is a STUB (`models/frontends.py`): precomputed patch
embeddings [B, 576, d_model] are prepended to the token stream through
`prefix_embeddings`.  The engine serves the backbone on tokens alone, as
the reference's does."""

from repro_torch.configs import specs
from repro_torch.models.frontends import VisionStub
from repro_torch.models.transformer import TransformerConfig

STUB = VisionStub(num_patches=576, d_model=3072)


def config() -> TransformerConfig:
    return TransformerConfig(
        name="phi-3-vision-4.2b", n_layers=32, d_model=3072, n_heads=32,
        n_kv_heads=32, head_dim=96, d_ff=8192, vocab_size=32064,
        norm="rmsnorm", mlp_kind="gated", act="silu",
        tie_embeddings=True, rope_theta=10000.0,
        num_prefix_embeddings=576)


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name="phi-3-vision-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=160, vocab_size=256,
        norm="rmsnorm", mlp_kind="gated", act="silu", tie_embeddings=True,
        num_prefix_embeddings=8)


def input_specs(shape: str):
    # Patch embeddings ride along for train/prefill shapes.
    return specs.lm_input_specs(config(), shape, prefix_len=576)
