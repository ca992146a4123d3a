"""recurrentgemma-9b [hybrid]: 38 temporal blocks d_model=4096, local attn
16H (MQA kv=1) head_dim=256 window=2048, d_ff=12288 GeGLU, vocab=256000 —
RG-LRU + local attention, pattern (rec, rec, attn) [arXiv:2402.19427;
unverified]."""

from repro_torch.configs import specs
from repro_torch.models.rglru import RGLRUConfig


def config() -> RGLRUConfig:
    return RGLRUConfig(
        name="recurrentgemma-9b", n_layers=38, d_model=4096, n_heads=16,
        n_kv_heads=1, head_dim=256, d_ff=12288, vocab_size=256000,
        lru_width=4096, sliding_window=2048,
        pattern=("recurrent", "recurrent", "attention"),
        tie_embeddings=True)


def smoke_config() -> RGLRUConfig:
    return RGLRUConfig(
        name="recurrentgemma-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=1, head_dim=16, d_ff=128, vocab_size=256,
        lru_width=64, sliding_window=8,
        pattern=("recurrent", "recurrent", "attention"),
        tie_embeddings=True)


def input_specs(shape: str):
    return specs.lm_input_specs(config(), shape)
