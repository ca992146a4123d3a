"""rwkv6-3b [ssm]: 32L d_model=2560 (attention-free) d_ff=8960 vocab=65536
— Finch, data-dependent decay [arXiv:2404.05892; hf].  head_dim=64
(40 heads)."""

from repro_torch.configs import specs
from repro_torch.models.rwkv6 import RWKV6Config


def config() -> RWKV6Config:
    return RWKV6Config(
        name="rwkv6-3b", n_layers=32, d_model=2560, head_dim=64,
        d_ff=8960, vocab_size=65536, lora_rank_decay=64, lora_rank_mix=32,
        chunk=32, tie_embeddings=False)


def smoke_config() -> RWKV6Config:
    return RWKV6Config(
        name="rwkv6-smoke", n_layers=2, d_model=64, head_dim=16,
        d_ff=128, vocab_size=256, lora_rank_decay=8, lora_rank_mix=4,
        chunk=8, tie_embeddings=False)


def input_specs(shape: str):
    return specs.lm_input_specs(config(), shape)
