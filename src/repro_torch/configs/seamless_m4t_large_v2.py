"""seamless-m4t-large-v2 [audio]: enc-dec 24L+24L d_model=1024 16H (MHA)
d_ff=8192 vocab=256206 [arXiv:2308.11596; hf].

The audio frontend is a stub (`models/frontends.AudioStub`): precomputed
speech frame embeddings [B, T <= 4096, d_model] feed the encoder."""

from repro_torch.configs import specs
from repro_torch.models.encdec import EncDecConfig


def config() -> EncDecConfig:
    return EncDecConfig(
        name="seamless-m4t-large-v2", n_enc_layers=24, n_dec_layers=24,
        d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64, d_ff=8192,
        vocab_size=256206, act="relu", max_source_len=4096,
        max_target_len=32768, tie_embeddings=True)


def smoke_config() -> EncDecConfig:
    return EncDecConfig(
        name="seamless-smoke", n_enc_layers=2, n_dec_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        vocab_size=256, act="relu", max_source_len=32, max_target_len=64,
        tie_embeddings=True)


def input_specs(shape: str):
    return specs.encdec_input_specs(config(), shape)
