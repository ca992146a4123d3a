"""Model substrate of the port: shared layers and the transformer, rwkv6,
rglru and encoder-decoder families."""
