"""Model substrate of the port: shared layers and the transformer family."""
