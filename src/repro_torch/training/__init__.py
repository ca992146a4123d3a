"""Training substrate of the port: optimizer, data, checkpointing,
compression, elastic scaling and the straggler watchdog."""
