"""Serving substrate of the port: arrivals, queueing, the analytical board
model and the PyTorch inference engine."""
