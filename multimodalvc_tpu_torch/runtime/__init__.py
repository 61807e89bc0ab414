"""Training runtime of the port: the trainer and its checkpoints."""
