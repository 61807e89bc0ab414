"""Configuration dataclasses of the port (the training groups so far)."""
