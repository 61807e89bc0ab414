"""Training criterions of the port."""
