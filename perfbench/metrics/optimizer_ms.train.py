"""The optimizer's span a step: entry into the update to its last kernel."""
from perfbench import readers


def read(layer):
    return readers.span_ms(layer, "train", "optimizer")
