"""K1's forward in the training step: its least time over its device time, in %."""
from perfbench import readers


def read(layer):
    return readers.attention_share(layer, "train", "fwd")
