"""Model FLOPs of the traced training steps over the window and the bf16 peak, in %."""
from perfbench import readers


def read(layer):
    return readers.mfu(layer, "train")
