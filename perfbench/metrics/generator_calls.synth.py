"""HifiGanGenerator calls a batch."""
from perfbench import readers


def read(layer):
    return readers.calls(layer, "synth", "generator")
