"""Device ms a batch under AVSREncoder.forward."""
from perfbench import readers


def read(layer):
    return readers.range_ms(layer, "synth", "encoder")
