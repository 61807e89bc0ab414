"""Device ms a batch under every HifiGanGenerator.forward."""
from perfbench import readers


def read(layer):
    return readers.range_ms(layer, "synth", "generator")
