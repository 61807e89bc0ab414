"""Share of the traced synthesis window with nothing on the device, in %."""
from perfbench import readers


def read(layer):
    return readers.idle_share(layer, "synth")
