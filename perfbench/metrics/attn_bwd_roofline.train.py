"""The attention backward (FlashAttentionGrad) counted as FlashAttention-2's, in %."""
from perfbench import readers


def read(layer):
    return readers.attention_share(layer, "train", "bwd")
