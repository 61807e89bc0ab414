"""The port's token-block packing (data/batching.py: pack_token_blocks in
its four break modes, block_to_dataset_index) against the JAX package's,
whose 'complete' modes run its native library or its Python loop, on random
sentence lengths."""
import numpy as np
import pytest

from multimodalvc_tpu.data import batching as jb
from multimodalvc_tpu_torch.data import batching as tb

MODES = [None, "none", "eos", "complete", "complete_doc"]


@pytest.mark.parametrize("mode", MODES)
def test_pack_token_blocks_matches_jax(mode):
    rng = np.random.default_rng(3)
    for trial in range(20):
        sizes = rng.integers(1, 12, rng.integers(1, 60))
        if trial % 2:
            sizes[rng.random(len(sizes)) < 0.2] = 1  # document separators
        for block in (1, 4, 8, 16):
            want = jb.pack_token_blocks(sizes, block, mode)
            got = tb.pack_token_blocks(sizes, block, mode)
            assert got.dtype == np.int64 and got.shape[1:] == (2,)
            np.testing.assert_array_equal(got, want, err_msg=f"{mode} {block} {sizes}")
            if len(got):
                np.testing.assert_array_equal(tb.block_to_dataset_index(sizes, got),
                                              jb.block_to_dataset_index(sizes, want))


def test_pack_token_blocks_fairseq_cases():
    """tests/test_data.py's hand-worked cases."""
    sizes = [5, 3, 7, 2, 5]
    np.testing.assert_array_equal(tb.pack_token_blocks(sizes, 8, "complete"),
                                  [[0, 8], [8, 15], [15, 22]])
    np.testing.assert_array_equal(tb.pack_token_blocks([3, 2, 1, 7, 1, 1, 4], 8, "complete_doc"),
                                  [[0, 5], [6, 13], [15, 19]])
    idx = tb.block_to_dataset_index(sizes, np.asarray([[5, 13], [13, 22], [9, 9]]))
    np.testing.assert_array_equal(idx, [[1, 0, 2], [2, 5, 4], [2, 1, 2]])
    with pytest.raises(ValueError, match="break_mode"):
        tb.pack_token_blocks(sizes, 8, "sentence")
