"""The port's ``ops/bitpack.py`` against the JAX package's, on the CPU:
``pack_width`` and ``pack`` (numpy copies) give JAX's words, and
``unpack`` (torch) is their exact inverse and JAX's ``unpack_jax``, for
every width from 2 to 16, the extreme values (-32768 among them) and
ragged final groups; bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from project_desert_tortoise_tpu.ops import bitpack as J
from project_desert_tortoise_tpu_torch.ops import bitpack as P


@pytest.mark.parametrize("w", range(2, 17))
def test_pack_unpack_round_trip_matches_jax(w):
    rng = np.random.default_rng(w)
    lo, hi = -(1 << (w - 1)), (1 << (w - 1)) - 1
    for n in (1, 31, 32, 33, 1000, 1027):
        x = rng.integers(lo, hi + 1, n).astype(np.int16)
        x[0], x[-1] = lo, hi
        assert P.pack_width(x) == J.pack_width(x)
        packed = P.pack(x, w)
        assert packed.dtype == np.uint32 and packed.shape == (-(-n // 32), w)
        assert np.array_equal(packed, J.pack(x, w))
        words = torch.from_numpy(packed.view(np.int32))
        got = P.unpack(words, w, n)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), x)
        assert np.array_equal(got.numpy(),
                              np.asarray(J.unpack_jax(jnp.asarray(packed),
                                                      w, n)))
        # the words in a wider integer type unpack the same
        assert torch.equal(P.unpack(torch.from_numpy(
            packed.astype(np.int64)), w, n), got)


def test_pack_width_edges():
    assert P.pack_width(np.array([-32768], np.int16)) == 16
    assert P.pack_width(np.array([32767], np.int16)) == 16
    # |x| <= 4095 fits 13 signed bits; JAX's width counts |x| = 2^(w-1)
    # (the most negative w-bit value) as needing one bit more
    assert P.pack_width(np.array([-4095, 4095], np.int16)) == 13
    assert P.pack_width(np.array([-4096], np.int16)) == 14
    assert P.pack_width(np.zeros(5, np.int16), np.array([], np.int16)) == 2
    for x in ([-32768, 5], [1, -1, 0], [-4096, 4095], [-2]):
        x = np.array(x, np.int16)
        assert P.pack_width(x) == J.pack_width(x)
