"""The port's 128-bit timestamp order (``ts_lt`` / ``ts_le`` / ``ts_eq``)
against the JAX package's on seeded triples at the protocol's boundaries:
epoch < 2^48, hlc < 2^63, flags < 2^16, and int64 words whose top bit is
set (the unsigned order the sign flip implements)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from accord_tpu.ops import packing as rp
from accord_tpu_torch.ops import packing as pp

BOUNDS = [0, 1, (1 << 16) - 1, 1 << 16, (1 << 47) - 1, 1 << 47,
          (1 << 48) - 1, 1 << 48, (1 << 62), (1 << 63) - 1, 1 << 63,
          (1 << 64) - 1]


def _triples(rng, n):
    words = np.array([pp.to_i64(b) for b in BOUNDS], np.int64)
    msb = rng.choice(words, n)
    lsb = rng.choice(words, n)
    node = rng.choice(np.array([-1, 0, 1, 2, (1 << 31) - 1], np.int32), n)
    return msb, lsb, node


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ts_order_equal(seed):
    rng = np.random.default_rng(seed)
    a = _triples(rng, 512)
    b = _triples(rng, 512)
    b = tuple(np.where(rng.random(512) < 0.3, x, y) for x, y in zip(a, b))
    for name in ("ts_lt", "ts_le", "ts_eq"):
        ref = getattr(rp, name)(*map(jnp.asarray, a), *map(jnp.asarray, b))
        port = getattr(pp, name)(*map(torch.from_numpy, a),
                                 *map(torch.from_numpy, b))
        np.testing.assert_array_equal(np.asarray(ref), port.numpy())


def test_ts_lt_is_the_unsigned_order():
    """Against python's exact integer order on (u64, u64, node)."""
    rng = np.random.default_rng(3)
    a = _triples(rng, 256)
    b = _triples(rng, 256)
    port = pp.ts_lt(*map(torch.from_numpy, a), *map(torch.from_numpy, b))
    want = [(pp.to_u64(am), pp.to_u64(al), int(an))
            < (pp.to_u64(bm), pp.to_u64(bl), int(bn))
            for am, al, an, bm, bl, bn in zip(*a, *b)]
    assert port.tolist() == want


def test_host_helpers_equal():
    for v in BOUNDS:
        assert pp.to_i64(v) == rp.to_i64(v)
        assert pp.to_u64(pp.to_i64(v)) == rp.to_u64(rp.to_i64(v))
