"""A numpy-only box space: the port's stand-in for `gymnasium.spaces.Box`.

The JAX package's class adapters declare their action and observation
spaces with gymnasium's `Box`.  The port imports no gymnasium (the card's
host has none), so it keeps this small own copy of what the adapters and
their users read: `low`, `high`, `shape`, `dtype`, `sample()`, `seed()`
and `contains()`.
"""
from __future__ import annotations

import numpy as np


class Box:
    """The box [low, high] of `shape`, elementwise; bounds may be infinite.

    Either give `low` and `high` as arrays of one shape, or as scalars with
    `shape`.  `sample()` draws from the space's own `np.random.Generator`
    (`seed(seed)` restarts it): uniform on a bounded axis, a shifted
    exponential on a half-bounded one and a normal on an unbounded one, as
    gymnasium's Box does; integer boxes draw integers.
    """

    def __init__(self, low, high, shape=None, dtype=np.float32, seed=None):
        self.dtype = np.dtype(dtype)
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        self.shape = tuple(int(x) for x in shape)
        self.low = np.broadcast_to(np.asarray(low, self.dtype),
                                   self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, self.dtype),
                                    self.shape).copy()
        if (self.low > self.high).any():
            raise ValueError("Box: some low bound lies above its high bound")
        self.np_random = np.random.default_rng(seed)

    def seed(self, seed=None):
        """Restart the sampling generator from `seed`."""
        self.np_random = np.random.default_rng(seed)
        return [seed]

    def sample(self) -> np.ndarray:
        """One point of the box, from the space's generator."""
        low = self.low.astype(np.float64)
        high = self.high.astype(np.float64)
        if np.issubdtype(self.dtype, np.integer):
            return self.np_random.integers(
                low.astype(np.int64), high.astype(np.int64) + 1,
                size=self.shape).astype(self.dtype)
        lo_ok, hi_ok = np.isfinite(low), np.isfinite(high)
        out = self.np_random.normal(size=self.shape)
        both = lo_ok & hi_ok
        out[both] = self.np_random.uniform(low[both], high[both])
        only_lo = lo_ok & ~hi_ok
        out[only_lo] = low[only_lo] + self.np_random.exponential(
            size=int(only_lo.sum()))
        only_hi = hi_ok & ~lo_ok
        out[only_hi] = high[only_hi] - self.np_random.exponential(
            size=int(only_hi.sum()))
        return out.astype(self.dtype)

    def contains(self, x) -> bool:
        """Whether `x` has the box's shape and lies inside its bounds."""
        x = np.asarray(x)
        return bool(x.shape == self.shape
                    and np.can_cast(x.dtype, self.dtype, "same_kind")
                    and np.all(x >= self.low) and np.all(x <= self.high))

    def __contains__(self, x) -> bool:
        return self.contains(x)
