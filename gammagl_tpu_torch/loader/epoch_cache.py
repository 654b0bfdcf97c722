"""Epoch-level sample caching: the host sampler's cost spread over epochs
(counterpart of `gammagl_tpu/loader/epoch_cache.py`).

Where the host samples slower than the card steps, the usual remedy is
to reuse each epoch's sampled subgraphs for a few epochs ("lazy
resampling"): epoch 0 pays for sampling, epochs 1..k-1 replay the cached
batches (in a new order), so their time is the card's alone. The
reference's loaders resample every epoch (gammagl/loader/
neighbor_sampler.py).

Works with any re-iterable loader whose items are host objects
(NeighborSamplerLoader, NodeLoader, ...). Items are held as they are:
ids and edge blocks, not features, which stay in the device cache.
"""

import numpy as np

__all__ = ["EpochCache"]


class EpochCache:
    """Iterate a loader; replay cached batches between resampling epochs.

    Parameters
    ----------
    loader : any re-iterable yielding per-batch host objects
    resample_every : int, re-run the loader every k-th epoch (1 = no
        caching, as the plain loader).
    reshuffle : bool, permute the replay order each cached epoch.
    seed : int, the seed of the replay order's ``default_rng``.
    """

    def __init__(self, loader, resample_every=5, reshuffle=True, seed=0):
        if resample_every < 1:
            raise ValueError("resample_every must be >= 1")
        self.loader = loader
        self.resample_every = resample_every
        self.reshuffle = reshuffle
        self._rng = np.random.default_rng(seed)
        self._cache = None
        self._epoch = 0

    def __len__(self):
        if self._cache is not None:
            return len(self._cache)
        return len(self.loader)

    def invalidate(self):
        """Drop the cache; the next epoch resamples."""
        self._cache = None
        self._epoch = 0

    def __getattr__(self, name):
        # the loader's attributes (e.g. NeighborSamplerLoader.sample)
        return getattr(self.loader, name)

    def __iter__(self):
        fresh = (self._cache is None
                 or self._epoch % self.resample_every == 0)
        self._epoch += 1
        if fresh:
            cache = []
            for item in self.loader:
                cache.append(item)
                yield item
            self._cache = cache
            return
        order = (self._rng.permutation(len(self._cache))
                 if self.reshuffle else range(len(self._cache)))
        for i in order:
            yield self._cache[i]
