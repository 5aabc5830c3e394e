"""The archive world with its textures shipped as BC1 ``.tex`` assets:
the world's scene (``world.py``), every texture a seeded BC1 chain at
its own size (``scenes/bcn.py``)."""

import numpy as np

from . import bcn, world


def build(cfg, seed):
    return bcn.compress(world.build(cfg, seed), "bc1",
                        np.random.default_rng([seed, 0xBC1]))
