"""The archive world with its textures shipped as BC7 ``.tex`` assets:
the world's scene (``world.py``), every texture a seeded BC7 chain of
the configuration's ``bc7_modes`` at its own size (``scenes/bcn.py``)."""

import numpy as np

from . import bcn, world


def build(cfg, seed):
    return bcn.compress(world.build(cfg, seed), "bc7",
                        np.random.default_rng([seed, 0xBC]),
                        cfg["bc7_modes"])
