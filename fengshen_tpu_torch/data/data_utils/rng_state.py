"""A collator's ``numpy.random.RandomState`` as checkpoint state.

The MLM collators draw every sample from one ``RandomState`` (``np_rng``)
that lives as long as the run. :class:`SeededCollator` gives them
``state_dict`` / ``load_state_dict``, which ``utils/universal_checkpoint``
saves with each step and restores on resume, so a resumed run draws the
batches the uninterrupted run draws.
"""

from __future__ import annotations

import numpy as np


class SeededCollator:
    """Mixin for a collator holding its generator in ``self.np_rng``."""

    np_rng: np.random.RandomState

    def state_dict(self) -> dict:
        """The generator's state in JSON types."""
        name, keys, pos, has_gauss, gauss = self.np_rng.get_state()
        return {"np_rng": [name, keys.tolist(), int(pos), int(has_gauss),
                           float(gauss)]}

    def load_state_dict(self, state: dict) -> None:
        name, keys, pos, has_gauss, gauss = state["np_rng"]
        self.np_rng.set_state((name, np.asarray(keys, np.uint32), pos,
                               has_gauss, gauss))
