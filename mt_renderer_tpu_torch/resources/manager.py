"""An opened resource: its bytes, engine path and DTI.

The filesystem and archive resolution of the JAX package's
``ResourceManager`` stays there; the scene builders here resolve through
``MemoryResourceManager``."""

from __future__ import annotations

import io

from ..dti import DTI


class Resource(io.BytesIO):
    """An opened resource (always fully materialised bytes)."""

    def __init__(self, data: bytes, path: str, dti: DTI):
        super().__init__(data)
        self.path = path
        self.dti = dti
