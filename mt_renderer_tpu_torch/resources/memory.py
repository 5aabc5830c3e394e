"""In-memory resource manager — same resolution contract as
``ResourceManager`` but backed by a dict instead of the filesystem.

Used by the demo/bench scene builders and tests so no temp directories are
needed; resources are keyed by ``(normalised path, DTI hash)`` exactly as
the archive TOC keys them (reference resource_manager.rs:94-113).
"""

from __future__ import annotations

from ..dti import DTI
from .manager import Resource


def _norm(path: str) -> str:
    return str(path).replace("\\", "/")


class MemoryResourceManager:
    def __init__(self, entries: dict | None = None):
        # entries: {(path, dti_hash): bytes}
        self._entries: dict[tuple[str, int], bytes] = {}
        if entries:
            for (path, dti), data in entries.items():
                self.put(path, dti, data)

    def put(self, path: str, dti: DTI, data: bytes) -> None:
        self._entries[(_norm(path), dti.hash)] = bytes(data)

    def get_resource(self, path, dti: DTI) -> Resource:
        key = (_norm(str(path)), dti.hash)
        data = self._entries.get(key)
        if data is None:
            raise FileNotFoundError(f"no in-memory resource {path} ({dti.name})")
        return Resource(data, str(path), dti)

    get_resource_fancy = get_resource
