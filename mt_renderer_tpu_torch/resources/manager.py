"""Resource manager — resolves named, typed resources to byte streams.

Policy mirrors the reference (``src/resource_manager.rs``):

* resources are addressed by an extensionless engine path plus a DTI; the
  file extension comes from the DTI (``resource_manager.rs:82-92``),
* a loose file under the base directory wins; otherwise every mounted
  archive is scanned (``resource_manager.rs:94-113``),
* ``"<archive>:<path>"`` auto-mounts the named archive first
  (``resource_manager.rs:69-80``),
* mounting the same archive twice is a no-op (``resource_manager.rs:50-65``).
"""

from __future__ import annotations

import io
from pathlib import Path

from .. import dti as dti_mod
from ..dti import DTI
from ..formats.arc import ArchiveFile


class Resource(io.BytesIO):
    """An opened resource (always fully materialised bytes)."""

    def __init__(self, data: bytes, path: str, dti: DTI):
        super().__init__(data)
        self.path = path
        self.dti = dti


class ResourceManager:
    def __init__(self, base_path):
        self.base_path = Path(base_path)
        self._archives: dict[Path, ArchiveFile] = {}

    def add_archive(self, path) -> None:
        path = Path(path)
        if path in self._archives:
            return
        arc_dti = dti_mod.from_name("rArchive")
        fs_path = self.base_path / path.with_suffix("." + arc_dti.file_ext)
        with open(fs_path, "rb") as f:
            self._archives[path] = ArchiveFile(f)

    def get_resource_fancy(self, path: str, dti: DTI) -> Resource:
        """Accepts ``"archive:path"`` to mount ``archive`` on the fly."""
        archive_path, sep, rest = path.partition(":")
        if sep:
            self.add_archive(Path(archive_path))
            path = rest
        return self.get_resource(path, dti)

    def get_resource(self, path, dti: DTI) -> Resource:
        if dti.file_ext is None:
            raise FileNotFoundError(f"DTI {dti.name} has no file extension")
        rel = Path(str(path).replace("\\", "/"))
        fs_path = self.base_path / rel.with_suffix("." + dti.file_ext)
        if fs_path.is_file():
            return Resource(fs_path.read_bytes(), str(path), dti)

        for archive in self._archives.values():
            data = archive.get_resource(str(rel), dti)
            if data is not None:
                return Resource(data, str(path), dti)

        raise FileNotFoundError(f"couldn't find resource {fs_path} ({dti.name})")
