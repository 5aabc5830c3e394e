"""rArchive (.arc) — the engine's zlib-compressed resource archive.

On-disk layout (reference ``src/rarchive.rs``):

* 8-byte header: magic ``"ARC\\0"``, u16 version (7), u16 resource count
  (``rarchive.rs:16-17,26-30``).
* ``count`` × 0x90-byte TOC records: 128-byte NUL-padded path, u32 DTI hash,
  u32 compressed size, u32 bitfield (bits 0-28 uncompressed size, bits 29-31
  quality), u32 absolute data offset (``rarchive.rs:32-41``).
* zlib streams back to back.

Paths inside archives use ``\\`` separators and carry no extension — the
extension is implied by the DTI (``resource_manager.rs``). Packing compresses
entries in parallel across a thread pool (the reference uses rayon,
``rarchive.rs:228-238``).
"""

from __future__ import annotations

import json
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .. import dti as dti_mod
from ..dti import DTI
from ..utils import Reader, cstr, get_logger, parse_error

log = get_logger("formats.arc")

ARCHIVE_MAGIC = b"ARC\0"
ARCHIVE_VERSION = 7
ORGSIZE_MASK = (1 << 29) - 1
QUALITY_MASK = (1 << 3) - 1
PATH_MAXLEN = 127

HEADER_DTYPE = np.dtype([
    ("magic", "S4"),
    ("version", "<u2"),
    ("num_resources", "<u2"),
])

RESOURCE_INFO_DTYPE = np.dtype([
    ("path", "S128"),
    ("dti_type", "<u4"),
    ("size_compressed", "<u4"),
    ("bitfield_orgsize_quality", "<u4"),
    ("offset", "<u4"),
])


def normalize_path(path: str) -> str:
    """Archive-internal form: backslash separators."""
    return path.replace("/", "\\")


@dataclass
class ResourceInfo:
    path: str
    dti: DTI
    size_compressed: int
    size_uncompressed: int
    quality: int
    offset: int


class ArchiveFile:
    """Parsed .arc with random access to decompressed resources."""

    def __init__(self, src):
        r = Reader(src)
        header = r.struct(HEADER_DTYPE)
        if bytes(header["magic"]) != ARCHIVE_MAGIC.rstrip(b"\0"):
            raise parse_error(
                f"bad archive magic: {bytes(header['magic'])!r}", r.data, 0
            )
        if int(header["version"]) != ARCHIVE_VERSION:
            raise parse_error(
                f"unsupported archive version: {header['version']}", r.data, 4
            )
        log.debug("archive: version %d, %d resources",
                  int(header["version"]), int(header["num_resources"]))

        self._data = r.data
        raw = r.struct_array(RESOURCE_INFO_DTYPE, int(header["num_resources"]))

        self.resources: list[ResourceInfo] = []
        self._index: dict[tuple[str, int], ResourceInfo] = {}
        for i, rec in enumerate(raw):
            bf = int(rec["bitfield_orgsize_quality"])
            dti = dti_mod.from_hash(int(rec["dti_type"]))
            if dti is None:
                raise parse_error(
                    f"unknown DTI hash 0x{int(rec['dti_type']):08x} "
                    f"for {cstr(rec['path'])!r}",
                    r.data,
                    HEADER_DTYPE.itemsize + i * RESOURCE_INFO_DTYPE.itemsize,
                )
            info = ResourceInfo(
                path=cstr(rec["path"]),
                dti=dti,
                size_compressed=int(rec["size_compressed"]),
                size_uncompressed=bf & ORGSIZE_MASK,
                quality=(bf >> 29) & QUALITY_MASK,
                offset=int(rec["offset"]),
            )
            log.debug(
                "  [%d] %s <%s> %d -> %d bytes q%d @0x%x", i, info.path,
                dti.name, info.size_compressed, info.size_uncompressed,
                info.quality, info.offset,
            )
            self.resources.append(info)
            self._index[(info.path, info.dti.hash)] = info

    def resource_infos(self) -> list[ResourceInfo]:
        return self.resources

    def get_resource(self, path: str, dti: DTI) -> bytes | None:
        info = self._index.get((normalize_path(path), dti.hash))
        if info is None:
            return None
        return self.get_resource_by_info(info)

    def raw_resource_bytes(self, info: ResourceInfo) -> bytes:
        """The still-compressed zlib stream of one resource."""
        return bytes(self._data[info.offset:info.offset + info.size_compressed])

    def get_resource_by_info(self, info: ResourceInfo) -> bytes:
        comp = self._data[info.offset:info.offset + info.size_compressed]
        out = zlib.decompress(comp)
        if len(out) != info.size_uncompressed:
            raise ValueError(
                f"{info.path}: decompressed {len(out)} != TOC {info.size_uncompressed}"
            )
        return out


class ArchiveWriter:
    """Byte-compatible .arc writer with thread-pooled deflate."""

    def __init__(self, compression_level: int = -1):
        self._entries: list[tuple[str, DTI, int, bytes]] = []
        self._level = compression_level

    def add_file(self, path: str, dti: DTI, quality: int, data: bytes):
        path = normalize_path(path)
        if len(path.encode()) > PATH_MAXLEN:
            raise ValueError(f"path too long ({len(path)} > {PATH_MAXLEN}): {path}")
        if quality > QUALITY_MASK:
            raise ValueError(f"quality {quality} out of range")
        if len(data) > ORGSIZE_MASK:
            raise ValueError(f"resource too large: {len(data)}")
        self._entries.append((path, dti, quality, bytes(data)))

    def tobytes(self) -> bytes:
        n = len(self._entries)
        # thread-pool deflate (the reference's rayon analog,
        # rarchive.rs:228-238); zlib releases the GIL
        with ThreadPoolExecutor(
            max_workers=min(32, (os.cpu_count() or 4))
        ) as pool:
            compressed = list(pool.map(
                lambda e: zlib.compress(e[3], self._level), self._entries
            ))

        toc = np.zeros(n, dtype=RESOURCE_INFO_DTYPE)
        offset = HEADER_DTYPE.itemsize + n * RESOURCE_INFO_DTYPE.itemsize
        for i, ((path, dti, quality, data), comp) in enumerate(
            zip(self._entries, compressed)
        ):
            toc[i]["path"] = path.encode()
            toc[i]["dti_type"] = dti.hash
            toc[i]["size_compressed"] = len(comp)
            toc[i]["bitfield_orgsize_quality"] = (
                (len(data) & ORGSIZE_MASK) | ((quality & QUALITY_MASK) << 29)
            )
            toc[i]["offset"] = offset
            offset += len(comp)

        header = np.zeros(1, dtype=HEADER_DTYPE)
        header[0]["magic"] = ARCHIVE_MAGIC
        header[0]["version"] = ARCHIVE_VERSION
        header[0]["num_resources"] = n
        return header.tobytes() + toc.tobytes() + b"".join(compressed)

    def save(self, fp):
        fp.write(self.tobytes())


# -- CLI helpers (reference rarchive.rs cli_util, arctool.rs, unpackall.rs) ---

FILE_INFO_NAME = "info.json"


def unpack_archive(archive_path: Path, out_dir: Path) -> int:
    """Extract every resource, writing an ``info.json`` manifest for repack."""
    archive_path, out_dir = Path(archive_path), Path(out_dir)
    with open(archive_path, "rb") as f:
        arc = ArchiveFile(f)

    infos = list(arc.resource_infos())
    blobs = [zlib.decompress(arc.raw_resource_bytes(i)) for i in infos]

    file_infos = []
    for info, data in zip(infos, blobs):
        if len(data) != info.size_uncompressed:
            raise ValueError(
                f"{info.path}: decompressed {len(data)} != "
                f"TOC {info.size_uncompressed}"
            )
        ext = info.dti.file_ext
        if ext is None:
            raise ValueError(f"DTI {info.dti.name} has no file extension")
        rel = Path(info.path.replace("\\", "/")).with_suffix("." + ext)
        out_path = out_dir / rel
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_bytes(data)
        file_infos.append(
            {"path": info.path, "dti": info.dti.name, "quality": info.quality}
        )

    (out_dir / FILE_INFO_NAME).write_text(json.dumps(file_infos, indent=2))
    return len(file_infos)


def repack_archive(unpacked_dir: Path, out_path: Path) -> int:
    """Rebuild an archive from an unpack dir's ``info.json`` manifest."""
    unpacked_dir, out_path = Path(unpacked_dir), Path(out_path)
    file_infos = json.loads((unpacked_dir / FILE_INFO_NAME).read_text())

    writer = ArchiveWriter()
    for info in file_infos:
        dti = dti_mod.from_name(info["dti"])
        if dti is None:
            raise ValueError(f"unknown DTI name {info['dti']!r}")
        fs_path = (unpacked_dir / info["path"].replace("\\", "/")).with_suffix(
            "." + dti.file_ext
        )
        writer.add_file(info["path"], dti, info["quality"], fs_path.read_bytes())

    with open(out_path, "wb") as f:
        writer.save(f)
    return len(file_infos)
