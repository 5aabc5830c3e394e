"""MTR_LOG-gated parser narration + hexdump error context.

The reference narrates every parsed record at ``debug!`` level, gated by
``env_logger``/``RUST_LOG`` (e.g. archive TOC entries at
``rarchive.rs:99-107``, material states at ``rmaterial.rs:211-230``), and
log levels are its de-facto debugging UI. Equivalent here:

    MTR_LOG=debug python -m mt_renderer_tpu_torch.frame_profile …

narrates per record on stderr. Parse failures raise ``parse_error``
ValueErrors carrying a hexdump window around the offending bytes, so the
first bad byte of real game data is diagnosable without a debugger.
"""

from __future__ import annotations

import logging
import os

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}

_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    root = logging.getLogger("mt_renderer_tpu_torch.host")
    name = os.environ.get("MTR_LOG", "").strip().lower()
    if not name:
        root.addHandler(logging.NullHandler())
        return
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter("[%(levelname).1s %(name)s] %(message)s")
    )
    root.addHandler(handler)
    root.setLevel(_LEVELS.get(name, logging.INFO))


def get_logger(name: str) -> logging.Logger:
    """Package logger, lazily wiring the MTR_LOG handler."""
    _configure()
    return logging.getLogger(f"mt_renderer_tpu_torch.host.{name}")


def parse_error(msg: str, data=None, offset: int = 0,
                window: int = 64) -> ValueError:
    """A ValueError whose message includes a hexdump of the bytes around
    ``offset`` — raise this from parsers so failures on real game data
    show the offending record, not just a bare message."""
    if data is not None and len(data):
        from .structio import hexdump

        start = max(0, (offset - window // 2) & ~0xF)
        chunk = bytes(data[start:start + window])
        lines = hexdump(chunk).rstrip("\n").splitlines()
        dump = "\n".join(
            f"  {start + 16 * i:08x}  {line}" for i, line in enumerate(lines)
        )
        msg = f"{msg}\n  context at +0x{offset:x}:\n{dump}"
    return ValueError(msg)
