from .crc import crc32, crc32_py, dti_hash
from .log import get_logger, parse_error
from .structio import (
    Reader,
    cstr,
    hexdump,
    read_cstring,
    read_struct,
    read_struct_array,
)

__all__ = [
    "crc32",
    "crc32_py",
    "dti_hash",
    "get_logger",
    "parse_error",
    "Reader",
    "cstr",
    "hexdump",
    "read_cstring",
    "read_struct",
    "read_struct_array",
]
