from .manager import Resource
from .memory import MemoryResourceManager

__all__ = ["Resource", "MemoryResourceManager"]
