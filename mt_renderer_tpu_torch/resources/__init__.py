from .manager import Resource, ResourceManager
from .memory import MemoryResourceManager

__all__ = ["Resource", "ResourceManager", "MemoryResourceManager"]
