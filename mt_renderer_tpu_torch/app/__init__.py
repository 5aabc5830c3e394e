from .camera import Camera

__all__ = ["Camera"]
