from .camera import Camera
from .input_state import InputState, Key

__all__ = ["Camera", "InputState", "Key"]
