"""Per-frame input accumulation (reference ``src/input_state.rs``)."""

from __future__ import annotations

import enum


class Key(enum.IntFlag):
    W = 1 << 0
    A = 1 << 1
    S = 1 << 2
    D = 1 << 3


class InputState:
    def __init__(self):
        self.frame_mouse_delta = (0.0, 0.0)
        self._keys = Key(0)

    def next_frame(self) -> None:
        self.frame_mouse_delta = (0.0, 0.0)

    def add_mouse_movement(self, dx: float, dy: float) -> None:
        x, y = self.frame_mouse_delta
        self.frame_mouse_delta = (x + dx, y + dy)

    def set_key(self, key: Key) -> None:
        self._keys |= key

    def unset_key(self, key: Key) -> None:
        self._keys &= ~key

    def has_key(self, key: Key) -> bool:
        return bool(self._keys & key)
