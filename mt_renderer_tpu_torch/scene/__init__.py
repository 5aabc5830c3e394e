from .model import DEBUG_PALETTE, DrawBatch, build_draw_batch

__all__ = ["DrawBatch", "build_draw_batch", "DEBUG_PALETTE"]
