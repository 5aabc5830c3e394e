from .model import DEBUG_PALETTE, DrawBatch, Model, build_draw_batch

__all__ = ["DrawBatch", "Model", "build_draw_batch", "DEBUG_PALETTE"]
