"""Multi-device frames: the band split and the geometry split
(``tiles``), and the same over ``torch.distributed`` processes
(``multihost``)."""

from .tiles import (make_row_mesh, render_frame_geomsplit,
                    render_frame_multichip)

__all__ = ["make_row_mesh", "render_frame_geomsplit",
           "render_frame_multichip"]
