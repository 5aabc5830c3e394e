"""rGUI (.gui) — GUI layout resource.

The reference leaves this format unimplemented (a ``todo!()`` stub,
``src/rgui.rs:8-10``); no layout information exists to build
against.  This module records the same gap explicitly.
"""

from __future__ import annotations


class GuiFile:
    def __init__(self, src):
        raise NotImplementedError(
            "rGUI parsing is unimplemented (the reference's rgui.rs is a "
            "todo!() stub with no layout information)"
        )
