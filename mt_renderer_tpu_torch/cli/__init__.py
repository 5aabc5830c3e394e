"""CLI tools (parity with the reference's src/bin/ binaries).

Run as ``python -m mt_renderer_tpu_torch.cli.<tool>``. Every tool has an
argparse interface with ``--help``. The dump/pack tools (``arctool``,
``gmdtool``, ``makefixtures``, ``materialinfo``, ``mtdeserializer``,
``schedulerdump``, ``scriptparse``, ``shaderdump``,
``shaderpackagedump``, ``unpackall``) run on the host and touch no
tensor. The viewers (``modelviewer``, ``textureviewer``,
``sceneviewer``) render on ``--device`` (default ``cuda``) and refuse to
start without that device: there is no fallback to the CPU.
"""

import signal
import sys

# behave like a unix tool when piped into head etc.
if sys.platform != "win32":
    signal.signal(signal.SIGPIPE, signal.SIG_DFL)
