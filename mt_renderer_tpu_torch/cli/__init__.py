"""The viewer CLIs: ``modelviewer``, ``textureviewer`` and ``sceneviewer``.

Run as ``python -m mt_renderer_tpu_torch.cli.<tool>``. Each renders on
``--device`` (default ``cuda``) and refuses to start without that device:
there is no fallback to the CPU. The dump/pack tools stay the JAX
package's for now (ROADMAP item 15b).
"""
