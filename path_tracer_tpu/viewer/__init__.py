"""Progressive render viewer.

The reference opens an SFML window fed per-pixel over an mpsc channel
(ref: src/renderer/viewer.rs:12-102). Headless accelerator hosts have no
display server, so the equivalent here is a tiny local HTTP viewer: the render
driver pushes the latest tonemapped frame after each sample pass, and a
browser page polls and repaints it (open http://127.0.0.1:<port>). Falls back
to writing ``preview.png`` next to the output when the server can't bind.
"""
from path_tracer_tpu.viewer.http_viewer import ProgressiveViewer  # noqa: F401
