"""CLI entry point: ``render`` and ``convert`` subcommands.

Parity with the reference CLI (ref: src/main.rs:14-57, src/config/mod.rs:14-52):

  render  INPUT [-o/--output render.png] [-q/--quiet] [-v/--viewer]
          [--debug-textures] [-p/--profile profile.yaml]
  convert INPUT OUTPUT_DIR

Flags also fall back to environment variables (clap ``env`` behavior:
OUTPUT, PROFILE). Errors print to stderr and exit(2) (ref main.rs:17-21).
"""
from __future__ import annotations

import argparse
import os
import sys


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="path-tracer-tpu",
                                     description="Path-trace awesome things")
    sub = parser.add_subparsers(dest="command", required=True)

    render = sub.add_parser("render", help="Render an ISF scene")
    render.add_argument("input", help="Input file name ISF format")
    render.add_argument("-o", "--output", default=os.environ.get("OUTPUT", "render.png"),
                        help="Output image name")
    render.add_argument("-q", "--quiet", action="store_true",
                        help="No progress bar printed")
    render.add_argument("-v", "--viewer", action="store_true",
                        help="Display a viewer (might slow down the rendering)")
    render.add_argument("--debug-textures", action="store_true",
                        help="Generate debug textures (AOV dump)")
    render.add_argument("-p", "--profile", default=os.environ.get("PROFILE"),
                        help="YAML file with the rendering profile")
    render.add_argument("--checkpoint", default=None, metavar="PATH",
                        help="Persist/resume the accumulation buffer at PATH "
                             "(an addition; the reference never persists "
                             "progressive passes)")
    render.add_argument("--checkpoint-every", type=int, default=0,
                        metavar="N", help="Checkpoint every N samples "
                                          "(0 = every pass batch)")
    render.add_argument("--profile-trace", default=None, metavar="DIR",
                        help="Capture a JAX profiler trace of the render "
                             "into DIR (open with TensorBoard/XProf)")

    convert = sub.add_parser("convert", help="Convert scenes into ISF format")
    convert.add_argument("input", help="Input glTF/GLB file name")
    convert.add_argument("output", help="Output directory")
    return parser


def run_render(args) -> None:
    from path_tracer_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    from path_tracer_tpu.config import Profile
    from path_tracer_tpu.scene import load_scene
    from path_tracer_tpu.utils.image_io import save_png

    profile = Profile.load(args.profile) if args.profile else Profile()
    scene = load_scene(args.input)

    if args.debug_textures:
        from path_tracer_tpu.models.debug_aov import debug_render

        debug_render(scene, profile.resolution)
        return

    viewer = None
    if args.viewer:
        from path_tracer_tpu.viewer import ProgressiveViewer

        viewer = ProgressiveViewer(profile.resolution)

    from path_tracer_tpu.models.renderer import render

    if args.profile_trace:
        import contextlib

        import jax.profiler

        trace_cm = jax.profiler.trace(args.profile_trace)
    else:
        import contextlib

        trace_cm = contextlib.nullcontext()

    with trace_cm:
        image = render(scene, profile, progress=not args.quiet, viewer=viewer,
                       checkpoint_path=args.checkpoint,
                       checkpoint_every=args.checkpoint_every)
    save_png(image, args.output)
    if viewer is not None:
        # The reference blocks until the viewer window closes after the
        # render finishes (viewer.rs:83-101 wait_for_close); the HTTP
        # analog keeps serving the final frame until /stop or Ctrl-C.
        viewer.wait_for_close()
        viewer.close()


def run_convert(args) -> None:
    from path_tracer_tpu.scene.gltf import convert_gltf_to_isf

    convert_gltf_to_isf(args.input, args.output)


def main(argv=None) -> None:
    args = _build_parser().parse_args(argv)
    try:
        if args.command == "render":
            run_render(args)
        else:
            run_convert(args)
    except Exception as e:  # noqa: BLE001 — match ref main.rs:17-21
        print(e, file=sys.stderr)
        sys.exit(2)


if __name__ == "__main__":
    main()
