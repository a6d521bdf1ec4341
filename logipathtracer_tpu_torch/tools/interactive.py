"""The interactive session at the reference's default configuration: the
web viewer's present loop at 1920x1080 (the port's counterpart of the
JAX package's ``scripts/interactive_1080p.py``).

    python -m logipathtracer_tpu_torch.tools.interactive [--scene S.glb]
        [--width 1920 --height 1080] [--preview-scale 4]
        [--preview-depth 4] [--nav-frames 12 --acc-frames 12]
        [--acc-spp 1] [--cpu] [--eager] [--out PREFIX]

The reference presents every sample of a 1920x1080 frame through a
swapchain, and a camera key resets accumulation (src/Main.cpp:57-93).
This tool runs the present loop of ``cli/webview.py`` at that
configuration, in two phases:

  NAVIGATE: ``rotate(1, 0.02)`` before every frame, on the preview
            renderer at max(64, width // preview-scale) x max(64,
            height // preview-scale) and depth ``--preview-depth``, one
            sample a frame — the frames ``web`` renders while keys
            arrive;
  CONVERGE: the full-resolution renderer (max_depth 10), the camera
            still, ``--acc-spp`` samples a frame.

Each frame is ``step_nosync`` → ``image_u8()`` → a pinned, non-blocking
copy to the host (``webview._HostFrame``), and frame N+1 is dispatched
before frame N is read.  Each phase's rates come from its own wall
clock: a navigation phase counts n times the last frame's rays (every
frame restarts on the moved camera), a converge phase the rays it
added.

The scene is ``--scene`` (glTF / .glb), else the procedural box
``make_box_scene(spheres=10, subdiv=3)``.  Prints one JSON line, the
JAX script's report without its per-frame lists (``warmup_s`` is its
``xla_warmup_s``: here the first frame of each renderer, the kernels'
build included); with ``--out PREFIX`` it writes ``PREFIX.png`` (the
converged image) and ``PREFIX_report.json`` (the report with the
per-frame lists).  Renders on the CUDA card; ``--cpu`` renders on the
CPU.  On the card the wavefront replays its captured stages
(render/graph.py); ``--eager`` runs its eager form instead, to compare
the two.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

# Host seed of both renderers (the JAX script's).
HOST_SEED = 0
# Camera turn before each navigation frame (radians about local y: the
# viewer's 'j' key).
TURN = 0.02


def load_scene(path):
    """The compiled scene of ``path``, or of the procedural box."""
    from logipathtracer_tpu_torch import compile_scene, load_gltf
    from logipathtracer_tpu_torch.scene.procedural import make_box_scene
    gltf = load_gltf(path) if path else make_box_scene(spheres=10, subdiv=3)
    return compile_scene(gltf)


def build(host_scene, width, height, preview_scale, preview_depth, device,
          eager=False):
    """(full renderer, preview renderer or None) over one compiled scene:
    the full one at width x height and max_depth 10, the preview as
    ``web`` builds it (cli/main.py ``_build_web``); ``eager``: both run
    the wavefront loop's eager form."""
    from logipathtracer_tpu_torch import ProgressiveRenderer, RenderConfig
    cfg = RenderConfig(width=width, height=height, max_depth=10)
    full = ProgressiveRenderer(host_scene, cfg, host_seed=HOST_SEED,
                               device=device)
    preview = None
    if preview_scale > 1:
        cfg_p = RenderConfig(width=max(64, width // preview_scale),
                             height=max(64, height // preview_scale),
                             max_depth=preview_depth or 10)
        preview = ProgressiveRenderer(host_scene, cfg_p,
                                      host_seed=HOST_SEED, device=device)
    for r in (full, preview):
        if r is not None:
            r._eager = eager
    return full, preview


def submit(renderer, move, spp=1):
    """Dispatch one viewer frame: turn the camera (``move``), step
    ``spp`` samples without the closing sync, and start the frame's copy
    to the host.  Returns the frame on its way (``.numpy()`` waits)."""
    from logipathtracer_tpu_torch.cli.webview import _HostFrame
    if move:
        renderer.rotate(1, TURN)
    renderer.step_nosync(spp)
    return _HostFrame(renderer.image_u8())


def present_sync(renderer):
    """One frame, dispatched and read before the next (the warm-up)."""
    t0 = time.perf_counter()
    rgba = submit(renderer, move=False).numpy()
    return rgba, time.perf_counter() - t0


def run_phase(n, renderer, move, spp=1):
    """n presented frames, each read after the next one's dispatch.  A
    frame's time is the interval between two presents (what a viewer's
    client sees).  Returns the phase record."""
    if n == 0:
        return {"frames": [], "fps_mean": None, "fps_best": None,
                "frame_ms_median": None, "samples_per_sec": None,
                "mrays_per_sec": None}
    frames = []
    rays_start = renderer.total_rays
    pending = submit(renderer, move, spp)
    t_prev = time.perf_counter()
    t_phase = t_prev
    for i in range(n):
        nxt = submit(renderer, move, spp) if i + 1 < n else None
        t_fetch0 = time.perf_counter()
        rgba = pending.numpy()
        t_fetch1 = time.perf_counter()
        blob = rgba.tobytes()
        now = time.perf_counter()
        frames.append({"total_s": now - t_prev,
                       "fetch_s": t_fetch1 - t_fetch0,
                       "encode_s": now - t_fetch1,
                       "blob_bytes": len(blob)})
        t_prev = now
        pending = nxt
    wall = time.perf_counter() - t_phase
    # A moving camera restarts every frame, so every frame traces the
    # last one's work; a still camera accumulates.
    rays = (n * renderer.total_rays if move
            else renderer.total_rays - rays_start)
    total = [f["total_s"] for f in frames]
    return {"frames": frames,
            "fps_mean": n / wall,
            "fps_best": 1.0 / min(total),
            "frame_ms_median": sorted(total)[n // 2] * 1e3,
            "samples_per_sec": n * spp / wall,
            "mrays_per_sec": rays / wall / 1e6}


def run(args):
    """The session of ``args`` (``main``'s flags).  Returns (report with
    the per-frame lists, converged image [H, W, 3] float on the host)."""
    from logipathtracer_tpu_torch.render.progressive import default_device
    device = torch.device("cpu") if args.cpu else default_device()
    t0 = time.perf_counter()
    host_scene = load_scene(args.scene)
    r, rp = build(host_scene, args.width, args.height, args.preview_scale,
                  args.preview_depth, device, eager=args.eager)
    scene_compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    present_sync(r)
    if rp is not None:
        present_sync(rp)
    warmup_s = time.perf_counter() - t0

    nav = run_phase(args.nav_frames, rp if rp is not None else r, move=True)
    # The camera moved on the preview only: turn the full renderer as far
    # (which resets it), so converge starts a clean accumulation.
    if rp is not None and args.nav_frames:
        r.rotate(1, TURN * args.nav_frames)
    acc = run_phase(args.acc_frames, r, move=False, spp=args.acc_spp)

    from logipathtracer_tpu_torch.film.image import to_uint8
    from logipathtracer_tpu_torch.film.png import encode_png
    img = r.image().cpu().numpy()
    t0 = time.perf_counter()
    png = encode_png(to_uint8(img))
    png_encode_s = time.perf_counter() - t0

    dev_name = (f"{device} ({torch.cuda.get_device_name(device)})"
                if device.type == "cuda" else str(device))
    cfg = r.config
    report = {
        "scene": host_scene.name,
        "resolution": f"{cfg.render_width}x{cfg.render_height}",
        "preview_resolution": (
            f"{rp.config.render_width}x{rp.config.render_height}"
            if rp is not None else None),
        "preview_depth": rp.config.max_depth if rp is not None else None,
        "device": dev_name,
        "renderer": ("megakernel" if cfg.renderer == "megakernel"
                     else "wavefront"),
        "scene_compile_s": scene_compile_s,
        "warmup_s": warmup_s,
        "navigate_1spp": {k: v for k, v in nav.items() if k != "frames"},
        "converge_accum": {k: v for k, v in acc.items() if k != "frames"},
        "png_screenshot_s": png_encode_s,
        "nav_frames": nav["frames"],
        "acc_frames": acc["frames"],
    }
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out + ".png", "wb") as fh:
            fh.write(png)
        with open(args.out + "_report.json", "w") as fh:
            json.dump(report, fh, indent=1)
    return report, img


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default=None,
                    help="glTF / .glb scene (default: the procedural box)")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--preview-scale", type=int, default=4,
                    help="resolution divisor of the navigation frames "
                         "(1: navigate on the full renderer)")
    ap.add_argument("--preview-depth", type=int, default=4,
                    help="max path depth of the navigation frames (0: 10)")
    ap.add_argument("--nav-frames", type=int, default=12)
    ap.add_argument("--acc-frames", type=int, default=12)
    ap.add_argument("--acc-spp", type=int, default=1,
                    help="samples a converge frame (web --spp-per-frame)")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (default: the CUDA card)")
    ap.add_argument("--eager", action="store_true",
                    help="run the wavefront loop eagerly on the card, not "
                         "through its captured CUDA graphs")
    ap.add_argument("--out", default=None,
                    help="write OUT.png and OUT_report.json")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    report, _ = run(parse_args(argv))
    print(json.dumps({k: v for k, v in report.items()
                      if k not in ("nav_frames", "acc_frames")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
