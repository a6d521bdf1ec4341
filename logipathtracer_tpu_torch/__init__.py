"""Progressive Monte Carlo path tracer in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

The port of ``logipathtracer_tpu`` (JAX/Pallas on a TPU), which stays
beside it as the reference.  Module names and layout follow that
package one for one; public functions keep its argument layouts.  This
package imports torch and never JAX.

The main path: ``load_gltf`` / a procedural scene → ``compile_scene`` →
``ProgressiveRenderer(scene, RenderConfig(...))`` → ``step(n)`` →
``radiance()`` / ``image()``, through the pooled wavefront renderer or,
with ``renderer="megakernel"``, the lockstep megakernel
(``render_sample`` renders one frame; ``render_wavefront`` renders a
batch of samples of a row slab in one pool; ``MeshRenderer`` shards a
session over a (samples, tiles) mesh of devices, ``parallel/mesh.py``).
On CUDA tensors it runs hand-written kernels (csrc/): for
resident-class scenes the compact worklist intersect (K1, the
default), the compact sweep over every
cluster in octant order (K7, ``compact_worklist=False``) or the dense
sweep (K8, ``intersect="sweep"``); for scenes beyond the resident
budget a streamed intersect — the frustum cluster worklists (K4, the
default), the chunk worklists (K5) or the octant chunk sweep (K6); then
the fused shade (K2) and, in the wavefront, the radiance flush (K3).
``intersect="bvh"`` walks the BVH in plain torch, and the basic BSDF
(``use_microfacet=False``) shades in plain torch.  On CPU tensors every
kernel's plain PyTorch version runs.  The command line:
``python -m logipathtracer_tpu_torch.cli.main render|view|web|compare``.
"""

from logipathtracer_tpu_torch.config import RenderConfig
from logipathtracer_tpu_torch.scene.gltf import load_gltf
from logipathtracer_tpu_torch.scene.compile import compile_scene


def __getattr__(name):
    # Lazy: the renderer imports torch.
    if name == "ProgressiveRenderer":
        from logipathtracer_tpu_torch.render.progressive import \
            ProgressiveRenderer
        return ProgressiveRenderer
    if name == "MeshRenderer":
        from logipathtracer_tpu_torch.parallel.mesh import MeshRenderer
        return MeshRenderer
    if name == "render_wavefront":
        from logipathtracer_tpu_torch.render.wavefront import \
            render_wavefront
        return render_wavefront
    if name == "render_sample":
        from logipathtracer_tpu_torch.render.megakernel import render_sample
        return render_sample
    raise AttributeError(name)


__version__ = "0.1.0"

__all__ = ["RenderConfig", "load_gltf", "compile_scene",
           "ProgressiveRenderer", "MeshRenderer", "render_wavefront",
           "render_sample", "__version__"]
