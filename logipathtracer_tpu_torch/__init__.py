"""Progressive Monte Carlo path tracer in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

The port of ``logipathtracer_tpu`` (JAX/Pallas on a TPU), which stays
beside it as the reference.  Module names and layout follow that
package one for one; public functions keep its argument layouts.  This
package imports torch and never JAX.

The main path: ``load_gltf`` / a procedural scene → ``compile_scene`` →
``ProgressiveRenderer(scene, RenderConfig(...))`` → ``step(n)`` →
``radiance()`` / ``image()``.  On CUDA tensors it runs three kernels
(csrc/): the compact worklist intersect (K1), the fused shade (K2) and
the radiance flush (K3); on CPU tensors their plain PyTorch versions.
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
    raise AttributeError(name)


__version__ = "0.1.0"

__all__ = ["RenderConfig", "load_gltf", "compile_scene",
           "ProgressiveRenderer", "__version__"]
