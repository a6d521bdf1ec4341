from logipathtracer_tpu_torch.scene.gltf import load_gltf
from logipathtracer_tpu_torch.scene.compile import compile_scene

__all__ = ["load_gltf", "compile_scene"]
