from logipathtracer_tpu_torch.film.png import decode_png, encode_png, write_png
from logipathtracer_tpu_torch.film.image import tonemap, srgb_to_linear, rmse

__all__ = ["decode_png", "encode_png", "write_png", "tonemap",
           "srgb_to_linear", "rmse"]
