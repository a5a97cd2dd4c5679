"""Image loading (port of semiblind_tv_tpu.utils)."""
from semiblind_tv_tpu_torch.utils.images import (  # noqa: F401
    available_images,
    load_image,
    read_png_gray8,
    synthetic_wheel,
)
