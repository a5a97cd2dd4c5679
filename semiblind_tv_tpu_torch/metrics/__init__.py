"""Image-quality metrics (port of semiblind_tv_tpu.metrics)."""
from semiblind_tv_tpu_torch.metrics.metrics import (  # noqa: F401
    l2_spectral_sq,
    mse_db,
    psnr,
    snr,
    ssim,
)
