"""Image-quality metrics with reference-MATLAB semantics (port of
`semiblind_tv_tpu/metrics/metrics.py`).

  * mse_db — utils/MSE.m: 10 log10(‖x − x̂‖²_F / d)
  * psnr   — utils/PSNR.m: 10 log10(max(x)²) − 10 log10(‖x − y‖² / d)
  * snr    — utils/snr_func.m: 20 log10(‖x‖ / ‖x − y‖)
  * l2_spectral_sq — utils/l2.m: MATLAB `norm(x-y)^2` on a matrix is the
    spectral norm squared
  * ssim   — MATLAB-style SSIM (11×11 Gaussian window, σ=1.5, K=[0.01,
    0.03], replicate padding), in float32 with MATLAB's double-image default
    L=1 (the demos call `ssim(x, xMAP)` on [0, 255] doubles).  Its
    convolution runs with cuDNN's TF32 off: TF32 keeps about three digits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["mse_db", "psnr", "snr", "l2_spectral_sq", "ssim"]


def mse_db(x_true, x_app):
    d = x_true.numel()
    return 10.0 * torch.log10(torch.sum((x_true - x_app) ** 2) / d)


def psnr(x, y):
    d = x.numel()
    peak = 10.0 * torch.log10(torch.max(x) ** 2)
    return peak - 10.0 * torch.log10(torch.sum((x - y) ** 2) / d)


def snr(x, y):
    return 20.0 * torch.log10(torch.linalg.norm(x) / torch.linalg.norm(x - y))


def l2_spectral_sq(x, y):
    s = torch.linalg.svdvals(x - y)
    return s[..., 0] ** 2


def _gaussian_window(size: int = 11, sigma: float = 1.5, dtype=torch.float32, device=None):
    offs = torch.arange(size, dtype=dtype, device=device) - (size - 1) / 2.0
    g1 = torch.exp(-(offs ** 2) / (2.0 * sigma ** 2))
    win = torch.outer(g1, g1)
    return win / torch.sum(win)


def _filter2_replicate(img, win):
    """2-D correlation with replicate (edge) padding, 'same' output."""
    p = win.shape[0] // 2
    padded = F.pad(img[None, None], (p, p, p, p), mode="replicate")
    return F.conv2d(padded, win[None, None])[0, 0]


def ssim(x, y, dynamic_range: float = 1.0, k1: float = 0.01, k2: float = 0.03):
    """Mean structural similarity index (MATLAB `ssim` semantics)."""
    x = torch.as_tensor(x).to(torch.float32)
    y = torch.as_tensor(y).to(device=x.device, dtype=torch.float32)
    win = _gaussian_window(dtype=x.dtype, device=x.device)
    c1 = (k1 * dynamic_range) ** 2
    c2 = (k2 * dynamic_range) ** 2

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        mu_x = _filter2_replicate(x, win)
        mu_y = _filter2_replicate(y, win)
        mu_x2 = mu_x * mu_x
        mu_y2 = mu_y * mu_y
        mu_xy = mu_x * mu_y
        sig_x2 = _filter2_replicate(x * x, win) - mu_x2
        sig_y2 = _filter2_replicate(y * y, win) - mu_y2
        sig_xy = _filter2_replicate(x * y, win) - mu_xy
    finally:
        torch.backends.cudnn.allow_tf32 = tf32

    num = (2.0 * mu_xy + c1) * (2.0 * sig_xy + c2)
    den = (mu_x2 + mu_y2 + c1) * (sig_x2 + sig_y2 + c2)
    return torch.mean(num / den)
