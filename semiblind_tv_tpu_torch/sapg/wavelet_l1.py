"""SAPG in a redundant-Haar synthesis representation with an L1 prior (port
of `semiblind_tv_tpu/sapg/wavelet_l1.py`).

The reference's SIAM experiment 4.2.3 (`SALSA/run_deblur_synthesis_L1.m`):
the unknown is the wavelet coefficient field xw (d = (3L+1)·d_y for L
levels), the forward model A = B∘W (uniform blur ∘ tight-frame synthesis),
the prior θ‖xw‖₁ with the soft-threshold prox, and θ is estimated by SAPG
**Algorithm 1** (η = log θ updates, SALSA/SAPG_algorithm_1.m:180-182;
MYULA without the positivity projection).  Then a SALSA MAP solve with the
Sherman–Morrison LS step.

The reference script as shipped cannot run its τ-estimation leg (it passes
a one-argument gradF into SAPG_algorithm_1, which calls gradF(X, tau), and
never defines op.grad_t); the JAX package and this port implement the
θ-only estimation the script intends.

A step is one synthesis, one rfft2, one irfft2 and one analysis: the
residual spectrum that the log-density of step n needs is the one the
gradient of step n+1 starts from, so it is computed once and carried.
Nothing inside the loops waits for the device: θ is a 0-d device tensor,
the traces fill device tensors that are copied to the host once, and
SALSA reads its stop flag every `_CHECK_EVERY` iterations.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from semiblind_tv_tpu_torch.ops.fourier import BlurOperator
from semiblind_tv_tpu_torch.ops.wavelet import ti_analysis, ti_synthesis, uniform_blur_kernel
from semiblind_tv_tpu_torch.runtime.problem import resolve_device

__all__ = ["WaveletL1Config", "WaveletL1Result", "run_sapg_wavelet_l1"]

_CHECK_EVERY = 32  # SALSA iterations between host reads of the stop flag


@dataclasses.dataclass(frozen=True)
class WaveletL1Config:
    """run_deblur_synthesis_L1.m:54-66 parameter block."""

    samples: int = 3000
    burn_in: int = 20
    warmup: int = 0
    th_init: float = 0.01
    min_th: float = 1e-3
    max_th: float = 1.0
    d_exp: float = 0.8
    d_scale: Optional[float] = None    # default 0.1 / th_init  (NOT 0.01!)
    lambda_max: float = 2.0
    gamma_frac: float = 0.98
    bsnr: float = 30.0
    blur_length: int = 9
    levels: int = 4
    wavelet_order: int = 2             # daubcqf(N) filter length; 2 = the
                                       # reference's Haar configuration
                                       # (run_deblur_synthesis_L1.m:101)
    # SALSA MAP solve (run_deblur_synthesis_L1.m:160-183)
    salsa_iters: int = 500
    salsa_tol: float = 1e-4


@dataclasses.dataclass
class WaveletL1Result:
    theta_EB: float
    thetas: np.ndarray
    logPiTrace: np.ndarray
    xw_last: np.ndarray
    x_map: np.ndarray
    mse_db: float
    salsa_iters: int
    mse_db_observation: float = 0.0
    sapg_time_s: float = 0.0     # host seconds, ending in a device sync
    salsa_time_s: float = 0.0


def soft(x, t):
    """sign(x)·max(|x|−t, 0) (the reference's proxG, run_deblur_synthesis_L1.m:138)."""
    return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)


def run_sapg_wavelet_l1(
    x_true,
    cfg: WaveletL1Config,
    generator: Optional[torch.Generator] = None,
    dtype=torch.float32,
    device="cuda",
    obs_noise=None,
    noise: Union[None, Callable, np.ndarray, torch.Tensor] = None,
):
    """The whole experiment on `device`: observation synthesis → SAPG (θ) →
    SALSA MAP.

    `generator` (a torch.Generator on `device`) draws the observation noise
    and then one standard-normal coefficient field per SAPG step.
    `obs_noise` (an (M, N) standard-normal field) and `noise` — an
    (samples−1, M, N·(3L+1)) field, or a callable `noise(shape)` called once
    a step — replace those draws (the tests inject the JAX package's)."""
    if cfg.levels < 1:
        raise ValueError(f"levels must be >= 1, got {cfg.levels}")
    device = resolve_device(device)
    x_true = torch.as_tensor(x_true, dtype=dtype).to(device)
    m, n = x_true.shape
    d_img = m * n
    L = cfg.levels
    d_w = d_img * (3 * L + 1)
    blur = BlurOperator((m, n), cfg.blur_length, dtype, device)
    w = blur.weights

    # uniform centred blur (SALSA/uniform_blur.m): a full-size kernel, so the
    # OTF is a host rfft2, not the corner-pad DFT factors
    kern = uniform_blur_kernel(m, cfg.blur_length)
    H = torch.from_numpy(np.fft.rfft2(kern)).to(device=device, dtype=blur.cdtype)
    ev_max = float(np.max(np.abs(np.fft.fft2(kern)) ** 2))  # λ_max(BᵀB)

    def B(v):
        return blur.irfft(H * blur.rfft(v))

    def W(xw):
        return ti_synthesis(xw, L, cfg.wavelet_order)

    def WT(v):
        return ti_analysis(v, L, cfg.wavelet_order)

    Bx = B(x_true)
    sigma = torch.linalg.norm(Bx - torch.mean(Bx)) / math.sqrt(d_img * 10.0 ** (cfg.bsnr / 10.0))
    if obs_noise is None:
        obs_noise = torch.randn((m, n), generator=generator, dtype=dtype, device=device)
    elif not torch.is_tensor(obs_noise):
        obs_noise = torch.tensor(np.asarray(obs_noise))
    y = Bx + sigma * obs_noise.to(device=device, dtype=dtype)
    sigma2 = sigma ** 2
    yhat = blur.rfft_host(y)
    if noise is None:
        def draw(shape, _i):
            return torch.randn(shape, generator=generator, dtype=dtype, device=device)
    elif callable(noise):
        def draw(shape, _i):
            return torch.as_tensor(noise(shape)).to(device=device, dtype=dtype)
    else:
        field = noise if torch.is_tensor(noise) else torch.tensor(np.asarray(noise))

        def draw(shape, i):
            return field[i].to(device=device, dtype=dtype)

    Lf = ev_max / float(sigma) ** 2  # (evMax/sigma)^2, evMax = λmax(BᵀB): ref :144
    lam = min(5.0 / Lf, cfg.lambda_max)
    gamma = cfg.gamma_frac / (Lf + 1.0 / lam)
    d_scale = cfg.d_scale if cfg.d_scale is not None else 0.1 / cfg.th_init
    min_eta, max_eta = float(np.log(cfg.min_th)), float(np.log(cfg.max_th))

    def residual_hat(xw):
        return H * blur.rfft(W(xw)) - yhat

    def grad_f(rhat):
        return WT(blur.irfft(torch.conj(H) * rhat)) / sigma2

    # the SA step sizes δ_i = d_scale·i^(−d_exp)/d_w, i = 2 … samples
    iis = torch.arange(2.0, cfg.samples + 1.0, dtype=dtype, device=device)
    deltas = d_scale * iis ** (-cfg.d_exp) / d_w
    n_steps = cfg.samples - 1
    traces = torch.zeros((2, n_steps), dtype=dtype, device=device)   # θ, logπ

    xw = WT(y)  # op.X0 = WT(y) (run_deblur_synthesis_L1.m:154)
    theta = torch.tensor(cfg.th_init, dtype=dtype, device=device)
    prox = soft(xw, lam * theta)
    rhat = residual_hat(xw)
    t0 = time.perf_counter()
    for i in range(n_steps):
        Z = draw(xw.shape, i)
        # Algorithm-1 MYULA: no abs() (SAPG_algorithm_1.m:173)
        xw = xw + gamma * (prox - xw) / lam - gamma * grad_f(rhat) + math.sqrt(2 * gamma) * Z
        g1 = torch.sum(torch.abs(xw))
        eta = torch.clamp(torch.log(theta) + deltas[i] * (d_w / theta - g1) * theta,
                          min_eta, max_eta)
        rhat = residual_hat(xw)
        re, im = rhat.real, rhat.imag
        res2 = torch.sum(w * (re * re + im * im)) / d_img
        traces[1, i] = -res2 / (2.0 * sigma2) - theta * g1   # logπ at the old θ
        prox = soft(xw, lam * theta)
        theta = torch.exp(eta)
        traces[0, i] = theta
    tr = traces.cpu().numpy()
    sapg_time = time.perf_counter() - t0
    thetas = np.concatenate([[cfg.th_init], tr[0]])
    theta_EB = float(np.exp(np.mean(np.log(thetas[cfg.burn_in - 1:]))))

    t0 = time.perf_counter()
    x_map, n_salsa = _salsa_l1_synthesis(
        y, yhat, H, blur, W, WT, theta_EB * float(sigma) ** 2, theta_EB,
        cfg.salsa_iters, cfg.salsa_tol, L,
    )
    mse_db = float(10.0 * torch.log10(torch.sum((x_true - x_map) ** 2) / d_img))
    salsa_time = time.perf_counter() - t0
    return WaveletL1Result(
        theta_EB=theta_EB,
        thetas=thetas,
        logPiTrace=np.concatenate([[0.0], tr[1]]),
        xw_last=xw.cpu().numpy(),
        x_map=x_map.cpu().numpy(),
        mse_db=mse_db,
        salsa_iters=n_salsa,
        mse_db_observation=float(10.0 * torch.log10(torch.sum((x_true - y) ** 2) / d_img)),
        sapg_time_s=sapg_time,
        salsa_time_s=salsa_time,
    )


def _salsa_l1_synthesis(y, yhat, H, blur, W, WT, tau, mu, max_iter, tol, L):
    """SALSA with a synthesis L1 prior and the Sherman–Morrison LS solve:
    invLS(r) = (r − WT(ifft(filter · fft(W r)))) / µ with
    filter = conj(H)·H/(|H|² + µ) (run_deblur_synthesis_L1.m:170-171),
    exact because W Wᵀ = I.  Returns (W(xw), iterations run)."""
    d_img = y.numel()
    w = blur.weights
    filt = torch.conj(H) * H / (torch.abs(H) ** 2 + mu)
    ATy = WT(blur.irfft(torch.conj(H) * yhat))
    thresh = tau / mu

    def objective(xw, u):
        rhat = yhat - H * blur.rfft(W(xw))
        re, im = rhat.real, rhat.imag
        return 0.5 * torch.sum(w * (re * re + im * im)) / d_img + tau * torch.sum(torch.abs(u))

    xw = torch.zeros((y.shape[0], y.shape[1] * (3 * L + 1)), dtype=y.dtype, device=y.device)
    u, bu = xw, xw
    prev_obj = objective(xw, xw)
    done = torch.zeros((), dtype=torch.bool, device=y.device)
    n_done = torch.zeros((), dtype=torch.int32, device=y.device)
    for k in range(max_iter):
        active = torch.logical_not(done)
        un = soft(xw - bu, thresh)
        r = ATy + mu * (un + bu)
        xwn = (r - WT(blur.irfft(filt * blur.rfft(W(r))))) / mu
        bun = bu + (un - xwn)
        obj = objective(xwn, un)
        if k >= 1:
            done = done | ((torch.abs(obj - prev_obj) / prev_obj < tol) & active)
        xw = torch.where(active, xwn, xw)
        u = torch.where(active, un, u)
        bu = torch.where(active, bun, bu)
        prev_obj = torch.where(active, obj, prev_obj)
        n_done = n_done + active.to(torch.int32)
        if (k + 1) % _CHECK_EVERY == 0 and bool(done):
            break
    return W(xw), int(n_done)
