"""SAPG with MYULA chains (SAPG_algorithm_Guassian.m, _moffat.m), plainly.

Warm-up: X = y, P = prox_{λθ0·TV}(X) (fresh duals), then warmup − 1 MYULA
steps at the initial θ0, σ²0 and PSF (lines 67-93).  Main loop, for
ii = 2 … samples (lines 158-194):

    G  = irfft2(conj(H)·(H·X̂ − ŷ)) / σ²
    X' = |X + γ(P − X)/λ − γG + √(2γ)·Z|          P is the previous prox
    P' = prox_{λθ·TV}(X') (fresh duals),  X̂' = rfft2(X')
    R  = H·X̂' − ŷ,  δ = (0.01/θ_init)·ii^(−d_exp)/d
    θ  ← clip(θ + cθ·δ·mean(d/θ − TV(X')))
    p  ← clip(p − cp·δ·mean(⟨∂pH·X̂', R⟩/σ²))        each free PSF parameter
    σ² ← clip(σ² + cσ·δ·mean(‖R‖²/2σ⁴ − d/2σ²))

with every update taken at the iterate's θ, σ² and PSF (the prox at the θ
before its update), H the OTF of the current PSF, the means over the
chains, and the inner products and norms over the full spectrum by
Parseval.  Z is drawn by `draw((B, M, N))` once a step, warm-up included.
On the card the prox is replayed from a CUDA graph (its thousand-odd small
operations a step would otherwise be paced by the host).
"""
from __future__ import annotations

import torch

from portbench.reference import problem as refproblem
from portbench.reference import psf
from portbench.reference.precision import exact
from portbench.reference.tv import chambolle, tv_norm


def _weights(shape, dtype, device):
    N = shape[1]
    w = torch.full((N // 2 + 1,), 2.0, dtype=dtype, device=device)
    w[0] = 1.0
    if N % 2 == 0:
        w[-1] = 1.0
    return w


def _graphed(fn, *example):
    """fn(*args) on CUDA tensors of example's shapes, replayed from a CUDA
    graph: the same operations, launched at once.  The call copies its
    arguments into the graph's inputs and returns its outputs, which the
    next call overwrites."""
    inputs = [a.clone() for a in example]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*inputs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outputs = fn(*inputs)

    def call(*args):
        for dst, src in zip(inputs, args):
            dst.copy_(src)
        graph.replay()
        return outputs
    return call


def run(prob, demo, n_chains, draw, q=exact):
    """Traces of θ, σ² and the free PSF parameters over ii = 2 … samples,
    the chains' last state, and the mean sweeps a prox call over all chains."""
    y = prob["y"]
    dtype, device = y.dtype, y.device
    M, N = y.shape
    d = M * N
    B = n_chains
    w = _weights((M, N), dtype, device)

    def rfft(t):
        return q(torch.fft.rfft2(t))

    def irfft(t):
        return q(torch.fft.irfft2(t, s=(M, N)))

    def sqnorm(R):
        return torch.sum(w * (R.real ** 2 + R.imag ** 2), dim=(-2, -1)) / d

    def dot(A, R):
        return torch.sum(w * (A * torch.conj(R)).real, dim=(-2, -1)) / d

    def fresh_prox(X, lam_theta):
        f, _, n = chambolle(X, lam_theta, demo["chambolle_iters"], demo["chambolle_tau"],
                            demo["chambolle_tol"], q=q)
        return f, n

    def prox(X, lam_theta):
        f, n = prox_call(X, lam_theta)
        sweeps.append(n.sum())
        return f

    def myula(X, P, G, gamma, lam, Z, positivity):
        Xn = q(X + gamma * (P - X) / lam - gamma * G + torch.sqrt(2.0 * gamma) * Z)
        return torch.abs(Xn) if positivity else Xn

    free = [p for p in demo["psf_params"] if not p["fix"]]
    yhat = q(prob["yhat"])
    lam, gamma = prob["lam"], prob["gamma"]
    theta = torch.tensor(demo["theta"]["init"], dtype=dtype, device=device)
    sigma2 = prob["sigma2_init"]
    params = refproblem.init_params(demo, dtype, device)
    H0 = q(psf.otf(psf.kernel_and_grads(demo, params, dtype, device)[0], (M, N)))
    sweeps = []

    X = y.expand(B, M, N).contiguous()
    prox_call = _graphed(fresh_prox, X, lam * theta) if X.is_cuda else fresh_prox
    P = prox(X, lam * theta)
    Xhat = rfft(X)
    for _ in range(demo["warmup"] - 1):
        G = irfft(torch.conj(H0) * (H0 * Xhat - yhat)) / sigma2
        X = myula(X, P, G, gamma, lam, draw((B, M, N)), True)
        P = prox(X, lam * theta)
        Xhat = rfft(X)

    d_scale = 0.01 / demo["theta"]["init"]
    t_box, s_box = demo["theta"]["box"], (prob["sigma2_lo"], prob["sigma2_hi"])
    traces = {"theta": [], "sigma2": [], **{p["name"]: [] for p in free}}
    for ii in range(2, demo["samples"] + 1):
        if free:
            k, dks = psf.kernel_and_grads(demo, params, dtype, device)
            Hs = q(psf.otf(torch.stack([k] + [dks[p["name"]] for p in free]), (M, N)))
            H, dH = Hs[0], Hs[1:]
        else:
            H, dH = H0, []
        G = irfft(torch.conj(H) * (H * Xhat - yhat)) / sigma2
        X = myula(X, P, G, gamma, lam, draw((B, M, N)), demo["positivity"])
        P = prox(X, lam * theta)
        Xhat = rfft(X)
        R = H * Xhat - yhat
        G_t = torch.mean(d / theta - tv_norm(X))
        G_s = torch.mean(sqnorm(R) / (2.0 * sigma2 ** 2) - d / (2.0 * sigma2))
        G_p = [torch.mean(dot(dh * Xhat, R) / sigma2) for dh in dH]
        delta = d_scale * float(ii) ** (-demo["d_exp"]) / d
        theta = torch.clamp(theta + demo["theta"]["step_scale"] * delta * G_t, *t_box)
        for p, g in zip(free, G_p):
            params[p["name"]] = torch.clamp(params[p["name"]] - p["step_scale"] * delta * g,
                                            *p["box"])
        sigma2 = torch.clamp(sigma2 + demo["sigma_step_scale"] * delta * G_s, *s_box)
        traces["theta"].append(theta)
        traces["sigma2"].append(sigma2)
        for p in free:
            traces[p["name"]].append(params[p["name"]])
    out = {n: torch.stack(v).cpu().double().numpy() for n, v in traces.items()}
    out["X_last"] = X.cpu().double().numpy()
    out["sweeps"] = float(torch.stack(sweeps).double().mean())
    return out
