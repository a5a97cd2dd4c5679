"""reference/sapg.py with its chains in blocks, one block a device, in one
process: plain torch, no torch.distributed.

The arithmetic is reference/sapg.run's, step for step: the same warm-up,
MYULA steps and prox, and the same SA updates of θ, σ² and the free PSF
parameters.  Each step every block takes its own rows of the whole
(B, M, N) field `draw` gives, so the chains see the same normals as in
sapg.run; the blocks' statistics are summed over their chains, the sums
added on the first device and divided by B there, and the updated θ, σ²
and PSF copied back to every device.  So the result is sapg.run's up to the
order of the sums over the chains, and the devices work side by side (the
host enqueues, the copies between cards are stream-ordered, and a step's
copies go out before any block's work): 64 chains on four cards take
about as long as 16 on one.
"""
from __future__ import annotations

import contextlib

import torch

from portbench.reference import problem as refproblem
from portbench.reference import psf
from portbench.reference.precision import exact
from portbench.reference.sapg import _weights
from portbench.reference.tv import chambolle, tv_norm


def _on(dev):
    """The CUDA device `dev` as the current one (a graph replays on its
    current stream); nothing for the CPU."""
    if torch.device(dev).type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _graphed(fn, *example):
    """reference/sapg.py's _graphed, captured on a stream of the examples'
    own device: torch.cuda.graph's default capture stream is one for the
    process, made on the device current at its first use, and a capture on
    another device's stream leaves this device's work outside the graph."""
    dev = example[0].device
    inputs = [a.clone() for a in example]
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn(*inputs)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=torch.cuda.Stream(device=dev)):
        outputs = fn(*inputs)

    def call(*args):
        for dst, src in zip(inputs, args):
            dst.copy_(src)
        graph.replay()
        return outputs
    return call


def run(prob, demo, n_chains, draw, devices, q=exact):
    """sapg.run's outputs (θ, σ² and free PSF traces over ii = 2 … samples,
    X_last, `sweeps`: a prox call's sweeps summed over all chains, its mean
    over the calls) for n_chains chains in len(devices) equal blocks, block
    k on devices[k]; `block_sweeps` holds each block's share.  prob lives on
    devices[0], where `draw` draws."""
    y = prob["y"]
    dtype, home = y.dtype, y.device
    M, N = y.shape
    d = M * N
    K = len(devices)
    if n_chains % K:
        raise ValueError(f"{n_chains} chains do not split into {K} blocks")
    b = n_chains // K
    blocks = range(K)
    w = [_weights((M, N), dtype, dev) for dev in devices]

    def rfft(t):
        return q(torch.fft.rfft2(t))

    def irfft(t):
        return q(torch.fft.irfft2(t, s=(M, N)))

    def fresh_prox(X, lam_theta):
        f, _, n = chambolle(X, lam_theta, demo["chambolle_iters"], demo["chambolle_tau"],
                            demo["chambolle_tol"], q=q)
        return f, n

    def prox(k, X, lam_theta):
        with _on(devices[k]):
            f, n = prox_calls[k](X, lam_theta)
            sweeps[k].append(n.sum())
        return f

    def myula(X, P, G, gamma, lam, Z, positivity):
        Xn = q(X + gamma * (P - X) / lam - gamma * G + torch.sqrt(2.0 * gamma) * Z)
        return torch.abs(Xn) if positivity else Xn

    def rows(Z):
        """Each block's rows of the whole field, on its device.  Every copy is
        enqueued before any block's step: a copy between cards runs in the
        source card's stream and the destination's stream waits for it, so
        a copy queued behind block 0's step would hold the other cards back
        until that step ends."""
        return [Z[k * b:(k + 1) * b].to(devices[k]) for k in blocks]

    def total(parts):
        """The sum on the home device of the blocks' per-chain sums."""
        return sum(torch.sum(p).to(home) for p in parts)

    free = [p for p in demo["psf_params"] if not p["fix"]]
    yhat = [q(prob["yhat"]).to(dev) for dev in devices]
    lam, gamma = prob["lam"], prob["gamma"]
    lam_k = [lam.to(dev) for dev in devices]
    gamma_k = [gamma.to(dev) for dev in devices]
    theta = torch.tensor(demo["theta"]["init"], dtype=dtype, device=home)
    sigma2 = prob["sigma2_init"]
    params = refproblem.init_params(demo, dtype, home)
    H0 = q(psf.otf(psf.kernel_and_grads(demo, params, dtype, home)[0], (M, N)))
    H0_k = [H0.to(dev) for dev in devices]
    sweeps = [[] for _ in blocks]

    X = [y.to(dev).expand(b, M, N).contiguous() for dev in devices]
    lt_k = [(lam * theta).to(dev) for dev in devices]
    prox_calls = []
    for k in blocks:
        with _on(devices[k]):
            prox_calls.append(_graphed(fresh_prox, X[k], lt_k[k]) if X[k].is_cuda else fresh_prox)
    P = [prox(k, X[k], lt_k[k]) for k in blocks]
    Xhat = [rfft(x) for x in X]
    sigma2_k = [sigma2.to(dev) for dev in devices]
    for _ in range(demo["warmup"] - 1):
        Z = rows(draw((n_chains, M, N)))
        for k in blocks:
            G = irfft(torch.conj(H0_k[k]) * (H0_k[k] * Xhat[k] - yhat[k])) / sigma2_k[k]
            X[k] = myula(X[k], P[k], G, gamma_k[k], lam_k[k], Z[k], True)
            P[k] = prox(k, X[k], lt_k[k])
            Xhat[k] = rfft(X[k])

    d_scale = 0.01 / demo["theta"]["init"]
    t_box, s_box = demo["theta"]["box"], (prob["sigma2_lo"], prob["sigma2_hi"])
    traces = {"theta": [], "sigma2": [], **{p["name"]: [] for p in free}}
    for ii in range(2, demo["samples"] + 1):
        if free:
            k0, dks = psf.kernel_and_grads(demo, params, dtype, home)
            Hs = q(psf.otf(torch.stack([k0] + [dks[p["name"]] for p in free]), (M, N)))
        Z = rows(draw((n_chains, M, N)))
        theta_k = [theta.to(dev) for dev in devices]
        sigma2_k = [sigma2.to(dev) for dev in devices]
        Hs_k = [Hs.to(dev) for dev in devices] if free else None
        G_t, G_s, G_p = [], [], [[] for _ in free]
        for k in blocks:
            if free:
                H, dH = Hs_k[k][0], Hs_k[k][1:]
            else:
                H, dH = H0_k[k], []
            G = irfft(torch.conj(H) * (H * Xhat[k] - yhat[k])) / sigma2_k[k]
            X[k] = myula(X[k], P[k], G, gamma_k[k], lam_k[k], Z[k], demo["positivity"])
            P[k] = prox(k, X[k], lam_k[k] * theta_k[k])
            Xhat[k] = rfft(X[k])
            R = H * Xhat[k] - yhat[k]
            sq = torch.sum(w[k] * (R.real ** 2 + R.imag ** 2), dim=(-2, -1)) / d
            G_t.append(d / theta_k[k] - tv_norm(X[k]))
            G_s.append(sq / (2.0 * sigma2_k[k] ** 2) - d / (2.0 * sigma2_k[k]))
            for j, dh in enumerate(dH):
                dot = torch.sum(w[k] * (dh * Xhat[k] * torch.conj(R)).real, dim=(-2, -1)) / d
                G_p[j].append(dot / sigma2_k[k])
        delta = d_scale * float(ii) ** (-demo["d_exp"]) / d
        theta = torch.clamp(theta + demo["theta"]["step_scale"] * delta * total(G_t) / n_chains,
                            *t_box)
        for p, g in zip(free, G_p):
            params[p["name"]] = torch.clamp(
                params[p["name"]] - p["step_scale"] * delta * total(g) / n_chains, *p["box"])
        sigma2 = torch.clamp(sigma2 + demo["sigma_step_scale"] * delta * total(G_s) / n_chains,
                             *s_box)
        traces["theta"].append(theta)
        traces["sigma2"].append(sigma2)
        for p in free:
            traces[p["name"]].append(params[p["name"]])
    out = {n: torch.stack(v).cpu().double().numpy() for n, v in traces.items()}
    out["X_last"] = torch.cat([x.to(home) for x in X]).cpu().double().numpy()
    per_block = [torch.stack(s).double().mean().cpu() for s in sweeps]
    out["block_sweeps"] = [float(s) for s in per_block]
    out["sweeps"] = float(sum(per_block))
    return out
