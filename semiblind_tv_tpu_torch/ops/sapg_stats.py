"""The SAPG step's Fourier-domain work around the spatial segment on the
card: the residual, the Parseval statistics and the clamped SA updates,
three kernels of `csrc/sapg_stats.cu` (sapg/estimator.py's step calls
them on every route but 'plain').

    sapg_residual  Ĝ = conj(H)·(H·X̂ − ŷ), one pass over X̂
    sapg_stats     each problem's means over its chains of G_θ = d/θ − tv,
                   G_σ = res2/(2σ⁴) − d/(2σ²), G_p = pdot_p/σ² (each free
                   PSF parameter), logπ = −res2/(2σ²) − θ·tv and gX = tv,
                   from one pass over X̂ₙ (Rₙ = H·X̂ₙ − ŷ, res2 = Σw|Rₙ|²/d,
                   pdot_p = Σw·Re(dH_p·X̂ₙ·conj Rₙ)/d), into one (K, D)
                   block `packed` (rows `stat_names`), which a mesh
                   all-reduces over the chains group as it is; with
                   logpi_only, logπ alone, one row
    sapg_update    θ, σ² and the free PSF parameters' clamped SA updates
                   from `packed` (divided by the group's size) and the step
                   coefficients' column ii, read at a device index, and the
                   iteration's trace rows (`trace_names`, (n, D))

They replace no TPU kernel: the JAX package leaves this work to XLA.  They
take what they need from their inputs' shapes (problems D, chains C, the
half-spectrum M × Nh, the free parameters) and from the update's rule
(sa_rule: the config's log-scale options, σ² pinned, pinned PSF
parameters).

Each has a plain PyTorch version beside it — the step's expressions as
they were, so the CPU path keeps its bits: sapg_residual_plain,
sapg_stats_plain (a dict of (D,) means, problem by problem) and
sapg_update_plain (the trace rows from such a dict).  The wrappers take
the plain versions for CPU tensors (sapg_stats then stacks the dict in
`packed`'s order, and sapg_update reads `packed` as the kernel does) and
launch the kernel for CUDA tensors (float32 and complex64, contiguous);
anything else raises.  `stat_scales` is the float64 magnitude of each
statistic's terms, the scale the kernel's sums are held to against the
plain version's.  Launch counters: `launches.sapg_residual`,
`launches.sapg_stats`, `launches.sapg_update` (profiling.counters; a graph
replay adds its capture's).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence

import torch

from semiblind_tv_tpu_torch.ops.tv_cuda import check_status
from semiblind_tv_tpu_torch.runtime import profiling

__all__ = [
    "SARule", "sa_rule", "stat_names", "trace_names", "coefficient_column",
    "sapg_residual", "sapg_residual_plain", "sapg_stats", "sapg_stats_plain",
    "sapg_update", "sapg_update_plain", "stat_scales", "stats_workspace", "MAX_PSF",
    "UPDATE_FLAGS",
]

MAX_PSF = 2   # PSF parameters the kernels take (csrc/sapg_stats.cu): every preset's most
UPDATE_FLAGS = dict(theta_log_scale=1, sigma_log_scale=2, psf_log_scale=4, sigma_fix=8)


def stat_names(free_names: Sequence[str], logpi_only: bool = False) -> tuple:
    """The rows of `packed`: G_t, G_s, G_<each free parameter>, logPi, gX."""
    if logpi_only:
        return ("logPi",)
    return ("G_t", "G_s") + tuple(f"G_{n}" for n in free_names) + ("logPi", "gX")


def trace_names(psf_names: Sequence[str]) -> tuple:
    """The rows of a step's trace: θ, σ², logπ, gX, G_t, G_s, then G_<p> and
    p of every PSF parameter (pinned ones too: G 0, p its value)."""
    return (("theta", "sigma2", "logPi", "gX", "G_t", "G_s")
            + tuple(f"G_{n}" for n in psf_names) + tuple(psf_names))


def coefficient_column(table: torch.Tensor, ii):
    """Column ii of the step coefficient table: a view for a host int, a
    gather for a device index (a (1,) int64 tensor, which a CUDA graph
    advances)."""
    if isinstance(ii, int):
        return table[:, ii]
    return table.index_select(1, ii)[:, 0]


class SARule(NamedTuple):
    """What the SA updates take from the config (sa_rule)."""

    theta_spec: object
    psf_specs: tuple
    theta_log: bool
    sigma_log: bool
    psf_log: bool
    sigma_fix: bool
    fixed_vals: Dict[str, torch.Tensor]    # each pinned parameter's value, 0-d
    log_box: Dict[str, tuple]              # each parameter's box in log space, 0-d ends
    log_theta_box: tuple
    zero: torch.Tensor                     # the G of a pinned parameter, 0-d
    box: torch.Tensor                      # the kernel's: θ lo, hi, log lo, log hi; then
                                           # a parameter's lo, hi, log lo, log hi, value
    pinned: int                            # bit i: PSF parameter i is pinned
    flags: int                             # UPDATE_FLAGS of the options that hold

    @property
    def psf_names(self) -> tuple:
        return tuple(s.name for s in self.psf_specs)

    @property
    def free_names(self) -> tuple:
        return tuple(s.name for s in self.psf_specs if not s.fix)


def sa_rule(cfg, sigma_fix: bool, dtype, device) -> SARule:
    """The SA updates' rule of `cfg` on `device`: boxes, log boxes and
    pinned values as the step's tensors (the kernel's `box` is their
    float32 copy)."""
    sapg = cfg.sapg
    psf_specs = tuple(cfg.psf_params)

    def as_t(v):
        return torch.tensor(v, dtype=dtype, device=device)

    fixed_vals = {s.name: s.clip(as_t(s.true_value)) for s in psf_specs if s.fix}
    log_box = {s.name: (torch.log(as_t(s.box[0])), torch.log(as_t(s.box[1])))
               for s in psf_specs}
    theta_spec = cfg.theta
    log_theta_box = (torch.log(as_t(theta_spec.box[0])), torch.log(as_t(theta_spec.box[1])))
    vals = [as_t(theta_spec.box[0]), as_t(theta_spec.box[1]), *log_theta_box]
    for s in psf_specs:
        vals += [as_t(s.box[0]), as_t(s.box[1]), *log_box[s.name],
                 fixed_vals[s.name] if s.fix else as_t(math.nan)]
    flags = {"theta_log_scale": sapg.theta_log_scale, "sigma_log_scale": sapg.sigma_log_scale,
             "psf_log_scale": sapg.psf_log_scale, "sigma_fix": sigma_fix}
    return SARule(
        theta_spec=theta_spec, psf_specs=psf_specs, theta_log=bool(sapg.theta_log_scale),
        sigma_log=bool(sapg.sigma_log_scale), psf_log=bool(sapg.psf_log_scale),
        sigma_fix=bool(sigma_fix), fixed_vals=fixed_vals, log_box=log_box,
        log_theta_box=log_theta_box, zero=torch.zeros((), dtype=dtype, device=device),
        box=torch.stack(vals).to(torch.float32),
        pinned=sum(1 << i for i, s in enumerate(psf_specs) if s.fix),
        flags=sum(bit for k, bit in UPDATE_FLAGS.items() if flags[k]),
    )


# ---------------------------------------------------------------------------
# Plain versions: the step's expressions as they were
# ---------------------------------------------------------------------------

def sapg_residual_plain(xhat, h, yhat):
    """Ĝ = conj(H)·(H·X̂ − ŷ) of (D, C, M, Nh) X̂; H (M, Nh) for every
    problem or (D, M, Nh), ŷ (D, M, Nh)."""
    hl = h[None] if h.ndim == 2 else h[:, None]
    rhat = hl * xhat - yhat[:, None]
    return torch.conj(hl) * rhat


def sapg_stats_plain(xhat, h, yhat, tv, theta, sigma2, dhs: Optional[dict] = None,
                     weights=None, dim=None, logpi_only: bool = False) -> dict:
    """{name: (D,)} of stat_names: each problem's means over its chains of
    the chains' statistics of (D, C, M, Nh) X̂ₙ and (D, C) tv at θ and σ²
    ((D,); θ may be one value expanded), H (M, Nh) or (D, M, Nh), dhs {free
    parameter: (D, M, Nh) dH}; weights the rfft columns' Parseval weights
    and dim M·N.  Each problem's sums take the shapes, and so the order, of
    its own run; one problem's means take the problem axis as a view."""
    dhs = dhs or {}
    D = yhat.shape[0]
    w = weights
    hp = h.expand(D, *h.shape) if h.ndim == 2 else h

    def pnorm2(Rhat):
        re, im = Rhat.real, Rhat.imag
        return torch.sum(w[None] * (re * re + im * im), dim=(-2, -1)) / dim

    def pdot(Ahat, Bhat):
        return torch.sum(w[None] * (Ahat * torch.conj(Bhat)).real, dim=(-2, -1)) / dim

    def chain_stats(H, Xhn, yhat, tv, theta, sigma2, *dH):
        Rn = H[None] * Xhn - yhat[None]
        res2 = pnorm2(Rn)
        if logpi_only:
            return dict(logPi=-res2 / (2.0 * sigma2) - theta * tv)
        # the θ lag: logπ uses the pre-update θ and σ²
        return dict(
            G_t=dim / theta - tv,
            G_s=res2 / (2.0 * sigma2 ** 2) - dim / (2.0 * sigma2),
            **{f"G_{n}": pdot(dh[None] * Xhn, Rn) / sigma2 for n, dh in zip(dhs, dH)},
            logPi=-res2 / (2.0 * sigma2) - theta * tv,
            gX=tv,
        )

    args = (hp, xhat, yhat, tv, theta, sigma2, *dhs.values())
    means = [{k: torch.mean(v) for k, v in chain_stats(*(a[i] for a in args)).items()}
             for i in range(D)]
    return {k: means[0][k][None] if D == 1 else torch.stack([m[k] for m in means])
            for k in means[0]}


def stat_scales(xhat, h, yhat, tv, theta, sigma2, dhs: Optional[dict] = None, weights=None,
                dim=None, logpi_only: bool = False) -> torch.Tensor:
    """(K, D) float64, rows stat_names: each problem's mean over its chains
    of the magnitude of each statistic's terms (Σ|term| of each sum, |·| of
    each addend), in float64, of sapg_stats_plain's arguments.  Two float32
    sums of the same terms in different orders differ by a few ulps of this
    scale, not of the result, which cancels where the terms do (G_σ, and G_p
    whose terms take both signs)."""
    dhs = dhs or {}
    c128 = torch.complex128
    x = xhat.to(c128)
    hh = h.to(c128)
    hl = hh[None] if hh.ndim == 2 else hh[:, None]
    R = hl * x - yhat.to(c128)[:, None]
    w = weights.double()
    res2 = (w * R.abs() ** 2).sum((-2, -1)) / dim
    th = theta.double().expand(tv.shape[0])[:, None]
    s2 = sigma2.double()[:, None]
    tv64 = tv.double()
    logpi = res2 / (2 * s2) + th * tv64
    if logpi_only:
        return logpi.mean(1)[None]
    rows = [dim / th + tv64, res2 / (2 * s2 ** 2) + dim / (2 * s2)]
    rows += [(w * (dh.to(c128)[:, None] * x).abs() * R.abs()).sum((-2, -1)) / dim / s2
             for dh in dhs.values()]
    rows += [logpi, tv64]
    return torch.stack([r.expand_as(tv64).mean(1) for r in rows])


def sapg_update_plain(stats: dict, coef, theta, sigma2, params: dict, consts: dict,
                      rule: SARule) -> torch.Tensor:
    """The trace rows (trace_names, (n, D)) of the SA updates of θ, σ² and
    the free PSF parameters from the step's statistics {name: (D,)} and
    coef, column ii of the step coefficients (rows: θ, σ², then the free
    parameters)."""
    problems = theta.shape[0]
    G_t, G_s = stats["G_t"], stats["G_s"]
    free = rule.free_names
    G_p = {n: stats[f"G_{n}"] for n in free}
    coef_row = {n: 2 + j for j, n in enumerate(free)}
    if rule.theta_log:
        # Algorithm-1: eta = log θ, eta += δ·G_θ·θ, clipped in eta-space
        # (SALSA/SAPG_algorithm_1.m:180-182)
        eta_n = torch.clamp(torch.log(theta) + coef[0] * G_t * theta, *rule.log_theta_box)
        theta_n = torch.exp(eta_n)
    else:
        theta_n = rule.theta_spec.clip(theta + coef[0] * G_t)
    params_n = {}
    for s in rule.psf_specs:
        if s.fix:
            params_n[s.name] = rule.fixed_vals[s.name].expand(problems)
        elif rule.psf_log:
            # log-space update with the chain-rule factor p, clipped in
            # log space (an extension of the JAX package, opt-in)
            p = params[s.name]
            lp_n = torch.clamp(torch.log(p) + coef[coef_row[s.name]] * G_p[s.name] * p,
                               *rule.log_box[s.name])
            params_n[s.name] = torch.exp(lp_n)
        else:
            params_n[s.name] = s.clip(params[s.name] + coef[coef_row[s.name]] * G_p[s.name])
    if rule.sigma_fix:
        sigma_n = consts["sigma2_init"]
    elif rule.sigma_log:
        # log σ² with the chain-rule factor σ², clipped in log space (an
        # extension of the JAX package, opt-in: it moves far faster from
        # the wide BSNR-midpoint init at large d)
        lsig_n = torch.clamp(
            torch.log(sigma2) + coef[1] * G_s * sigma2,
            torch.log(consts["sigma2_lo"]), torch.log(consts["sigma2_hi"]),
        )
        sigma_n = torch.exp(lsig_n)
    else:
        sigma_n = torch.clamp(sigma2 + coef[1] * G_s, consts["sigma2_lo"], consts["sigma2_hi"])

    trace = dict(
        theta=theta_n,
        sigma2=sigma_n,
        logPi=stats["logPi"],
        gX=stats["gX"],
        G_t=G_t,
        G_s=G_s,
        **{f"G_{n}": G_p.get(n, rule.zero.expand(problems)) for n in rule.psf_names},
        **{n: params_n[n] for n in rule.psf_names},
    )
    return torch.stack([trace[n] for n in trace_names(rule.psf_names)])


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------

def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check(name, t: torch.Tensor, dtype, like: torch.Tensor) -> None:
    """Raise unless t is a contiguous `dtype` tensor on like's device."""
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} for the CUDA kernel, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _per_problem(name, t: torch.Tensor, D: int, tail: tuple) -> int:
    """The problem stride (in elements) of a per-problem tensor of shape
    tail, or (D, *tail); 0 for one shared by every problem."""
    if tuple(t.shape) == tail:
        return 0
    if tuple(t.shape) == (D,) + tail:
        return math.prod(tail)
    raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tail} or {(D,) + tail}")


def _device_kind(x: torch.Tensor, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type


def sapg_residual(xhat, h, yhat):
    """Ĝ = conj(H)·(H·X̂ − ŷ), (D, C, M, Nh) like X̂ (sapg_residual_plain's
    arguments)."""
    if _device_kind(xhat, "sapg_residual") == "cpu":
        return sapg_residual_plain(xhat, h, yhat)
    from semiblind_tv_tpu_torch._build import load_library

    D, C, M, Nh = xhat.shape
    for name, t in (("xhat", xhat), ("h", h), ("yhat", yhat)):
        _check(name, t, torch.complex64, xhat)
    h_stride = _per_problem("h", h, D, (M, Nh))
    if _per_problem("yhat", yhat, D, (M, Nh)) == 0 and D > 1:
        raise ValueError("yhat must hold one ŷ a problem")
    ghat = torch.empty_like(xhat)
    code = load_library().sb_sapg_residual(
        xhat.data_ptr(), h.data_ptr(), yhat.data_ptr(), ghat.data_ptr(), D * C, M * Nh, C,
        h_stride, _stream(xhat.device))
    check_status(code, "sapg_residual")
    profiling.counters.add("launches.sapg_residual")
    return ghat


def stats_workspace(device, B: int, mnh: int) -> tuple:
    """(partials, chain statistics, tickets) of sapg_stats for B chains of
    mnh values, for the most statistics a chain may have, so a launch of
    fewer shares them.  The B + 1 tickets (one a chain, one for the chains)
    are zero and each launch leaves them zero; launches that share a
    workspace run one after another (on one stream)."""
    from semiblind_tv_tpu_torch._build import load_library

    nblk = -(-mnh // load_library().sb_sapg_stats_span())
    return (torch.empty(((1 + MAX_PSF) * B * nblk,), dtype=torch.float32, device=device),
            torch.empty(((4 + MAX_PSF) * B,), dtype=torch.float32, device=device),
            torch.zeros((B + 1,), dtype=torch.int32, device=device))


def sapg_stats(xhat, h, yhat, tv, theta, sigma2, dhs: Optional[dict] = None, weights=None,
               dim=None, logpi_only: bool = False, workspace: Optional[dict] = None
               ) -> torch.Tensor:
    """`packed`: the (K, D) block of each problem's means of its chains'
    statistics, rows stat_names(dhs, logpi_only) (sapg_stats_plain's
    arguments).  workspace: a dict its caller keeps for launches on one
    stream, which holds the stats_workspace of each shape, made at its first
    launch, so a captured graph's pointers stay valid; without one a launch
    makes its own."""
    dhs = dhs or {}
    if _device_kind(xhat, "sapg_stats") == "cpu":
        stats = sapg_stats_plain(xhat, h, yhat, tv, theta, sigma2, dhs, weights, dim,
                                 logpi_only)
        return torch.stack(list(stats.values()))
    from semiblind_tv_tpu_torch._build import load_library

    lib = load_library()
    D, C, M, Nh = xhat.shape
    P = len(dhs)
    if P > MAX_PSF or (logpi_only and P):
        raise ValueError(f"sapg_stats takes at most {MAX_PSF} free parameters, none for logπ")
    for name, t in (("xhat", xhat), ("h", h), ("yhat", yhat), *dhs.items()):
        _check(name, t, torch.complex64, xhat)
    for name, t in (("tv", tv), ("sigma2", sigma2), ("weights", weights)):
        _check(name, t, torch.float32, xhat)
    h_stride = _per_problem("h", h, D, (M, Nh))
    if tuple(yhat.shape) != (D, M, Nh) or tuple(tv.shape) != (D, C) \
            or tuple(sigma2.shape) != (D,) or weights.numel() != Nh:
        raise ValueError("sapg_stats: yhat (D, M, Nh), tv (D, C), sigma2 (D,) and Nh "
                         f"weights, got {tuple(yhat.shape)}, {tuple(tv.shape)}, "
                         f"{tuple(sigma2.shape)}, {tuple(weights.shape)}")
    for n, t in dhs.items():
        if tuple(t.shape) != (D, M, Nh):
            raise ValueError(f"dH of {n} has shape {tuple(t.shape)}, expected {(D, M, Nh)}")
    if theta.dtype != torch.float32 or theta.device != xhat.device:
        raise TypeError(f"theta must be float32 on {xhat.device}")
    if theta.numel() == 1 or (theta.shape == (D,) and theta.stride(0) == 0):
        theta_stride = 0
    elif theta.shape == (D,) and theta.is_contiguous():
        theta_stride = 1
    else:
        raise ValueError(f"theta must be one value or (D,), got {tuple(theta.shape)}")
    K = 1 if logpi_only else 4 + P
    key = (D * C, M * Nh)
    if workspace is None:
        workspace = {}
    if key not in workspace:
        workspace[key] = stats_workspace(xhat.device, *key)
    partials, chain_stats, ticket = workspace[key]
    packed = torch.empty((K, D), dtype=torch.float32, device=xhat.device)
    dh = [t.data_ptr() for t in dhs.values()] + [None] * (MAX_PSF - P)
    code = lib.sb_sapg_stats(
        xhat.data_ptr(), h.data_ptr(), yhat.data_ptr(), *dh, weights.data_ptr(),
        tv.data_ptr(), theta.data_ptr(), sigma2.data_ptr(), packed.data_ptr(),
        partials.data_ptr(), chain_stats.data_ptr(), ticket.data_ptr(), partials.numel(),
        D * C, C, M, Nh, h_stride, theta_stride, P, int(bool(logpi_only)), float(dim),
        _stream(xhat.device))
    check_status(code, "sapg_stats")
    profiling.counters.add("launches.sapg_stats")
    return packed


def sapg_update(packed, n_group: int, coef_table, ii, theta, sigma2, params: dict,
                consts: dict, rule: SARule) -> torch.Tensor:
    """The trace rows (trace_names, (n, D)) of the SA updates from
    `packed` (sapg_stats' block, summed over a chains group of n_group
    ranks) and column ii of coef_table (a host int or a (1,) int64 device
    index); θ, σ², each parameter and consts' sigma2_lo/hi/init (D,)."""
    if _device_kind(packed, "sapg_update") == "cpu":
        free = rule.free_names
        means = packed if n_group == 1 else packed / n_group
        stats = dict(zip(stat_names(free), means.unbind(0)))
        return sapg_update_plain(stats, coefficient_column(coef_table, ii), theta, sigma2,
                                 params, consts, rule)
    from semiblind_tv_tpu_torch._build import load_library

    D = theta.shape[0]
    names = rule.psf_names
    if len(names) > MAX_PSF:
        raise ValueError(f"sapg_update takes at most {MAX_PSF} PSF parameters")
    scalars = [("packed", packed), ("coef_table", coef_table), ("theta", theta),
               ("sigma2", sigma2), ("box", rule.box)]
    scalars += [(k, consts[k]) for k in ("sigma2_lo", "sigma2_hi", "sigma2_init")]
    scalars += [(n, params[n]) for n in rule.free_names]
    for name, t in scalars:
        _check(name, t, torch.float32, packed)
    if tuple(packed.shape) != (4 + len(rule.free_names), D):
        raise ValueError(f"packed has shape {tuple(packed.shape)}, "
                         f"expected {(4 + len(rule.free_names), D)}")
    if isinstance(ii, int):
        index, col = None, ii
    else:
        _check("ii", ii, torch.int64, packed)
        index, col = ii.data_ptr(), 0
    ptrs = [None if s.fix else params[s.name].data_ptr() for s in rule.psf_specs]
    rows = torch.empty((len(trace_names(names)), D), dtype=torch.float32, device=packed.device)
    code = load_library().sb_sapg_update(
        packed.data_ptr(), coef_table.data_ptr(), index, theta.data_ptr(), sigma2.data_ptr(),
        *(ptrs + [None] * (MAX_PSF - len(ptrs))), consts["sigma2_lo"].data_ptr(),
        consts["sigma2_hi"].data_ptr(), consts["sigma2_init"].data_ptr(), rule.box.data_ptr(),
        rows.data_ptr(), col, coef_table.shape[1], D, len(names), rule.pinned, rule.flags,
        float(n_group), _stream(packed.device))
    check_status(code, "sapg_update")
    profiling.counters.add("launches.sapg_update")
    return rows
