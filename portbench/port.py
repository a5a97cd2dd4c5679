"""The benchmark's door into the measured program, `semiblind_tv_tpu_torch`:
its configuration presets and its problem (the drivers call its entry
points, `run_sapg` and `salsa_tv`, themselves).

`demo_config` builds the program's DemoConfig through its own preset, sets
over it the fields of the program's SAPGConfig that the configuration file
lists under `sapg_options` (the sample budget; options the reference's
arithmetic does not depend on, such as `fft_mode`), and refuses to go on
unless every number of the file's `demo` block is what the program runs and
the program keeps none of the options the reference does not implement
(`ASSUMED`): the reference reads those numbers, so the two sides then run the
same configuration.
"""
from __future__ import annotations

import dataclasses


# what the reference implements and the program could do otherwise: the SA's
# linear steps, σ² estimated, the demos' signs and unscaled λ and γ
ASSUMED = {"theta.sign": 1.0, "fix_sigma": False, "lambda_scale": 1.0, "gamma_scale": 1.0,
           "theta_log_scale": False, "sigma_log_scale": False, "psf_log_scale": False,
           "psf.sign": -1.0}


def _mismatches(cfg, demo, options):
    sapg, salsa = cfg.sapg, cfg.salsa
    pairs = [
        ("psf", cfg.psf, demo["psf"]), ("psf_size", cfg.psf_size, demo["psf_size"]),
        ("phi", cfg.phi, demo["phi"]), ("bsnr", cfg.bsnr, demo["bsnr"]),
        ("bsnr_min", cfg.bsnr_min, demo["bsnr_min"]), ("bsnr_max", cfg.bsnr_max, demo["bsnr_max"]),
        ("theta.init", cfg.theta.init, demo["theta"]["init"]),
        ("theta.box", list(cfg.theta.box), demo["theta"]["box"]),
        ("theta.step_scale", cfg.theta.step_scale, demo["theta"]["step_scale"]),
        ("theta.sign", cfg.theta.sign, ASSUMED["theta.sign"]),
        ("sigma_step_scale", cfg.sigma_step_scale, demo["sigma_step_scale"]),
        ("fix_sigma", cfg.fix_sigma, ASSUMED["fix_sigma"]),
        ("lambda_max", sapg.lambda_max, demo["lambda_max"]),
        ("gamma_frac", sapg.gamma_frac, demo["gamma_frac"]),
        ("gamma_multiplier", sapg.gamma_multiplier, demo["gamma_multiplier"]),
        ("lipschitz_agg", sapg.lipschitz_agg, demo["lipschitz_agg"]),
        ("d_exp", sapg.d_exp, demo["d_exp"]), ("d_scale", sapg.d_scale, None),
        ("chambolle_iters", sapg.chambolle_iters, demo["chambolle_iters"]),
        ("chambolle_tau", sapg.chambolle_tau, demo["chambolle_tau"]),
        ("chambolle_tol", sapg.chambolle_tol, demo["chambolle_tol"]),
        ("samples", sapg.samples, demo["samples"]), ("warmup", sapg.warmup, demo["warmup"]),
        ("burn_in", sapg.burn_in_resolved, demo["burn_in"]),
        ("positivity", sapg.positivity, demo["positivity"]),
        *[(k, getattr(sapg, k), ASSUMED[k]) for k in (
            "lambda_scale", "gamma_scale", "theta_log_scale", "sigma_log_scale", "psf_log_scale")],
        *[(f"sapg_options.{k}", getattr(sapg, k), v) for k, v in options.items()],
        ("tv_iters", salsa.tv_iters, demo["salsa"]["tv_iters"]),
        ("mu_factor", salsa.mu_factor, demo["salsa"]["mu_factor"]),
        ("psf_params", [p.name for p in cfg.psf_params], [p["name"] for p in demo["psf_params"]]),
    ]
    for spec, want in zip(cfg.psf_params, demo["psf_params"]):
        pairs += [(f"{spec.name}.{k}", got, want[w]) for k, got, w in (
            ("init", spec.init, "init"), ("box", list(spec.box), "box"),
            ("step_scale", spec.step_scale, "step_scale"), ("fix", spec.fix, "fix"),
            ("true_value", spec.true_value, "true"))]
        pairs.append((f"{spec.name}.sign", spec.sign, ASSUMED["psf.sign"]))
    return [f"{name}: program {got!r}, configuration {want!r}" for name, got, want in pairs
            if got != want]


def demo_config(config):
    """The program's DemoConfig for a configuration file: its preset with
    the file's `sapg_options` set over it; raises where it differs from the file."""
    from semiblind_tv_tpu_torch.runtime.config import preset

    demo, options = config["demo"], config.get("sapg_options", {})
    cfg = preset(config["preset"])
    cfg = dataclasses.replace(cfg, sapg=dataclasses.replace(cfg.sapg, **options))
    bad = _mismatches(cfg, demo, options)
    if bad:
        raise ValueError(f"{config['name']}: the program's preset differs from the "
                         "configuration: " + "; ".join(bad))
    return cfg


def build_problem(cfg, image, obs_noise, device):
    """The program's Problem on `device`, y drawn with the benchmark's noise field."""
    from semiblind_tv_tpu_torch.runtime.problem import build_problem as build

    return build(image, cfg, device=device, noise=obs_noise)
