"""Configuration, problem assembly, checkpoints and observability (port of
semiblind_tv_tpu.runtime)."""
from semiblind_tv_tpu_torch.runtime.config import (  # noqa: F401
    DemoConfig,
    SALSAConfig,
    SAPGConfig,
    gaussian_preset,
    isotropic_preset,
    laplace_preset,
    moffat_preset,
    preset,
)
from semiblind_tv_tpu_torch.runtime.problem import (  # noqa: F401
    Problem,
    build_problem,
    problem_from_arrays,
    synthesize_observation,
)
