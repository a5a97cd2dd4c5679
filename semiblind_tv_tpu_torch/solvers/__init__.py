"""MAP solvers (port of semiblind_tv_tpu.solvers; SALSA so far)."""
from semiblind_tv_tpu_torch.solvers.salsa import SALSAResult, salsa_tv, soft_threshold  # noqa: F401
