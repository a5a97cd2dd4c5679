"""MAP solvers (port of semiblind_tv_tpu.solvers; SALSA and FISTA so far)."""
from semiblind_tv_tpu_torch.solvers.salsa import SALSAResult, salsa_tv, soft_threshold  # noqa: F401
from semiblind_tv_tpu_torch.solvers.fista import FISTAResult, fista, fista_tv  # noqa: F401
