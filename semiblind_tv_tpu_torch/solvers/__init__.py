"""MAP solvers (port of semiblind_tv_tpu.solvers)."""
from semiblind_tv_tpu_torch.solvers.salsa import SALSAResult, salsa_tv, soft_threshold  # noqa: F401
from semiblind_tv_tpu_torch.solvers.fista import FISTAResult, fista, fista_tv  # noqa: F401
from semiblind_tv_tpu_torch.solvers.csalsa import (  # noqa: F401
    CSALSAResult,
    csalsa,
    csalsa_synthesis,
    csalsa_tv,
)
from semiblind_tv_tpu_torch.solvers.coral import CoRALResult, coral, coral_tv_l1  # noqa: F401
from semiblind_tv_tpu_torch.solvers.nesta import NESTAResult, nesta  # noqa: F401
from semiblind_tv_tpu_torch.solvers.spgl1 import SPGL1Result, spg_lasso, spgl1_bpdn  # noqa: F401
