"""SAPG empirical-Bayes estimator (port of semiblind_tv_tpu.sapg)."""
from semiblind_tv_tpu_torch.sapg.estimator import SAPGResult, run_sapg  # noqa: F401
