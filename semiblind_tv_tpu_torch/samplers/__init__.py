"""Langevin samplers (port of semiblind_tv_tpu.samplers)."""
from semiblind_tv_tpu_torch.samplers.myula import myula_kernel_step  # noqa: F401
