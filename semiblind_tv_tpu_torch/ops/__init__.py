"""Operators: PSFs, the rfft blur operator, TV and its prox, and the CUDA
kernel wrappers (port of semiblind_tv_tpu.ops)."""
from semiblind_tv_tpu_torch.ops.psf import (  # noqa: F401
    gaussian_kernel,
    gaussian_kernel_grads,
    laplace_kernel,
    laplace_kernel_grads,
    moffat_kernel,
    moffat_kernel_grads,
)
from semiblind_tv_tpu_torch.ops.fourier import (  # noqa: F401
    BlurOperator,
    otf_rfft,
    otf_fft,
    rfft_weights,
    parseval_dot,
    parseval_norm_sq,
)
from semiblind_tv_tpu_torch.ops.tv import (  # noqa: F401
    tv_norm,
    chambolle_prox,
    divergence,
    forward_gradient,
)
from semiblind_tv_tpu_torch.ops.lipschitz import (  # noqa: F401
    power_iteration,
    max_eigenval_closed_form,
)
