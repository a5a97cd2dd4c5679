"""semiblind_tv_tpu_torch — the PyTorch/CUDA port of `semiblind_tv_tpu`.

Empirical-Bayesian semi-blind TV deblurring (SAPG estimation of θ, σ² and
the PSF parameters with MYULA chains, then a SALSA MAP solve) on PyTorch,
with the JAX package's Pallas kernels replaced by CUDA C++ kernels for
Hopper (`csrc/tv_kernels.cu`).  The layout mirrors the JAX package: the
counterpart of `semiblind_tv_tpu/X/y.py` is `semiblind_tv_tpu_torch/X/y.py`.

Conventions: plain functions on tensors in the JAX layout `(B, M, N)` with
chains on the leading dimension; an explicit device; `torch.Generator`s
seeded from `cfg.seed`; Python loops where JAX had `lax.scan`, with no host
synchronisation inside them.  This package imports neither `jax` nor
`semiblind_tv_tpu`.
"""

__version__ = "0.1.0"
