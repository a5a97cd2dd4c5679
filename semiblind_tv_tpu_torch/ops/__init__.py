"""Operators: PSFs, the rfft blur operator, TV and its prox, and the CUDA
kernel wrappers (port of semiblind_tv_tpu.ops)."""
