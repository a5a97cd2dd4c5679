"""The benchmark's plain reference of the semi-blind TV deblurring pipeline.

Plain PyTorch, written from the published MATLAB demos
(charles-kmc/Semi-blind-image-deblurring-problems-with-TV:
run_Gaussian_demo.m, run_moffat_demo.m, SAPG_algorithm_Guassian.m,
SALSA_v2.m, chambolle_prox_TV_stop.m, the PSF files under utils/).  It
imports nothing of the measured program, nor JAX: it works out the
observation, the OTFs, σ², λ and γ, the chains and the MAP solve again from
the image, the configuration's numbers and the noise fields the benchmark
draws from its seed.

`precision.py` holds the control: the same code with every field it stores
rounded to TF32's 10-bit mantissa.
"""
