"""The benchmark of `semiblind_tv_tpu_torch`, the PyTorch and CUDA port, on one
NVIDIA H100: `python portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` (see run.py and harness.py; cells, metrics
and bounds in BENCHMARK.json at the checkout's root).  Nothing here imports
JAX or the JAX package, and `reference/` imports nothing of the port."""
