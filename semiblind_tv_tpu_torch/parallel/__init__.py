"""The parallel path: device meshes, the sharded SAPG and the row-sharded
spatial estimator (port of semiblind_tv_tpu.parallel)."""
