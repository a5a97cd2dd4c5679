"""Command-line entry points (port of semiblind_tv_tpu.cli)."""
