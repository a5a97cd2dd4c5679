"""The port's share of the public surface that MIGRATION.md documents.

Every (module, name) of tests/test_migration_surface.py::DOCUMENTED, with
`semiblind_tv_tpu` read as `semiblind_tv_tpu_torch`, exists in the port and
is callable — or stands in NOT_YET, the names still to port (ROADMAP.md
queue 1 lists the same).  A NOT_YET name that appears in the port fails
the test, so the list shrinks with each slice that ports one.
"""
import importlib
import inspect

import numpy as np
import pytest
import torch

from tests.test_migration_surface import DOCUMENTED

NOT_YET = set()


def _port(module: str) -> str:
    return "semiblind_tv_tpu_torch" + module[len("semiblind_tv_tpu"):]


def _lookup(module, attr):
    try:
        return getattr(importlib.import_module(_port(module)), attr)
    except (ImportError, AttributeError):
        return None


def test_not_yet_names_are_documented():
    assert NOT_YET <= set(DOCUMENTED)


@pytest.mark.parametrize("module,attr", DOCUMENTED, ids=lambda v: str(v))
def test_documented_name_in_the_port(module, attr):
    obj = _lookup(module, attr)
    if (module, attr) in NOT_YET:
        assert obj is None, f"{_port(module)}.{attr} is ported: take it off NOT_YET"
    else:
        assert obj is not None, f"{_port(module)}.{attr} is missing from the port"
        assert callable(obj) or inspect.isclass(obj)


def test_run_sapg_documented_kwargs():
    from semiblind_tv_tpu_torch.sapg import run_sapg

    params = inspect.signature(run_sapg).parameters
    for kw in ("n_chains", "mesh", "checkpoint_every", "checkpoint_path", "checkpoint_backend",
               "fault_hook", "nan_guard", "max_restores"):
        assert kw in params


def test_salsa_tv_documented_call_shape():
    from semiblind_tv_tpu_torch.solvers.salsa import salsa_tv

    params = inspect.signature(salsa_tv).parameters
    for kw in ("tau", "mu", "blur"):
        assert kw in params


def test_otf_fft_matches_jax_and_otf_rfft():
    import jax.numpy as jnp

    from semiblind_tv_tpu.ops import fourier as jfourier
    from semiblind_tv_tpu_torch.ops import fourier as tfourier

    k = np.random.default_rng(0).random((7, 7))
    full = tfourier.otf_fft(torch.from_numpy(k), (24, 30))
    np.testing.assert_allclose(full.numpy(), np.asarray(jfourier.otf_fft(jnp.asarray(k), (24, 30))),
                               rtol=1e-12, atol=1e-12)
    half = tfourier.otf_rfft(torch.from_numpy(k), (24, 30))
    np.testing.assert_allclose(full[:, :16].numpy(), half.numpy(), rtol=1e-12, atol=1e-12)
