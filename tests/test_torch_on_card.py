"""The CUDA kernels of the port against their plain versions, on the card.

Every test here needs a CUDA card and skips without one.  The file imports
neither jax nor the JAX package, so it runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest tests/test_torch_on_card.py -q

Inputs are float32; the kernels are built with --fmad=false, so f, the
duals, xn and proxn agree with the plain versions to 1e-5 of their largest
magnitude at a fixed sweep count (tol=0) — the residual and TV sums are
taken in another order — and the early exit stops on the same sweep.
"""
import numpy as np
import pytest
import torch

from semiblind_tv_tpu_torch.ops import fused_step_cuda, tv_cuda

REL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels of csrc/tv_kernels.cu run only there")
    return torch.device("cuda")


def _rel_err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _field(rng, shape, dev, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)


@pytest.mark.parametrize("shape", [(1, 64, 64), (3, 48, 40), (2, 17, 33)])
def test_kernel_a_warm_matches_plain(cuda_device, shape):
    rng = np.random.default_rng(0)
    g = torch.from_numpy((rng.random(shape) * 255).astype(np.float32)).to(cuda_device)
    px0, py0 = _field(rng, shape, cuda_device), _field(rng, shape, cuda_device)
    lam = torch.tensor(20.0, device=cuda_device)
    before = tv_cuda.LAUNCHES
    f, st = tv_cuda.chambolle_prox_cuda(g, lam, 10, tol=0.0, duals=(px0, py0))
    pf, pst = tv_cuda.chambolle_prox_plain(g, lam, 10, tol=0.0, duals=(px0, py0))
    torch.cuda.synchronize()
    assert tv_cuda.LAUNCHES == before + 1
    assert _rel_err(f, pf) <= REL
    assert _rel_err(st.px, pst.px) <= REL and _rel_err(st.py, pst.py) <= REL
    assert torch.equal(st.iters.cpu(), pst.iters.cpu())


def test_kernel_a_fresh_early_exit_matches_plain(cuda_device):
    yy, xx = np.mgrid[0:64, 0:64]
    base = (np.sin(xx / 5.0) + np.cos(yy / 7.0)).astype(np.float32)
    g = torch.from_numpy(np.stack([base * s for s in (1e-5, 1e-4, 1.0)])).to(cuda_device)
    f, st = tv_cuda.chambolle_prox_cuda(g, 0.5, 25, return_state=False)
    pf, pst = tv_cuda.chambolle_prox_plain(g, 0.5, 25, return_state=False)
    torch.cuda.synchronize()
    assert torch.equal(st.iters.cpu(), pst.iters.cpu())
    assert st.iters[0] < 25 and st.iters[2] == 25
    assert _rel_err(f, pf) <= REL
    assert float(st.px.abs().max()) == 0.0


@pytest.mark.parametrize("positivity", [True, False])
def test_kernel_b_matches_plain(cuda_device, positivity):
    rng = np.random.default_rng(1)
    shape = (2, 48, 40)
    x = torch.from_numpy((rng.random(shape) * 255).astype(np.float32)).to(cuda_device)
    prox = x + _field(rng, shape, cuda_device, 0.1)
    grad = _field(rng, shape, cuda_device, 0.01)
    z = _field(rng, shape, cuda_device)
    args = tuple(torch.tensor(v, device=cuda_device) for v in (1.9, 2.0, 0.02))
    before = fused_step_cuda.LAUNCHES
    k = fused_step_cuda.myula_prox_tv(x, prox, grad, z, *args, 25, tol=0.0,
                                      positivity=positivity)
    p = fused_step_cuda.myula_prox_tv_plain(x, prox, grad, z, *args, 25, tol=0.0,
                                            positivity=positivity)
    torch.cuda.synchronize()
    assert fused_step_cuda.LAUNCHES == before + 1
    for a, b in zip(k, p):
        assert _rel_err(a, b) <= REL


def test_wrappers_raise_on_bad_inputs(cuda_device):
    g = torch.zeros((1, 16, 16), device=cuda_device)
    with pytest.raises(TypeError):
        tv_cuda.chambolle_prox_cuda(g.double(), 0.5, 5)
    with pytest.raises(ValueError):
        tv_cuda.chambolle_prox_cuda(g.transpose(1, 2), 0.5, 5)
    with pytest.raises(ValueError):
        tv_cuda.chambolle_prox_cuda(g, torch.tensor(0.5), 5)  # λ on the host
