"""The port on the card: the CUDA kernel against its plain version, and the
coded-training bridge decoding through it.

Every test here is marked ``cuda`` and skips where there is no CUDA
device.  The file imports neither ``jax`` nor ``repro``, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.data.pipeline import SyntheticClassificationDataset
from repro_torch.kernels.coded_reduce import coded_reduce, coded_reduce_ref
from repro_torch.models.mlp import init_mlp, mlp_loss
from repro_torch.optim.optimizers import adamw, tree_leaves
from repro_torch.sim import scenario_spec
from repro_torch.train import CodedTrainer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card)")
    return torch.device("cuda")


def _tol(dtype):
    # bf16 inputs: the kernel and the plain version convert the same bf16
    # values, so only the f32 summation order differs; the reference's
    # kernel tests use the same bounds
    return (dict(rtol=1e-2, atol=1e-2) if dtype == "bfloat16"
            else dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("n_slots,D", [(4, 512), (7, 1024), (16, 2048),
                                       (5, 777), (6, 235146)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(cuda_device, n_slots, D, dtype):
    rng = np.random.default_rng(7)
    g = torch.from_numpy(rng.standard_normal((n_slots, D)).astype(
        np.float32)).to(cuda_device, getattr(torch, dtype))
    w = torch.from_numpy(rng.standard_normal(n_slots).astype(
        np.float32)).to(cuda_device)
    before = coded_reduce.launches
    out = coded_reduce(g, w)
    torch.cuda.synchronize()
    assert coded_reduce.launches == before + 1
    assert out.device.type == "cuda" and out.dtype == torch.float32
    np.testing.assert_allclose(out.cpu().numpy(),
                               coded_reduce_ref(g, w).cpu().numpy(),
                               **_tol(dtype))


def _trainer(scheme, device):
    spec = scenario_spec("bursty-stragglers")
    params = init_mlp(torch.Generator().manual_seed(0), dims=(32, 32, 4),
                      device=device)
    return CodedTrainer(
        spec, scheme,
        SyntheticClassificationDataset(spec.K, 16, 32, 4, device=device),
        adamw(1e-3), params=params, loss_fn=mlp_loss, device=device)


@pytest.mark.parametrize("scheme", ["two-stage", "cyclic", "fractional",
                                    "uncoded"])
def test_trainer_decodes_through_the_kernel(cuda_device, scheme):
    gpu, cpu = _trainer(scheme, cuda_device), _trainer(scheme, "cpu")
    before = coded_reduce.launches
    decoded = 0
    for epoch in range(3):
        lg, lc = gpu.run_epoch(epoch), cpu.run_epoch(epoch)
        # the co-sim's outcomes do not depend on the gradient's values
        assert (lg.decode_ok, lg.n_slots, lg.time) == \
            (lc.decode_ok, lc.n_slots, lc.time)
        if lg.decode_ok:
            decoded += 1
            np.testing.assert_allclose(gpu.last_decoded, gpu.last_full_grad,
                                       rtol=1e-4, atol=1e-5)
    assert coded_reduce.launches == before + decoded
    assert all(p.device.type == "cuda" for p in tree_leaves(gpu.params))
    # cuBLAS and the CPU's BLAS sum the float32 products in other orders
    for pg, pc in zip(tree_leaves(gpu.params), tree_leaves(cpu.params)):
        np.testing.assert_allclose(pg.cpu().numpy(), pc.numpy(), rtol=1e-4,
                                   atol=1e-5)
