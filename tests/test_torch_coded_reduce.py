"""The port's coded decode-reduce held against the JAX package's.

On the CPU the wrapper computes its plain version; it is held against the
reference's einsum oracle and its Pallas kernel in interpret mode on the
shapes of ``tests/test_kernels.py`` plus the paper MLP's payload.  The
CUDA kernel itself is compared with the plain version on the card by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""
from itertools import combinations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.coded_reduce.ops import coded_reduce_op
from repro.kernels.coded_reduce.ref import coded_reduce_ref as jax_ref

from repro_torch.core.coding import cyclic_repetition, rs_decode_weights
from repro_torch.kernels import _build, kernel_sources
from repro_torch.kernels.coded_reduce import coded_reduce, coded_reduce_ref
from repro_torch.kernels.coded_reduce.ops import MAX_SLOTS, SOURCE


def _tol(dtype):
    return (dict(rtol=1e-2, atol=1e-2) if dtype == "bfloat16"
            else dict(rtol=1e-5, atol=1e-5))


def _inputs(seed, n_slots, D, dtype, scale=1.0):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((n_slots, D)) * scale).astype(np.float32)
    w = rng.standard_normal((n_slots,)).astype(np.float32)
    g_t = torch.from_numpy(g).to(getattr(torch, dtype))
    g_j = jnp.asarray(g, getattr(jnp, dtype))
    return g_t, torch.from_numpy(w), g_j, jnp.asarray(w)


@pytest.mark.parametrize("n_slots,D", [(4, 512), (7, 1024), (16, 2048)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_sweep(n_slots, D, dtype):
    g, w, g_j, w_j = _inputs(7, n_slots, D, dtype)
    out = coded_reduce(g, w)
    assert out.dtype == torch.float32 and out.shape == (D,)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_ref(g_j, w_j)),
                               **_tol(dtype))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(coded_reduce_op(g_j, w_j, block_d=256,
                                                interpret=True)),
        **_tol(dtype))


@pytest.mark.parametrize("D", [513, 777, 2047])
def test_plain_matches_pallas_ragged_width(D):
    g, w, g_j, w_j = _inputs(10, 5, D, "float32")
    np.testing.assert_allclose(
        coded_reduce(g, w).numpy(),
        np.asarray(coded_reduce_op(g_j, w_j, block_d=512, interpret=True)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_slots,D", [(6, 98624), (6, 235146)])
def test_plain_matches_pallas_bridge_payloads(n_slots, D):
    """The bridge's payloads: the reference's TINY transformer and the
    paper's MLP (784, 256, 128, 10), whose flattened gradient has
    D = 235,146."""
    g, w, g_j, w_j = _inputs(12, n_slots, D, "float32", scale=0.1)
    np.testing.assert_allclose(
        coded_reduce(g, w).numpy(),
        np.asarray(coded_reduce_op(g_j, w_j, interpret=True)),
        rtol=1e-4, atol=1e-4)


def test_rs_erasure_sweep_recovers_the_shard_sum():
    """Every ≤s erasure pattern of CRS(6, 2), decoded with the port's
    ``rs_decode_weights`` and reduced over the surviving rows only."""
    rng = np.random.default_rng(11)
    M, s, D = 6, 2, 700
    scheme = cyclic_repetition(M, s)
    g_parts = rng.standard_normal((M, D)).astype(np.float32)
    coded = np.asarray(scheme.B @ g_parts, np.float32)
    patterns = [()] + [(i,) for i in range(M)] + \
        list(combinations(range(M), s))
    for dead in patterns:
        alive = np.ones(M, bool)
        alive[list(dead)] = False
        a = rs_decode_weights(scheme.nodes, alive, scheme.s)
        contrib = np.flatnonzero(a != 0.0)
        out = coded_reduce(torch.from_numpy(coded[contrib]),
                           torch.tensor(a[contrib], dtype=torch.float32))
        np.testing.assert_allclose(out.numpy(), g_parts.sum(0), rtol=1e-3,
                                   atol=1e-3, err_msg=f"dead={dead}")


# --------------------------------------------------------------------- #
# the wrapper's contract
# --------------------------------------------------------------------- #
def test_cpu_path_does_not_count_launches():
    before = coded_reduce.launches
    coded_reduce(torch.ones(3, 8), torch.ones(3))
    assert coded_reduce.launches == before


@pytest.mark.parametrize("case", ["rank", "length", "g_dtype", "w_dtype",
                                  "strided", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    g, w = torch.ones(4, 16), torch.ones(4)
    args = {"rank": (torch.ones(4, 2, 8), w),
            "length": (g, torch.ones(3)),
            "g_dtype": (g.double(), w),
            "w_dtype": (g, w.double()),
            "strided": (torch.ones(16, 4).t(), w),
            "device": (g.to("meta"), w.to("meta"))}[case]
    with pytest.raises((ValueError, TypeError)):
        coded_reduce(*args)


def test_build_names_library_by_source_hash(tmp_path, monkeypatch):
    from repro_torch.kernels.flash_attention.ops import SOURCE as FA_SOURCE
    from repro_torch.kernels.rglru_scan.ops import SOURCE as RG_SOURCE
    from repro_torch.kernels.rwkv6_wkv.ops import SOURCE as WKV_SOURCE
    assert kernel_sources() == [SOURCE, FA_SOURCE, WKV_SOURCE, RG_SOURCE]
    assert all(s.exists() for s in kernel_sources())
    lib = _build.library_path(SOURCE)
    assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"
    assert lib == _build.library_path(SOURCE)            # deterministic
    edited = tmp_path / SOURCE.name
    edited.write_text(SOURCE.read_text() + "\n// edited\n")
    assert _build.library_path(edited) != lib
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_kernel_source_states_its_cap():
    assert f"kMaxSlots = {MAX_SLOTS};" in SOURCE.read_text()
