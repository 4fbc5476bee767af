"""The port on the card: the CUDA kernels against their plain versions, the
coded-training bridge decoding through them, the rwkv6 and
recurrentgemma models on the card against the CPU, and the paper's
``FELTrainer`` and the LM training loop on the card against the CPU.

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
        None, spec, scheme,
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
            np.testing.assert_allclose(gpu.last_decoded.cpu().numpy(),
                                       gpu.last_full_grad.cpu().numpy(),
                                       rtol=1e-4, atol=1e-5)
    assert coded_reduce.launches == before + decoded
    assert all(p.device.type == "cuda" for p in tree_leaves(gpu.params))
    # cuBLAS and the CPU's BLAS sum the float32 products in other orders
    for pg, pc in zip(tree_leaves(gpu.params), tree_leaves(cpu.params)):
        np.testing.assert_allclose(pg.cpu().numpy(), pc.numpy(), rtol=1e-4,
                                   atol=1e-5)


# --------------------------------------------------------------------- #
# flash attention: the kernel against its plain version, forward and
# backward.  Both compute in float32 from the same inputs; float32 sums
# in another order (rtol/atol 2e-5 forward, 1e-4 gradients), bfloat16
# outputs round the same float32 values (2e-2, the reference's kernel
# test tolerance).
# --------------------------------------------------------------------- #
def _attention_inputs(device, shape_q, shape_k, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def draw(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device, getattr(torch, dtype))
    return draw(shape_q), draw(shape_k), draw(shape_k), draw(shape_q)


def _fa_tol(dtype, grad):
    if dtype == "bfloat16":
        return dict(rtol=2e-2, atol=2e-2)
    return dict(rtol=1e-4, atol=1e-4) if grad else dict(rtol=2e-5,
                                                         atol=2e-5)


@pytest.mark.parametrize("shape_q,shape_k", [
    ((1, 128, 2, 1, 32), (1, 128, 2, 32)),
    ((2, 256, 1, 1, 64), (2, 256, 1, 64)),
    ((1, 128, 2, 1, 80), (1, 128, 2, 80)),
    ((2, 128, 2, 3, 32), (2, 128, 2, 32)),         # GQA
    ((1, 100, 2, 2, 16), (1, 100, 2, 16)),         # ragged tail
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48),
                                           (False, 0)])
def test_flash_attention_kernel_matches_plain_on_card(
        cuda_device, shape_q, shape_k, dtype, causal, window):
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_ref,
        flash_attention_fwd, flash_attention_fwd_ref)
    q, k, v, do = _attention_inputs(cuda_device, shape_q, shape_k, dtype)
    kw = dict(causal=causal, window=window, q_chunk=64, kv_chunk=64)
    before = (flash_attention.fwd_launches, flash_attention.bwd_launches)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    grads = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert (flash_attention.fwd_launches, flash_attention.bwd_launches) == \
        (before[0] + 1, before[1] + 1)
    out_ref, lse_ref = flash_attention_fwd_ref(q, k, v, **kw)
    grads_ref = flash_attention_bwd_ref(q, k, v, out_ref, lse_ref, do, **kw)
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               out_ref.float().cpu().numpy(),
                               **_fa_tol(dtype, False))
    np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    for g, r in zip(grads, grads_ref):
        assert g.dtype == r.dtype == q.dtype
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   r.float().cpu().numpy(),
                                   **_fa_tol(dtype, True))


# bf16, the tensor-core route (wgmma fed by TMA): P and dS are rounded to
# bf16 before their products, so the bounds are the bf16 ones above
@pytest.mark.parametrize("shape_q,causal,window", [
    ((1, 130, 2, 2, 8), True, 48),                 # D not a multiple of 16
    ((1, 130, 2, 2, 24), True, 0),
    ((1, 130, 2, 2, 40), False, 30),
    ((1, 1, 2, 2, 16), True, 0),                   # ragged S
    ((1, 100, 2, 2, 16), True, 24),
    ((1, 100, 2, 2, 16), False, 30),
    ((1, 200, 2, 2, 16), True, 0),
    ((1, 200, 2, 2, 16), True, 24),
    ((2, 128, 2, 3, 32), True, 48),                # GQA with a window
    ((1, 4096, 32, 1, 64), True, 0),               # the training path
])
def test_flash_attention_bf16_route_matches_plain_on_card(
        cuda_device, shape_q, causal, window):
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd,
        flash_attention_fwd_ref)
    from repro_torch.kernels.flash_attention.ops import kernel_route
    assert kernel_route(torch.bfloat16, shape_q[4], True) == \
        "tensor cores, bf16"
    B, S, KV, G, D = shape_q
    q, k, v, do = _attention_inputs(cuda_device, shape_q, (B, S, KV, D),
                                    "bfloat16", seed=3)
    kw = dict(causal=causal, window=window)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    grads = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    out_ref, lse_ref = flash_attention_fwd_ref(q, k, v, **kw)
    grads_ref = flash_attention_bwd_ref(q, k, v, out_ref, lse_ref, do, **kw)
    for got, want in [(out, out_ref)] + list(zip(grads, grads_ref)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   **_fa_tol("bfloat16", True))
    np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape_q,window", [
    ((1, 3000, 1, 10, 256), 2048),     # MQA at 256, a window that masks
    ((4, 1024, 1, 10, 256), 2048),     # the recurrentgemma path
])
def test_flash_attention_bf16_head_dim_256_matches_plain_on_card(
        cuda_device, shape_q, window):
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_fwd_ref)
    B, S, KV, G, D = shape_q
    q, k, v, _ = _attention_inputs(cuda_device, shape_q, (B, S, KV, D),
                                   "bfloat16", seed=4)
    out, lse = flash_attention_fwd(q, k, v, window=window)
    torch.cuda.synchronize()
    out_ref, lse_ref = flash_attention_fwd_ref(q, k, v, window=window)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               out_ref.float().cpu().numpy(),
                               **_fa_tol("bfloat16", False))
    np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_backward_on_a_thread_of_its_own(cuda_device,
                                                         dtype):
    """Autograd runs the backward on a thread of its own, where no context
    may be current: the first backward of the process, there, must run."""
    import threading

    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd)
    shape_q = (1, 96, 2, 2, 64)
    q, k, v, do = _attention_inputs(cuda_device, shape_q, (1, 96, 2, 64),
                                    dtype, seed=6)
    out, lse = flash_attention_fwd(q, k, v)
    got = {}
    worker = threading.Thread(target=lambda: got.update(
        grads=flash_attention_bwd(q, k, v, out, lse, do)))
    worker.start()
    worker.join()
    torch.cuda.synchronize()
    for g, r in zip(got["grads"], flash_attention_bwd_ref(q, k, v, out, lse,
                                                          do)):
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   r.float().cpu().numpy(),
                                   **_fa_tol(dtype, True))


def test_transformer_trainer_launches_the_kernels(cuda_device):
    """Coded training of a small transformer on the card: every epoch's
    attention goes through the kernels, forward twice per layer and shard
    under ``remat="full"`` (forward, then the recompute) and backward
    once, and every decode through ``coded_reduce``."""
    import dataclasses

    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.train.e2e import TINY

    cfg = dataclasses.replace(TINY, remat="full")
    spec = scenario_spec("bursty-stragglers")
    tr = CodedTrainer(cfg, spec, "two-stage",
                      SyntheticLMDataset(spec.K, 2, 64, cfg.vocab,
                                         device=cuda_device),
                      adamw(1e-3), device=cuda_device)
    flash_attention.fwd_launches = flash_attention.bwd_launches = 0
    before = coded_reduce.launches
    logs = tr.run(2)
    K, L = spec.K, cfg.n_layers
    assert flash_attention.fwd_launches == 2 * 2 * K * L
    assert flash_attention.bwd_launches == 2 * K * L
    assert coded_reduce.launches == before + sum(lg.decode_ok for lg in logs)
    assert logs[-1].decode_ok
    for lg in logs:
        if lg.decode_ok:
            assert np.isfinite(lg.loss)
    np.testing.assert_allclose(tr.last_decoded.cpu().numpy(),
                               tr.last_full_grad.cpu().numpy(), rtol=1e-4,
                               atol=1e-5)


# --------------------------------------------------------------------- #
# the WKV recurrence: kernel vs its plain version (the sequential
# recurrence).  float32: both sum K products per step in other orders
# (the reference's kernel-test bound, 2e-4, on the output's scale);
# bfloat16 inputs: the same float32 arithmetic, so the bf16 outputs
# differ by at most one rounding step.
# --------------------------------------------------------------------- #
def _wkv_inputs(device, shape, dtype, w=None, seed=0):
    """w: None for U(0.3, 0.99), a constant, "path" for exp(-exp(U(-8,
    2))) (the range the model's decay takes) or "zeros" for U(0.3, 0.99)
    with a tenth of the entries 0 and a tenth 1e-30."""
    B, H, S, K, V = shape
    rng = np.random.default_rng(seed)

    def draw(*sh):
        return torch.from_numpy(rng.standard_normal(sh).astype(
            np.float32)).to(device, getattr(torch, dtype))
    r, k, v = draw(B, H, S, K), draw(B, H, S, K), draw(B, H, S, V)
    if w is None or w == "zeros":
        wv = rng.uniform(0.3, 0.99, (B, H, S, K))
        if w == "zeros":
            pick = rng.uniform(size=wv.shape)
            wv[pick < 0.1] = 0.0
            wv[(pick >= 0.1) & (pick < 0.2)] = 1e-30
    elif w == "path":
        wv = np.exp(-np.exp(rng.uniform(-8.0, 2.0, (B, H, S, K))))
    else:
        wv = np.full((B, H, S, K), w)
    return r, k, v, torch.from_numpy(wv.astype(np.float32)).to(device), \
        draw(H, K)


@pytest.mark.parametrize("shape,w", [
    ((1, 2, 64, 16, 16), None), ((2, 1, 128, 32, 32), None),
    ((1, 1, 96, 64, 64), None),                  # tests/test_kernels.py
    ((1, 2, 128, 64, 64), 0.36787944117144233),  # e^-1: chunked form off
    ((1, 2, 128, 64, 64), 0.000617978989331094),  # exp(-e^2)
    ((2, 3, 77, 16, 64), None),                  # ragged, K != V
    ((1, 2, 200, 64, 64), "zeros"),              # log 0 and tiny w
    ((1, 2, 300, 64, 64), 1.0),                  # w = 1: no decay
    ((1, 2, 1024, 64, 64), "path"),              # the model's decays
    ((1, 2, 1023, 16, 64), None),                # ragged chunk, K != V
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv_kernel_matches_plain_on_card(cuda_device, shape, w, dtype):
    from repro_torch.kernels.rwkv6_wkv import wkv, wkv_ref
    args = _wkv_inputs(cuda_device, shape, dtype, w)
    before = wkv.launches
    out, s_last = wkv(*args, chunk=64)
    torch.cuda.synchronize()
    assert wkv.launches == before + 1
    out_ref, s_ref = wkv_ref(*args)
    assert out.dtype == args[0].dtype and s_last.dtype == torch.float32
    scale = max(1.0, float(out_ref.float().abs().max()))
    tol = (dict(rtol=1e-2, atol=1e-2) if dtype == "bfloat16"
           else dict(rtol=2e-4, atol=2e-4 * scale))
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               out_ref.float().cpu().numpy(), **tol)
    np.testing.assert_allclose(s_last.cpu().numpy(), s_ref.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)


def test_wkv_kernel_refuses_what_needs_a_gradient(cuda_device):
    from repro_torch.kernels.rwkv6_wkv import wkv
    r, k, v, w, u = _wkv_inputs(cuda_device, (1, 1, 8, 16, 16), "float32")
    before = wkv.launches
    with pytest.raises(NotImplementedError, match="forward-only"):
        wkv(r.requires_grad_(True), k, v, w, u)
    with pytest.raises(ValueError, match="K and V"):
        wkv(*_wkv_inputs(cuda_device, (1, 1, 8, 8, 8), "float32"))
    assert wkv.launches == before


def test_rwkv_model_on_card_matches_cpu_and_counts_launches(cuda_device):
    """REDUCED rwkv6 in float32: prefill and two decode steps on the card
    (the WKV kernel, one launch per layer and prefill) against the CPU
    (the plain recurrence)."""
    import dataclasses

    from repro_torch.configs.rwkv6_1_6b import REDUCED
    from repro_torch.kernels.rwkv6_wkv import wkv
    from repro_torch.models.transformer import (decode_step, init_params,
                                                prefill)
    cfg = dataclasses.replace(REDUCED, compute_dtype="float32")
    from repro_torch.optim.optimizers import tree_map
    p_cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    p_gpu = tree_map(lambda t: t.to(cuda_device), p_cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 70)))
    out = []
    for p, dev in ((p_gpu, cuda_device), (p_cpu, "cpu")):
        before = wkv.launches
        last, caches, pos = prefill(p, {"tokens": toks[:, :68].to(dev)},
                                    cfg)
        assert wkv.launches == before + (cfg.n_layers if dev != "cpu"
                                         else 0)
        steps = [last]
        for i in range(2):
            lg, caches = decode_step(p, toks[:, 68 + i:69 + i].to(dev),
                                     caches, pos + i, cfg)
            steps.append(lg)
        out.append(torch.stack(steps).cpu().numpy())
    np.testing.assert_allclose(out[0], out[1], rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------- #
# the RG-LRU scan: kernel vs its plain version (the sequential
# recurrence).  Both multiply, then add, in float32, step by step, so
# they agree bit for bit (the copy ring where rows are 16-byte aligned,
# the rows kernel elsewhere); the bound stated is the reference's
# kernel-test one (float32 2e-5 on the output's scale, bfloat16 2e-2).
# --------------------------------------------------------------------- #
def _scan_inputs(device, shape, dtype, a_lo=0.5, a_hi=0.999, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(a_lo, a_hi, shape).astype(np.float32)
    b = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return (torch.from_numpy(a).to(device, getattr(torch, dtype)),
            torch.from_numpy(b).to(device, getattr(torch, dtype)))


@pytest.mark.parametrize("shape,a_lo,a_hi", [
    ((2, 128, 64), 0.5, 0.999), ((1, 256, 128), 0.5, 0.999),
    ((3, 64, 256), 0.5, 0.999),                  # tests/test_kernels.py
    ((2, 1000, 250), 0.5, 0.999),                # ragged S and D
    ((1, 4096, 96), 0.9999, 1.0),                # a -> 1: |h| grows
    ((3, 1, 64), 0.5, 0.999),                    # S = 1
    ((2, 50, 1), 0.5, 0.999),                    # D = 1
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_kernel_matches_plain_on_card(cuda_device, shape, a_lo, a_hi,
                                            dtype):
    from repro_torch.kernels.rglru_scan import rglru_ref, rglru_scan
    a, b = _scan_inputs(cuda_device, shape, dtype, a_lo, a_hi)
    before = rglru_scan.launches
    out, h_last = rglru_scan(a, b)
    torch.cuda.synchronize()
    assert rglru_scan.launches == before + 1
    out_ref, h_ref = rglru_ref(a, b)
    assert out.dtype == a.dtype and h_last.dtype == torch.float32
    scale = max(1.0, float(out_ref.float().abs().max()))
    tol = (dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16"
           else dict(rtol=2e-5, atol=2e-5 * scale))
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               out_ref.float().cpu().numpy(), **tol)
    np.testing.assert_allclose(h_last.cpu().numpy(), h_ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * scale)


def test_rglru_kernel_refuses_what_needs_a_gradient(cuda_device):
    from repro_torch.kernels.rglru_scan import rglru_scan
    a, b = _scan_inputs(cuda_device, (1, 8, 16), "float32")
    before = rglru_scan.launches
    with pytest.raises(NotImplementedError, match="forward-only"):
        rglru_scan(a.requires_grad_(True), b)
    with pytest.raises(ValueError, match="contiguous"):
        rglru_scan(a.detach().transpose(1, 2), b.transpose(1, 2))
    assert rglru_scan.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_head_dim_256_matches_plain_on_card(cuda_device,
                                                            dtype):
    """recurrentgemma-2b's local layers: MQA (G = 10) at head width 256,
    causal, a window shorter than the sequence and a ragged last tile."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_fwd, flash_attention_fwd_ref)
    q, k, v, _ = _attention_inputs(cuda_device, (1, 300, 1, 10, 256),
                                   (1, 300, 1, 256), dtype)
    kw = dict(causal=True, window=100, q_chunk=64, kv_chunk=64)
    before = (flash_attention.fwd_launches,
              flash_attention.fwd_windowed_launches)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (flash_attention.fwd_launches,
            flash_attention.fwd_windowed_launches) == (before[0] + 1,
                                                       before[1] + 1)
    out_ref, lse_ref = flash_attention_fwd_ref(q, k, v, **kw)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               out_ref.float().cpu().numpy(),
                               **_fa_tol(dtype, False))
    np.testing.assert_allclose(lse.cpu().numpy(), lse_ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


def test_flash_attention_backward_refuses_head_dim_256(cuda_device):
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_fwd)
    q, k, v, do = _attention_inputs(cuda_device, (1, 64, 1, 2, 256),
                                    (1, 64, 1, 256), "float32")
    out, lse = flash_attention_fwd(q, k, v)
    before = flash_attention.bwd_launches
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_attention_bwd(q, k, v, out, lse, do)
    assert flash_attention.bwd_launches == before


def test_recurrentgemma_model_on_card_matches_cpu_and_counts_launches(
        cuda_device):
    """REDUCED recurrentgemma in float32: prefill past the window and two
    decode steps on the card (the RG-LRU kernel once per rec layer and the
    attention forward once per local layer, each prefill) against the CPU
    (the plain versions)."""
    import dataclasses

    from repro_torch.configs.recurrentgemma_2b import REDUCED
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.models.transformer import (decode_step, init_params,
                                                pad_cache, prefill)
    from repro_torch.optim.optimizers import tree_map
    cfg = dataclasses.replace(REDUCED, compute_dtype="float32")
    kinds = [m for m, _ in cfg.layer_kinds()]
    p_cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    p_gpu = tree_map(lambda t: t.to(cuda_device), p_cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 70)))
    out = []
    for p, dev in ((p_gpu, cuda_device), (p_cpu, "cpu")):
        before = (rglru_scan.launches, flash_attention.fwd_launches)
        last, caches, pos = prefill(p, {"tokens": toks[:, :68].to(dev)},
                                    cfg)
        on_card = dev != "cpu"
        assert (rglru_scan.launches, flash_attention.fwd_launches) == (
            before[0] + on_card * kinds.count("rec"),
            before[1] + on_card * kinds.count("local"))
        caches = pad_cache(caches, cfg, extra=2)
        steps = [last]
        for i in range(2):
            lg, caches = decode_step(p, toks[:, 68 + i:69 + i].to(dev),
                                     caches, pos + i, cfg)
            steps.append(lg)
        out.append(torch.stack(steps).cpu().numpy())
    np.testing.assert_allclose(out[0], out[1], rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------- #
# the paper's experiment and the LM training loop
# --------------------------------------------------------------------- #
FEL_HOST_FIELDS = ("epoch", "time", "utilization", "n_stragglers",
                   "redundancy", "efficiency", "compute_time", "comm_time",
                   "decode_ok")


@pytest.mark.parametrize("backend", ["instant", "cluster"])
@pytest.mark.parametrize("scheme", ["two-stage", "cyclic", "fractional",
                                    "uncoded"])
def test_fel_trainer_on_card_matches_cpu(cuda_device, scheme, backend):
    from repro_torch.core.fel import FELTrainer
    from repro_torch.models.mlp import per_slot_mlp_loss
    from repro_torch.optim.optimizers import sgd_momentum

    params = init_mlp(torch.Generator().manual_seed(0), (32, 32, 4),
                      device="cpu")
    kw = (dict(cluster=scenario_spec("bursty-stragglers"))
          if backend == "cluster" else
          dict(M1=4, s=1, rates=np.array([2.0, 2.0, 4.0, 4.0, 8.0, 8.0]),
               noise_scale=0.3, fault_prob=0.1, straggler_prob=0.2))
    runs = {}
    for device in ("cpu", cuda_device):
        data = SyntheticClassificationDataset(6, 16, 32, 4, seed=7,
                                              device="cpu")
        tr = FELTrainer(scheme, 6, 6, data, per_slot_mlp_loss,
                        sgd_momentum(0.05), params, seed=3, device=device,
                        **kw)
        runs[str(device)] = (tr.run(3), tr)
    (logs_c, cpu), (logs_g, card) = runs["cpu"], runs[str(cuda_device)]
    assert all(p.device.type == "cuda" for p in tree_leaves(card.params))
    for lc, lg in zip(logs_c, logs_g):
        assert tuple(getattr(lc, f) for f in FEL_HOST_FIELDS) == \
            tuple(getattr(lg, f) for f in FEL_HOST_FIELDS)
        np.testing.assert_allclose(lg.loss, lc.loss, rtol=1e-5)
    for a, b in zip(tree_leaves(cpu.params), tree_leaves(card.params)):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_lm_train_coded_step_on_card_matches_cpu(cuda_device):
    """One coded step of ``launch.train.train`` at TINY (bf16 compute):
    equal host outcomes, losses within bf16's unit roundoff, and the
    attention kernels launched twice a layer forward (remat) and once
    backward."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.train import TINY, train
    from repro_torch.models.transformer import init_params

    params = init_params(TINY, torch.Generator().manual_seed(0),
                         device="cpu")
    kw = dict(steps=1, batch=2, seq=32, coded=True, params=params,
              log=lambda msg: None)
    cpu = train(TINY, device="cpu", **kw)
    before = (flash_attention.fwd_launches, flash_attention.bwd_launches)
    card = train(TINY, device=cuda_device, **kw)
    torch.cuda.synchronize()
    assert (flash_attention.fwd_launches - before[0],
            flash_attention.bwd_launches - before[1]) == \
        (2 * TINY.n_layers, TINY.n_layers)
    for key in ("n_slots", "sim_time", "decode_ok", "n_stragglers"):
        assert card[key] == cpu[key], key
    np.testing.assert_allclose(card["loss"], cpu["loss"], rtol=2.0 ** -9)
    for p in tree_leaves(card["params"]):
        assert p.device.type == "cuda" and bool(torch.isfinite(p).all())


def _epoch_fields(r):
    c = r.comm
    return (r.time, r.compute_time, r.comm_time, r.decode_ok,
            r.n_stragglers, r.stage2_triggered, c.n_slots, c.idle_slots,
            c.min_energy, c.max_overdraft, c.arrived.tobytes(),
            c.bytes_admitted.tobytes(), c.bytes_transmitted.tobytes(),
            c.queue_residual.tobytes(), c.final_energy.tobytes())


@pytest.mark.parametrize("scenario", ["fading-uplink", "saturated-uplink"])
def test_batched_fleet_on_card_equals_the_oracle(cuda_device, scenario):
    """64 lanes of the batched engine on the card equal the card's oracle
    on lanes 0 and 1 and the CPU's batched engine on every lane, bit for
    bit (the scheduler's reductions do not depend on shape or device)."""
    from repro_torch.sim import BatchedFleet, build_cluster
    from repro_torch.sim.spec import fleet_seeds

    spec = scenario_spec(scenario)
    seeds = fleet_seeds(64, 0)
    card = BatchedFleet(spec, "two-stage", seeds,
                        device=cuda_device).run(2)
    cpu = BatchedFleet(spec, "two-stage", seeds, device="cpu").run(2)
    for e in range(2):
        assert [_epoch_fields(r) for r in card[e]] == \
            [_epoch_fields(r) for r in cpu[e]]
    for i in (0, 1):
        oracle = build_cluster(spec, "two-stage", seeds[i],
                               device=cuda_device)
        for e in range(2):
            assert _epoch_fields(oracle.run_epoch(e)) == \
                _epoch_fields(card[e][i])


def test_scheduler_batched_call_on_card_equals_per_lane_calls(cuda_device):
    from repro_torch.core.lyapunov import (Observation, QueueState,
                                           SystemParams, schedule_slot)

    rng = np.random.default_rng(0)
    S, M = 64, 6

    def rows(lo, hi, zeros=0.3):
        x = rng.uniform(lo, hi, (S, M)) * (rng.random((S, M)) > zeros)
        return torch.tensor(x, dtype=torch.float32, device=cuda_device)

    def lane_scalars(choices):
        return torch.tensor(rng.choice(choices, S), dtype=torch.float32,
                            device=cuda_device)

    state = QueueState(Q=rows(0, 4), H=rows(0, 8), E=rows(0, 10, 0.1),
                       R=rows(0, 200), R_server=lane_scalars([0.0, 3.7]))
    params = SystemParams(
        T=lane_scalars([0.1, 0.3]), p=rows(0.2, 4, 0), delta=rows(
            1e-4, 0.05, 0), xi=rows(0, 0.5, 0.2), f_max=rows(1, 100, 0),
        F=lane_scalars([1.0, 100.0]),
        E_cap=torch.full((S, M), 10.0, device=cuda_device),
        V=lane_scalars([5.0, 50.0]), lam=torch.ones(S, M,
                                                   device=cuda_device))
    obs = Observation(D=rows(0, 3, 0.6), r=rows(0.25, 10, 0),
                      E_H=rows(0, 1, 0), L=lane_scalars([1.0, 1.7, 3.0]),
                      new_cycles=rows(0, 50, 0.7))
    s_b, d_b = schedule_slot(state, params, obs)
    for i in range(S):
        def lane(t):
            return type(t)(*(x[i] for x in t))
        s_i, d_i = schedule_slot(lane(state), SystemParams(
            **{k: getattr(params, k)[i] for k in params.__dataclass_fields__}),
            lane(obs))
        for a, b in zip(list(s_b) + list(d_b), list(s_i) + list(d_i)):
            assert torch.equal(a[i].view(torch.int32), b.view(torch.int32))
