"""The port's mixture-of-experts FFN against the JAX package's, on the CPU.

Tolerances:

* Dispatch, given the same float32 router logits: ``slot_token`` and
  ``slot_valid`` equal, every slot (empty ones point at the same clipped
  token); ``slot_weight`` and ``aux`` within rtol 1e-6 (the two softmaxes
  round their exponentials differently, by up to 2 float32 ulps).
* ``moe_ffn`` in float32: rtol 1e-5, atol 1e-6 (the products sum in
  another order).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import repro.models.moe as ref_moe

import repro_torch.models.moe as port_moe

W_RTOL = 1e-6
FFN_TOL = dict(rtol=1e-5, atol=1e-6)


def _logits(seed, Sh, T, E, ties):
    rng = np.random.default_rng(seed)
    lg = rng.standard_normal((Sh, T, E)).astype(np.float32)
    if ties:
        lg[:, ::3, 1] = lg[:, ::3, 2]         # pairs of equal experts
        lg[:, ::5] = 0.0                      # every expert equal
        lg[:, 1::7, :4] = lg[:, 1::7, 4:5]    # four equal to a fifth
    return lg


def _plans(lg, k, C):
    return (ref_moe.moe_dispatch_indices(jnp.asarray(lg), k, C),
            port_moe.moe_dispatch_indices(torch.from_numpy(lg), k, C))


@pytest.mark.parametrize("Sh,T,E,k,C,ties", [
    (1, 64, 8, 2, 32, False),        # no overflow
    (1, 64, 8, 2, 8, False),         # overflow: small capacity
    (1, 60, 8, 2, 16, True),         # forced ties
    (2, 40, 5, 3, 8, True),          # two shards, ties and overflow
    (2, 32, 8, 1, 8, False),         # top-1, two shards
    (1, 50, 40, 8, 16, True),        # granite's E and k
])
def test_dispatch_matches_reference(Sh, T, E, k, C, ties):
    lg = _logits(T + E, Sh, T, E, ties)
    r, p = _plans(lg, k, C)
    np.testing.assert_array_equal(p.slot_token.numpy(),
                                  np.asarray(r.slot_token))
    np.testing.assert_array_equal(p.slot_valid.numpy(),
                                  np.asarray(r.slot_valid))
    np.testing.assert_allclose(p.slot_weight.numpy(),
                               np.asarray(r.slot_weight), rtol=W_RTOL)
    np.testing.assert_allclose(float(p.aux_loss), float(r.aux_loss),
                               rtol=W_RTOL)


def test_top_k_takes_the_lower_expert_among_ties():
    lg = np.zeros((1, 3, 6), np.float32)
    lg[0, 1, [1, 4]] = 1.0
    lg[0, 2, [0, 2, 5]] = 2.0
    p = port_moe.moe_dispatch_indices(torch.from_numpy(lg), 2, 8)
    # ascending expert order of each token's two choices
    chosen = (p.token_slot[0] // 8).tolist()
    assert chosen == [[0, 1], [1, 4], [0, 2]]
    r = ref_moe.moe_dispatch_indices(jnp.asarray(lg), 2, 8)
    np.testing.assert_array_equal(p.slot_token.numpy(),
                                  np.asarray(r.slot_token))


@pytest.mark.parametrize("C", [8, 16, 64])
def test_token_slot_inverts_the_slots(C):
    """Each (token, choice) kept points at the slot that holds it, in
    ascending expert order; the dropped ones are -1, and as many as the
    slots past capacity."""
    Sh, T, E, k = 2, 48, 6, 2
    lg = _logits(C, Sh, T, E, True)
    p = port_moe.moe_dispatch_indices(torch.from_numpy(lg), k, C)
    tok, valid = p.slot_token.reshape(Sh, -1), p.slot_valid.reshape(Sh, -1)
    for s in range(Sh):
        kept = p.token_slot[s]
        assert int((kept >= 0).sum()) == int(valid[s].sum())
        for t in range(T):
            slots = [int(x) for x in kept[t] if x >= 0]
            assert slots == sorted(slots)
            for x in slots:
                assert bool(valid[s, x]) and int(tok[s, x]) == t
    counts = np.stack([np.bincount(
        np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(lg[s])), k)[1])
        .reshape(-1), minlength=E) for s in range(Sh)])
    dropped = np.maximum(counts - C, 0).sum()
    assert int((p.token_slot < 0).sum()) == dropped


def _ffn_params(seed, d, f, E, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"router": rng.standard_normal((d, E)).astype(dtype),
            "wg": (rng.standard_normal((E, d, f)) * 0.1).astype(dtype),
            "wu": (rng.standard_normal((E, d, f)) * 0.1).astype(dtype),
            "wd": (rng.standard_normal((E, f, d)) * 0.1).astype(dtype)}


@pytest.mark.parametrize("cf,shards,k,act", [
    (1.0, 1, 2, "silu"), (1.0, 2, 2, "silu"), (0.5, 2, 2, "gelu"),
    (0.25, 1, 1, "silu"), (16.0, 1, 3, "gelu")])
def test_moe_ffn_matches_reference(cf, shards, k, act):
    B, S, d, f, E = 2, 16, 16, 32, 4
    x = np.random.default_rng(1).standard_normal((B, S, d)).astype(
        np.float32)
    p = _ffn_params(2, d, f, E)
    ref_act = {"silu": jax.nn.silu, "gelu": jax.nn.gelu}[act]
    port_act = {"silu": F.silu,
                "gelu": lambda t: F.gelu(t, approximate="tanh")}[act]
    o_r, a_r = ref_moe.moe_ffn(jnp.asarray(x),
                               {n: jnp.asarray(v) for n, v in p.items()},
                               top_k=k, capacity_factor=cf, act=ref_act,
                               dp_shards=shards)
    o_p, a_p = port_moe.moe_ffn(torch.from_numpy(x),
                                {n: torch.from_numpy(v)
                                 for n, v in p.items()},
                                top_k=k, capacity_factor=cf, act=port_act,
                                dp_shards=shards)
    np.testing.assert_allclose(o_p.numpy(), np.asarray(o_r), **FFN_TOL)
    np.testing.assert_allclose(float(a_p), float(a_r), rtol=W_RTOL)


def test_moe_ffn_gradients_match_reference():
    B, S, d, f, E, k = 2, 8, 16, 24, 4, 2
    x = np.random.default_rng(3).standard_normal((B, S, d)).astype(
        np.float32)
    p = _ffn_params(4, d, f, E)

    def ref_loss(x, p):
        out, aux = ref_moe.moe_ffn(x, p, top_k=k, capacity_factor=1.0,
                                   act=jax.nn.silu, dp_shards=1)
        return jnp.sum(out * out) + aux
    g_x, g_p = jax.grad(ref_loss, argnums=(0, 1))(
        jnp.asarray(x), {n: jnp.asarray(v) for n, v in p.items()})
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = {n: torch.from_numpy(v).requires_grad_(True) for n, v in p.items()}
    out, aux = port_moe.moe_ffn(tx, tp, top_k=k, capacity_factor=1.0,
                                act=F.silu, dp_shards=1)
    (torch.sum(out * out) + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(g_x), rtol=1e-4,
                               atol=1e-5)
    for n in p:
        np.testing.assert_allclose(tp[n].grad.numpy(), np.asarray(g_p[n]),
                                   rtol=1e-4, atol=1e-5, err_msg=n)


def test_moe_ffn_no_drop_equals_dense_mixture():
    """The reference's ``test_moe_ffn_no_drop_equals_dense_mixture`` on
    the port: with room for every token, the output is each token's
    explicit top-k mixture of every expert's output."""
    rng = np.random.default_rng(3)
    B, S, d, f, E, k = 2, 8, 16, 32, 4, 2
    x = torch.from_numpy(rng.standard_normal((B, S, d)).astype(np.float32))
    p = {n: torch.from_numpy(v) for n, v in _ffn_params(5, d, f, E).items()}
    out, aux = port_moe.moe_ffn(x, p, top_k=k, capacity_factor=float(E * 4),
                                act=F.silu)
    probs = torch.softmax(x @ p["router"], dim=-1)
    top_p, top_e = torch.topk(probs, k)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    y_all = torch.einsum("bsef,efd->bsed",
                         F.silu(torch.einsum("bsd,edf->bsef", x, p["wg"]))
                         * torch.einsum("bsd,edf->bsef", x, p["wu"]),
                         p["wd"])
    want = torch.zeros_like(x)
    for i in range(k):
        sel = torch.gather(y_all, 2, top_e[..., i, None, None].expand(
            -1, -1, 1, d))[..., 0, :]
        want = want + top_p[..., i, None] * sel
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert float(aux) > 0


def test_expert_blocks_and_stored_weights_change_nothing(monkeypatch):
    """bfloat16 activations over float32 expert stacks: casting the
    stacks a block of experts at a time gives the output of casting them
    whole, bit for bit."""
    B, S, d, f, E, k = 2, 16, 16, 32, 6, 2
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, S, d)).astype(np.float32)).to(torch.bfloat16)
    p32 = {n: torch.from_numpy(v) for n, v in _ffn_params(7, d, f, E).items()}
    pbf = {n: v.to(torch.bfloat16) for n, v in p32.items()}
    whole, aux_w = port_moe.moe_ffn(x, pbf, top_k=k, capacity_factor=1.0,
                                    act=F.silu)
    monkeypatch.setattr(port_moe, "_CAST_BLOCK_BYTES", 3 * d * f * 2 * 4)
    blocks, aux_b = port_moe.moe_ffn(
        x, dict(p32, router=pbf["router"]), top_k=k, capacity_factor=1.0,
        act=F.silu)
    assert blocks.dtype == torch.bfloat16
    assert torch.equal(whole, blocks) and torch.equal(aux_w, aux_b)


def test_moe_ffn_is_deterministic_and_checks_its_shards():
    B, S, d, f, E = 3, 5, 8, 16, 4
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (B, S, d)).astype(np.float32))
    p = {n: torch.from_numpy(v) for n, v in _ffn_params(9, d, f, E).items()}
    a = port_moe.moe_ffn(x, p, top_k=2, capacity_factor=1.0, act=F.silu)
    b = port_moe.moe_ffn(x, p, top_k=2, capacity_factor=1.0, act=F.silu)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="shards"):
        port_moe.moe_ffn(x, p, top_k=2, capacity_factor=1.0, act=F.silu,
                         dp_shards=2)


@pytest.mark.parametrize("T,k,E,cf", [(4096, 8, 40, 1.0), (8, 8, 40, 1.0),
                                      (2048, 1, 128, 1.25), (64, 2, 8, 8.0)])
def test_capacity_is_the_reference_s(T, k, E, cf):
    want = max(int(T * k / E * cf), 8)
    want = ((want + 7) // 8) * 8
    assert port_moe.moe_capacity(T, k, E, cf) == want
    assert port_moe.moe_capacity(4096, 8, 40, 1.0) == 824
