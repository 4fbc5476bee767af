"""Serving loop: batched prefill + greedy decode with Lyapunov request
admission.

The torch counterpart of ``repro.launch.serve``.  The paper's
transmission-phase scheduler (§4.3) applied to inference: each client m has
a request queue Q_m; per slot the drift-plus-penalty decisions (P4/P5/P7)
admit requests and allocate decode-batch slots, maximizing
Σ log(1+λ·throughput) — proportional fairness across clients — instead of
letting one hot client starve the rest.

The loop is :func:`serve`; :func:`main` is the reference's command line
(its flags and defaults, reduced configs, seed 0) plus ``--device``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tiny --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core.lyapunov import (Observation, init_queues, jain_index,
                                       make_system_params, schedule_slot)
from repro_torch.launch.train import TINY
from repro_torch.models.transformer import (decode_step, init_params,
                                            pad_cache, prefill)

__all__ = ["TINY", "main", "serve"]


def _generate(params, tokens, cfg: ModelConfig, gen_len: int, sync):
    """Prefill ``tokens`` (B, S), then ``gen_len`` greedy decode steps.
    Returns ``(generated (B, gen_len), prefill ms, decode ms)``."""
    t0 = time.perf_counter()
    last, caches, pos = prefill(params, {"tokens": tokens}, cfg)
    caches = pad_cache(caches, cfg, extra=gen_len)
    sync()
    t1 = time.perf_counter()
    tok = last.argmax(-1)[:, None]
    outs = []
    for i in range(gen_len):
        logits, caches = decode_step(params, tok, caches, pos + i, cfg)
        tok = logits.argmax(-1)[:, None]
        outs.append(tok)
    gen = torch.cat(outs, dim=1)
    sync()
    t2 = time.perf_counter()
    return gen, (t1 - t0) * 1e3, (t2 - t1) * 1e3


def serve(cfg: ModelConfig, params, *, clients: int = 6, slots: int = 40,
          prompt_len: int = 32, gen_len: int = 8, batch: int = 4,
          V: float = 30.0, seed: int = 0, device="cuda") -> dict:
    """Run the admission loop for ``slots`` slots.

    Each slot, client 0 floods (Poisson 6 requests) and the others trickle
    (Poisson 1); ``schedule_slot`` admits requests and decides how many of
    each client's are served; up to ``batch`` of them run as one batched
    prefill of ``prompt_len`` random tokens and ``gen_len`` greedy decode
    steps.  The numpy draws are the reference's, in its order, from
    ``seed``.

    Returns a dict: ``served`` (clients,) and ``jain`` at the end;
    ``admitted`` and ``scheduled`` (slots, clients), ``served_by_slot``
    (slots, clients) and ``max_Q`` (slots,) per slot; ``prefills`` (the
    number of batches run); and host times in ms, synchronised with the
    card: ``schedule_ms`` per slot, ``prefill_ms`` and ``decode_ms`` per
    batch.
    """
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    Mc = clients
    rng = np.random.default_rng(seed)
    sys_params = make_system_params(Mc, T=1.0, p=0.1, delta=1e-4, xi=0.01,
                                    f_max=100.0, F=500.0, E_cap=50.0, V=V,
                                    device=device)
    q_state = init_queues(Mc, E0=25.0, device=device)
    L = torch.tensor(1.0, device=device)
    r = torch.full((Mc,), float(batch), device=device)
    no_cycles = torch.zeros((Mc,), device=device)

    served = np.zeros(Mc)
    out = {k: [] for k in ("admitted", "scheduled", "served_by_slot",
                           "max_Q", "schedule_ms", "prefill_ms",
                           "decode_ms")}
    for _ in range(slots):
        t0 = time.perf_counter()
        # hot client 0 floods; others trickle (fairness stressor)
        arrivals = rng.poisson([6.0] + [1.0] * (Mc - 1)).astype(np.float32)
        e_h = rng.uniform(1, 3, Mc).astype(np.float32)
        obs = Observation(D=torch.from_numpy(arrivals).to(device), r=r,
                          E_H=torch.from_numpy(e_h).to(device), L=L,
                          new_cycles=no_cycles)
        q_state, dec = schedule_slot(q_state, sys_params, obs)
        # transmitted data c_m = requests actually scheduled this slot
        d, c, max_q = (t.cpu().numpy() for t in (dec.d, dec.c,
                                                 q_state.Q.max()))
        n_serve = np.round(c).astype(int)
        out["schedule_ms"].append((time.perf_counter() - t0) * 1e3)
        total = int(n_serve.sum())
        if total > 0:
            n_run = min(total, batch)
            toks = torch.from_numpy(
                rng.integers(0, cfg.vocab, (n_run, prompt_len))).to(device)
            _, t_pre, t_dec = _generate(params, toks, cfg, gen_len, sync)
            out["prefill_ms"].append(t_pre)
            out["decode_ms"].append(t_dec)
            served += n_serve * (n_run / max(total, 1))
        out["admitted"].append(d)
        out["scheduled"].append(n_serve)
        out["served_by_slot"].append(served.copy())
        out["max_Q"].append(float(max_q))
    for k in ("admitted", "scheduled", "served_by_slot", "max_Q"):
        out[k] = np.asarray(out[k])
    out.update(served=served, jain=jain_index(served),
               prefills=len(out["prefill_ms"]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny")
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--slots", type=int, default=40)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4,
                    help="decode batch slots per scheduler slot")
    ap.add_argument("--V", type=float, default=30.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = TINY if args.arch == "tiny" else get_config(args.arch,
                                                      reduced=True)
    device = torch.device(args.device)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    t0 = time.time()
    res = serve(cfg, params, clients=args.clients, slots=args.slots,
                prompt_len=args.prompt_len, gen_len=args.gen_len,
                batch=args.batch, V=args.V, seed=0, device=device)
    for slot in range(0, args.slots, 10):
        served = res["served_by_slot"][slot]
        print(f"slot {slot:3d} admitted={res['admitted'][slot].sum():.1f} "
              f"served={served.sum():.1f} "
              f"jain={jain_index(served + 1e-9):.3f} "
              f"maxQ={res['max_Q'][slot]:.1f}")
    print(f"\nclients served: {np.round(res['served'], 1)}")
    print(f"Jain fairness index: {res['jain']:.3f} "
          f"({args.slots} slots, {time.time() - t0:.1f}s)")
    return res


if __name__ == "__main__":
    main()
