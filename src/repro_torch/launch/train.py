"""End-to-end training loop.

The torch counterpart of ``repro.launch.train``: synthetic partitioned
data → (optionally) the two-stage coded gradient runtime → the train step
→ checkpointing and resume.  The loop is :func:`train`; :func:`main` is the
reference's command line (its flags and defaults) plus ``--device``:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --coded --steps 5 \\
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --preset 100m \\
      --steps 300 --ckpt-dir /tmp/ck

The coded path runs ``TwoStageRuntime`` over ``workers`` simulated
heterogeneous workers and K = 2·workers partitions; each step trains on the
epoch's slot batch through ``make_coded_train_step``, whose one backward
over the weighted per-slot losses is the decoded full gradient.  The plain
path is data-parallel SGD with AdamW and ``clip_norm`` 1.0.  Both steps
are in place (``inplace=True``: AdamW's ``update_``), which frees each
gradient leaf once applied: a functional update would hold old and new
parameters and moments together, 12 more bytes a parameter.

Every token-decoder family trains, the MoE configs too.  As in the
reference, the coded per-slot loss is the cross-entropy alone (its
``per_slot_lm_loss`` drops the MoE balance loss ``aux``) and the plain
loss is ``transformer.loss_fn``, CE + 0.01·aux.  A coded aux could not
decode to the full batch's: the slot batch holds redundant partitions
twice and unused slots as zero tokens.  For the same reason an MoE layer's
capacity, which counts the tokens of one forward, drops other tokens in
the slot batch than in the K partitions, so the decoded gradient equals
the full-batch one only where nothing is dropped.

A checkpoint saved as step n holds the state after step n; a resumed run
continues at step n + 1, replaying the runtime's host draws of steps 0..n
first, so a resumed run takes the steps an unbroken one takes.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core.coded_step import (make_coded_train_step,
                                         make_train_step, slot_batch)
from repro_torch.core.runtime import TwoStageRuntime
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import adamw, tree_leaves, tree_map

__all__ = ["TINY", "PRESET_100M", "per_slot_lm_loss", "train", "main"]

TINY = ModelConfig(name="tiny", family="dense", n_layers=2, d_model=128,
                   n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
                   vocab=512)
PRESET_100M = ModelConfig(name="preset-100m", family="dense", n_layers=12,
                          d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
                          d_ff=3072, vocab=16384)

#: tokens a chunk of the per-slot cross-entropy: its float32 logits, at
#: stablelm-1.6b's 100,352 words, take 1.6 GB
CE_CHUNK = 4096


def _config(args) -> ModelConfig:
    if args.preset == "100m":
        return PRESET_100M
    if args.arch == "tiny":
        return TINY
    return get_config(args.arch, reduced=args.reduced)


def _token_ce(x, head, labels, w, dt):
    """``w ⊙ CE`` of each token: x (n, d), labels (n,), w (n,); the head
    is cast to ``dt`` here, so that its gradient sums the chunks in the
    head's own type (float32), not in ``dt``."""
    logits = (x.to(dt) @ head.to(dt)).float()
    ll = torch.gather(logits, -1, labels[:, None].long())[:, 0]
    return (torch.logsumexp(logits, dim=-1) - ll) * w


def per_slot_lm_loss(cfg: ModelConfig, chunk: int = CE_CHUNK):
    """``(params, slot_batch) -> (M, n_slots)`` mean next-token CE per slot.

    ``slot_batch`` holds ``tokens``, ``labels`` and ``weights``, each
    ``(M, n_slots, b, S)``.  A row's CE is its weighted mean, a slot's the
    mean of its b rows (zero for an unused slot, whose weights are zero).
    The logits never exist whole: each ``chunk`` of tokens is projected,
    reduced and recomputed in the backward.  The reference projects all
    tokens in one product, whose head gradient is rounded to the compute
    type once; here each chunk's is, and the chunks sum in the head's own
    type (float32 weights: float32), not in the compute type.
    """
    dt = tfm._dtype(cfg.compute_dtype)

    def fn(params, batch):
        toks = batch["tokens"]
        M_, K_, b, S = toks.shape
        x, _ = tfm.forward(params, {"tokens": toks.reshape(-1, S)}, cfg)
        x = x.reshape(-1, x.shape[-1])
        labels = batch["labels"].reshape(-1)
        w = batch["weights"].reshape(-1).float()
        head = tfm._lm_head(params, cfg)
        ce = torch.cat([
            checkpoint(_token_ce, x[i:i + chunk], head, labels[i:i + chunk],
                       w[i:i + chunk], dt, use_reentrant=False)
            for i in range(0, x.shape[0], chunk)]).reshape(-1, S)
        ce = ce.sum(-1) / torch.clamp(w.reshape(-1, S).sum(-1), min=1e-9)
        return ce.reshape(M_, K_, b).mean(-1)
    return fn


def train(cfg: ModelConfig, *, steps: int = 50, batch: int = 8,
          seq: int = 128, lr: float = 3e-4, coded: bool = False,
          workers: int = 6, straggler_prob: float = 0.2,
          ckpt_dir=None, ckpt_every: int = 25, log_every: int = 10,
          params=None, device="cuda", log=print) -> dict:
    """Train ``cfg`` for ``steps`` steps (the reference's loop).

    ``params`` (copied to ``device``: the steps write in place, never
    into the caller's tensors) default to :func:`transformer.init_params`
    from seed 0 on ``device``.  Returns a dict: ``params`` and
    ``opt_state`` at the end, ``start_step``, and per step run ``step``,
    ``loss`` and the host clock,
    synchronised with the card, in ms: ``plan_ms`` (the runtime's epoch),
    ``data_ms`` (drawing, stacking and copying the batch) and ``step_ms``
    (the train step).  The coded path adds ``sim_time``, ``n_slots``,
    ``decode_ok`` and ``n_stragglers``; the plain path ``grad_norm``.
    """
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    if cfg.family in ("vlm", "audio"):
        raise SystemExit("train driver covers LM families; use the smoke "
                         "tests for frontend-stub archs")
    opt = adamw(lr=lr, state_dtype=getattr(torch, cfg.opt_state_dtype))
    if params is None:
        params = tfm.init_params(
            cfg, torch.Generator(device=device).manual_seed(0),
            device=device)
    else:                                  # the steps write in place
        params = tree_map(lambda p: p.to(device, copy=True), params)
    n_params = sum(p.numel() for p in tree_leaves(params))
    log(f"arch={cfg.name} params={n_params / 1e6:.1f}M coded={coded} "
        f"steps={steps}")
    ck = Checkpointer(ckpt_dir) if ckpt_dir else None
    opt_state = opt.init(params)
    start = 0
    if ck and ck.latest_step() is not None:
        last, t = ck.restore({"params": params, "opt": opt_state})
        params, opt_state = t["params"], t["opt"]
        start = last + 1
        log(f"resumed from step {last}")

    if coded:
        M = workers
        ds = SyntheticLMDataset(M * 2, examples_per_partition=batch,
                                seq_len=seq, vocab=cfg.vocab, device="cpu")
        runtime = TwoStageRuntime(M, M * 2, max(M // 2, 2),
                                  rates=np.linspace(1.0, 4.0, M),
                                  straggler_prob=straggler_prob, seed=0)
        for step in range(start):          # the runtime's host draws
            runtime.run_epoch(step)
        step_fn = make_coded_train_step(per_slot_lm_loss(cfg), opt,
                                        inplace=True)
    else:
        ds = SyntheticLMDataset(1, examples_per_partition=batch,
                                seq_len=seq, vocab=cfg.vocab, device="cpu")
        step_fn = make_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), opt,
                                  clip_norm=1.0, inplace=True)

    out = {k: [] for k in ("step", "loss", "plan_ms", "data_ms",
                           "step_ms")}
    out.update({k: [] for k in (("sim_time", "n_slots", "decode_ok",
                                 "n_stragglers") if coded
                                else ("grad_norm",))})
    t_run = time.perf_counter()
    for step in range(start, steps):
        t0 = time.perf_counter()
        if coded:
            res = runtime.run_epoch(step)
            t1 = time.perf_counter()
            data = slot_batch(ds, step, res.plan, device)
            w = torch.as_tensor(res.weights, dtype=torch.float32,
                                device=device)
        else:
            t1 = time.perf_counter()
            data = {k: v.to(device) for k, v in ds.partition(step, 0).items()}
        sync()
        t2 = time.perf_counter()
        if coded:
            params, opt_state, aux = step_fn(params, opt_state, data, w)
        else:
            params, opt_state, aux = step_fn(params, opt_state, data)
        del data
        loss = float(aux["loss"])          # synchronises with the card
        sync()
        t3 = time.perf_counter()
        for key, v in (("step", step), ("loss", loss),
                       ("plan_ms", (t1 - t0) * 1e3),
                       ("data_ms", (t2 - t1) * 1e3),
                       ("step_ms", (t3 - t2) * 1e3)):
            out[key].append(v)
        if coded:
            out["sim_time"].append(float(res.time))
            out["n_slots"].append(int(res.plan.n_slots))
            out["decode_ok"].append(bool(res.decode_ok))
            out["n_stragglers"].append(int(res.n_stragglers))
            if step % log_every == 0:
                log(f"step {step:4d} loss={loss:.4f} "
                    f"sim_epoch_time={res.time:.3f} "
                    f"util={res.utilization:.2f} "
                    f"stragglers={res.n_stragglers}")
        else:
            out["grad_norm"].append(float(aux["grad_norm"]))
            if step % log_every == 0:
                dt = (time.perf_counter() - t_run) / (step - start + 1)
                log(f"step {step:4d} loss={loss:.4f} "
                    f"gnorm={out['grad_norm'][-1]:.2f} {dt:.2f}s/step")
        if ck and step and step % ckpt_every == 0:
            ck.async_save(step, {"params": params, "opt": opt_state})
    if ck:
        ck.wait()
    log(f"done in {time.perf_counter() - t_run:.1f}s")
    out.update(params=params, opt_state=opt_state, start_step=start)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny")
    ap.add_argument("--preset", default=None)
    # the reference's flag: store_true with default True, so a named arch
    # always runs its REDUCED config from the command line
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--coded", action="store_true",
                    help="two-stage coded gradient runtime (simulated "
                         "heterogeneous workers)")
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--straggler-prob", type=float, default=0.2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return train(_config(args), steps=args.steps, batch=args.batch,
                 seq=args.seq, lr=args.lr, coded=args.coded,
                 workers=args.workers, straggler_prob=args.straggler_prob,
                 ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 log_every=args.log_every, device=args.device)


if __name__ == "__main__":
    main()
