#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (``nvcc``, target ``sm_90a``):

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device  -- a CUDA card must be present; prints its name and power limit;
2. build   -- compiles every CUDA source of the port with nvcc, one process
              per source, all started together;
3. kernels -- each kernel against its plain PyTorch version on the card, on
              the shapes of the JAX package's kernel tests and the slice's
              own payload, with those tests' tolerances;
4. slice   -- the main path: ``CodedTrainer`` with the paper's MLP
              (784, 256, 128, 10) on ``bursty-stragglers``, 10,000 examples
              per partition, AdamW(1e-3), 4 schemes x 3 epochs, on the card.
              Launch counts are zeroed just before and read just after; every
              decoded epoch must equal the full-batch gradient and every
              kernel of the path must have launched.  The same trainers then
              run on the CPU: the co-simulated outcomes must be equal and the
              losses agree within rtol 1e-3;
5. times   -- each kernel, its plain version and one library call, timed
              with CUDA events, beside the least time the card could take,
              and the per-epoch phase split of the main path.

The line before the last holds one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

DIMS = (784, 256, 128, 10)
SCENARIO = "bursty-stragglers"
SCHEMES = ("two-stage", "cyclic", "fractional", "uncoded")
EXAMPLES_PER_PARTITION = 10_000
EPOCHS = 3
PHASES = ("shard_grads", "cosim", "encode", "decode_reduce",
          "optimizer_step")


def log(msg: str) -> None:
    print(msg, flush=True)


def check_close(name, got, want, rtol, atol) -> float:
    """Raise unless ``got`` is within ``atol + rtol·|want|`` of ``want``;
    return the largest absolute error."""
    import torch
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {got.numel()} entries outside "
            f"rtol={rtol} atol={atol}; max abs err {float(err.max()):.3e}")
    return float(err.max())


# --------------------------------------------------------------------- #
# 1-2. device and build
# --------------------------------------------------------------------- #
def device_phase():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def build_phase():
    from repro_torch.kernels import _build, kernel_sources
    t0 = time.perf_counter()
    libs = _build.compile_libraries(kernel_sources())
    log(f"[build] {len(libs)} CUDA source(s) in "
        f"{time.perf_counter() - t0:.2f} s -> {_build.BUILD_DIR}")
    for lib in libs:
        report = lib.with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {lib.stem}: {line.strip()}")


# --------------------------------------------------------------------- #
# 3. kernels against their plain versions
# --------------------------------------------------------------------- #
def _uploads(seed, n_slots, D, dtype, scale=1.0):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((n_slots, D)) * scale).astype(np.float32)
    w = rng.standard_normal(n_slots).astype(np.float32)
    return (torch.from_numpy(g).to("cuda", dtype),
            torch.from_numpy(w).to("cuda"))


def kernel_phase() -> dict:
    """coded_reduce on the cases of the JAX package's kernel tests; returns
    the largest error at each shape, keyed by ``(n_slots, D)``."""
    from itertools import combinations

    import numpy as np
    import torch

    from repro_torch.core.coding import cyclic_repetition, rs_decode_weights
    from repro_torch.kernels.coded_reduce import (coded_reduce,
                                                  coded_reduce_ref)

    errs = {}

    def case(tag, g, w, rtol, atol, want=None):
        out = coded_reduce(g, w)
        torch.cuda.synchronize()
        if out.shape != (g.shape[1],) or out.dtype != torch.float32:
            raise AssertionError(f"{tag}: got {tuple(out.shape)} {out.dtype}")
        want = coded_reduce_ref(g, w) if want is None else want
        e = check_close(tag, out, want, rtol, atol)
        key = tuple(g.shape)
        errs[key] = max(errs.get(key, 0.0), e)
        log(f"[kernels] coded_reduce {tag}: max abs err {e:.3e} "
            f"(rtol {rtol}, atol {atol})")

    for n_slots, D in [(4, 512), (7, 1024), (16, 2048)]:
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
            g, w = _uploads(7, n_slots, D, dtype)
            case(f"({n_slots},{D}) {str(dtype)[6:]}", g, w, tol, tol)
    for D in (513, 777, 2047):
        g, w = _uploads(10, 5, D, torch.float32)
        case(f"(5,{D}) ragged", g, w, 1e-5, 1e-5)
    # every <= s erasure pattern of CRS(6, 2), decoded with the port's
    # rs_decode_weights, reduced over the surviving rows only
    rng = np.random.default_rng(11)
    M, s, D = 6, 2, 700
    scheme = cyclic_repetition(M, s)
    parts = rng.standard_normal((M, D)).astype(np.float32)
    coded = torch.from_numpy(np.asarray(scheme.B @ parts, np.float32))
    want = torch.from_numpy(parts.sum(0)).cuda()
    patterns = [()] + [(i,) for i in range(M)] + \
        list(combinations(range(M), s))
    for dead in patterns:
        alive = np.ones(M, bool)
        alive[list(dead)] = False
        a = rs_decode_weights(scheme.nodes, alive, scheme.s)
        live = np.flatnonzero(a != 0.0)
        case(f"CRS(6,2) dead={dead}", coded[live].cuda(),
             torch.tensor(a[live], dtype=torch.float32, device="cuda"),
             1e-3, 1e-3, want=want)
    for n_slots in range(1, 7):     # every upload count the MLP path gives
        for D in (98_624, 235_146):
            g, w = _uploads(12, n_slots, D, torch.float32, scale=0.1)
            case(f"({n_slots},{D}) payload", g, w, 1e-4, 1e-4)
    return errs


# --------------------------------------------------------------------- #
# 4. the slice: coded training of the paper's MLP
# --------------------------------------------------------------------- #
class PhaseTimer:
    """Host clock around each trainer phase, synchronised with the card at
    both ends, so a phase's time includes its kernels."""

    def __init__(self, sync: bool):
        self.sync = sync
        self.ms = {p: [] for p in PHASES}

    def __call__(self, name, epoch):
        timer = self

        class _Span:
            def __enter__(self):
                timer._sync()
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                timer._sync()
                timer.ms[name].append((time.perf_counter() - self.t0) * 1e3)
                return False
        return _Span()

    def _sync(self):
        if self.sync:
            import torch
            torch.cuda.synchronize()


def _trainer(scheme, device, timer):
    import torch

    from repro_torch.data.pipeline import SyntheticClassificationDataset
    from repro_torch.models.mlp import init_mlp, mlp_loss
    from repro_torch.optim.optimizers import adamw
    from repro_torch.sim import scenario_spec
    from repro_torch.train import CodedTrainer

    spec = scenario_spec(SCENARIO)
    # random weights from a seed, made on the host so that the card's and
    # the CPU's trainers start from the same values
    params = init_mlp(torch.Generator().manual_seed(0), DIMS, device="cpu")
    data = SyntheticClassificationDataset(
        spec.K, EXAMPLES_PER_PARTITION, DIMS[0], DIMS[-1], seed=0,
        device=device)
    return CodedTrainer(spec, scheme, data, adamw(1e-3), params=params,
                        loss_fn=mlp_loss, seed=0, device=device,
                        phase_timer=timer)


def slice_phase():
    """Returns (launches during the main path, the main path's logs, its
    phase timer)."""
    import numpy as np
    import torch

    from repro_torch.kernels.coded_reduce import coded_reduce
    from repro_torch.optim.optimizers import tree_leaves

    timer = PhaseTimer(sync=True)
    trainers = [_trainer(s, "cuda", timer) for s in SCHEMES]
    torch.cuda.synchronize()
    # ---- the main path: counts zeroed just before, read just after ----
    coded_reduce.launches = 0
    t0 = time.perf_counter()
    logs = {}
    decode_errs = []
    for scheme, tr in zip(SCHEMES, trainers):
        logs[scheme] = []
        for epoch in range(EPOCHS):
            lg = tr.run_epoch(epoch)
            logs[scheme].append(lg)
            if lg.decode_ok:
                decode_errs.append(check_close(
                    f"{scheme} epoch {epoch} decoded vs full-batch gradient",
                    torch.from_numpy(tr.last_decoded),
                    torch.from_numpy(tr.last_full_grad), 1e-4, 1e-5))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"coded_reduce": coded_reduce.launches}
    # ---------------------------------------------------------------------
    n_decoded = sum(lg.decode_ok for v in logs.values() for lg in v)
    log(f"[slice] {len(SCHEMES)} schemes x {EPOCHS} epochs on the card in "
        f"{wall:.2f} s; {n_decoded} decoded, coded_reduce launches "
        f"{launches['coded_reduce']}; decoded vs full-batch max abs err "
        f"{max(decode_errs, default=0.0):.3e}")
    if n_decoded == 0:
        raise AssertionError("no epoch decoded: the kernel was never on "
                             "the path")
    if launches["coded_reduce"] != n_decoded:
        raise AssertionError(f"coded_reduce launched "
                             f"{launches['coded_reduce']} times for "
                             f"{n_decoded} decoded epochs")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {name} never launched on the path")
    for scheme, tr in zip(SCHEMES, trainers):
        if not all(p.device.type == "cuda" for p in tree_leaves(tr.params)):
            raise AssertionError(f"{scheme}: params left the card")
        for p in tree_leaves(tr.params):
            if not bool(torch.isfinite(p).all()):
                raise AssertionError(f"{scheme}: non-finite params")
    for scheme in SCHEMES:
        for lg in logs[scheme]:
            log(f"[slice] {scheme} epoch {lg.epoch}: decode_ok="
                f"{lg.decode_ok} slots={lg.n_slots} uploads={lg.n_uploads} "
                f"sim_time={lg.time:.4f} loss={lg.loss:.6f}")

    # the same trainers on the CPU: equal co-simulated outcomes, close
    # losses (cuBLAS and the CPU's BLAS sum float32 in other orders)
    t0 = time.perf_counter()
    for scheme in SCHEMES:
        tr = _trainer(scheme, "cpu", None)
        for epoch in range(EPOCHS):
            lc, lg = tr.run_epoch(epoch), logs[scheme][epoch]
            if (lc.decode_ok, lc.n_slots, lc.time) != \
                    (lg.decode_ok, lg.n_slots, lg.time):
                raise AssertionError(
                    f"{scheme} epoch {epoch}: card (decode_ok, slots, time)"
                    f" = {(lg.decode_ok, lg.n_slots, lg.time)}, CPU "
                    f"{(lc.decode_ok, lc.n_slots, lc.time)}")
            if not np.allclose(lg.loss, lc.loss, rtol=1e-3, atol=0.0,
                               equal_nan=True):
                raise AssertionError(f"{scheme} epoch {epoch}: loss on the "
                                     f"card {lg.loss}, on the CPU {lc.loss}")
    log(f"[slice] the same {len(SCHEMES) * EPOCHS} epochs on the CPU agree "
        f"({time.perf_counter() - t0:.1f} s)")
    return launches, logs, timer


# --------------------------------------------------------------------- #
# 5. times
# --------------------------------------------------------------------- #
def time_ms(fn, reps=50, cold=True) -> float:
    """Median time of one call of ``fn`` on the card, by CUDA events.
    ``cold`` overwrites a 256 MiB buffer before each call, so the call's
    inputs come from HBM and not from the 50 MB L2 cache.  A sleep kernel
    then keeps the card busy while the host enqueues the call, so that the
    events time the call on the card and not the host's launch."""
    import torch
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if cold:
            flush.zero_()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(sorted(times)[len(times) // 2])


def coded_reduce_times(n_slots, D) -> dict:
    import torch

    from repro_torch.kernels.coded_reduce import (coded_reduce,
                                                  coded_reduce_ref)
    g, w = _uploads(3, n_slots, D, torch.float32, scale=0.1)
    saved = coded_reduce.launches
    err = check_close(f"coded_reduce ({n_slots},{D}) timed inputs",
                      coded_reduce(g, w), coded_reduce_ref(g, w), 1e-4, 1e-4)
    row = {"ms": time_ms(lambda: coded_reduce(g, w)),
           "plain_ms": time_ms(lambda: coded_reduce_ref(g, w)),
           "library_ms": time_ms(lambda: w @ g),
           "warm_ms": time_ms(lambda: coded_reduce(g, w), cold=False)}
    coded_reduce.launches = saved          # timing launches are not the path's
    n_bytes = n_slots * D * g.element_size() + 4 * n_slots + 4 * D
    flops = 2 * n_slots * D
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    row.update(bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               max_abs_err=err, bytes=n_bytes)
    log(f"[times] coded_reduce ({n_slots},{D}) f32: kernel {row['ms']:.5f} "
        f"ms (inputs in L2: {row['warm_ms']:.5f}), plain "
        f"{row['plain_ms']:.5f}, w @ g {row['library_ms']:.5f}, bound "
        f"{row['bound_ms']:.5f} ms "
        f"({n_bytes} bytes at 3.35 TB/s) -> "
        f"{row['bound_ms'] / row['ms']:.1%} of the bound")
    return row


def slot_round_trip_ms(device, reps=200) -> float:
    """Host time of the device part of one co-sim slot, as
    ``EdgeCluster._run_comm`` does it: the observation rows to ``device``,
    ``schedule_slot``, and the decisions back to the host."""
    import numpy as np
    import torch

    from repro_torch.core.lyapunov import (Observation, init_queues,
                                           schedule_slot)
    from repro_torch.sim import build_cluster, scenario_spec

    cl = build_cluster(scenario_spec(SCENARIO), "two-stage", 0,
                       device=device)
    rows_np = np.random.default_rng(0).random((3, cl.M)).astype(np.float32)
    state = init_queues(cl.M, E0=cl.comm.E0, device=device)

    def slot(state):
        rows = torch.from_numpy(rows_np).to(device)
        obs = Observation(D=rows[0], r=rows[1], E_H=rows[2], L=cl._L,
                          new_cycles=cl._zeros)
        state, dec = schedule_slot(state, cl.sys_params, obs)
        torch.stack([dec.d, dec.c, dec.e_up, dec.e_com, state.Q,
                     state.E]).cpu().numpy()
        return state

    for _ in range(10):
        state = slot(state)
    t0 = time.perf_counter()
    for _ in range(reps):
        state = slot(state)
    return (time.perf_counter() - t0) / reps * 1e3


def data_ms(device, reps=3) -> float:
    """Host time to make one epoch's K partitions of the slice's dataset
    on ``device`` (numpy draws, and on the card the copy there)."""
    import torch

    from repro_torch.data.pipeline import SyntheticClassificationDataset
    from repro_torch.sim import scenario_spec
    data = SyntheticClassificationDataset(
        scenario_spec(SCENARIO).K, EXAMPLES_PER_PARTITION, DIMS[0], DIMS[-1],
        seed=0, device=device)
    t0 = time.perf_counter()
    for epoch in range(reps):
        for k in range(data.K):
            data.partition(epoch, k)
    if device == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def times_phase(launches, logs, timer, errs) -> list:
    from collections import Counter

    import numpy as np

    # the MLP's payload at the most uploads an epoch of the path reduces
    # (M = 6, every worker arrived, as the uncoded scheme gives)
    n_main, D = 6, 235_146
    counts = Counter(lg.n_uploads for v in logs.values() for lg in v
                     if lg.decode_ok)
    log(f"[times] upload counts on the main path: {dict(counts)}")
    main = coded_reduce_times(n_main, D)
    coded_reduce_times(16, 2 ** 24)

    epochs = [lg for v in logs.values() for lg in v]
    for name in PHASES:
        ms = timer.ms[name]
        if not ms:               # encode/decode/step skip a failed decode
            log(f"[times] phase {name}: no epoch")
            continue
        log(f"[times] phase {name}: {len(ms)} epochs, mean "
            f"{np.mean(ms):.3f} ms, min {np.min(ms):.3f}, max "
            f"{np.max(ms):.3f}")
    log(f"[times] data for one epoch (K partitions x "
        f"{EXAMPLES_PER_PARTITION} examples): {data_ms('cpu'):.1f} ms of "
        f"numpy draws, {data_ms('cuda'):.1f} ms with the copy to the card")
    slots = sum(lg.n_slots for lg in epochs)
    log(f"[times] co-sim: {slots} slots in {sum(timer.ms['cosim']):.1f} ms"
        f" -> {sum(timer.ms['cosim']) / max(slots, 1):.4f} ms per slot")
    log(f"[times] co-sim slot, device part only (H2D rows, schedule_slot, "
        f"D2H decisions): {slot_round_trip_ms('cuda'):.4f} ms on the card, "
        f"{slot_round_trip_ms('cpu'):.4f} ms on the CPU")
    return [{
        "name": "coded_reduce", "route": "cuda",
        "source": "src/repro_torch/kernels/coded_reduce/csrc/coded_reduce.cu",
        "replaces": "src/repro/kernels/coded_reduce/coded_reduce.py:41",
        "launches": launches["coded_reduce"],
        "max_abs_err": max(errs.get((n_main, D), 0.0), main["max_abs_err"]),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"]}]


def main() -> int:
    smi = device_phase()
    build_phase()
    errs = kernel_phase()
    launches, logs, timer = slice_phase()
    kernels = times_phase(launches, logs, timer, errs)
    import torch
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
