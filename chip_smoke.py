#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit (``nvcc``, target ``sm_90a``):

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. device  -- a CUDA card must be present; prints its name and power limit;
2. build   -- compiles every CUDA source of the port with nvcc, one process
              per source, all started together; prints each kernel's
              registers and spills, the dynamic shared memory of the WKV,
              RG-LRU and attention tensor-core kernels and, where cuobjdump
              is found, the attention kernels' count of HGMMA/HMMA
              instructions in the SASS (none fails);
3. kernels -- each kernel against its plain PyTorch version on the card:
              coded_reduce on the shapes of the JAX package's kernel tests and
              on every payload shape of both paths; flash attention, forward
              and backward, on both of its routes (bf16: tensor cores;
              float32: CUDA cores): the reference's kernel-test cases, a GQA
              case, ragged sequences, head widths 8, 24 and 40 and the
              transformer path's shape; the WKV recurrence on the reference's
              kernel-test cases, bf16 inputs, a ragged sequence, the decays
              where the reference's chunked form fails, w -> 1, w = 1, w
              with zeros and 1e-30 entries and the serve path's shape; the
              RG-LRU scan on the reference's kernel-test
              cases, a ragged (2, 1000, 2500), a -> 1 over 4,096 steps and the
              recurrentgemma path's shape; the attention forward at head width
              256 (MQA, G = 10) with a window of 2,048 over 3,000 tokens and
              at the recurrentgemma path's shape, and forward and backward
              at head width 256 over 3,000 tokens (GQA and MQA, windows
              1,024 and 2,048 and none, both routes) and 192; the RG-LRU
              backward (held equal) and the WKV backward at the family
              training path's shapes and ragged ones; the attention
              forward at the shapes of the
              moe and zoo paths (D = 64 at G = 3; 128 at G = 5, 6, 8; 80
              non-causal; 256 at G = 2 with a window of 1,024) and where
              their windows and padding bite; each with its stated
              tolerance;
4. mlp     -- the first path: ``CodedTrainer`` with the paper's MLP
              (784, 256, 128, 10) on ``bursty-stragglers``, 10,000 examples
              per partition, AdamW(1e-3), 4 schemes x 3 epochs, on the card,
              then the same on the CPU (equal co-simulated outcomes, losses
              within rtol 1e-3);
5. lm      -- the second path: ``CodedTrainer`` with stablelm-1.6b at full
              width cut to 4 layers (D = 616,581,120), one 4,096-token
              sequence per partition, AdamW(1e-3), 4 schemes x 2 epochs.
              Every decoded gradient must equal the full-batch gradient,
              every failed decode must be a no-op step, and the launch
              counts must be what the path implies;
6. tiny    -- ``repro_torch.train.e2e`` at its TINY config on the card and
              on the CPU: equal decode outcomes and simulated times, losses
              within rtol 1e-3, and the reference's speedups;
7. fel     -- the paper's experiment: ``repro_torch.core.fel.FELTrainer``
              with the MLP (784, 256, 128, 10), 10,000 examples a
              partition, M = K = 6, SGD-momentum(1e-2), 4 schemes x 3
              epochs on the instant-uplink backend (noise 0) and through
              ``cluster=`` the ``bursty-stragglers`` scenario; the
              loss-weighted coded step decodes inside its one backward.
              C1: every run that decoded every epoch ends with the params
              of the straggler-free uncoded run (rtol 1e-5, atol 1e-6);
              the same runs at 64 examples on the CPU give bit-equal host
              outcomes and params within that tolerance of the card's;
              each epoch's split (plan, draw, stack, copy, step);
8. lmtrain -- ``repro_torch.launch.train.train`` at stablelm-1.6b's full
              size (24 layers): 3 coded steps (M = 6 workers, K = 12
              partitions of one 1,024-token sequence, AdamW) and one plain
              step (4 sequences, clip_norm 1.0); the attention kernels
              must launch twice a layer forward (remat) and once backward
              a step; then one coded step's gradient against the gradient
              of the K partitions' summed mean CE, taken directly, within
              the model's bf16 conditioning (``GRAD_ROUTE_FACTOR``);
8b. famtrain -- the same driver on every other token-decoder family
              (``FAM_TRAIN``): granite-moe-3b-a800m, rwkv6-1.6b and
              recurrentgemma-2b at full size, gemma3-12b at full width cut
              to 6 layers (2,048 tokens, so its window bites); 3 coded
              steps each, launches as the path implies (the WKV, RG-LRU
              and attention backward kernels once a layer and step),
              finite losses, peak memory under 80 GB; each coded
              gradient against the full-batch gradient of its own CE,
              within a one-ulp nudge's change and ``GRAD_ROUTE_FACTOR`` x
              the larger of two exact routes (half batches; loss_fn's CE),
              granite at the capacity where nothing drops; its drops a layer at
              capacity 1.0 and one plain step (CE + 0.01·aux);
9. serve   -- the third path: ``repro_torch.launch.serve.serve`` with
              rwkv6-1.6b at full size (24 layers, bf16 compute): Lyapunov
              admission of 6 clients over 10 slots, batched prefill of
              1,024-token prompts through the WKV kernel, 16 greedy decode
              steps.  The WKV kernel must launch 24 times per prefill.
              Then a teacher-forced check of decode against a fresh forward
              (bf16 and float32), the model on the card against the CPU at
              REDUCED, and the REDUCED serve loop on the card and the CPU
              (equal admissions and served counts);
10. rg     -- the fourth path: the same serve loop and traffic with
              recurrentgemma-2b at full size (26 layers, 2.68 B parameters,
              bf16 compute): each prefill runs the RG-LRU kernel in its 18
              rec layers and the attention forward (head width 256) in its
              8 local layers.  Then teacher-forced decode against a fresh
              forward at prompts of 1,024, 2,040 (decode crosses the window
              of 2,048) and 2,560 tokens (a ring from prefill), in bf16 and
              float32, the model on the card against the CPU at REDUCED,
              and the REDUCED serve loop on the card and the CPU;
11. moe    -- the same serve loop and traffic with granite-moe-3b-a800m at
              full size (32 layers, 40 experts top-8, 3.37 B parameters,
              bf16 compute): each prefill runs the attention forward in its
              32 layers; the share of assignments each layer's prefill
              drops; the structural check (float32 at capacity 8: prefill
              and teacher-forced decode against a fresh forward); one MoE
              layer's dispatch of 4,096 tokens equal on the card and the
              CPU, and its float32 output within ``MOE_FFN_TOL``; the
              REDUCED model card vs CPU and the REDUCED serve loop on both;
12. zoo    -- the six other new configs at full width, depth cut as
              ``ZOO`` says (hubert-xlarge uncut; llama4 in bf16 weights):
              a bf16 prefill of 2 x 1,024 and one decode step (hubert: a
              forward), then the float32 route against a fresh forward
              (hubert: a batch of two against each sequence alone) within
              ``ZOO_F32_TOL`` (the weights conditioned to ``NUDGE_MARGIN``
              times inside it), and bf16 within ``ZOO_BF16_TOL`` of
              float32; each row's attention launches counted, the windowed
              ones apart; llama4's float32
              route is its structural check at capacity 8;
13. fleet  -- the batched fleet engines (no kernel of the port): (a)
              ``compare_schemes`` on every registry scenario, 4 schemes x
              64 seeds x 3 epochs (``fleet_scale.py``'s FULL size), on
              the card, every lane's outcomes equal to the same fleets on
              the CPU and the ledgers within rtol 1e-5; (b) the oracle on
              seeds 0 and 1 and the hybrid engine on all 64, bit-equal to
              (a); (c) one epoch of a 1,000-lane megafleet whose first 64
              lanes equal (a), with the host's waits for the card counted
              by torch's sync debug mode; (d) ``grid_sweep.py``'s SMOKE
              grid (64 cells) equal to per-cell runs, one chunk-runner
              build per group at most; (e) a recorded fleet equal to the
              unrecorded one, its series equal to the oracle's, its
              Chrome trace valid JSON;
14. device -- the device-resident epoch tail: ``compare_schemes`` with
              ``engine="device"`` over the same 7 scenarios x 4 schemes x
              64 seeds x 3 epochs, every lane-epoch bit-equal to (11a);
              the host's waits for the card by torch's sync debug mode
              (at most one a chunk and one an epoch); seconds and
              seed-epochs/s beside the batched engine's;
15. soak   -- ``repro_torch.sim.frontier.run_frontier`` at 2,000 slots
              (the frontier's 5 scenarios and ``paper-v-sweep`` x their V
              grids) on the card and on the CPU: points and pareto marks
              equal, each scenario's best throughput within 10 % of the
              committed 1M-slot ``BENCH_lyapunov_frontier.json``; each
              stacked group's final float32 state bit-equal on the card
              and the CPU, moments within rtol 1e-12, chunks of 500 and
              2,000 bit-equal; ms a slot and lane-slots/s, card and CPU;
16. grid   -- one cell of each shape of the (arch x shape) grid through
              ``repro_torch.launch.steps`` at the shape's full sequence
              length (``GRID``): train_4k (stablelm-1.6b, 24 layers, 24 of
              256 sequences of 4,096 tokens; 3 steps with the EF int8
              quantizer as ``grad_transform``, its residuals carried, one
              EF top-k step, one plain step), prefill_32k
              (recurrentgemma-2b, 8 of 32 prompts of 32,768 tokens),
              decode_32k (recurrentgemma-2b, 128 sequences, caches of its
              size drawn from the seed, from position 32,767) and
              long_500k (rwkv6-1.6b, a prefill of 524,288 tokens, then a
              serve step); each line with its median step time, peak
              memory, ``mfu`` (the cut shape's model FLOPs over the time
              over the H100's bf16 peak) and the roofline's bottleneck
              (``repro_torch.analysis.roofline``, ``HW_H100``); finite
              losses and logits; the quantizer's output within one step of
              every block of its input, its residual exact, its codes on
              the card equal to the host's numpy route on a whole leaf and
              windows of the largest; launches as each cell implies; each
              kernel against its plain version at its cell's shape, timed
              there;
17. times  -- each kernel, its plain version and one library call, timed
              with CUDA events, beside the least time the card could take
              (the attention forward also at each moe and zoo shape; the
              three backward kernels at the family training shapes), the
              per-epoch phase split of the training paths and a profile of
              one prefill and its decode steps of each serve path.

Launch counts are zeroed just before each path and read just after it.
The line before the last holds one JSON object with every kernel's
numbers; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.analysis.roofline import HW_H100  # noqa: E402

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = HW_H100["hbm_bw"]
F32_FLOP_PER_S = HW_H100["peak_flops_f32"]
BF16_FLOP_PER_S = HW_H100["peak_flops_bf16"]

SCENARIO = "bursty-stragglers"
SCHEMES = ("two-stage", "cyclic", "fractional", "uncoded")
PHASES = ("shard_grads", "cosim", "encode", "decode_reduce",
          "optimizer_step")
# the MLP path
DIMS = (784, 256, 128, 10)
EXAMPLES_PER_PARTITION = 10_000
EPOCHS = 3
# the transformer path: stablelm-1.6b, full width, depth cut to 4 layers
LM_LAYERS = 4
LM_SEQ = 4096
LM_EPOCHS = 2
#: the attention shape of the transformer path: (B, S, KV, G, D)
FA_PATH = (1, LM_SEQ, 32, 1, 64)
# the serve path: rwkv6-1.6b at full size, the reference's arrival mix
SERVE = dict(clients=6, slots=10, prompt_len=1024, gen_len=16, batch=4,
             V=30.0, seed=0)
#: the WKV shape of the serve path's prefill: (B, H, S, K, V)
WKV_PATH = (4, 32, 1024, 64, 64)
# the recurrentgemma-2b serve path: full size, the same traffic (SERVE)
#: the RG-LRU scan of its prefill: (B, S, D = d_rnn), float32 a and b
RG_SCAN_PATH = (4, 1024, 2560)
#: the attention of its local layers' prefill: (B, S, KV, G, D), window
RG_FA_PATH, RG_WINDOW = (4, 1024, 1, 10, 256), 2048
# the family training path ([famtrain]): M = 6 workers x up to 5 slots of
# one 1,024-token sequence each, so the kernels see 30 rows
FAM_ROWS = 30
#: the backward kernels' shapes there: WKV (rows, H, S, K, V), bf16
#: r/k/v/u; RG-LRU (rows, S, d_rnn), float32; attention at head width 256
#: (recurrentgemma's local layers, window 2,048, and gemma3's, window 1,024)
WKV_TRAIN_PATH = (FAM_ROWS, 32, 1024, 64, 64)
RG_TRAIN_PATH = (FAM_ROWS, 1024, 2560)
FA256_TRAIN_PATHS = (((FAM_ROWS, 1024, 1, 10, 256), RG_WINDOW),
                     ((FAM_ROWS, 2048, 8, 2, 256), 1024))
#: the design of the attention backward at head width 256
FA256_BWD_DESIGN = ("two consumer warpgroups a block exchanging P or dS "
                    "through shared memory: S and dP once a tile pair, 7 "
                    "full-width products")
#: teacher-forced prompts: below the window, decoding across its edge,
#: and above it (a ring from prefill)
RG_TF_PROMPTS = (1024, 2040, 2560)
# the granite-moe-3b-a800m serve path: full size, the same traffic (SERVE)
#: the attention of its prefill: (B, S, KV, G, D), causal
GRANITE_FA_PATH = (4, 1024, 8, 3, 64)
#: the dispatch check: one MoE layer at full width over this many tokens
MOE_DISPATCH_T = 4096
#: the structural check (float32, capacity 8: nothing dropped): batch,
#: prompt length and teacher-forced decode steps
MOE_TF_B, MOE_TF_PROMPT, MOE_TF_STEPS = 2, 512, 4
# the zoo: the other new configs at full width, one batch of ZOO_B x ZOO_S
ZOO_B, ZOO_S = 2, 1024
#: (arch, layers kept: None = all), smallest first
ZOO = (("hubert-xlarge", None), ("internvl2-26b", 2), ("qwen3-14b", 2),
       ("gemma3-12b", 6), ("deepseek-67b", 2),
       ("llama4-maverick-400b-a17b", 2))


def log(msg: str) -> None:
    print(msg, flush=True)


def check_close(name, got, want, rtol, atol) -> float:
    """Raise unless ``got`` is within ``atol + rtol·|want|`` of ``want``
    and finite; return the largest absolute error.  Works in slices, so a
    comparison of two 2.5 GB vectors needs a few hundred MB more."""
    import torch
    got, want = got.reshape(-1), want.reshape(-1)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shapes {tuple(got.shape)} and "
                             f"{tuple(want.shape)}")
    n_bad, worst, step = 0, 0.0, 1 << 26
    for i in range(0, got.numel(), step):
        g, w = got[i:i + step].float(), want[i:i + step].float()
        err = (g - w).abs()
        n_bad += int((err > atol + rtol * w.abs()).sum()) + \
            int((~torch.isfinite(g)).sum())
        worst = max(worst, float(err.max()))
    if n_bad:
        raise AssertionError(
            f"{name}: {n_bad} of {got.numel()} entries outside rtol={rtol} "
            f"atol={atol} or not finite; max abs err {worst:.3e}")
    return worst


def set_counts(counts: dict) -> None:
    from repro_torch.kernels.coded_reduce import coded_reduce
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rwkv6_wkv import wkv
    coded_reduce.launches = counts["coded_reduce"]
    flash_attention.fwd_launches = counts["flash_attention_fwd"]
    flash_attention.bwd_launches = counts["flash_attention_bwd"]
    wkv.launches = counts["rwkv6_wkv"]
    wkv.bwd_launches = counts["rwkv6_wkv_bwd"]
    rglru_scan.launches = counts["rglru_scan"]
    rglru_scan.bwd_launches = counts["rglru_scan_bwd"]


COUNTED = ("coded_reduce", "flash_attention_fwd", "flash_attention_bwd",
           "rwkv6_wkv", "rwkv6_wkv_bwd", "rglru_scan", "rglru_scan_bwd")


def no_launches(**n) -> dict:
    """Every kernel's count at 0, but those given."""
    counts = dict.fromkeys(COUNTED, 0)
    counts.update(n)
    return counts


def reset_counts() -> None:
    """Every count at 0, the windowed shares of the attention forward's
    and backward's (``windowed_launches``) too."""
    from repro_torch.kernels.flash_attention import flash_attention
    set_counts(no_launches())
    flash_attention.fwd_windowed_launches = 0
    flash_attention.bwd_windowed_launches = 0


def windowed_launches(backward: bool = False) -> int:
    """Attention forward (or backward) launches with a sliding window
    since ``reset_counts``."""
    from repro_torch.kernels.flash_attention import flash_attention
    return flash_attention.bwd_windowed_launches if backward else \
        flash_attention.fwd_windowed_launches


def read_counts() -> dict:
    from repro_torch.kernels.coded_reduce import coded_reduce
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rwkv6_wkv import wkv
    return {"coded_reduce": coded_reduce.launches,
            "flash_attention_fwd": flash_attention.fwd_launches,
            "flash_attention_bwd": flash_attention.bwd_launches,
            "rwkv6_wkv": wkv.launches,
            "rwkv6_wkv_bwd": wkv.bwd_launches,
            "rglru_scan": rglru_scan.launches,
            "rglru_scan_bwd": rglru_scan.bwd_launches}


# --------------------------------------------------------------------- #
# 1-2. device and build
# --------------------------------------------------------------------- #
def device_phase():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    # float32 products in full float32, as the reference computes them
    # (the trainers set this too; every float32 check below relies on it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def kernel_name(mangled: str) -> str:
    """``fa_fwd_tc_kernel<4>`` or ``wkv_fwd_chunked_kernel<bf16, 64, 64, 32,
    16, 3>`` from its mangled name (the name as it is where it does not
    parse): the element type, then the integer arguments.  The name is the
    first length-prefixed component ending in ``_kernel``."""
    at = mangled.find("N") + 1 if mangled.startswith("_ZN") else 2
    while True:
        m = re.match(r"(\d+)", mangled[at:])
        if not m:
            return mangled
        at += len(m.group(1))
        name = mangled[at:at + int(m.group(1))]
        at += len(name)
        if name.endswith("_kernel"):
            break
    t = re.match(r"I(\w*?)EE", mangled[at:])
    if not t:
        return name
    tail = t.group(1)
    args = (["float"] if re.match(r"(?:NS_\d+\w*?CfgI)?f", tail) else
            ["bf16"] if "13__nv_bfloat16" in tail else []) + \
        re.findall(r"Li(\d+)", tail)
    return f"{name}<{', '.join(args)}>"


def ptxas_kernels(report: str) -> list:
    """``(kernel, registers, spill bytes stored, spill bytes loaded)`` of
    each kernel in a ``ptxas -v`` report."""
    out, name, spill = [], None, (0, 0)
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1))) + spill)
            name = None
    return out


def sass_mma_counts(lib) -> dict:
    """Tensor-core instructions (``HGMMA``, ``HMMA``) in each kernel's SASS,
    by ``cuobjdump``; None where ``cuobjdump`` is not found."""
    import os
    import shutil
    tool = shutil.which("cuobjdump") or str(Path(os.environ.get(
        "CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump")
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = kernel_name(line.split(":", 1)[1].strip())
            counts[name] = {"HGMMA": 0, "HMMA": 0}
        elif name and "HGMMA" in line:
            counts[name]["HGMMA"] += 1
        elif name and "HMMA" in line:
            counts[name]["HMMA"] += 1
    return counts


def recurrence_smem(name: str):
    """Dynamic shared memory a block of the WKV or RG-LRU ring kernel
    takes, for the instance ``name`` (``kernel_name``'s form: the element
    type, then K and V first for WKV); None for other kernels."""
    import torch

    from repro_torch.kernels.rglru_scan import ops as rg
    from repro_torch.kernels.rwkv6_wkv import ops as wk
    m = re.match(r"(\w+)<(float|bf16), ([\d, ]+)>$", name)
    if not m:
        return None
    dtype = torch.float32 if m.group(2) == "float" else torch.bfloat16
    args = [int(x) for x in m.group(3).split(", ")]
    if m.group(1) in ("wkv_fwd_chunked_kernel", "wkv_bwd_kernel"):
        return wk.smem_bytes(dtype, args[0], args[1],
                             backward=m.group(1) == "wkv_bwd_kernel")
    if m.group(1) == "rglru_scan_ring_kernel":
        return rg.smem_bytes(dtype)
    return None


def build_phase():
    """Build every source; print each kernel's registers and spills (and
    the attention's tensor-core kernels' shared memory and SASS count of
    tensor-core instructions); raise if one of those has none."""
    from repro_torch.kernels import _build, kernel_sources
    from repro_torch.kernels.flash_attention.ops import SOURCE, _library
    t0 = time.perf_counter()
    libs = _build.compile_libraries(kernel_sources())
    log(f"[build] {len(libs)} CUDA source(s) in "
        f"{time.perf_counter() - t0:.2f} s -> {_build.BUILD_DIR}")
    for lib in libs:
        report = lib.with_suffix(".log")
        if report.exists():
            for name, regs, st, ld in ptxas_kernels(report.read_text()):
                smem = recurrence_smem(name)
                log(f"[build] {lib.stem} {name}: {regs} registers, spill "
                    f"stores {st} B, spill loads {ld} B" +
                    ("" if smem is None else
                     f", {smem} B of dynamic shared memory a block"))
    fa_lib = _build.library_path(SOURCE)
    smem = _library().fa_bf16_smem_bytes
    for bwd, D in ((0, 64), (0, 128), (0, 256), (1, 64), (1, 128), (1, 256)):
        log(f"[build] tensor-core {'backward' if bwd else 'forward'} at "
            f"D = {D}: {smem(bwd, D)} bytes of dynamic shared memory a "
            f"block")
    counts = sass_mma_counts(fa_lib)
    if counts is None:
        log("[build] cuobjdump not found: no SASS count of tensor-core "
            "instructions")
        return
    for name, c in sorted(counts.items()):
        if name.startswith("fa_"):
            log(f"[build] SASS {name}: {c['HGMMA']} HGMMA, {c['HMMA']} HMMA")
            if "_tc_" in name and c["HGMMA"] + c["HMMA"] == 0:
                raise AssertionError(f"{name} has no tensor-core "
                                     f"instruction in its SASS")


# --------------------------------------------------------------------- #
# 3. kernels against their plain versions
# --------------------------------------------------------------------- #
def _uploads(seed, n_slots, D, dtype, scale=1.0):
    """Uploads and weights drawn on the host with numpy (small shapes) or
    on the card from a seeded generator (the transformer's payload)."""
    import numpy as np
    import torch
    if n_slots * D > 1 << 27:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        g = torch.randn((n_slots, D), generator=gen, device="cuda")
        w = torch.randn((n_slots,), generator=gen, device="cuda")
        return g.mul_(scale).to(dtype), w
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((n_slots, D)) * scale).astype(np.float32)
    w = rng.standard_normal(n_slots).astype(np.float32)
    return (torch.from_numpy(g).to("cuda", dtype),
            torch.from_numpy(w).to("cuda"))


def lm_config():
    from repro_torch.configs.stablelm_1_6b import FULL
    return dataclasses.replace(FULL, n_layers=LM_LAYERS)


def lm_payload() -> int:
    """D of the transformer path, from the shapes alone."""
    from repro_torch.models.common import spec_leaves
    from repro_torch.models.transformer import model_specs
    return sum(math.prod(s.shape) for s in spec_leaves(
        model_specs(lm_config())))


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
    # every upload count both paths give, at both payloads
    for D in (98_624, 235_146, lm_payload()):
        for n_slots in range(1, 7):
            g, w = _uploads(12, n_slots, D, torch.float32, scale=0.1)
            case(f"({n_slots},{D}) payload", g, w, 1e-4, 1e-4)
            del g, w
    torch.cuda.empty_cache()
    return errs


def _card_draws(seed):
    """A seeded generator on the card: inputs of 10^8-10^9 entries (the
    grid's shapes) take seconds, not minutes, to draw."""
    import torch
    return torch.Generator(device="cuda").manual_seed(seed)


def _fa_inputs(seed, shape_q, dtype, card=False):
    """q, k, v, dO normal in ``dtype`` on the card, drawn with numpy (or
    on the card, ``card``)."""
    import numpy as np
    import torch
    B, S, KV, G, D = shape_q
    rng = _card_draws(seed) if card else np.random.default_rng(seed)

    def draw(shape):
        if card:
            return torch.randn(shape, generator=rng, device="cuda").to(dtype)
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", dtype)
    return (draw(shape_q), draw((B, S, KV, D)), draw((B, S, KV, D)),
            draw(shape_q))


#: (forward, gradient) tolerances: float32 sums in another order than the
#: plain version's (the reference's kernel-test bound forward; gradients
#: sum up to S terms more), bfloat16 outputs are roundings of float32
#: values that differ in their last float32 bits (the reference's bf16
#: kernel-test bound)
FA_TOL = {"float32": ((2e-5, 2e-5), (1e-4, 1e-4)),
          "bfloat16": ((2e-2, 2e-2), (2e-2, 2e-2))}


def fa_case(tag, shape_q, dtype, causal, window, chunk=64,
            card=False) -> tuple:
    """Flash attention forward and backward at ``shape_q`` against the
    plain version, each within ``FA_TOL``, and the backward bit-equal over
    two launches; returns the largest errors (forward, backward).
    ``card``: the inputs drawn on the card."""
    import torch

    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd,
        flash_attention_fwd_ref)
    from repro_torch.kernels.flash_attention.ops import kernel_route
    q, k, v, do = _fa_inputs(0, shape_q, dtype, card)
    kw = dict(causal=causal, window=window, q_chunk=chunk, kv_chunk=chunk)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    grads = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError(f"{tag}: two backward launches differ")
    del again
    out_r, lse_r = flash_attention_fwd_ref(q, k, v, **kw)
    grads_r = flash_attention_bwd_ref(q, k, v, out_r, lse_r, do, **kw)
    name = str(dtype)[6:]
    (fr, fa), (gr, ga) = FA_TOL[name]
    e_fwd = max(check_close(f"{tag} out", out, out_r, fr, fa),
                check_close(f"{tag} lse", lse, lse_r, 1e-5, 1e-5))
    e_bwd = 0.0
    for n, g, r in zip(("dq", "dk", "dv"), grads, grads_r):
        if g.dtype != q.dtype or g.shape != r.shape:
            raise AssertionError(f"{tag} {n}: {g.dtype} {g.shape}")
        e_bwd = max(e_bwd, check_close(f"{tag} {n}", g, r, gr, ga))
    log(f"[kernels] flash_attention {tag} {name} causal={causal} "
        f"window={window} ({kernel_route(dtype, shape_q[4], True)}): "
        f"max abs err fwd {e_fwd:.3e} (rtol {fr}, atol {fa}), bwd "
        f"{e_bwd:.3e} (rtol {gr}, atol {ga})")
    return e_fwd, e_bwd


def flash_kernel_phase() -> dict:
    """Flash attention, forward and backward, kernel vs plain version;
    returns the largest errors at the path's shape, by direction."""
    import torch

    path_errs = {"fwd": 0.0, "bwd": 0.0}
    # the reference's kernel-test cases, (B, H, S, D) -> G = 1
    for B, H, S, D in [(1, 2, 128, 32), (2, 1, 256, 64), (1, 2, 128, 80)]:
        for dtype in (torch.float32, torch.bfloat16):
            for causal, window in ((True, 0), (True, 48), (False, 0)):
                fa_case(f"({B},{H},{S},{D})", (B, S, H, 1, D), dtype, causal,
                     window)
    # GQA, ragged sequences and head widths that are not a multiple of 16,
    # on both routes (bf16: tensor cores; float32: CUDA cores)
    for dtype in (torch.float32, torch.bfloat16):
        fa_case("GQA (2,128,2,3,32)", (2, 128, 2, 3, 32), dtype, True, 0)
        for S in (1, 100, 200):
            for causal, window in ((True, 0), (False, 30), (True, 24)):
                fa_case(f"ragged (1,{S},2,2,16)", (1, S, 2, 2, 16), dtype,
                     causal, window)
        for D in (8, 24, 40):
            fa_case(f"D={D} (1,130,2,2,{D})", (1, 130, 2, 2, D), dtype, True,
                 48)
    for dtype in (torch.bfloat16, torch.float32):
        e_fwd, e_bwd = fa_case(f"path {FA_PATH}", FA_PATH, dtype, True, 0,
                            chunk=1024)
        if dtype == torch.bfloat16:
            path_errs = {"fwd": e_fwd, "bwd": e_bwd}
    torch.cuda.empty_cache()
    return path_errs


def _wkv_inputs(seed, shape, dtype, w, card=False):
    """r, k, v, u normal in ``dtype`` and w float32 on the card, drawn with
    numpy; ``w`` is a constant or ``"uniform"`` (the reference's kernel
    tests: U(0.3, 0.99)) or ``"path"`` (exp(-exp(U(-8, 2))), the whole
    range ``_rwkv_decay`` gives) or ``"zeros"`` (U(0.3, 0.99) with a tenth
    of the entries 0 and a tenth 1e-30).  ``card``: "path" drawn on the
    card."""
    import numpy as np
    import torch
    B, H, S, K, V = shape
    if card:
        assert w == "path"
        g = _card_draws(seed)

        def normal(*sh):
            return torch.randn(sh, generator=g, device="cuda").to(dtype)
        r, k, v = normal(B, H, S, K), normal(B, H, S, K), normal(B, H, S, V)
        wv = torch.rand((B, H, S, K), generator=g, device="cuda")
        wv = torch.exp(-torch.exp(wv.mul_(10.0).sub_(8.0)))
        return r, k, v, wv, normal(H, K)
    rng = np.random.default_rng(seed)

    def draw(*sh):
        return torch.from_numpy(rng.standard_normal(sh).astype(
            np.float32)).to("cuda", dtype)
    r, k, v = draw(B, H, S, K), draw(B, H, S, K), draw(B, H, S, V)
    if w == "uniform":
        wv = rng.uniform(0.3, 0.99, (B, H, S, K))
    elif w == "path":
        wv = np.exp(-np.exp(rng.uniform(-8.0, 2.0, (B, H, S, K))))
    elif w == "zeros":
        wv = rng.uniform(0.3, 0.99, (B, H, S, K))
        pick = rng.uniform(size=wv.shape)
        wv[pick < 0.1] = 0.0
        wv[(pick >= 0.1) & (pick < 0.2)] = 1e-30
    else:
        wv = np.full((B, H, S, K), w)
    return r, k, v, torch.from_numpy(wv.astype(np.float32)).cuda(), \
        draw(H, K)


def wkv_kernel_phase() -> float:
    """The WKV kernel against its plain version (the sequential
    recurrence); returns the largest output error at the path's shape.

    Tolerances.  Float32: the reference's kernel-test bound, rtol 2e-4 and
    atol 2e-4·max(1, max|out|) -- both sum K products per step in float32
    in other orders, and as w -> 1 the outputs grow with S.  bfloat16
    inputs: the same float32 arithmetic on the same rounded inputs, so the
    bf16 outputs differ by at most one rounding step (rtol 1e-2, atol 1e-2)
    and the float32 state is held as in float32."""
    import torch

    from repro_torch.kernels.rwkv6_wkv import wkv, wkv_ref
    path_err = 0.0

    def case(tag, shape, dtype, w):
        nonlocal path_err
        r, k, v, wv, u = _wkv_inputs(0, shape, dtype, w)
        out, s_last = wkv(r, k, v, wv, u)
        torch.cuda.synchronize()
        out_r, s_r = wkv_ref(r, k, v, wv, u)
        if out.dtype != dtype or s_last.dtype != torch.float32:
            raise AssertionError(f"{tag}: {out.dtype}, {s_last.dtype}")
        if dtype == torch.float32:
            tol = (2e-4, 2e-4 * max(1.0, float(out_r.abs().max())))
        else:
            tol = (1e-2, 1e-2)
        e_out = check_close(f"wkv {tag} out", out, out_r, *tol)
        e_s = check_close(f"wkv {tag} S_last", s_last, s_r, 2e-4,
                          2e-4 * max(1.0, float(s_r.abs().max())))
        log(f"[kernels] wkv {tag} {str(dtype)[6:]} w={w}: max abs err out "
            f"{e_out:.3e} (rtol {tol[0]}, atol {tol[1]:.3g}; max|out| "
            f"{float(out_r.float().abs().max()):.4g}), S_last {e_s:.3e}")
        if shape == WKV_PATH:
            path_err = max(path_err, e_out)

    # the reference's kernel-test cases (tests/test_kernels.py)
    for shape in [(1, 2, 64, 16, 16), (2, 1, 128, 32, 32),
                  (1, 1, 96, 64, 64)]:
        case(f"{shape}", shape, torch.float32, "uniform")
    case("(1, 2, 64, 16, 16) bf16 inputs", (1, 2, 64, 16, 16),
         torch.bfloat16, "uniform")
    case("ragged (1, 2, 1000, 64, 64)", (1, 2, 1000, 64, 64), torch.float32,
         "uniform")
    case("K != V (2, 3, 77, 16, 64)", (2, 3, 77, 16, 64), torch.float32,
         "uniform")
    # where the reference's chunked form is off (its exponent clamp at 30)
    for w in (math.exp(-1.0), math.exp(-math.e ** 2)):
        case("(1, 2, 128, 64, 64)", (1, 2, 128, 64, 64), torch.float32, w)
    case("w -> 1 (1, 2, 1024, 64, 64)", (1, 2, 1024, 64, 64), torch.float32,
         math.exp(-math.exp(-8.0)))
    # where a log-domain form would break: log 0, tiny w, and w = 1
    for dtype in (torch.float32, torch.bfloat16):
        case("w with zeros and 1e-30 (1, 2, 1000, 64, 64)",
             (1, 2, 1000, 64, 64), dtype, "zeros")
    case("w = 1 (1, 2, 1024, 64, 64)", (1, 2, 1024, 64, 64), torch.float32,
         1.0)
    case("K != V, ragged (1, 2, 1023, 16, 64)", (1, 2, 1023, 16, 64),
         torch.float32, "path")
    for dtype in (torch.float32, torch.bfloat16):
        case(f"path {WKV_PATH}", WKV_PATH, dtype, "path")
    torch.cuda.empty_cache()
    return path_err


def _scan_inputs(seed, shape, dtype, a_lo=0.5, a_hi=0.999, card=False):
    """a ~ U(a_lo, a_hi) and b ~ N(0, 0.1) in ``dtype`` on the card, drawn
    with numpy (the reference's kernel tests: U(0.5, 0.999)), or on the
    card (``card``)."""
    import numpy as np
    import torch
    if card:
        g = _card_draws(seed)
        a = torch.rand(shape, generator=g, device="cuda")
        a = a.mul_(a_hi - a_lo).add_(a_lo)
        b = torch.randn(shape, generator=g, device="cuda").mul_(0.1)
        return a.to(dtype), b.to(dtype)
    rng = np.random.default_rng(seed)
    a = rng.uniform(a_lo, a_hi, shape).astype(np.float32)
    b = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    return (torch.from_numpy(a).to("cuda", dtype),
            torch.from_numpy(b).to("cuda", dtype))


def rglru_kernel_phase() -> float:
    """The RG-LRU scan kernel against its plain version (the sequential
    recurrence); returns the largest output error at the path's shape.

    Tolerances: the reference's kernel-test bounds (tests/test_kernels.py):
    float32 rtol 2e-5 and atol 2e-5·max(1, max|out|) for out (as a -> 1,
    |h| grows with S), rtol 1e-5 and atol 1e-5·max(1, max|h|) for h_last;
    bfloat16 2e-2 and 1e-2.  Both multiply, then add, in float32, step by
    step, so the errors should be 0."""
    import torch

    from repro_torch.kernels.rglru_scan import rglru_ref, rglru_scan
    path_err = 0.0

    def case(tag, shape, dtype, a_lo=0.5, a_hi=0.999):
        nonlocal path_err
        a, b = _scan_inputs(0, shape, dtype, a_lo, a_hi)
        out, h_last = rglru_scan(a, b)
        torch.cuda.synchronize()
        out_r, h_r = rglru_ref(a, b)
        if out.dtype != dtype or h_last.dtype != torch.float32 or \
                h_last.shape != (shape[0], shape[2]):
            raise AssertionError(f"{tag}: {out.dtype}, {h_last.dtype} "
                                 f"{tuple(h_last.shape)}")
        scale = max(1.0, float(out_r.float().abs().max()))
        if dtype == torch.float32:
            tol, tol_h = (2e-5, 2e-5 * scale), (1e-5, 1e-5 * scale)
        else:
            tol, tol_h = (2e-2, 2e-2), (1e-2, 1e-2)
        e_out = check_close(f"rglru {tag} out", out, out_r, *tol)
        e_h = check_close(f"rglru {tag} h_last", h_last, h_r, *tol_h)
        log(f"[kernels] rglru_scan {tag} {str(dtype)[6:]}: max abs err out "
            f"{e_out:.3e} (rtol {tol[0]}, atol {tol[1]:.3g}; max|out| "
            f"{scale:.4g}), h_last {e_h:.3e}")
        if shape == RG_SCAN_PATH:
            path_err = max(path_err, e_out)

    for dtype in (torch.float32, torch.bfloat16):
        # the reference's kernel-test cases (tests/test_kernels.py:77)
        for shape in [(2, 128, 64), (1, 256, 128), (3, 64, 256)]:
            case(f"{shape}", shape, dtype)
        case("ragged (2, 1000, 2500)", (2, 1000, 2500), dtype)
        case(f"path {RG_SCAN_PATH}", RG_SCAN_PATH, dtype)
    case("a -> 1 (2, 4096, 256)", (2, 4096, 256), torch.float32, 0.9999,
         1.0)
    torch.cuda.empty_cache()
    return path_err


def rglru_bwd_kernel_phase() -> float:
    """The RG-LRU backward kernel (the reverse scan) against its plain
    version, float32 with the forward's states handed over and bfloat16
    with them recomputed, at the training path's shape and a ragged one;
    returns the largest error at the path's shape.  Both multiply, then
    add, each rounded to float32, in step order, so they are held equal
    (rtol 0, atol 0)."""
    import torch

    from repro_torch.kernels.rglru_scan import (rglru_bwd, rglru_bwd_ref,
                                                rglru_scan)
    path_err = 0.0
    for shape in (RG_TRAIN_PATH, (3, 1000, 2500)):
        for dtype in (torch.float32, torch.bfloat16):
            a, b = _scan_inputs(2, shape, dtype)
            dout, _ = _scan_inputs(3, shape, dtype)
            dh = _scan_inputs(4, (shape[0], 1, shape[2]),
                              torch.float32)[1][:, 0].contiguous()
            h = rglru_scan(a, b)[0] if dtype == torch.float32 else None
            got = rglru_bwd(a, b, dout, dh, h)
            torch.cuda.synchronize()
            want = rglru_bwd_ref(a, b, dout, dh, h)
            err = 0.0
            for n, g, w in zip(("da", "db"), got, want):
                if g.dtype != dtype:
                    raise AssertionError(f"rglru bwd {n}: {g.dtype}")
                err = max(err, check_close(f"rglru bwd {shape} {n}", g, w,
                                           0.0, 0.0))
            how = "handed over" if h is not None else "recomputed"
            log(f"[kernels] rglru_scan backward {shape} {str(dtype)[6:]} "
                f"(states {how}): max abs err {err:.3e} (held equal)")
            if shape == RG_TRAIN_PATH:
                path_err = max(path_err, err)
            del a, b, dout, got, want, h
    torch.cuda.empty_cache()
    return path_err


def wkv_bwd_kernel_phase() -> float:
    """The WKV backward kernel against its plain version (the reverse
    sweep over the sequential recurrence's states) on the path's shape in
    bfloat16, float32 cases with a ragged tail, K != V, decays with zeros
    and w -> 1, and a gradient of S_last, a sequence of one whole chunk
    and one shorter than a chunk; each bit-equal over two launches;
    returns the largest error at the path's shape.

    Tolerances.  Float32: rtol 2e-4 and atol 2e-4·max(1, max|grad|), the
    forward's bound: both sum K or V products a step in float32 in other
    orders, and dS carries its rounding back over the sequence.  bfloat16
    outputs (dr, dk, dv, du): the same float32 arithmetic rounded once, so
    within 1e-2·max(1, max|grad|); dw is float32 and held as in float32."""
    import torch

    from repro_torch.kernels.rwkv6_wkv import wkv_bwd, wkv_bwd_ref
    path_err = 0.0

    def case(tag, shape, dtype, w, with_ds=False):
        nonlocal path_err
        import numpy as np
        r, k, v, wv, u = _wkv_inputs(5, shape, dtype, w)
        B, H, S, K, V = shape
        rng = np.random.default_rng(6)
        dout = torch.from_numpy(rng.standard_normal((B, H, S, V)).astype(
            np.float32)).to("cuda", dtype)
        ds = torch.from_numpy(rng.standard_normal((B, H, K, V)).astype(
            np.float32)).cuda() if with_ds else None
        got = wkv_bwd(r, k, v, wv, u, dout, ds)
        again = wkv_bwd(r, k, v, wv, u, dout, ds)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"wkv bwd {tag}: two launches differ")
        del again
        want = wkv_bwd_ref(r, k, v, wv, u, dout, ds)
        err = 0.0
        for n, g, x in zip(("dr", "dk", "dv", "dw", "du"), got, want):
            if g.dtype != x.dtype or g.shape != x.shape:
                raise AssertionError(f"wkv bwd {tag} {n}: {g.dtype} "
                                     f"{tuple(g.shape)}")
            scale = max(1.0, float(x.float().abs().max()))
            tol = (1e-2, 1e-2 * scale) if g.dtype == torch.bfloat16 else \
                (2e-4, 2e-4 * scale)
            err = max(err, check_close(f"wkv bwd {tag} {n}", g, x, *tol))
        log(f"[kernels] wkv backward {tag} {str(dtype)[6:]} w={w}"
            f"{' dS_last given' if with_ds else ''}: max abs err {err:.3e}")
        if shape == WKV_TRAIN_PATH:
            path_err = max(path_err, err)
        del r, k, v, wv, u, dout, got, want

    case("(1, 2, 64, 16, 16)", (1, 2, 64, 16, 16), torch.float32, "uniform",
         with_ds=True)
    case("ragged (2, 3, 1000, 64, 64)", (2, 3, 1000, 64, 64), torch.float32,
         "path", with_ds=True)
    case("K != V ragged (1, 2, 77, 16, 64)", (1, 2, 77, 16, 64),
         torch.float32, "uniform")
    case("K != V (1, 2, 100, 64, 32)", (1, 2, 100, 64, 32), torch.float32,
         "uniform")
    case("w with zeros and 1e-30 (1, 2, 1000, 64, 64)",
         (1, 2, 1000, 64, 64), torch.float32, "zeros")
    case("w -> 1 (1, 2, 1024, 64, 64)", (1, 2, 1024, 64, 64),
         torch.float32, math.exp(-math.exp(-8.0)))
    case("one chunk (1, 1, 16, 64, 64)", (1, 1, 16, 64, 64), torch.float32,
         "uniform", with_ds=True)
    case("K != V (1, 2, 100, 32, 16)", (1, 2, 100, 32, 16), torch.float32,
         "zeros", with_ds=True)
    case("ragged (2, 3, 1000, 64, 64)", (2, 3, 1000, 64, 64),
         torch.bfloat16, "path")
    case("shorter than a chunk (1, 2, 5, 64, 64)", (1, 2, 5, 64, 64),
         torch.bfloat16, "uniform", with_ds=True)
    case(f"path {WKV_TRAIN_PATH}", WKV_TRAIN_PATH, torch.bfloat16, "path")
    torch.cuda.empty_cache()
    return path_err


def flash256_kernel_phase() -> float:
    """The attention forward at head width 256 (recurrentgemma-2b's local
    layers: MQA, G = 10, window 2,048) against its plain version, with
    ``FA_TOL``'s forward bounds, then forward and backward at head width
    256 over 3,000 tokens, windows 1,024 and 2,048 and none, on both
    routes, and bf16 at G = 1, at a ragged tail and without a mask;
    returns the largest forward error at the path's shape."""
    import torch

    from repro_torch.kernels.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_ref)
    path_err = 0.0
    for shape in ((1, 3000, 1, 10, 256), RG_FA_PATH):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, _ = _fa_inputs(0, shape, dtype)
            kw = dict(causal=True, window=RG_WINDOW, q_chunk=1024,
                      kv_chunk=1024)
            out, lse = flash_attention_fwd(q, k, v, **kw)
            torch.cuda.synchronize()
            out_r, lse_r = flash_attention_fwd_ref(q, k, v, **kw)
            name = str(dtype)[6:]
            fr, fa = FA_TOL[name][0]
            e = max(check_close(f"fa256 {shape} out", out, out_r, fr, fa),
                    check_close(f"fa256 {shape} lse", lse, lse_r, 1e-5,
                                1e-5))
            log(f"[kernels] flash_attention forward {shape} {name} causal "
                f"window={RG_WINDOW}: max abs err {e:.3e} (rtol {fr}, atol "
                f"{fa})")
            if shape == RG_FA_PATH and dtype == torch.bfloat16:
                path_err = e
            del q, k, v, out, lse, out_r, lse_r
    # the backward at head width 256: gemma3's GQA (KV 8, G 2) and
    # recurrentgemma's MQA (G 10), their windows and none, a ragged tail
    for window in (1024, 2048, 0):
        fa_case("D=256 (1,3000,8,2,256)", (1, 3000, 8, 2, 256),
                torch.bfloat16, True, window, chunk=1024)
        fa_case("D=256 (1,3000,1,2,256)", (1, 3000, 1, 2, 256),
                torch.float32, True, window, chunk=1024)
    fa_case("D=256 MQA (1,3000,1,10,256)", (1, 3000, 1, 10, 256),
            torch.bfloat16, True, RG_WINDOW, chunk=1024)
    # the two-warpgroup kernels at G = 1, at a ragged tail, not causal
    fa_case("D=256 G=1 (1,200,2,1,256)", (1, 200, 2, 1, 256),
            torch.bfloat16, True, 0)
    fa_case("D=256 ragged (2,100,1,3,256)", (2, 100, 1, 3, 256),
            torch.bfloat16, True, 48)
    fa_case("D=256 non-causal (1,200,2,2,256)", (1, 200, 2, 2, 256),
            torch.bfloat16, False, 0)
    fa_case("D=192 (1,300,2,2,192)", (1, 300, 2, 2, 192), torch.bfloat16,
            True, 100)
    fa_case("D=192 (1,300,2,2,192)", (1, 300, 2, 2, 192), torch.float32,
            True, 100)
    torch.cuda.empty_cache()
    return path_err


#: the attention forwards of the granite serve path and the zoo, each at
#: its path's shape: (tag, row name in the ``kernels`` line, (B, S, KV,
#: G, D), causal, window, the archs whose layers launch it); a row takes
#: its launches from those archs' counts, the windowed ones where it has
#: a window, the others where it has none
ZOO_FA_PATHS = (
    ("granite", "granite", GRANITE_FA_PATH, True, 0,
     ("granite-moe-3b-a800m",)),
    ("d128 G5 (qwen3, llama4)", "d128_g5", (2, 1024, 8, 5, 128), True, 0,
     ("qwen3-14b", "llama4-maverick-400b-a17b")),
    ("d128 G6 (internvl2)", "d128_g6", (2, 1024, 8, 6, 128), True, 0,
     ("internvl2-26b",)),
    ("d128 G8 (deepseek)", "d128_g8", (2, 1024, 8, 8, 128), True, 0,
     ("deepseek-67b",)),
    ("d80 non-causal (hubert)", "d80_noncausal", (2, 1024, 16, 1, 80),
     False, 0, ("hubert-xlarge",)),
    ("d256 G2 window 1024 (gemma3 local)", "d256_w1024",
     (2, 1024, 8, 2, 256), True, 1024, ("gemma3-12b",)),
    ("d256 G2 (gemma3 global)", "d256_g2", (2, 1024, 8, 2, 256), True, 0,
     ("gemma3-12b",)))
#: the same widths where the window or the padding bites: a window of
#: 1,024 over 3,000 tokens, and ragged sequences (no row, no path)
ZOO_FA_EXTRA = (
    ("d256 G2 window 1024, 3000 tokens", None, (1, 3000, 8, 2, 256), True,
     1024, ()),
    ("d80 non-causal ragged", None, (1, 1500, 16, 1, 80), False, 0, ()),
    ("d80 causal window 300 ragged", None, (1, 700, 4, 2, 80), True, 300,
     ()),
    ("d128 G5 ragged", None, (1, 1000, 8, 5, 128), True, 0, ()))


def zoo_kernel_phase() -> dict:
    """The attention forward at the head widths and group sizes that the
    MoE serve path and the zoo give it (64 at G = 3; 128 at G = 5, 6, 8;
    80 non-causal; 256 at G = 2 with a window of 1,024), in bf16 (tensor
    cores) and float32 (CUDA cores), against its plain version with
    ``FA_TOL``'s forward bounds; returns the largest bf16 error at each
    path shape, by tag."""
    import torch

    from repro_torch.kernels.flash_attention import (
        flash_attention_fwd, flash_attention_fwd_ref)
    from repro_torch.kernels.flash_attention.ops import kernel_route
    errs = {}
    for tag, _, shape, causal, window, _ in ZOO_FA_PATHS + ZOO_FA_EXTRA:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, _ = _fa_inputs(0, shape, dtype)
            kw = dict(causal=causal, window=window, q_chunk=1024,
                      kv_chunk=1024)
            out, lse = flash_attention_fwd(q, k, v, **kw)
            torch.cuda.synchronize()
            out_r, lse_r = flash_attention_fwd_ref(q, k, v, **kw)
            name = str(dtype)[6:]
            fr, fa = FA_TOL[name][0]
            e = max(check_close(f"fa {tag} {shape} out", out, out_r, fr, fa),
                    check_close(f"fa {tag} {shape} lse", lse, lse_r, 1e-5,
                                1e-5))
            log(f"[kernels] flash_attention forward {tag} {shape} {name} "
                f"causal={causal} window={window} "
                f"({kernel_route(dtype, shape[4])}): max abs err {e:.3e} "
                f"(rtol {fr}, atol {fa})")
            if dtype == torch.bfloat16:
                errs[tag] = e
            del q, k, v, out, lse, out_r, lse_r
    torch.cuda.empty_cache()
    return errs


# --------------------------------------------------------------------- #
# 4-8. the paths
# --------------------------------------------------------------------- #
class PhaseTimer:
    """Host clock around each trainer phase, synchronised with the card at
    both ends, so a phase's time includes its kernels."""

    def __init__(self, sync: bool, phases=PHASES):
        self.sync = sync
        self.ms = {p: [] for p in phases}

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


def _mlp_trainer(scheme, device, timer):
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
    return CodedTrainer(None, spec, scheme, data, adamw(1e-3), params=params,
                        loss_fn=mlp_loss, seed=0, device=device,
                        phase_timer=timer)


def _check_params(tag, params):
    import torch

    from repro_torch.optim.optimizers import tree_leaves
    for p in tree_leaves(params):
        if p.device.type != "cuda":
            raise AssertionError(f"{tag}: params left the card")
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"{tag}: non-finite params")


def mlp_phase():
    """Returns (launches during the path, its logs, its phase timer)."""
    import numpy as np
    import torch

    timer = PhaseTimer(sync=True)
    trainers = [_mlp_trainer(s, "cuda", timer) for s in SCHEMES]
    torch.cuda.synchronize()
    # ---- the path: counts zeroed just before, read just after ----
    reset_counts()
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
                    tr.last_decoded, tr.last_full_grad, 1e-4, 1e-5))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    # ---------------------------------------------------------------------
    n_decoded = sum(lg.decode_ok for v in logs.values() for lg in v)
    log(f"[mlp] {len(SCHEMES)} schemes x {EPOCHS} epochs on the card in "
        f"{wall:.2f} s; {n_decoded} decoded; launches {launches}; decoded "
        f"vs full-batch max abs err {max(decode_errs, default=0.0):.3e}")
    if n_decoded == 0 or launches["coded_reduce"] != n_decoded:
        raise AssertionError(f"coded_reduce launched "
                             f"{launches['coded_reduce']} times for "
                             f"{n_decoded} decoded epochs")
    for scheme, tr in zip(SCHEMES, trainers):
        _check_params(scheme, tr.params)
    for scheme in SCHEMES:
        for lg in logs[scheme]:
            log(f"[mlp] {scheme} epoch {lg.epoch}: decode_ok="
                f"{lg.decode_ok} slots={lg.n_slots} uploads={lg.n_uploads} "
                f"sim_time={lg.time:.4f} loss={lg.loss:.6f}")

    # the same trainers on the CPU: equal co-simulated outcomes, close
    # losses (cuBLAS and the CPU's BLAS sum float32 in other orders)
    t0 = time.perf_counter()
    for scheme in SCHEMES:
        tr = _mlp_trainer(scheme, "cpu", None)
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
    log(f"[mlp] the same {len(SCHEMES) * EPOCHS} epochs on the CPU agree "
        f"({time.perf_counter() - t0:.1f} s)")
    del trainers
    return launches, logs, timer


def lm_phase():
    """The transformer path.  Returns (launches, logs, phase timer, peak
    device bytes, payload bytes)."""
    import torch

    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.optimizers import adamw
    from repro_torch.sim import scenario_spec
    from repro_torch.train import CodedTrainer

    cfg = lm_config()
    spec = scenario_spec(SCENARIO)
    D = lm_payload()
    # one upload is one payload unit: grad_bytes = 1.0, the scale the
    # scenarios were tuned for (4 MiB a unit would make it 588 units)
    bytes_per_unit = 4.0 * D
    log(f"[lm] {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab}, {cfg.n_layers} of 24 layers, "
        f"compute {cfg.compute_dtype}, remat {cfg.remat}; D = {D} "
        f"({4 * D} bytes a gradient); bytes_per_unit = {bytes_per_unit:.0f}"
        f" -> grad_bytes 1.0")
    params0 = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                          device="cuda")
    data = SyntheticLMDataset(spec.K, 1, LM_SEQ, cfg.vocab, seed=0,
                              device="cuda")
    timer = PhaseTimer(sync=True)
    logs = {}
    decode_errs = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the path: counts zeroed just before, read just after ----
    reset_counts()
    t0 = time.perf_counter()
    for scheme in SCHEMES:
        tr = CodedTrainer(cfg, spec, scheme, data, adamw(1e-3),
                          params=params0, seed=0,
                          bytes_per_unit=bytes_per_unit, device="cuda",
                          phase_timer=timer)
        if tr.grad_bytes != 1.0 or tr.partition.D != D:
            raise AssertionError(f"payload {tr.partition.D} entries, "
                                 f"{tr.grad_bytes} units")
        logs[scheme] = []
        for epoch in range(LM_EPOCHS):
            before = (tr.params, tr.opt_state)
            lg = tr.run_epoch(epoch)
            logs[scheme].append(lg)
            if lg.decode_ok:
                if not math.isfinite(lg.loss):
                    raise AssertionError(f"{scheme} epoch {epoch}: loss "
                                         f"{lg.loss}")
                decode_errs.append(check_close(
                    f"{scheme} epoch {epoch} decoded vs full-batch gradient",
                    tr.last_decoded, tr.last_full_grad, 1e-4, 1e-5))
            elif tr.params is not before[0] or \
                    tr.opt_state is not before[1] or \
                    not math.isnan(lg.loss):
                raise AssertionError(f"{scheme} epoch {epoch}: a failed "
                                     f"decode stepped the model")
            log(f"[lm] {scheme} epoch {epoch}: decode_ok={lg.decode_ok} "
                f"slots={lg.n_slots} uploads={lg.n_uploads} sim_time="
                f"{lg.time:.4f} loss={lg.loss:.6f}")
        _check_params(scheme, tr.params)
        del tr, before
        gc.collect()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    # ---------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    n_epochs = len(SCHEMES) * LM_EPOCHS
    n_decoded = sum(lg.decode_ok for v in logs.values() for lg in v)
    K, L = spec.K, cfg.n_layers
    remat = 2 if cfg.remat in ("full", "dots") else 1
    want = no_launches(coded_reduce=n_decoded,
                       flash_attention_fwd=remat * K * L * n_epochs,
                       flash_attention_bwd=K * L * n_epochs)
    log(f"[lm] {len(SCHEMES)} schemes x {LM_EPOCHS} epochs on the card in "
        f"{wall:.2f} s; {n_decoded} decoded; launches {launches} (the path "
        f"implies {want}); decoded vs full-batch max abs err "
        f"{max(decode_errs, default=0.0):.3e}; peak device memory "
        f"{peak / 1e9:.2f} GB")
    if n_decoded == 0:
        raise AssertionError("no epoch decoded: coded_reduce was never on "
                             "the path")
    if launches != want:
        raise AssertionError(f"launch counts {launches}, the path implies "
                             f"{want}")
    del params0
    gc.collect()
    torch.cuda.empty_cache()
    return launches, logs, timer, peak, 4 * D


def tiny_phase():
    """``repro_torch.train.e2e`` at TINY, 5 seeds x 4 schemes x 2 epochs,
    on the card and on the CPU from the same weights."""
    import numpy as np
    import torch

    from repro_torch.models.transformer import init_params
    from repro_torch.train import e2e

    params = init_params(e2e.TINY, torch.Generator().manual_seed(0),
                         device="cpu")
    t0 = time.perf_counter()
    card = e2e.run_benchmark(e2e.TINY, n_seeds=5, params=params,
                             device="cuda")
    t1 = time.perf_counter()
    cpu = e2e.run_benchmark(e2e.TINY, n_seeds=5, params=params, device="cpu")
    for scheme in SCHEMES:
        for seed, (cg, cc) in enumerate(zip(card["schemes"][scheme]["curves"],
                                            cpu["schemes"][scheme]["curves"])):
            if (cg["decode_ok"], cg["wall_clock"]) != \
                    (cc["decode_ok"], cc["wall_clock"]):
                raise AssertionError(f"TINY {scheme} seed {seed}: card "
                                     f"{cg['decode_ok']} {cg['wall_clock']},"
                                     f" CPU {cc['decode_ok']} "
                                     f"{cc['wall_clock']}")
            # AdamW's first step moves an entry whose gradient cancels to
            # float32 noise by up to lr, so later losses agree to ~1e-4
            lg = np.array(cg["loss"], dtype=float)
            lc = np.array(cc["loss"], dtype=float)
            if not np.allclose(lg, lc, rtol=1e-3, atol=0.0, equal_nan=True):
                raise AssertionError(f"TINY {scheme} seed {seed}: losses "
                                     f"{lg} on the card, {lc} on the CPU")
    speedups = (card["speedup_vs_uncoded"], card["speedup_vs_cyclic"])
    if speedups != (cpu["speedup_vs_uncoded"], cpu["speedup_vs_cyclic"]) \
            or abs(speedups[0] - 1.3444444444444443) > 1e-9 \
            or abs(speedups[1] - 1.4) > 1e-9:
        raise AssertionError(f"TINY speedups {speedups} on the card, "
                             f"{cpu['speedup_vs_uncoded']}, "
                             f"{cpu['speedup_vs_cyclic']} on the CPU")
    log(f"[tiny] e2e TINY, 5 seeds x 4 schemes x 2 epochs: card "
        f"{t1 - t0:.1f} s, CPU {time.perf_counter() - t1:.1f} s; equal "
        f"decode outcomes and simulated times; two-stage "
        f"{speedups[0]:.4f}x vs uncoded, {speedups[1]:.4f}x vs cyclic")


# --------------------------------------------------------------------- #
# the paper's experiment (FELTrainer) and the LM training loop
# --------------------------------------------------------------------- #
#: FELTrainer runs: 4 schemes x these backends, SGD-momentum (the AdamW
#: parity limit of ROADMAP.md §3 rules AdamW out of an rtol 1e-5 check)
FEL_BACKENDS = ("instant", "cluster")
FEL_PHASES = ("plan", "draw", "stack", "copy", "step")
FEL_LR = 1e-2
FEL_M1 = 3
#: examples a partition of the card-vs-CPU runs
FEL_SMALL = 64
#: C1: every scheme's params against the straggler-free uncoded run's
C1_TOL = (1e-5, 1e-6)
FEL_HOST_FIELDS = ("time", "utilization", "n_stragglers", "redundancy",
                   "efficiency", "compute_time", "comm_time", "decode_ok")
#: ``launch.train.train`` at stablelm-1.6b full size (24 layers)
LM_TRAIN = dict(steps=3, batch=1, seq=1024, workers=6, straggler_prob=0.2,
                lr=3e-4)
#: sequences of 1,024 tokens in the plain step
LM_PLAIN_BATCH = 4
#: the coded gradient against the full-batch gradient (relative error in
#: norm, of the whole gradient and of its largest leaf), read against the
#: gradient's own conditioning in bf16: it must be within the change that
#: ``nudge_sensitivity``'s nudge (every float32 weight moved by -1, 0 or
#: +1 ulp) makes in the full-batch gradient, and within this many times
#: the difference of two exact routes to the full-batch gradient that
#: round in other places (one batch of the K sequences against the sum of
#: two half batches).  The first measurement (an H100 80GB HBM3 at 700 W,
#: full size): coded 2.4e-5 in norm (1.9e-4 in the largest leaf), the two
#: routes 9.0e-4 (2.3e-3), the nudge 1.27: at these random weights a
#: one-ulp nudge moves the gradient by more than its norm, so the nudge
#: bounds nothing and the routes' difference carries the check.  On the
#: CPU, at a 2-layer cut of the REDUCED config, the coded error was 1.1-1.4x
#: the routes' difference.
GRAD_ROUTE_FACTOR = 4.0


class _Memo:
    """A dataset whose partitions are drawn once and kept: the runs of the
    FEL phase see the same bytes, and only the first run pays the draws."""

    def __init__(self, data):
        self.data, self.K, self.memo = data, data.K, {}

    def partition(self, epoch, k):
        if (epoch, k) not in self.memo:
            self.memo[(epoch, k)] = self.data.partition(epoch, k)
        return self.memo[(epoch, k)]


def _fel_runs(n, device, timed: bool):
    """4 schemes x ``FEL_BACKENDS`` x ``EPOCHS`` of ``FELTrainer`` with the
    paper's MLP, ``n`` examples a partition, on ``device``; returns
    ``{(backend, scheme): (logs, flat params, timer)}``."""
    import torch

    from repro_torch.core.fel import FELTrainer
    from repro_torch.data.pipeline import SyntheticClassificationDataset
    from repro_torch.models.mlp import init_mlp, per_slot_mlp_loss
    from repro_torch.optim.optimizers import sgd_momentum, tree_leaves
    from repro_torch.sim import scenario_spec

    spec = scenario_spec(SCENARIO)
    params = init_mlp(torch.Generator().manual_seed(0), DIMS, device="cpu")
    data = _Memo(SyntheticClassificationDataset(
        spec.K, n, DIMS[0], DIMS[-1], seed=0, device="cpu"))
    out = {}
    for backend in FEL_BACKENDS:
        kw = (dict(cluster=spec) if backend == "cluster" else
              dict(M1=FEL_M1, s=1, noise_scale=0.0))
        for scheme in SCHEMES:
            timer = PhaseTimer(device == "cuda", FEL_PHASES) if timed \
                else None
            tr = FELTrainer(scheme, spec.M, spec.K, data, per_slot_mlp_loss,
                            sgd_momentum(FEL_LR), params, seed=0,
                            device=device, phase_timer=timer, **kw)
            logs = tr.run(EPOCHS)
            flat = torch.cat([p.reshape(-1) for p in tree_leaves(tr.params)])
            out[(backend, scheme)] = (logs, flat, timer)
    return out


def fel_phase() -> dict:
    """The paper's experiment on the card: ``FELTrainer``, the MLP at its
    full size, 4 schemes x 2 backends x 3 epochs; C1 against the
    straggler-free uncoded run; the same runs on the CPU and the card at
    ``FEL_SMALL`` examples.  Returns the runs' phase timers."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_counts()
    runs = _fel_runs(EXAMPLES_PER_PARTITION, "cuda", timed=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    log(f"[fel] MLP {DIMS}, {EXAMPLES_PER_PARTITION} examples a partition, "
        f"SGD-momentum({FEL_LR}): {len(SCHEMES)} schemes x "
        f"{len(FEL_BACKENDS)} backends x {EPOCHS} epochs on the card in "
        f"{wall:.2f} s; launches {launches} (the loss-weighted step "
        f"decodes inside its one backward: no kernel of the port)")
    if launches != no_launches():
        raise AssertionError(f"the FEL path launched {launches}")
    for (backend, scheme), (logs, flat, timer) in runs.items():
        for lg in logs:
            if math.isnan(lg.loss) == lg.decode_ok:
                raise AssertionError(f"{backend} {scheme} epoch "
                                     f"{lg.epoch}: decode_ok "
                                     f"{lg.decode_ok}, loss {lg.loss}")
            ms = {p: timer.ms[p][lg.epoch] for p in FEL_PHASES}
            log(f"[fel] {backend} {scheme} epoch {lg.epoch}: decode_ok="
                f"{lg.decode_ok} time={lg.time:.4f} compute="
                f"{lg.compute_time:.4f} comm={lg.comm_time:.4f} util="
                f"{lg.utilization:.3f} stragglers={lg.n_stragglers} "
                f"redundancy={lg.redundancy:.3f} loss={lg.loss:.6f}; ms "
                + ", ".join(f"{p} {v:.1f}" for p, v in ms.items()))
        if not torch.isfinite(flat).all():
            raise AssertionError(f"{backend} {scheme}: non-finite params")
    # C1: exact gradient recovery, whatever the stragglers
    ref = runs[("instant", "uncoded")][1]
    n_c1 = 0
    for (backend, scheme), (logs, flat, _) in runs.items():
        if not all(lg.decode_ok for lg in logs):
            log(f"[fel] C1 {backend} {scheme}: a failed decode (a zero-"
                f"weight step), not compared")
            continue
        err = check_close(f"C1 {backend} {scheme} vs straggler-free "
                          f"uncoded", flat, ref, *C1_TOL)
        n_c1 += 1
        log(f"[fel] C1 {backend} {scheme} "
            f"({sum(lg.n_stragglers for lg in logs)} stragglers in "
            f"{EPOCHS} epochs) vs straggler-free uncoded: max abs err "
            f"{err:.3e} (rtol {C1_TOL[0]}, atol {C1_TOL[1]})")
    if n_c1 < len(SCHEMES):
        raise AssertionError(f"C1 compared only {n_c1} runs")
    # the same runs on the CPU and on the card at FEL_SMALL examples
    t1 = time.perf_counter()
    cpu = _fel_runs(FEL_SMALL, "cpu", timed=False)
    card = _fel_runs(FEL_SMALL, "cuda", timed=False)
    worst = 0.0
    for key, (logs, flat, _) in cpu.items():
        for lc, lg in zip(logs, runs[key][0]):
            got = tuple(getattr(lc, f) for f in FEL_HOST_FIELDS)
            want = tuple(getattr(lg, f) for f in FEL_HOST_FIELDS)
            if got != want:
                raise AssertionError(f"{key} epoch {lc.epoch}: CPU {got}, "
                                     f"card {want}")
        worst = max(worst, check_close(f"{key} params, CPU vs card",
                                       flat, card[key][1].cpu(), *C1_TOL))
    log(f"[fel] the same runs at {FEL_SMALL} examples a partition on the "
        f"CPU: host outcomes ({', '.join(FEL_HOST_FIELDS)}) equal to the "
        f"card's full-size runs in every epoch; params against the card's "
        f"at {FEL_SMALL}: max abs err {worst:.3e} (rtol {C1_TOL[0]}, atol "
        f"{C1_TOL[1]}); {time.perf_counter() - t1:.1f} s")
    timers = {key: timer for key, (_, _, timer) in runs.items()}
    del runs, cpu, card
    torch.cuda.empty_cache()
    log(f"[fel] phase wall time {time.perf_counter() - t0:.1f} s")
    return {"wall_s": wall, "timers": timers}


def _rel_errs(got, want) -> tuple:
    """(relative error in norm of the whole tree, of its largest leaf, the
    largest leaf's shape), summed in float64 over slices of each leaf, so
    that no float64 copy of a whole leaf is made."""
    from repro_torch.optim.optimizers import tree_leaves

    def sq(g, w):
        num = den = 0.0
        g, w, step = g.reshape(-1), w.reshape(-1), 1 << 24
        for i in range(0, w.numel(), step):
            a, b = g[i:i + step].double(), w[i:i + step].double()
            num += float((a - b).square().sum())
            den += float(b.square().sum())
        return num, den
    pairs = list(zip(tree_leaves(got), tree_leaves(want)))
    sums = [sq(g, w) for g, w in pairs]
    big = max(range(len(pairs)), key=lambda i: pairs[i][1].numel())
    return (math.sqrt(sum(n for n, _ in sums) / sum(d for _, d in sums)),
            math.sqrt(sums[big][0] / sums[big][1]),
            tuple(pairs[big][1].shape))


def lm_train_phase() -> dict:
    """``repro_torch.launch.train.train`` at stablelm-1.6b's full size: the
    coded path, the plain path, and the coded gradient against the
    full-batch gradient."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.coded_step import (_value_and_grad,
                                             make_coded_train_step,
                                             slot_batch)
    from repro_torch.core.runtime import TwoStageRuntime
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.launch.train import per_slot_lm_loss, train
    from repro_torch.models.transformer import init_params, loss_fn
    from repro_torch.optim.optimizers import Optimizer, tree_leaves

    cfg = get_config("stablelm-1.6b")
    L, S, M = cfg.n_layers, LM_TRAIN["seq"], LM_TRAIN["workers"]
    t_phase = time.perf_counter()
    log(f"[lmtrain] {cfg.name}: {L} layers (full depth), d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, compute {cfg.compute_dtype}, "
        f"remat {cfg.remat}; coded: M = {M} workers, K = {2 * M} "
        f"partitions of {LM_TRAIN['batch']} x {S} tokens, AdamW("
        f"{LM_TRAIN['lr']})")
    def say(msg):
        log(f"[lmtrain] {msg}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = train(cfg, coded=True, device="cuda", log_every=1, log=say,
                **LM_TRAIN)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    n = LM_TRAIN["steps"]
    want = no_launches(flash_attention_fwd=2 * L * n,
                       flash_attention_bwd=L * n)
    for i, step in enumerate(out["step"]):
        log(f"[lmtrain] coded step {step}: n_slots {out['n_slots'][i]} -> "
            f"{M * out['n_slots'][i]} sequences of {S}, decode_ok "
            f"{out['decode_ok'][i]}, sim_time {out['sim_time'][i]:.4f}, "
            f"loss {out['loss'][i]:.6f}; ms: plan "
            f"{out['plan_ms'][i]:.1f}, data {out['data_ms'][i]:.1f}, step "
            f"{out['step_ms'][i]:.1f}")
    log(f"[lmtrain] coded path: launches {launches} (the path implies "
        f"{want}: forward twice a layer under remat, backward once); peak "
        f"device memory {peak} bytes ({peak / 1e9:.2f} GB)")
    if launches != want:
        raise AssertionError(f"launch counts {launches}, the path implies "
                             f"{want}")
    if not all(math.isfinite(x) for x in out["loss"]):
        raise AssertionError(f"coded losses {out['loss']}")
    coded = {k: out[k] for k in ("n_slots", "step_ms", "plan_ms",
                                 "data_ms", "loss")}
    coded.update(peak=peak, launches=launches,
                 shape=(M * max(out["n_slots"]), S, cfg.n_kv_heads,
                        cfg.n_heads // cfg.n_kv_heads, cfg.head_dim))
    del out
    gc.collect()
    torch.cuda.empty_cache()
    # the attention kernels at the largest shape the coded path gave them
    coded["fa_errs"] = fa_case(f"lm_train path {coded['shape']}",
                               coded["shape"], torch.bfloat16, True, 0,
                               chunk=1024)
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out = train(cfg, steps=1, batch=LM_PLAIN_BATCH, seq=S, lr=LM_TRAIN["lr"],
                coded=False, device="cuda", log=say)
    torch.cuda.synchronize()
    launches = read_counts()
    plain_peak = torch.cuda.max_memory_allocated()
    want = no_launches(flash_attention_fwd=2 * L, flash_attention_bwd=L)
    log(f"[lmtrain] plain step ({LM_PLAIN_BATCH} x {S} tokens, clip_norm "
        f"1.0): {out['step_ms'][0]:.1f} ms, loss {out['loss'][0]:.6f}, "
        f"grad norm {out['grad_norm'][0]:.4f}; launches {launches} (the "
        f"path implies {want}); peak {plain_peak / 1e9:.2f} GB")
    if launches != want or not math.isfinite(out["loss"][0]):
        raise AssertionError(f"plain step: launches {launches}, loss "
                             f"{out['loss']}")
    plain = {"step_ms": out["step_ms"][0], "peak": plain_peak,
             "launches": launches}
    del out
    gc.collect()
    torch.cuda.empty_cache()

    # the coded gradient of one step against the gradient of the sum of
    # the K partitions' mean CE, taken directly (transformer.loss_fn over
    # the K sequences, each partition's weights summing to one)
    counts = read_counts()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                         device="cuda")
    runtime = TwoStageRuntime(M, 2 * M, max(M // 2, 2),
                              rates=np.linspace(1.0, 4.0, M),
                              straggler_prob=LM_TRAIN["straggler_prob"],
                              seed=0)
    epoch = 0
    res = runtime.run_epoch(epoch)
    while not res.decode_ok:
        epoch += 1
        res = runtime.run_epoch(epoch)
    data = SyntheticLMDataset(2 * M, LM_TRAIN["batch"], S, cfg.vocab,
                              device="cpu")
    seen = []

    def capture(grads, state, p):
        seen.append(grads)
        return p, state
    step = make_coded_train_step(per_slot_lm_loss(cfg),
                                 Optimizer(init=lambda p: (), update=capture))
    _, _, aux = step(params, (), slot_batch(data, epoch, res.plan, "cuda"),
                     torch.as_tensor(res.weights, dtype=torch.float32,
                                     device="cuda"))
    g_coded = seen.pop()
    parts = [data.partition(epoch, k) for k in range(2 * M)]
    full = {key: torch.cat([p[key] for p in parts]).to("cuda")
            for key in parts[0]}
    direct = _value_and_grad(lambda p, b: loss_fn(p, b, cfg))
    loss_d, g_direct = direct(params, full)
    err = _rel_errs(g_coded, g_direct)
    del g_coded
    halves = [{key: v[i:i + M] for key, v in full.items()}
              for i in (0, M)]
    g_route = direct(params, halves[0])[1]
    for a, b in zip(tree_leaves(g_route),
                    tree_leaves(direct(params, halves[1])[1])):
        a.add_(b)
    route = _rel_errs(g_route, g_direct)
    del g_route
    nudged = ulp_nudge(params)
    del params
    sens = _rel_errs(direct(nudged, full)[1], g_direct)
    del nudged, g_direct
    torch.cuda.synchronize()
    check_launches = {k: v - counts[k] for k, v in read_counts().items()}
    set_counts(counts)                   # these launches are not a path's
    log(f"[lmtrain] decoded vs full-batch gradient (epoch {epoch}, "
        f"{res.plan.n_slots} slots, {M * res.plan.n_slots} sequences, "
        f"against the {2 * M} partitions once), relative error in norm of "
        f"the whole gradient and of its largest leaf {err[2]}: "
        f"{err[0]:.3e}, {err[1]:.3e}; two exact routes (one batch, two "
        f"halves): {route[0]:.3e}, {route[1]:.3e}; a one-ulp nudge of "
        f"every weight: {sens[0]:.3e}, {sens[1]:.3e}; bound: the nudge's "
        f"and {GRAD_ROUTE_FACTOR} x the routes'; losses coded "
        f"{float(aux['loss']):.6f}, direct {float(loss_d):.6f}; launches "
        f"of the check (apart) {check_launches}; "
        f"{time.perf_counter() - t0:.1f} s")
    for i in (0, 1):
        if not err[i] <= min(sens[i], GRAD_ROUTE_FACTOR * route[i]) < 1.0:
            raise AssertionError(f"decoded gradient off the full-batch "
                                 f"one: {err[:2]} against {sens[:2]} and "
                                 f"{GRAD_ROUTE_FACTOR} x {route[:2]} (the "
                                 f"bound must stay under 1)")
    if not math.isclose(float(aux["loss"]), float(loss_d), rel_tol=2 ** -8):
        raise AssertionError(f"coded loss {float(aux['loss'])}, direct "
                             f"{float(loss_d)}")
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"[lmtrain] phase wall time {wall:.1f} s")
    return {"coded": coded, "plain": plain, "grad_err": err,
            "grad_route": route, "grad_sens": sens, "wall_s": wall}


#: the family training phase: (arch, layers kept (None = all), sequence
#: length); ``train(cfg, coded=True)`` at ``LM_TRAIN``'s M, K and batch.
#: gemma3-12b keeps one period of its layer pattern (5 windowed + 1
#: global) for memory, as the zoo phase does, and takes 2,048 tokens so
#: that its 1,024-token window bites
FAM_TRAIN = (("granite-moe-3b-a800m", None, 1024), ("rwkv6-1.6b", None, 1024),
             ("recurrentgemma-2b", None, 1024), ("gemma3-12b", 6, 2048))
FAM_STEPS = 3


def fam_launches(cfg, n_steps) -> dict:
    """What ``n_steps`` coded steps of ``cfg`` imply under ``remat``: every
    layer's kernel forward twice (the forward, and its recompute in the
    backward), its backward once."""
    kinds = [m for m, _ in cfg.layer_kinds()]
    n_attn = sum(m in ("attn", "local") for m in kinds)
    n_rwkv, n_rec = kinds.count("rwkv"), kinds.count("rec")
    return no_launches(flash_attention_fwd=2 * n_attn * n_steps,
                       flash_attention_bwd=n_attn * n_steps,
                       rwkv6_wkv=2 * n_rwkv * n_steps,
                       rwkv6_wkv_bwd=n_rwkv * n_steps,
                       rglru_scan=2 * n_rec * n_steps,
                       rglru_scan_bwd=n_rec * n_steps)


def _ce_only(cfg):
    """The summed weighted CE of ``transformer.loss_fn`` without its
    0.01·aux (``transformer.chunked_ce``)."""
    from repro_torch.models import transformer as tfm

    def fn(params, batch):
        x, _ = tfm.forward(params, batch, cfg)
        head = tfm._lm_head(params, cfg).to(tfm._dtype(cfg.compute_dtype))
        return tfm.chunked_ce(x, head, batch["labels"], batch["weights"],
                              cfg)
    return fn


def coded_grad_check(tag, cfg, S) -> dict:
    """One decodable epoch's coded gradient (the step ``train`` takes, in
    the config's compute type) against the full-batch gradient of the same
    loss: ``per_slot_lm_loss`` over the K partitions as one batch, each
    partition once, at ``conditioned`` weights from seed 1; relative error
    in norm, of the whole gradient and of its largest leaf.  It must be
    within the change a one-ulp nudge of every weight makes in the
    full-batch gradient, and within ``GRAD_ROUTE_FACTOR`` times the larger
    difference of two exact routes from it: the same loss over two half
    batches, summed; ``transformer.loss_fn``'s CE (``chunked_ce``, which
    chunks and rounds the head otherwise) over the K partitions.  Neither
    bound may reach 1 (a zero gradient's error).  The kernels' launches
    here are not a path's and are taken back out."""
    import numpy as np
    import torch

    from repro_torch.core.coded_step import _value_and_grad, slot_batch
    from repro_torch.core.runtime import TwoStageRuntime
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.launch.train import per_slot_lm_loss
    from repro_torch.models.transformer import init_params
    from repro_torch.optim.optimizers import tree_leaves

    M = LM_TRAIN["workers"]
    counts = read_counts()
    t0 = time.perf_counter()
    params = conditioned(init_params(
        cfg, torch.Generator(device="cuda").manual_seed(1), device="cuda"),
        cfg)
    runtime = TwoStageRuntime(M, 2 * M, max(M // 2, 2),
                              rates=np.linspace(1.0, 4.0, M),
                              straggler_prob=LM_TRAIN["straggler_prob"],
                              seed=0)
    epoch = 0
    res = runtime.run_epoch(epoch)
    while not res.decode_ok:
        epoch += 1
        res = runtime.run_epoch(epoch)
    data = SyntheticLMDataset(2 * M, LM_TRAIN["batch"], S, cfg.vocab,
                              device="cpu")
    slot_loss = per_slot_lm_loss(cfg)
    coded = _value_and_grad(lambda p, b, w: torch.sum(slot_loss(p, b) * w))
    loss_c, g_coded = coded(params, slot_batch(data, epoch, res.plan, "cuda"),
                            torch.as_tensor(res.weights, dtype=torch.float32,
                                            device="cuda"))
    parts = [data.partition(epoch, k) for k in range(2 * M)]
    full = {key: torch.cat([p[key] for p in parts]).to("cuda")
            for key in parts[0]}

    def as_slots(rows):                  # (1, partitions, b, S)
        return {key: v[rows].reshape((1, -1, LM_TRAIN["batch"], S))
                for key, v in full.items()}
    direct = _value_and_grad(lambda p, b: torch.sum(slot_loss(p, b)))
    loss_d, g_direct = direct(params, as_slots(slice(0, 2 * M)))
    err = _rel_errs(g_coded, g_direct)
    del g_coded
    g_split = direct(params, as_slots(slice(0, M)))[1]
    for a, b in zip(tree_leaves(g_split),
                    tree_leaves(direct(params, as_slots(slice(M, 2 * M)))[1])):
        a.add_(b)
    split = _rel_errs(g_split, g_direct)
    del g_split
    ce = _rel_errs(_value_and_grad(_ce_only(cfg))(params, full)[1], g_direct)
    nudged = ulp_nudge(params)
    del params
    sens = _rel_errs(direct(nudged, as_slots(slice(0, 2 * M)))[1], g_direct)
    del nudged, g_direct, full
    torch.cuda.synchronize()
    check = {k: v - counts[k] for k, v in read_counts().items()}
    set_counts(counts)
    route = [max(split[i], ce[i]) for i in (0, 1)]
    bound = [min(sens[i], GRAD_ROUTE_FACTOR * route[i]) for i in (0, 1)]
    log(f"[famtrain] {tag} {cfg.compute_dtype}: decoded vs full-batch CE "
        f"gradient (epoch {epoch}, {res.plan.n_slots} slots, "
        f"{M * res.plan.n_slots} sequences of {S}, against the {2 * M} "
        f"partitions once), relative error in norm of the whole gradient "
        f"and of its largest leaf {err[2]}: {err[0]:.3e}, {err[1]:.3e}; "
        f"exact routes: two half batches {split[0]:.3e}, {split[1]:.3e}; "
        f"loss_fn's CE {ce[0]:.3e}, {ce[1]:.3e} (ratio to the larger "
        f"{err[0] / route[0]:.2f}, {err[1] / route[1]:.2f}); a one-ulp "
        f"nudge {sens[0]:.3e}, {sens[1]:.3e}; bound {bound[0]:.3e}, "
        f"{bound[1]:.3e}; losses coded {float(loss_c):.6f}, direct "
        f"{float(loss_d):.6f}; launches (apart) {check}; "
        f"{time.perf_counter() - t0:.1f} s")
    for i in (0, 1):
        if not (err[i] <= bound[i] < 1.0):
            raise AssertionError(
                f"{tag}: decoded gradient off the full-batch one: {err[:2]} "
                f"against the nudge's {sens[:2]} and {GRAD_ROUTE_FACTOR} x "
                f"the routes' {route}, bound {bound} (must stay under 1)")
    if not math.isclose(float(loss_c), float(loss_d), rel_tol=2 ** -8):
        raise AssertionError(f"{tag}: coded loss {float(loss_c)}, direct "
                             f"{float(loss_d)}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"err": err, "split": split, "ce": ce, "sens": sens,
            "bound": bound}


def famtrain_phase() -> dict:
    """``repro_torch.launch.train.train`` on every token-decoder family
    the reference's driver trains, through the hand-written kernels:
    granite-moe-3b-a800m (MoE), rwkv6-1.6b (WKV), recurrentgemma-2b
    (RG-LRU and attention at head width 256) at full size, gemma3-12b at
    full width cut to 6 layers.  Per config: ``FAM_STEPS`` coded steps at
    M = 6, K = 12, batch 1, their launch counts against ``fam_launches``,
    finite losses and the peak memory (under 80 GB); the coded gradient
    against the full-batch CE gradient within the nudge and
    ``GRAD_ROUTE_FACTOR`` x two exact routes (``coded_grad_check``;
    granite at ``capacity_factor = E / top_k``,
    where nothing drops: the slot batch's forward counts other tokens than
    the K partitions', so its drops differ); granite's
    share of assignments dropped a layer at its own capacity, 1.0, and one
    plain step (CE + 0.01·aux, clip_norm 1.0)."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.coded_step import slot_batch
    from repro_torch.core.runtime import TwoStageRuntime
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.launch.train import train

    t_phase = time.perf_counter()
    M = LM_TRAIN["workers"]
    out_all = {}
    for arch, layers, S in FAM_TRAIN:
        t_cfg = time.perf_counter()
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        log(f"[famtrain] {arch}: {cfg.n_layers} of {get_config(arch).n_layers}"
            f" layers, d_model {cfg.d_model}, compute {cfg.compute_dtype}, "
            f"remat {cfg.remat}; coded: M = {M}, K = {2 * M} partitions of "
            f"{LM_TRAIN['batch']} x {S} tokens, AdamW({LM_TRAIN['lr']}), "
            f"in-place update")

        def say(msg, arch=arch):
            log(f"[famtrain] {arch} {msg}")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out = train(cfg, coded=True, device="cuda", log_every=1, log=say,
                    steps=FAM_STEPS, batch=LM_TRAIN["batch"], seq=S,
                    workers=M, straggler_prob=LM_TRAIN["straggler_prob"],
                    lr=LM_TRAIN["lr"])
        torch.cuda.synchronize()
        launches, windowed = read_counts(), windowed_launches()
        windowed_bwd = windowed_launches(backward=True)
        peak = torch.cuda.max_memory_allocated()
        want = fam_launches(cfg, FAM_STEPS)
        for i, step in enumerate(out["step"]):
            log(f"[famtrain] {arch} coded step {step}: {M * out['n_slots'][i]}"
                f" sequences of {S}, decode_ok {out['decode_ok'][i]}, loss "
                f"{out['loss'][i]:.6f}; ms: plan {out['plan_ms'][i]:.1f}, "
                f"data {out['data_ms'][i]:.1f}, step {out['step_ms'][i]:.1f}")
        log(f"[famtrain] {arch} launches {launches} (the path implies "
            f"{want}), of them windowed attention forwards {windowed}, "
            f"backwards {windowed_bwd}; peak device memory {peak} bytes "
            f"({peak / 1e9:.2f} GB)")
        if launches != want:
            raise AssertionError(f"{arch}: launch counts {launches}, the "
                                 f"path implies {want}")
        if not all(math.isfinite(x) for x in out["loss"]):
            raise AssertionError(f"{arch}: coded losses {out['loss']}")
        if peak >= 80e9:
            raise AssertionError(f"{arch}: peak {peak / 1e9:.2f} GB")
        row = {k: out[k] for k in ("n_slots", "step_ms", "loss")}
        row.update(peak=peak, launches=launches, windowed=windowed,
                   windowed_bwd=windowed_bwd, S=S,
                   rows=M * max(out["n_slots"]))
        if cfg.head_dim == 256 and launches["flash_attention_bwd"]:
            # the attention kernels at the largest shape the path gave
            # them, at its window and, where some layers are global,
            # without one
            counts = read_counts()
            shape = (row["rows"], S, cfg.n_kv_heads,
                     cfg.n_heads // cfg.n_kv_heads, 256)
            windows = [cfg.window] + (
                [0] if windowed_bwd < launches["flash_attention_bwd"] else [])
            row["fa_bwd_errs"] = {
                w: fa_case(f"{arch} path {shape}", shape, torch.bfloat16,
                           True, w, chunk=1024)[1] for w in windows}
            row["fa_bwd_err"] = max(row["fa_bwd_errs"].values())
            set_counts(counts)
        if cfg.n_experts:
            # the share of assignments each layer drops at capacity 1.0,
            # in the last step's slot batch at the trained weights
            runtime = TwoStageRuntime(M, 2 * M, max(M // 2, 2),
                                      rates=np.linspace(1.0, 4.0, M),
                                      straggler_prob=LM_TRAIN[
                                          "straggler_prob"], seed=0)
            for step in range(FAM_STEPS):
                res = runtime.run_epoch(step)
            ds = SyntheticLMDataset(2 * M, LM_TRAIN["batch"], S, cfg.vocab,
                                    device="cpu")
            toks = slot_batch(ds, FAM_STEPS - 1, res.plan, "cuda")["tokens"]
            counts = read_counts()
            drops = prefill_drops(out["params"], cfg, toks.reshape(-1, S))
            set_counts(counts)
            row["drops"] = drops
            log(f"[famtrain] {arch} share of assignments dropped a layer at "
                f"capacity_factor {cfg.capacity_factor}, the last step's "
                f"{toks.numel()} tokens: min {min(drops):.4f}, median "
                f"{float(np.median(drops)):.4f}, max {max(drops):.4f}")
            del toks
        del out
        gc.collect()
        torch.cuda.empty_cache()
        if cfg.n_experts:
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            plain = train(cfg, steps=1, batch=LM_PLAIN_BATCH, seq=S,
                          lr=LM_TRAIN["lr"], coded=False, device="cuda",
                          log=say)
            torch.cuda.synchronize()
            launches = read_counts()
            p_want = fam_launches(cfg, 1)
            p_peak = torch.cuda.max_memory_allocated()
            log(f"[famtrain] {arch} plain step ({LM_PLAIN_BATCH} x {S} "
                f"tokens, CE + 0.01·aux, clip_norm 1.0): "
                f"{plain['step_ms'][0]:.1f} ms, loss {plain['loss'][0]:.6f}, "
                f"grad norm {plain['grad_norm'][0]:.4f}; launches {launches}"
                f" (the path implies {p_want}); peak {p_peak / 1e9:.2f} GB")
            if launches != p_want or not math.isfinite(plain["loss"][0]) \
                    or p_peak >= 80e9:
                raise AssertionError(f"{arch} plain step: launches "
                                     f"{launches}, loss {plain['loss']}, "
                                     f"peak {p_peak}")
            row["plain"] = {"step_ms": plain["step_ms"][0], "peak": p_peak,
                            "launches": launches}
            del plain
            gc.collect()
            torch.cuda.empty_cache()
        check_cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k) \
            if cfg.n_experts else cfg
        row["grad"] = coded_grad_check(arch, check_cfg, S)
        row["wall_s"] = time.perf_counter() - t_cfg
        log(f"[famtrain] {arch} wall time {row['wall_s']:.1f} s")
        out_all[arch] = row
    log(f"[famtrain] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return out_all


def serve_config(**over):
    from repro_torch.configs.rwkv6_1_6b import FULL
    return dataclasses.replace(FULL, **over)


def _draw_zero_init(params, gen):
    """Draw, in place, the rwkv leaves the reference initialises to zero
    (token-shift mixes, decay bias and LoRA output, bonus, head norm), as
    the CPU tests do: at zero the token shift does nothing and every decay
    is e^-1, so an off-by-one state would go unseen."""
    for group in params["groups"]:
        for unit in group.values():
            mix, ffn = unit["mixer"], unit["ffn"]
            mix["mu"].uniform_(0.0, 1.0, generator=gen)
            ffn["mu"].uniform_(0.0, 1.0, generator=gen)
            mix["w0"].uniform_(-1.0, 0.5, generator=gen)
            mix["w_lora_b"].normal_(0.0, 0.1, generator=gen)
            mix["u"].normal_(0.0, 0.5, generator=gen)
            mix["gn"].normal_(0.0, 0.1, generator=gen)
    return params


def serve_params(cfg, device):
    """Random weights of ``cfg`` from seed 0 on ``device``."""
    import torch

    from repro_torch.models.transformer import init_params
    gen = torch.Generator(device=device).manual_seed(0)
    return _draw_zero_init(init_params(cfg, gen, device=device), gen)


def batch_logits(params, cfg, batch, positions):
    """Float32 logits (B, len(positions), V) of a fresh forward over
    ``batch`` (the model's head: tied or its own)."""
    import torch

    from repro_torch.models.transformer import _lm_head, forward
    with torch.no_grad():
        x, _ = forward(params, batch, cfg)
        head = _lm_head(params, cfg).to(getattr(torch, cfg.compute_dtype))
        return (x[:, positions] @ head).float()


def teacher_forced(params, cfg, prompt, n_steps, given=None):
    """Prefill ``prompt`` (B, S), then ``n_steps`` decode steps, each fed
    the greedy choice of the step before or, where ``given`` (B, n_steps)
    is passed, those tokens; then one fresh forward over the prompt and
    the tokens fed.  Returns the logits of prefill's last position and of
    every step and the forward's at the same positions, each (B, n_steps +
    1, V) float32, and the tokens the forward saw."""
    import torch

    from repro_torch.models.transformer import (decode_step, pad_cache,
                                                prefill)
    S = prompt.shape[1]
    with torch.no_grad():
        last, caches, pos = prefill(params, {"tokens": prompt}, cfg)
        caches = pad_cache(caches, cfg, extra=n_steps)
        logits, fed = [last], []
        for i in range(n_steps):
            fed.append(last.argmax(-1)[:, None] if given is None
                       else given[:, i:i + 1])
            last, caches = decode_step(params, fed[-1], caches, pos + i, cfg)
            logits.append(last)
    full = torch.cat([prompt] + fed, dim=1)
    return (torch.stack(logits, dim=1).float(),
            batch_logits(params, cfg, {"tokens": full}, slice(S - 1, None)),
            full)


#: decode logits vs a fresh forward: (rtol, atol as a fraction of the
#: largest |logit|).  float32: only summation order differs.  bfloat16:
#: the two routes round the residual stream to bf16 after each of 48
#: sublayers at other places (a (B, 1, d) step against a (1, S, d) pass),
#: and bf16 keeps 8 bits; the first measurement gave a largest difference
#: of 6 % of the largest logit and 5.8 % in norm, so the bound is 10 %
#: elementwise and in norm.
TF_TOL = {"bfloat16": (0.1, 0.1), "float32": (1e-3, 2e-4)}
#: the same for recurrentgemma-2b, measured first (an H100 80GB HBM3 at
#: 700 W).  float32: ``TF_TOL``'s rtol in norm, but atol 1e-3 of the
#: largest |logit|, not 2e-4: at these weights a one-ulp nudge of every
#: weight moves a float32 forward's logits by 3.4-3.7e-4 of the largest
#: (``nudge_sensitivity``, logged each run), so no two float32 routes
#: agree to 2e-4; decode against forward measured 1.1-3.5e-4.  bfloat16:
#: the routes round the residual stream after each of 52 sublayers at
#: other places, and each bf16 route is 35-37 % from the float32 forward
#: in norm on the same tokens; decode against forward measured 14-15 % in
#: norm and 16-19 % of the largest logit elementwise, so the bound is
#: 25 %, and decode must be as close to float32 as the forward is
#: (``BF16_AS_CLOSE``)
RG_TF_TOL = {"bfloat16": (0.25, 0.25), "float32": (1e-3, 1e-3)}
#: bf16 decode's norm distance from the float32 forward, at most this
#: many times the bf16 forward's (measured 0.99-1.006 on both serve paths)
BF16_AS_CLOSE = 1.05


def ulp_nudge(tree, seed=0):
    """Every float32 weight moved by -1, 0 or +1 ulp, drawn entry by
    entry on the card from ``seed``."""
    import torch

    from repro_torch.optim.optimizers import tree_map
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def nudge(x):
        d = torch.randint(-1, 2, x.shape, generator=gen, device=x.device,
                          dtype=torch.int8)
        up = torch.nextafter(x, torch.full_like(x, math.inf))
        down = torch.nextafter(x, torch.full_like(x, -math.inf))
        return torch.where(d > 0, up, torch.where(d < 0, down, x))
    return tree_map(nudge, tree)


def nudge_sensitivity(params, cfg, batch, positions, ref, seed=0) -> tuple:
    """How far a fresh forward's logits at ``positions`` of ``batch`` move
    from ``ref`` (the same forward's) when every weight moves by -1, 0 or
    +1 float32 ulp, drawn entry by entry: the model's own conditioning at
    these weights, against which a difference of two routes in float32 is
    read.  Returns (max abs change as a fraction of the largest |logit|,
    norm rel change)."""
    moved = batch_logits(ulp_nudge(params, seed), cfg, batch, positions)
    return (float((moved - ref).abs().max() / ref.abs().max()),
            _rel_norm(moved, ref))


def _rel_norm(a, b) -> float:
    return float((a - b).norm() / b.norm())


#: a float32 check's bound must be at least this many times what a
#: one-ulp nudge of every weight moves the fresh forward
#: (``nudge_sensitivity``), in norm and elementwise: where the model's own
#: conditioning fills more of it, the bound cannot tell a wrong route from
#: a right one, and the check fails rather than widen
NUDGE_MARGIN = 2.0


def f32_route_check(tag, got, ref, tol, nudge=None) -> tuple:
    """Float32 logits ``got`` of one route against ``ref``, a fresh
    forward's at the same positions: within ``tol`` = (rtol, atol as a
    fraction of the largest |logit|) elementwise and rtol in norm, with the
    same greedy choices everywhere.  Given ``nudge``
    (``nudge_sensitivity``'s pair), the weights must first be conditioned
    to ``NUDGE_MARGIN`` times inside ``tol``.  Returns (max abs err, norm
    rel err)."""
    rtol, frac = tol
    if nudge is not None and (NUDGE_MARGIN * nudge[0] > frac or
                              NUDGE_MARGIN * nudge[1] > rtol):
        raise AssertionError(
            f"{tag}: a one-ulp nudge of every weight moves the float32 "
            f"forward by {nudge[0]:.3e} of the largest |logit| and "
            f"{nudge[1]:.3e} in norm, over 1/{NUDGE_MARGIN} of the bound "
            f"(atol {frac}, rtol {rtol}): the weights are not conditioned "
            f"well enough to compare two routes")
    err = check_close(f"{tag} float32", got, ref, rtol,
                      frac * float(ref.abs().max()))
    rel = _rel_norm(got, ref)
    same = (got.argmax(-1) == ref.argmax(-1)).flatten().tolist()
    if rel > rtol or not all(same):
        raise AssertionError(f"{tag} float32: norm rel err {rel} (bound "
                             f"{rtol}), greedy choices equal {same}")
    return err, rel


def tf_check(tag, params, cfg_of, prompt, gen_len, tol,
             nudge=False) -> dict:
    """Teacher-forced decode against a fresh forward, in bfloat16 and
    float32 (``cfg_of(dtype)``), each within ``tol[dtype]`` = (rtol, atol
    as a fraction of the largest |logit|) elementwise and rtol in norm;
    float32 (``f32_route_check``) must make the same greedy choices, and
    with ``nudge`` its weights must be conditioned as that says.  Returns
    the errors."""
    S = prompt.shape[1]
    errs = {}
    for dtype in ("bfloat16", "float32"):
        got, ref, full = teacher_forced(params, cfg_of(dtype), prompt,
                                        gen_len)
        rtol, frac = tol[dtype]
        scale = float(ref.abs().max())
        what = f"{tag} teacher-forced {dtype}, prompt {S}"
        sens = ""
        if dtype == "float32":
            n = (nudge_sensitivity(params, cfg_of(dtype), {"tokens": full},
                                   slice(S - 1, None), ref)
                 if nudge else None)
            err, rel = f32_route_check(what, got, ref, tol[dtype], n)
            if n:
                sens = (f"; a one-ulp nudge of every weight moves the "
                        f"forward by {n[0]:.3e} of the largest |logit|, "
                        f"{n[1]:.3e} in norm (at most 1/{NUDGE_MARGIN} of "
                        f"the bound)")
        else:
            err = check_close(what, got, ref, rtol, frac * scale)
            rel = _rel_norm(got, ref)
        same = (got.argmax(-1) == ref.argmax(-1)).flatten().tolist()
        log(f"[{tag}] teacher-forced {dtype}, prompt {S}: {got.shape[1]} "
            f"positions of {got.shape[2]} logits, max abs err {err:.4g} "
            f"(rtol {rtol}, atol {frac * scale:.3g} = {frac} x max|logit| "
            f"{scale:.4g}), norm rel err {rel:.3e} (bound {rtol}); argmax "
            f"equal at {sum(same)} of {len(same)}{sens}")
        if rel > rtol:
            raise AssertionError(f"{what}: norm rel err {rel}")
        if dtype == "bfloat16":
            # both bf16 routes against float32 on the same tokens
            exact = batch_logits(params, cfg_of("float32"),
                                 {"tokens": full}, slice(S - 1, None))
            d_dec = _rel_norm(got, exact)
            d_fwd = _rel_norm(ref, exact)
            log(f"[{tag}] bf16 vs float32 on the same tokens, norm rel err:"
                f" decode {d_dec:.3e}, forward {d_fwd:.3e} (ratio "
                f"{d_dec / d_fwd:.4f}, bound {BF16_AS_CLOSE})")
            if d_dec > BF16_AS_CLOSE * d_fwd:
                raise AssertionError(f"{tag} bf16 decode is farther from "
                                     f"float32 than the forward, prompt "
                                     f"{S}: {d_dec} against {d_fwd}")
        errs[dtype] = (err, rel)
    return errs


def serve_phase() -> dict:
    """The serve path at full size, its checks, and the REDUCED twins.
    Returns the path's launches, its timings, the parameter count and the
    peak device memory."""
    import numpy as np
    import torch

    from repro_torch.configs.rwkv6_1_6b import REDUCED
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import decode_step, prefill
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    cfg = serve_config()
    params = serve_params(cfg, "cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.d_model // cfg.rwkv_head_dim} WKV heads of "
        f"{cfg.rwkv_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"compute {cfg.compute_dtype}; {n_params} parameters "
        f"({4 * n_params / 1e9:.2f} GB float32); serve {SERVE}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the path: counts zeroed just before, read just after ----
    reset_counts()
    t0 = time.perf_counter()
    res = serve(cfg, params, device="cuda", **SERVE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    # ---------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    want = no_launches(rwkv6_wkv=cfg.n_layers * res["prefills"])
    pre = np.asarray(res["prefill_ms"])
    dec = np.asarray(res["decode_ms"]) / SERVE["gen_len"]
    log(f"[serve] {SERVE['slots']} slots in {wall:.2f} s: {res['prefills']} "
        f"prefills, served {np.round(res['served'], 2).tolist()}, Jain "
        f"{res['jain']:.4f}, admitted per slot "
        f"{res['admitted'].sum(1).tolist()}; launches {launches} (the path "
        f"implies {want}); peak device memory {peak} bytes "
        f"({peak / 1e9:.2f} GB)")
    log(f"[serve] ms per prefill (batch <= {SERVE['batch']} x "
        f"{SERVE['prompt_len']} tokens): median {np.median(pre):.2f}, min "
        f"{pre.min():.2f}, max {pre.max():.2f}; ms per decode step: median "
        f"{np.median(dec):.3f}, min {dec.min():.3f}, max {dec.max():.3f}; "
        f"schedule ms per slot median {np.median(res['schedule_ms']):.3f}")
    if res["prefills"] == 0 or launches != want:
        raise AssertionError(f"launch counts {launches}, the path implies "
                             f"{want}")
    if not 0.0 < res["jain"] <= 1.0 or res["served"].sum() <= 0:
        raise AssertionError(f"served {res['served']}, Jain {res['jain']}")

    # teacher-forced: decode == a fresh forward, bf16 and float32
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, SERVE["prompt_len"]))).cuda()
    tf_check("serve", params, lambda dt: serve_config(compute_dtype=dt),
             prompt, SERVE["gen_len"], TF_TOL)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # REDUCED, float32: the model on the card (WKV kernel) vs the CPU
    red = dataclasses.replace(REDUCED, compute_dtype="float32")
    p_cpu = serve_params(red, "cpu")
    p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, red.vocab, (2, 104)))
    out = []
    for p, dev in ((p_gpu, "cuda"), (p_cpu, "cpu")):
        last, caches, pos = prefill(p, {"tokens": toks[:, :100].to(dev)},
                                    red)
        steps = [last]
        for i in range(4):
            lg, caches = decode_step(p, toks[:, 100 + i:101 + i].to(dev),
                                     caches, pos + i, red)
            steps.append(lg)
        out.append((torch.stack(steps).cpu(), caches[0]["l0"]["mix"]["S"]
                    .cpu()))
    e_l = check_close("REDUCED logits card vs CPU", out[0][0], out[1][0],
                      1e-4, 1e-4)
    e_s = check_close("REDUCED WKV state card vs CPU", out[0][1], out[1][1],
                      1e-4, 1e-4 * max(1.0, float(out[1][1].abs().max())))
    log(f"[serve] REDUCED float32, prefill 100 tokens + 4 decode steps, card"
        f" vs CPU: logits max abs err {e_l:.3e}, WKV state {e_s:.3e} "
        f"(rtol 1e-4)")

    # REDUCED serve loop (its defaults, bf16) on the card and on the CPU
    red = REDUCED
    t1 = time.perf_counter()
    card = serve(red, serve_params(red, "cuda"), device="cuda")
    t2 = time.perf_counter()
    cpu = serve(red, serve_params(red, "cpu"), device="cpu")
    for key in ("admitted", "scheduled", "served"):
        if not np.array_equal(card[key], cpu[key]):
            raise AssertionError(f"REDUCED serve {key}: card {card[key]}, "
                                 f"CPU {cpu[key]}")
    log(f"[serve] REDUCED serve loop (40 slots): card {t2 - t1:.1f} s, CPU "
        f"{time.perf_counter() - t2:.1f} s; equal admissions, schedules and "
        f"served counts {np.round(card['served'], 2).tolist()}")
    return {"launches": launches, "res": res, "peak": peak,
            "n_params": n_params}


def rg_config(**over):
    from repro_torch.configs.recurrentgemma_2b import FULL
    return dataclasses.replace(FULL, **over)


def _draw_rec_leaves(params, gen):
    """Draw, in place, the rec leaves the reference initialises to ones or
    zeros, as the CPU tests do: ``lam`` so that a^c lies in [0.9, 0.999]
    (Griffin's initialisation; at lam = 1, a = exp(-10.5·r) and the
    recurrence forgets everything in one step, so an error in the carry
    would go unseen), ``b_a``, ``b_x`` and ``conv_b``."""
    import torch
    for group in params["groups"]:
        for unit in group.values():
            mix = unit["mixer"]
            if "lam" not in mix:
                continue
            ac = torch.empty_like(mix["lam"]).uniform_(0.9, 0.999,
                                                       generator=gen)
            # a = exp(-c·softplus(lam)) at r = 1: softplus(lam) = -log(a^c)/c
            mix["lam"].copy_(torch.log(torch.expm1(-torch.log(ac) / 8.0)))
            mix["b_a"].normal_(0.0, 0.5, generator=gen)
            mix["b_x"].normal_(0.0, 0.5, generator=gen)
            mix["conv_b"].normal_(0.0, 0.1, generator=gen)
    return params


def rg_params(cfg, device):
    """Random weights of ``cfg`` (recurrentgemma) from seed 0 on
    ``device``."""
    import torch

    from repro_torch.models.transformer import init_params
    gen = torch.Generator(device=device).manual_seed(0)
    return _draw_rec_leaves(init_params(cfg, gen, device=device), gen)


def rg_serve_phase() -> dict:
    """The recurrentgemma-2b serve path at full size, its checks, and the
    REDUCED twins.  Returns the path's launches, its timings, the
    parameter count and the peak device memory."""
    import numpy as np
    import torch

    from repro_torch.configs.recurrentgemma_2b import REDUCED
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import (decode_step, pad_cache,
                                                prefill)
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    cfg = rg_config()
    kinds = [m for m, _ in cfg.layer_kinds()]
    n_rec, n_local = kinds.count("rec"), kinds.count("local")
    params = rg_params(cfg, "cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"[rg] {cfg.name}: {cfg.n_layers} layers ({n_rec} rec, {n_local} "
        f"local), d_model {cfg.d_model}, d_rnn {cfg.d_rnn} in "
        f"{cfg.rnn_heads} heads, {cfg.n_heads} query heads and "
        f"{cfg.n_kv_heads} kv head of {cfg.head_dim}, window {cfg.window}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab} (tied), compute "
        f"{cfg.compute_dtype}; {n_params} parameters "
        f"({4 * n_params / 1e9:.2f} GB float32); serve {SERVE}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the path: counts zeroed just before, read just after ----
    reset_counts()
    t0 = time.perf_counter()
    res = serve(cfg, params, device="cuda", **SERVE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    # ---------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    want = no_launches(rglru_scan=n_rec * res["prefills"],
                       flash_attention_fwd=n_local * res["prefills"])
    pre = np.asarray(res["prefill_ms"])
    dec = np.asarray(res["decode_ms"]) / SERVE["gen_len"]
    log(f"[rg] {SERVE['slots']} slots in {wall:.2f} s: {res['prefills']} "
        f"prefills, served {np.round(res['served'], 2).tolist()}, Jain "
        f"{res['jain']:.4f}; launches {launches} (the path implies {want}: "
        f"{n_rec} scans and {n_local} attention forwards a prefill); peak "
        f"device memory {peak} bytes ({peak / 1e9:.2f} GB)")
    log(f"[rg] ms per prefill (batch <= {SERVE['batch']} x "
        f"{SERVE['prompt_len']} tokens): median {np.median(pre):.2f}, min "
        f"{pre.min():.2f}, max {pre.max():.2f}; ms per decode step: median "
        f"{np.median(dec):.3f}, min {dec.min():.3f}, max {dec.max():.3f}; "
        f"schedule ms per slot median {np.median(res['schedule_ms']):.3f}")
    if res["prefills"] == 0 or launches != want:
        raise AssertionError(f"launch counts {launches}, the path implies "
                             f"{want}")
    if not 0.0 < res["jain"] <= 1.0 or res["served"].sum() <= 0:
        raise AssertionError(f"served {res['served']}, Jain {res['jain']}")

    # teacher-forced at batch 1: below the window, across its edge, above
    tf = {}
    for n in RG_TF_PROMPTS:
        prompt = torch.from_numpy(np.random.default_rng(n).integers(
            0, cfg.vocab, (1, n))).cuda()
        tf[n] = tf_check("rg", params,
                         lambda dt: rg_config(compute_dtype=dt), prompt,
                         SERVE["gen_len"], RG_TF_TOL, nudge=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # REDUCED, float32: the model on the card (both kernels) vs the CPU,
    # prefill past the window of 32
    red = dataclasses.replace(REDUCED, compute_dtype="float32")
    p_cpu = rg_params(red, "cpu")
    p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, red.vocab, (2, 104)))
    out = []
    for p, dev in ((p_gpu, "cuda"), (p_cpu, "cpu")):
        last, caches, pos = prefill(p, {"tokens": toks[:, :100].to(dev)},
                                    red)
        caches = pad_cache(caches, red, extra=4)
        steps = [last]
        for i in range(4):
            lg, caches = decode_step(p, toks[:, 100 + i:101 + i].to(dev),
                                     caches, pos + i, red)
            steps.append(lg)
        out.append((torch.stack(steps).cpu(),
                    caches[0]["l0"]["mix"]["h"].cpu()))
    e_l = check_close("rg REDUCED logits card vs CPU", out[0][0], out[1][0],
                      1e-4, 1e-4)
    e_h = check_close("rg REDUCED rec state card vs CPU", out[0][1],
                      out[1][1], 1e-4,
                      1e-4 * max(1.0, float(out[1][1].abs().max())))
    log(f"[rg] REDUCED float32, prefill 100 tokens (window 32) + 4 decode "
        f"steps, card vs CPU: logits max abs err {e_l:.3e}, rec state "
        f"{e_h:.3e} (rtol 1e-4)")

    # REDUCED serve loop (its defaults, bf16) on the card and on the CPU
    red = REDUCED
    t1 = time.perf_counter()
    card = serve(red, rg_params(red, "cuda"), device="cuda")
    t2 = time.perf_counter()
    cpu = serve(red, rg_params(red, "cpu"), device="cpu")
    for key in ("admitted", "scheduled", "served"):
        if not np.array_equal(card[key], cpu[key]):
            raise AssertionError(f"rg REDUCED serve {key}: card "
                                 f"{card[key]}, CPU {cpu[key]}")
    log(f"[rg] REDUCED serve loop (40 slots): card {t2 - t1:.1f} s, CPU "
        f"{time.perf_counter() - t2:.1f} s; equal admissions, schedules and "
        f"served counts {np.round(card['served'], 2).tolist()}")
    return {"launches": launches, "res": res, "peak": peak,
            "n_params": n_params, "tf": tf}


# --------------------------------------------------------------------- #
# 11-12. moe and zoo: granite-moe-3b-a800m served, the other new configs
# --------------------------------------------------------------------- #
def granite_config(**over):
    from repro_torch.configs.granite_moe_3b_a800m import FULL
    return dataclasses.replace(FULL, **over)


def conditioned(params, cfg):
    """``params`` with each stacked matrix scaled, in place, to the std of
    its own fan-in, ``scale/sqrt(d_in)``.  The reference's init takes a
    stacked leaf's fan-in from its first axis, the layer count R
    (``models/common.py::_init_one``), so at R = 32 a (1536, 1536) query
    matrix has std 0.18 and at R = 2 a (5120, 5120) one 0.71: attention
    saturates towards an argmax, and a one-ulp nudge of every weight moves
    32-layer granite's float32 logits by 90 % in norm on an H100, so no
    two float32 routes can be held to each other.  Scaled, they can."""
    from repro_torch.models.common import spec_leaves
    from repro_torch.models.transformer import model_specs
    from repro_torch.optim.optimizers import tree_leaves
    for sp, t in zip(spec_leaves(model_specs(cfg)), tree_leaves(params)):
        if sp.init == "normal" and len(sp.shape) >= 3:
            t.mul_(math.sqrt(sp.shape[0] / sp.shape[-2]))
    return params


def granite_params(cfg, device):
    """Random weights of ``cfg`` (granite) from seed 0 on ``device``,
    ``conditioned``."""
    import torch

    from repro_torch.models.transformer import init_params
    return conditioned(init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device),
        cfg)


def prefill_drops(params, cfg, tokens) -> list:
    """The share of (token, expert) assignments that one prefill of
    ``tokens`` drops, in each MoE layer, in layer order: each layer's plan
    is read as ``moe_ffn`` makes it."""
    from unittest import mock

    import torch

    from repro_torch.models import moe
    from repro_torch.models.transformer import prefill
    dispatch_indices = moe.moe_dispatch_indices
    plans = []

    def recorded(*args, **kw):
        plan = dispatch_indices(*args, **kw)
        plans.append(plan.token_slot)
        return plan
    with torch.no_grad(), mock.patch.object(moe, "moe_dispatch_indices",
                                            recorded):
        prefill(params, {"tokens": tokens}, cfg)
    drops = [float((t < 0).sum()) / t.numel() for t in plans]
    del plans
    torch.cuda.empty_cache()
    return drops


#: the structural check, float32 at capacity 8 (routing equal in prefill,
#: decode and the fresh forward): rtol in norm and atol as a fraction of
#: the largest |logit|, ``TF_TOL``'s float32 bounds, the weights
#: conditioned to ``NUDGE_MARGIN`` times inside them (measured each run)
MOE_TF_TOL = TF_TOL["float32"]
#: the dispatch check's FFN output, float32 card vs CPU from the same
#: plan: the products and the combine sum in other orders (rtol, and atol
#: as a fraction of the largest |output|)
MOE_FFN_TOL = (1e-4, 1e-5)


def moe_dispatch_check(params, cfg) -> dict:
    """One MoE layer at full width over ``MOE_DISPATCH_T`` tokens: router
    logits in float32 from the card, dispatched on the card and on the
    CPU (slot tokens and validity equal; weights and aux within rtol
    1e-6), then the float32 FFN on both (within ``MOE_FFN_TOL``)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.models.moe import (moe_capacity, moe_dispatch_indices,
                                        moe_ffn)
    from repro_torch.optim.optimizers import tree_map
    layer = tree_map(lambda t: t[0], params["groups"][0]["l0"]["ffn"])
    d, E, k = cfg.d_model, cfg.n_experts, cfg.top_k
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((1, MOE_DISPATCH_T, d), generator=gen, device="cuda")
    logits = x @ layer["router"].float()
    C = moe_capacity(MOE_DISPATCH_T, k, E, cfg.capacity_factor)
    card = moe_dispatch_indices(logits, k, C)
    cpu = moe_dispatch_indices(logits.cpu(), k, C)
    for name in ("slot_token", "slot_valid", "token_slot"):
        if not torch.equal(getattr(card, name).cpu(), getattr(cpu, name)):
            raise AssertionError(f"moe dispatch {name} differs card vs CPU")
    e_w = check_close("moe dispatch slot_weight", card.slot_weight.cpu(),
                      cpu.slot_weight, 1e-6, 0.0)
    aux_c, aux_h = float(card.aux_loss), float(cpu.aux_loss)
    if abs(aux_c - aux_h) > 1e-6 * abs(aux_h):
        raise AssertionError(f"moe aux card {aux_c}, CPU {aux_h}")
    dropped = int((card.token_slot < 0).sum())
    p_cuda = {n: layer[n].float() for n in ("router", "wg", "wu", "wd")}
    p_cpu = tree_map(lambda t: t.cpu(), p_cuda)
    out_c, _ = moe_ffn(x, p_cuda, top_k=k, capacity_factor=cfg.
                       capacity_factor, act=F.silu)
    out_h, _ = moe_ffn(x.cpu(), p_cpu, top_k=k,
                       capacity_factor=cfg.capacity_factor, act=F.silu)
    rtol, frac = MOE_FFN_TOL
    e_o = check_close("moe FFN card vs CPU", out_c.cpu(), out_h, rtol,
                      frac * float(out_h.abs().max()))
    log(f"[moe] dispatch of one layer (d {d}, {E} experts, top-{k}) over "
        f"{MOE_DISPATCH_T} tokens at capacity {C}: slot tokens, validity and"
        f" each assignment's slot equal card vs CPU; weights max abs err "
        f"{e_w:.3e} (rtol 1e-6); aux card {aux_c!r} CPU {aux_h!r}; "
        f"{dropped} of {MOE_DISPATCH_T * k} assignments dropped "
        f"({dropped / (MOE_DISPATCH_T * k):.2%}); FFN float32 card vs CPU "
        f"max abs err {e_o:.3e} (rtol {rtol}, atol {frac} x max|out| "
        f"{float(out_h.abs().max()):.4g})")
    del x, logits, p_cuda, out_c
    torch.cuda.empty_cache()
    return {"weights_err": e_w, "aux": (aux_c, aux_h), "ffn_err": e_o,
            "capacity": C, "dropped": dropped}


def moe_serve_phase() -> dict:
    """granite-moe-3b-a800m served at full size through ``serve()``, the
    share dropped per layer, the structural check (float32, capacity 8),
    the dispatch check, the REDUCED model card vs CPU and the REDUCED
    serve loop on both.  Returns the path's launches, timings, parameter
    count, peak memory and the checks' numbers."""
    import numpy as np
    import torch

    from repro_torch.configs.granite_moe_3b_a800m import REDUCED
    from repro_torch.launch.serve import serve
    from repro_torch.models.moe import moe_capacity
    from repro_torch.models.transformer import (decode_step, pad_cache,
                                                prefill)
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg = granite_config()
    params = granite_params(cfg, "cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    T_pre = SERVE["batch"] * SERVE["prompt_len"]
    log(f"[moe] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} query heads and {cfg.n_kv_heads} kv heads of "
        f"{cfg.head_dim}, {cfg.n_experts} experts of d_ff {cfg.d_ff}, top-"
        f"{cfg.top_k}, capacity factor {cfg.capacity_factor} ("
        f"{moe_capacity(T_pre, cfg.top_k, cfg.n_experts, cfg.capacity_factor)}"
        f" slots an expert at prefill, "
        f"{moe_capacity(SERVE['batch'], cfg.top_k, cfg.n_experts, cfg.capacity_factor)}"  # noqa: E501
        f" at decode), vocab {cfg.vocab}, compute {cfg.compute_dtype}; "
        f"{n_params} parameters ({4 * n_params / 1e9:.2f} GB float32); "
        f"serve {SERVE}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the path: counts zeroed just before, read just after ----
    reset_counts()
    t0 = time.perf_counter()
    res = serve(cfg, params, device="cuda", **SERVE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    windowed = windowed_launches()
    # ---------------------------------------------------------------------
    peak = torch.cuda.max_memory_allocated()
    want = no_launches(flash_attention_fwd=cfg.n_layers * res["prefills"])
    pre = np.asarray(res["prefill_ms"])
    dec = np.asarray(res["decode_ms"]) / SERVE["gen_len"]
    log(f"[moe] {SERVE['slots']} slots in {wall:.2f} s: {res['prefills']} "
        f"prefills, served {np.round(res['served'], 2).tolist()}, Jain "
        f"{res['jain']:.4f}; launches {launches} (the path implies {want}: "
        f"{cfg.n_layers} attention forwards a prefill); peak device memory "
        f"{peak} bytes ({peak / 1e9:.2f} GB)")
    log(f"[moe] ms per prefill (batch <= {SERVE['batch']} x "
        f"{SERVE['prompt_len']} tokens): median {np.median(pre):.2f}, min "
        f"{pre.min():.2f}, max {pre.max():.2f}; ms per decode step: median "
        f"{np.median(dec):.3f}, min {dec.min():.3f}, max {dec.max():.3f}; "
        f"schedule ms per slot median {np.median(res['schedule_ms']):.3f}")
    if res["prefills"] == 0 or launches != want or windowed:
        raise AssertionError(f"launch counts {launches}, {windowed} "
                             f"windowed; the path implies {want}, none "
                             f"windowed")
    if not 0.0 < res["jain"] <= 1.0 or res["served"].sum() <= 0:
        raise AssertionError(f"served {res['served']}, Jain {res['jain']}")

    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (SERVE["batch"], SERVE["prompt_len"]))).cuda()
    drops = prefill_drops(params, cfg, toks)
    log(f"[moe] share of prefill assignments dropped at capacity "
        f"{cfg.capacity_factor}, batch {SERVE['batch']} x "
        f"{SERVE['prompt_len']}, layer by layer: "
        f"{[round(x, 4) for x in drops]} (mean {np.mean(drops):.4f})")

    # structural check: float32, capacity 8, decode == a fresh forward
    cfg32 = granite_config(compute_dtype="float32", capacity_factor=8.0)
    tf_toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (MOE_TF_B, MOE_TF_PROMPT + MOE_TF_STEPS))).cuda()
    got, ref, full = teacher_forced(params, cfg32,
                                    tf_toks[:, :MOE_TF_PROMPT], MOE_TF_STEPS,
                                    given=tf_toks[:, MOE_TF_PROMPT:])
    nudge = nudge_sensitivity(params, cfg32, {"tokens": full},
                              slice(MOE_TF_PROMPT - 1, None), ref)
    torch.cuda.empty_cache()
    tf_err, tf_rel = f32_route_check("moe structural", got, ref, MOE_TF_TOL,
                                     nudge)
    log(f"[moe] structural check, float32 at capacity 8.0 (nothing "
        f"dropped): prefill {MOE_TF_B} x {MOE_TF_PROMPT} + "
        f"{MOE_TF_STEPS} teacher-forced decode steps vs a fresh forward: "
        f"max abs err {tf_err:.4g} (atol {MOE_TF_TOL[1]} x max|logit| "
        f"{float(ref.abs().max()):.4g}), norm rel err {tf_rel:.3e} (bound "
        f"{MOE_TF_TOL[0]}); argmax equal; a one-ulp nudge of every weight "
        f"moves the forward by {nudge[0]:.3e} of the largest |logit|, "
        f"{nudge[1]:.3e} in norm (at most 1/{NUDGE_MARGIN} of the bound)")
    del got, ref, full
    dispatch = moe_dispatch_check(params, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # REDUCED, float32 at capacity 8: the model on the card vs the CPU
    red = dataclasses.replace(REDUCED, compute_dtype="float32",
                              capacity_factor=8.0)
    p_cpu = granite_params(red, "cpu")
    p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
    rtoks = torch.from_numpy(np.random.default_rng(2).integers(
        0, red.vocab, (2, 104)))
    out = []
    for p, dev in ((p_gpu, "cuda"), (p_cpu, "cpu")):
        last, caches, pos = prefill(p, {"tokens": rtoks[:, :100].to(dev)},
                                    red)
        steps = [last]
        caches = pad_cache(caches, red, extra=4)
        for i in range(4):
            lg, caches = decode_step(p, rtoks[:, 100 + i:101 + i].to(dev),
                                     caches, pos + i, red)
            steps.append(lg)
        out.append(torch.stack(steps).cpu())
    e_l = check_close("moe REDUCED logits card vs CPU", out[0], out[1],
                      1e-4, 1e-4)
    log(f"[moe] REDUCED float32 at capacity 8, prefill 100 tokens + 4 "
        f"decode steps, card vs CPU: logits max abs err {e_l:.3e} (rtol "
        f"1e-4)")

    # REDUCED serve loop (its defaults, bf16) on the card and on the CPU
    red = REDUCED
    t1 = time.perf_counter()
    card = serve(red, granite_params(red, "cuda"), device="cuda")
    t2 = time.perf_counter()
    cpu = serve(red, granite_params(red, "cpu"), device="cpu")
    for key in ("admitted", "scheduled", "served"):
        if not np.array_equal(card[key], cpu[key]):
            raise AssertionError(f"moe REDUCED serve {key}: card "
                                 f"{card[key]}, CPU {cpu[key]}")
    seconds = time.perf_counter() - t_phase
    log(f"[moe] REDUCED serve loop (40 slots): card {t2 - t1:.1f} s, CPU "
        f"{time.perf_counter() - t2:.1f} s; equal admissions, schedules and "
        f"served counts {np.round(card['served'], 2).tolist()}")
    log(f"[moe] phase passed in {seconds:.1f} s")
    return {"launches": launches, "windowed": windowed, "res": res,
            "peak": peak, "n_params": n_params, "drops": drops,
            "tf": (tf_err, tf_rel) + nudge,
            "dispatch": dispatch, "seconds": seconds}


#: the zoo's float32 route, decode (or a batch of two) against a fresh
#: forward: ``TF_TOL``'s float32 bounds (rtol in norm, atol as a fraction
#: of the largest |logit|), the weights conditioned to ``NUDGE_MARGIN``
#: times inside them (measured each run; not for llama4, whose weights
#: are bfloat16 and do not fit twice)
ZOO_F32_TOL = TF_TOL["float32"]
#: the bf16 route against the float32 forward on the same inputs, in
#: norm: ``RG_TF_TOL``'s bf16 bound
ZOO_BF16_TOL = RG_TF_TOL["bfloat16"][0]


def zoo_config(arch, layers, **over):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers:
        over = dict(n_layers=layers, **over)
    return dataclasses.replace(cfg, **over)


def _in_type(batch, dtype):
    return {k: v.to(dtype) if v.is_floating_point() and k != "weights"
            else v for k, v in batch.items()}


def zoo_one(arch, layers) -> dict:
    """One config of the zoo at full width (``layers`` kept): a bf16
    prefill of ZOO_B x ZOO_S and one decode step (an encoder: one
    forward), then the float32 route, each held as ``ZOO_*_TOL`` say."""
    import numpy as np
    import torch

    from repro_torch.data.batches import synthetic_batch
    from repro_torch.models.transformer import (decode_step, init_params,
                                                pad_cache, prefill)
    from repro_torch.optim.optimizers import tree_leaves

    t0 = time.perf_counter()
    cfg = zoo_config(arch, layers)
    over32 = dict(compute_dtype="float32")
    if cfg.n_experts:
        over32["capacity_factor"] = 8.0      # the structural check
    cfg32 = zoo_config(arch, layers, **over32)
    n_attn = sum(m in ("attn", "local") for m, _ in cfg.layer_kinds())
    n_local = sum(m == "local" for m, _ in cfg.layer_kinds()) \
        if cfg.window else 0
    decoder = cfg.frontend != "audio"
    torch.cuda.reset_peak_memory_stats()
    params = conditioned(init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda"),
        cfg)
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    # float32 inputs; the bf16 route rounds them as synthetic_batch does
    full = synthetic_batch(cfg32, ZOO_B, ZOO_S + decoder, "prefill", seed=1,
                           device="cuda")
    dt = getattr(torch, cfg.compute_dtype)
    S = ZOO_S
    if decoder:
        prompt = dict(full, tokens=full["tokens"][:, :-1])
        nxt = full["tokens"][:, -1:]
    out = {"arch": arch, "layers": cfg.n_layers, "n_params": n_params,
           "param_bytes": n_bytes}

    # ---- bf16: counts zeroed just before, read just after ----
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.perf_counter()
    if decoder:
        last_b, caches, pos = prefill(params, _in_type(prompt, dt), cfg)
    else:
        all_b = batch_logits(params, cfg, _in_type(full, dt), slice(None))
    torch.cuda.synchronize()
    out["prefill_ms"] = (time.perf_counter() - t1) * 1e3
    out["launches"] = read_counts()
    out["windowed"] = windowed_launches()
    # ---------------------------------------------------------------------
    want = no_launches(flash_attention_fwd=n_attn)
    if out["launches"] != want or out["windowed"] != n_local:
        raise AssertionError(f"zoo {arch} launches {out['launches']}, "
                             f"{out['windowed']} windowed; one prefill "
                             f"implies {want}, {n_local} windowed")
    if decoder:
        if pos != S:
            raise AssertionError(f"zoo {arch}: prefill pos {pos}, want {S}")
        caches = pad_cache(caches, cfg, extra=1)
        t2 = time.perf_counter()
        step_b, _ = decode_step(params, nxt, caches, pos, cfg)
        torch.cuda.synchronize()
        out["decode_ms"] = (time.perf_counter() - t2) * 1e3
        del caches
        got_b = torch.stack([last_b, step_b], dim=1)
    else:
        got_b = all_b
    if not bool(torch.isfinite(got_b).all()):
        raise AssertionError(f"zoo {arch}: bf16 logits not finite")

    # ---- float32 route ----
    positions = [S - 1, S] if decoder else slice(None)
    fresh = batch_logits(params, cfg32, full, positions)
    if decoder:
        last_f, caches, pos = prefill(params, prompt, cfg32)
        caches = pad_cache(caches, cfg32, extra=1)
        step_f, _ = decode_step(params, nxt, caches, pos, cfg32)
        del caches
        got_f = torch.stack([last_f, step_f], dim=1)
        what = "prefill's last position and one decode step vs a fresh forward"
    else:
        got_f = torch.cat([batch_logits(params, cfg32,
                                        {k: v[i:i + 1] for k, v in
                                         full.items()}, slice(None))
                           for i in range(ZOO_B)])
        what = f"a batch of {ZOO_B} vs each sequence alone"
    nudge = None
    if params["embed"].dtype == torch.float32:
        nudge = out["nudge"] = nudge_sensitivity(params, cfg32, full,
                                                 positions, fresh)
    e32, rel32 = f32_route_check(f"zoo {arch}", got_f, fresh, ZOO_F32_TOL,
                                 nudge)
    # bf16 against the float32 forward (llama4: the decode step only, its
    # bf16 prefill drops tokens at capacity 1.25 by design)
    cols = slice(1, 2) if (decoder and cfg.n_experts) else slice(None)
    rel16 = _rel_norm(got_b[:, cols], fresh[:, cols])
    if rel16 > ZOO_BF16_TOL:
        raise AssertionError(f"zoo {arch} bf16 vs float32: norm rel "
                             f"{rel16} (bound {ZOO_BF16_TOL})")
    out.update(f32_err=e32, f32_rel=rel32,
               bf16_rel=rel16, peak=torch.cuda.max_memory_allocated(),
               seconds=time.perf_counter() - t0)
    sens = (f"; a one-ulp nudge of every weight moves the float32 forward "
            f"by {nudge[0]:.3e} of the largest |logit|, {nudge[1]:.3e} in "
            f"norm (at most 1/{NUDGE_MARGIN} of the bound)" if nudge else
            "; no nudge (bfloat16 weights)")
    rtol, frac = ZOO_F32_TOL
    log(f"[zoo] {arch}: {cfg.n_layers} of {zoo_config(arch, None).n_layers}"
        f" layers, "
        f"{n_params} parameters ({n_bytes / 1e9:.2f} GB {cfg.param_dtype})"
        f", {n_attn} attention layers (D {cfg.head_dim}, G "
        f"{cfg.group_size}, causal {cfg.causal}, window {cfg.window}); bf16 "
        f"{'prefill' if decoder else 'forward'} of {ZOO_B} x {S}: "
        f"{out['prefill_ms']:.1f} ms, launches {out['launches']} "
        f"({out['windowed']} of them windowed)"
        + (f", decode step {out['decode_ms']:.1f} ms" if decoder else "")
        + f"; float32 ({what}): max abs err {e32:.3e} (atol {frac} x "
        f"max|logit| {float(fresh.abs().max()):.4g}), norm rel {rel32:.3e} "
        f"(bound {rtol}), argmax equal{sens}; bf16 vs float32 norm rel "
        f"{rel16:.4f} "
        f"(bound {ZOO_BF16_TOL}); peak {out['peak'] / 1e9:.2f} GB; "
        f"{out['seconds']:.1f} s")
    del params, full, fresh, got_f, got_b
    gc.collect()
    torch.cuda.empty_cache()
    return out


def zoo_phase() -> dict:
    """Every other new config at full width, its depth cut as ``ZOO``
    says; returns each one's numbers by arch."""
    t0 = time.perf_counter()
    out = {arch: zoo_one(arch, layers) for arch, layers in ZOO}
    log(f"[zoo] phase passed in {time.perf_counter() - t0:.1f} s")
    return out


# --------------------------------------------------------------------- #
# 13. fleet: the batched fleet engines and their telemetry
# --------------------------------------------------------------------- #
#: fleet_scale.py::FULL: 64 seeds x 3 epochs; MEGAFLEET_SMOKE: 1,000 lanes
FLEET_SEEDS, FLEET_EPOCHS, MEGAFLEET_LANES = 64, 3, 1000
#: grid_sweep.py::SMOKE: 4 scenarios x 4 payloads x 4 schemes, 1 seed and
#: 1 epoch a cell (None keeps the scenario's payload)
SWEEP_SCENARIOS = ("homogeneous", "bursty-stragglers", "heterogeneous-rates",
                   "energy-harvesting-constrained")
SWEEP_PAYLOADS = (None, 0.5, 1.5, 2.0)
#: the ledgers of a co-simulated epoch, and their tolerance against the CPU
FLEET_LEDGERS = ("bytes_offered", "bytes_admitted", "bytes_transmitted",
                 "queue_residual", "pending_residual", "final_energy")
FLEET_TOL = dict(rtol=1e-5, atol=1e-9)


def _outcome(r) -> tuple:
    """The discrete outcomes of one epoch (and its simulated times)."""
    c = r.comm
    return (r.decode_ok, r.stage2_triggered, r.n_stragglers, r.time,
            r.compute_time, r.comm_time, c.n_slots, c.idle_slots,
            c.decode_ok, c.decode_time, c.arrived.tobytes(),
            r.weights.tobytes())


def _exact(r) -> tuple:
    """Every field of one epoch, floats as their bytes."""
    c = r.comm
    return _outcome(r) + (
        r.useful_task_time, r.total_task_time, r.executed_tasks,
        c.min_energy, c.max_overdraft,
        *(getattr(c, f).tobytes() for f in FLEET_LEDGERS))


def _close_to(tag, got, want) -> int:
    """Raise unless the lanes' outcomes are equal and their ledgers within
    FLEET_TOL; return how many lanes are equal to the last bit."""
    import numpy as np
    n_exact = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if _outcome(g) != _outcome(w):
            raise AssertionError(f"{tag} lane {i}: outcomes differ")
        for f in FLEET_LEDGERS:
            np.testing.assert_allclose(getattr(g.comm, f),
                                       getattr(w.comm, f), **FLEET_TOL,
                                       err_msg=f"{tag} lane {i} {f}")
        np.testing.assert_allclose(
            [g.comm.min_energy, g.comm.max_overdraft],
            [w.comm.min_energy, w.comm.max_overdraft], rtol=1e-5, atol=1e-6,
            err_msg=f"{tag} lane {i}")
        n_exact += _exact(g) == _exact(w)
    return n_exact


def _equal(tag, got, want) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        if _exact(g) != _exact(w):
            raise AssertionError(f"{tag} lane {i}: not bit-equal")


class _kept_runs:
    """Within the block, keep every :class:`FleetRun` that
    ``Fleet.run`` returns (``compare_schemes`` returns summaries only)."""

    def __enter__(self):
        from repro_torch.sim.fleet import Fleet
        self.runs, self._run = [], Fleet.run
        runs, run = self.runs, self._run

        def keep(fleet, *args, **kwargs):
            runs.append(run(fleet, *args, **kwargs))
            return runs[-1]
        Fleet.run = keep
        return self.runs

    def __exit__(self, *exc):
        from repro_torch.sim.fleet import Fleet
        Fleet.run = self._run
        return False


def _sync_count(fn):
    """``fn()`` under torch's CUDA sync debug mode: its result and the
    messages of the synchronising calls it made (copies to the host,
    blocking copies from pageable memory, ``.item()``), without the mode's
    one-off notice that it is a prototype."""
    import warnings

    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [str(w.message) for w in caught
                 if "called a synchronizing CUDA operation"
                 in str(w.message)]


def _waits_per_chunk(mega, smi: str) -> dict:
    """The host's waits for the card: one more epoch of ``mega`` (one
    chunk) and a 64-lane saturated-uplink epoch cut into chunks of 32,
    each after a first epoch that built the runner and pinned its host
    buffer; waits = a·chunks + b solved from the two."""
    from repro_torch.sim import scenario_spec
    from repro_torch.sim.batched import BatchedFleet
    from repro_torch.sim.spec import fleet_seeds

    sat = BatchedFleet(scenario_spec("saturated-uplink"), "two-stage",
                       fleet_seeds(FLEET_SEEDS, 0), chunk=32,
                       device="cuda")
    sat.run_epoch(0)
    counts = []
    for fleet, epoch in ((mega, 1), (sat, 1)):
        before = fleet.chunk_counters["chunks"]
        _, msgs = _sync_count(lambda: fleet.run_epoch(epoch))
        counts.append((fleet.chunk_counters["chunks"] - before, len(msgs),
                       sorted(set(m.split("\n")[0][:80] for m in msgs))))
    (c1, w1, m1), (c2, w2, m2) = counts
    a = (w2 - w1) / (c2 - c1) if c2 != c1 else float("nan")
    out = {"a_per_chunk": a, "b_per_epoch": w1 - a * c1,
           "runs": [(c1, w1), (c2, w2)]}
    log(f"[fleet] host waits for the card (torch's sync debug mode): "
        f"{w1} in an epoch of {c1} chunk(s), {w2} in one of {c2} -> "
        f"{a:.2f} a chunk + {out['b_per_epoch']:.2f} an epoch; calls: "
        f"{sorted(set(m1) | set(m2))} ({smi})")
    return out


def _fleet_profile(smi: str) -> dict:
    """One epoch of a 64-lane ``fading-uplink`` two-stage fleet under
    ``torch.profiler``: kernels a slot of the chunk loop, their device
    time, and the share of the epoch in which the card ran no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.sim import scenario_spec
    from repro_torch.sim.batched import BatchedFleet
    from repro_torch.sim.spec import fleet_seeds

    fleet = BatchedFleet(scenario_spec("fading-uplink"), "two-stage",
                         fleet_seeds(FLEET_SEEDS, 0), device="cuda")
    fleet.run_epoch(0)                                  # builds the runner
    torch.cuda.synchronize()
    before = dict(fleet.chunk_counters)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fleet.run_epoch(1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    slots = fleet.chunk_counters["slots"] - before["slots"]
    loop_ms = 1e3 * (fleet.chunk_counters["seconds"] - before["seconds"])
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"[fleet] profile: {wall:.2f} ms host time; no device events "
            f"recorded, so the idle share is not measured ({smi})")
        return {"wall_ms": wall}
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    out = {"wall_ms": wall, "loop_ms": loop_ms, "slots": slots,
           "kernels": len(kernels), "kernels_per_slot": len(kernels) / slots,
           "busy_ms": busy, "idle": max(0.0, 1 - busy / wall)}
    log(f"[fleet] profile of one 64-lane fading-uplink epoch: {wall:.2f} ms "
        f"(chunk loop {loop_ms:.2f} ms over {slots} slots, "
        f"{loop_ms / slots:.3f} ms a slot under the profiler), "
        f"{len(kernels)} kernels ({len(kernels) / slots:.1f} a slot), "
        f"{busy:.2f} ms of kernels -> the card idle {out['idle']:.1%} "
        f"({smi})")
    return out


def fleet_phase(smi: str) -> dict:
    """The batched fleet engines on the card: (a) ``compare_schemes`` on
    every registry scenario, 4 schemes x 64 seeds x 3 epochs, against the
    same fleets on the CPU; (b) the oracle (seeds 0 and 1 of the fleet)
    and the hybrid engine against (a); (c) a 1,000-lane megafleet whose
    first 64 lanes must equal (a); (d) the grid sweep against per-cell
    runs; (e) a recorded fleet against the unrecorded one and the
    oracle's series.  Returns the phase's numbers."""
    import json as _json
    import tempfile

    import numpy as np
    import torch

    from repro_torch.sim import (ExperimentSpec, Fleet, available_scenarios,
                                 build_cluster, compare_schemes, plan_groups,
                                 reset_scan_compile_cache, run_experiment,
                                 scan_trace_count, scenario_spec, sweep)
    from repro_torch.sim.batched import BatchedFleet
    from repro_torch.sim.spec import fleet_seeds
    from repro_torch.telemetry import FleetRecorder, write_chrome_trace

    t_phase = time.perf_counter()
    seeds = fleet_seeds(FLEET_SEEDS, 0)
    out = {"a": {}, "oracle_ms_slot": None}
    card = {}
    # (a) compare_schemes on the card; its fleets' lanes (kept by a
    # wrapper around Fleet.run) against the same fleets on the CPU
    a_s = a_cpu_s = 0.0
    n_exact = n_lanes = 0
    for name in sorted(available_scenarios()):
        spec = scenario_spec(name)
        torch.cuda.synchronize()
        with _kept_runs() as kept:
            t0 = time.perf_counter()
            summ = compare_schemes(spec, n_seeds=FLEET_SEEDS,
                                   n_epochs=FLEET_EPOCHS, engine="batched",
                                   device="cuda")
            dt = time.perf_counter() - t0
        a_s += dt
        for scheme, run in zip(SCHEMES, kept):
            if (run.scheme, run.seeds) != (scheme, seeds) or \
                    run.summary() != summ[scheme]:
                raise AssertionError(f"{name}/{scheme}: not the run "
                                     f"compare_schemes summarised")
            t1 = time.perf_counter()
            cpu = Fleet(spec).run(scheme, seeds, n_epochs=FLEET_EPOCHS,
                                  engine="batched", device="cpu")
            a_cpu_s += time.perf_counter() - t1
            for e in range(FLEET_EPOCHS):
                n_exact += _close_to(f"(a) {name}/{scheme} epoch {e}",
                                     run.results[e], cpu.results[e])
                n_lanes += FLEET_SEEDS
            card[(name, scheme)] = run.results
            log(f"[fleet] {summ[scheme].row()}")
        se = len(SCHEMES) * FLEET_SEEDS * FLEET_EPOCHS
        out["a"][name] = {"seconds": dt, "seed_epochs_per_s": se / dt}
        log(f"[fleet] (a) {name}: compare_schemes {dt:.2f} s on the card, "
            f"{se / dt:.0f} seed-epochs/s ({smi})")
    out["a_seconds"], out["a_cpu_seconds"] = a_s, a_cpu_s
    total_se = len(out["a"]) * len(SCHEMES) * FLEET_SEEDS * FLEET_EPOCHS
    log(f"[fleet] (a) 7 scenarios x 4 schemes x {FLEET_SEEDS} seeds x "
        f"{FLEET_EPOCHS} epochs: {a_s:.2f} s on the card "
        f"({total_se / a_s:.0f} seed-epochs/s), {a_cpu_s:.2f} s on the CPU; "
        f"outcomes equal, ledgers within rtol 1e-5, {n_exact} of {n_lanes} "
        f"lane-epochs bit-equal to the CPU's ({smi})")
    out["a_bit_equal"] = (n_exact, n_lanes)

    # (b) the oracle on the card (seeds 0 and 1 of the fleet) and the
    # hybrid engine over the 64 seeds, both exactly (a)
    oracle_s, oracle_slots = 0.0, 0
    hybrid_s = 0.0
    for (name, scheme), results in card.items():
        spec = scenario_spec(name)
        for i in (0, 1):
            cl = build_cluster(spec, scheme, seeds[i], device="cuda")
            for e in range(FLEET_EPOCHS):
                t0 = time.perf_counter()
                r = cl.run_epoch(e)
                oracle_s += time.perf_counter() - t0
                oracle_slots += r.comm.n_slots
                _equal(f"(b) oracle {name}/{scheme} seed {seeds[i]} "
                       f"epoch {e}", [r], [results[e][i]])
        t0 = time.perf_counter()
        hyb = Fleet(spec).run(scheme, seeds, n_epochs=FLEET_EPOCHS,
                              engine="hybrid", device="cuda")
        hybrid_s += time.perf_counter() - t0
        for e in range(FLEET_EPOCHS):
            _equal(f"(b) hybrid {name}/{scheme} epoch {e}",
                   hyb.results[e], results[e])
    out["oracle_ms_slot"] = 1e3 * oracle_s / oracle_slots
    out["hybrid_seconds"] = hybrid_s
    log(f"[fleet] (b) oracle = lanes 0, 1 and hybrid = batched, bit for "
        f"bit, on all 28 fleets; the oracle {out['oracle_ms_slot']:.3f} ms "
        f"a slot over {oracle_slots} slots (epoch wall time / slots, "
        f"compute phase included); hybrid {hybrid_s:.2f} s ({smi})")

    # (c) the megafleet: one epoch of homogeneous two-stage over 1,000
    # lanes; lanes 0-63 must be (a)'s epoch 0
    spec = scenario_spec("homogeneous")
    t0 = time.perf_counter()
    mega = BatchedFleet(spec, "two-stage", fleet_seeds(MEGAFLEET_LANES, 0),
                        device="cuda")
    build_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mega.run_epoch(0)
    torch.cuda.synchronize()
    mega_s = time.perf_counter() - t0
    _equal("(c) megafleet lanes 0-63", res[:FLEET_SEEDS],
           card[("homogeneous", "two-stage")][0])
    cc = dict(mega.chunk_counters)
    out["mega"] = {"lanes": MEGAFLEET_LANES, "seconds": mega_s,
                   "build_s": build_s,
                   "seeds_per_s": MEGAFLEET_LANES / mega_s,
                   "chunks": cc["chunks"], "chunk": mega.chunk,
                   "ms_chunk": 1e3 * cc["seconds"] / cc["chunks"],
                   "max_slots": max(r.comm.n_slots for r in res)}
    m = out["mega"]
    log(f"[fleet] (c) megafleet {MEGAFLEET_LANES} lanes, one epoch: "
        f"{mega_s:.2f} s ({m['seeds_per_s']:.0f} seeds/s; fleet built in "
        f"{build_s:.2f} s); {m['chunks']} chunk(s) of {m['chunk']} slots, "
        f"{m['ms_chunk']:.1f} ms a chunk; lanes 0-63 equal (a) ({smi})")
    out["waits"] = _waits_per_chunk(mega, smi)
    out["profile"] = _fleet_profile(smi)

    # (d) the sweep: grid_sweep.py's SMOKE grid, rows equal per-cell
    # run_experiment, one runner build per group at most
    grid = []
    for name in SWEEP_SCENARIOS:
        base = scenario_spec(name)
        for gb in SWEEP_PAYLOADS:
            sc = (base if gb is None else base.with_overrides(
                name=f"{name}-gb{gb}", grad_bytes=gb))
            grid.extend(ExperimentSpec(scenario=sc, scheme=scheme,
                                       n_seeds=1, n_epochs=1)
                        for scheme in SCHEMES)
    t0 = time.perf_counter()
    per_cell = [run_experiment(c, device="cuda") for c in grid]
    cell_s = time.perf_counter() - t0
    reset_scan_compile_cache()
    before = scan_trace_count()
    t0 = time.perf_counter()
    swept = sweep(grid, device="cuda")
    sweep_s = time.perf_counter() - t0
    builds = scan_trace_count() - before
    n_groups = len(plan_groups(grid))
    if swept != per_cell:
        raise AssertionError("(d) sweep rows differ from per-cell runs")
    if builds > n_groups:
        raise AssertionError(f"(d) {builds} runner builds > {n_groups} "
                             f"groups")
    out["sweep"] = {"cells": len(grid), "groups": n_groups,
                    "builds": builds, "seconds": sweep_s,
                    "per_cell_seconds": cell_s}
    log(f"[fleet] (d) sweep of {len(grid)} cells in {n_groups} groups: "
        f"{sweep_s:.2f} s, {builds} runner builds; per-cell runs "
        f"{cell_s:.2f} s; rows equal ({smi})")

    # (e) telemetry: a recorded fading-uplink fleet equals the unrecorded
    # one, its series equal the oracle's, and its trace is JSON
    spec = scenario_spec("fading-uplink")
    rec = FleetRecorder(scenario="fading-uplink", scheme="two-stage",
                        engine="batched")
    t0 = time.perf_counter()
    recorded = Fleet(spec).run("two-stage", seeds, n_epochs=1,
                               telemetry=rec, device="cuda")
    rec_s = time.perf_counter() - t0
    _equal("(e) recorded fleet", recorded.results[0],
           card[("fading-uplink", "two-stage")][0])
    rec_o = FleetRecorder()
    for i in (0, 1):
        cl = build_cluster(spec, "two-stage", seeds[i], device="cuda")
        cl.telemetry_lane = i
        cl.telemetry = rec_o
        cl.run_epoch(0)
    for i in (0, 1):
        sb, so = rec.comm_series(i, 0), rec_o.comm_series(i, 0)
        for f in sb:
            if not np.array_equal(sb[f], so[f]):
                raise AssertionError(f"(e) series {f} of lane {i} differs "
                                     f"from the oracle's")
    with tempfile.TemporaryDirectory() as tmp:
        path = write_chrome_trace(rec, str(Path(tmp) / "fleet_trace.json"))
        with open(path) as f:
            doc = _json.load(f)
    n_ev = len(doc["traceEvents"])
    out["telemetry"] = {"seconds": rec_s, "trace_events": n_ev}
    log(f"[fleet] (e) recorded fleet {rec_s:.2f} s, equal to the "
        f"unrecorded one; series of lanes 0, 1 equal the oracle's; "
        f"Chrome trace {n_ev} events ({smi})")
    out["seconds"] = time.perf_counter() - t_phase
    out["card"] = card
    log(f"[fleet] phase passed in {out['seconds']:.1f} s ({smi})")
    return out


# --------------------------------------------------------------------- #
# 14. device: the device-resident epoch tail
# --------------------------------------------------------------------- #
class _kept_fleets:
    """Within the block, keep every ``BatchedFleet`` that runs (its
    ``chunk_counters`` hold the chunk loop's chunks, waits and seconds)."""

    def __enter__(self):
        from repro_torch.sim.batched import BatchedFleet
        self.fleets, self._run = [], BatchedFleet.run
        fleets, run = self.fleets, self._run

        def keep(fleet, *args, **kwargs):
            fleets.append(fleet)
            return run(fleet, *args, **kwargs)
        BatchedFleet.run = keep
        return self.fleets

    def __exit__(self, *exc):
        from repro_torch.sim.batched import BatchedFleet
        BatchedFleet.run = self._run
        return False


def _counters(fleets) -> dict:
    keys = ("chunks", "slots", "host_waits", "seconds")
    return {k: sum(f.chunk_counters[k] for f in fleets) for k in keys}


def device_engine_phase(smi: str, fleet: dict) -> dict:
    """``compare_schemes(engine="device")`` on every registry scenario, 4
    schemes x 64 seeds x 3 epochs: every lane-epoch bit-equal to the
    ``fleet`` phase's batched run on the card; the host's waits for the
    card counted by torch's sync debug mode; seconds and seed-epochs/s
    beside the batched engine's."""
    import torch

    from repro_torch.sim import (available_scenarios, compare_schemes,
                                 scenario_spec)
    from repro_torch.sim.batched import BatchedFleet
    from repro_torch.sim.spec import fleet_seeds

    t_phase = time.perf_counter()
    seeds = fleet_seeds(FLEET_SEEDS, 0)
    out = {"a": {}}
    total_s = 0.0
    all_fleets = []
    se = len(SCHEMES) * FLEET_SEEDS * FLEET_EPOCHS
    for name in sorted(available_scenarios()):
        spec = scenario_spec(name)
        torch.cuda.synchronize()
        with _kept_runs() as kept, _kept_fleets() as fleets:
            t0 = time.perf_counter()
            summ = compare_schemes(spec, n_seeds=FLEET_SEEDS,
                                   n_epochs=FLEET_EPOCHS, engine="device",
                                   device="cuda")
            dt = time.perf_counter() - t0
        total_s += dt
        all_fleets += fleets
        if any(f.tail != "device" for f in fleets) or len(fleets) != 4:
            raise AssertionError(f"[device] {name}: not the device tail")
        for scheme, run in zip(SCHEMES, kept):
            if (run.scheme, run.seeds) != (scheme, seeds) or \
                    run.summary() != summ[scheme]:
                raise AssertionError(f"[device] {name}/{scheme}: not the "
                                     f"run compare_schemes summarised")
            for e in range(FLEET_EPOCHS):
                _equal(f"[device] {name}/{scheme} epoch {e}",
                       run.results[e], fleet["card"][(name, scheme)][e])
        batched = fleet["a"][name]
        out["a"][name] = {"seconds": dt, "seed_epochs_per_s": se / dt}
        log(f"[device] {name}: compare_schemes {dt:.2f} s on the card, "
            f"{se / dt:.0f} seed-epochs/s (batched, fleet (a): "
            f"{batched['seconds']:.2f} s, {batched['seed_epochs_per_s']:.0f}"
            f"/s); every lane-epoch bit-equal to (a) ({smi})")
    cc = _counters(all_fleets)
    out.update(seconds_total=total_s, counters=cc)
    n_se = len(out["a"]) * se
    log(f"[device] 7 scenarios x 4 schemes x {FLEET_SEEDS} seeds x "
        f"{FLEET_EPOCHS} epochs: {total_s:.2f} s ({n_se / total_s:.0f} "
        f"seed-epochs/s; batched {fleet['a_seconds']:.2f} s, "
        f"{n_se / fleet['a_seconds']:.0f}/s); chunk loop {cc['chunks']} "
        f"chunks, {cc['slots'] / cc['chunks']:.1f} slots and "
        f"{1e3 * cc['seconds'] / cc['chunks']:.2f} ms a chunk; designed host "
        f"waits {cc['host_waits']} = one a chunk + "
        f"{cc['host_waits'] - cc['chunks']} (one an epoch) ({smi})")

    # the host's waits: one single-chunk epoch and one of chunks of 32,
    # each after a first epoch; waits = a·chunks + b solved from the two
    counts = []
    for scenario, chunk in (("homogeneous", None),
                            ("saturated-uplink", 32)):
        f = BatchedFleet(scenario_spec(scenario), "two-stage", seeds,
                         chunk=chunk, tail="device", device="cuda")
        f.run_epoch(0)
        before = f.chunk_counters["chunks"]
        _, msgs = _sync_count(lambda: f.run_epoch(1))
        counts.append((f.chunk_counters["chunks"] - before, len(msgs)))
    (c1, w1), (c2, w2) = counts
    a = (w2 - w1) / (c2 - c1)
    b = w1 - a * c1
    out["waits"] = {"a_per_chunk": a, "b_per_epoch": b, "runs": counts}
    log(f"[device] host waits for the card (torch's sync debug mode): {w1} "
        f"in an epoch of {c1} chunk(s), {w2} in one of {c2} -> {a:.2f} a "
        f"chunk + {b:.2f} an epoch ({smi})")
    if a > 1.0 or b > 1.0:
        raise AssertionError(f"[device] {a:.2f} waits a chunk, {b:.2f} an "
                             f"epoch: more than one a chunk and one an "
                             f"epoch")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[device] phase passed in {out['seconds']:.1f} s ({smi})")
    return out


# --------------------------------------------------------------------- #
# 15. soak: the Lyapunov soak and its policy search
# --------------------------------------------------------------------- #
SOAK_SLOTS = 2000
#: the committed 1M-slot run of the reference's frontier benchmark
FRONTIER_BASELINE = ROOT / "benchmarks" / "baselines" / \
    "BENCH_lyapunov_frontier.json"
SOAK_MOMENTS = ("mean_Q", "max_Q", "mean_H", "mean_E", "admitted",
                "delivered", "mean_y", "drift_slope", "throughput", "jain",
                "utility")


def _soak_equal(tag, a, b, rtol) -> float:
    """Raise unless the final states of two soak results are bit-equal and
    their moments agree within ``rtol``; return the largest relative
    difference of the moments."""
    import numpy as np
    for f in a.final:
        if not np.array_equal(a.final[f], b.final[f]):
            raise AssertionError(f"{tag}: final {f} differs")
    worst = 0.0
    for f in SOAK_MOMENTS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        np.testing.assert_allclose(x, y, rtol=rtol, atol=0,
                                   err_msg=f"{tag}: {f}")
        d = np.abs(x - y) / np.maximum(np.abs(y), 1e-300)
        worst = max(worst, float(d.max()))
    return worst


def soak_phase(smi: str) -> dict:
    """(a) ``run_frontier`` at 2,000 slots on the card: finite points,
    each scenario's best throughput within 10 % of the committed 1M-slot
    frontier; the same frontier on the CPU: pareto marks and points
    equal; (b) each stacked group on the card and on the CPU: final
    float32 states bit-equal, moments within rtol 1e-12, times a slot;
    (c) chunks of 500 and 2,000 on the card bit-equal."""
    import numpy as np
    import torch

    from repro_torch.sim import plan_groups, run_soak, soak_compat_key
    from repro_torch.sim.frontier import (SCENARIOS, paper_cells,
                                          run_frontier)
    from repro_torch.sim.policy import policy_grid
    from repro_torch.sim.scenarios import scenario_spec

    t_phase = time.perf_counter()
    base = json.loads(FRONTIER_BASELINE.read_text())["metrics"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = run_frontier(SOAK_SLOTS, device="cuda")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = run_frontier(SOAK_SLOTS, device="cpu")
    cpu_s = time.perf_counter() - t0
    n_cells, n_pareto = 0, 0
    for name, row in card["scenarios"].items():
        pts = row["points"]
        if pts != cpu["scenarios"][name]["points"]:
            raise AssertionError(f"[soak] (a) {name}: points differ from "
                                 f"the CPU's")
        for p in pts:
            if not all(np.isfinite(p[k]) for k in p if k != "pareto"):
                raise AssertionError(f"[soak] (a) {name}: a point is not "
                                     f"finite: {p}")
            # the reference's bound: float32 rates carry 1e-6 slack
            if not 0.0 < p["throughput"] <= p["capacity"] * (1 + 1e-6):
                raise AssertionError(f"[soak] (a) {name}: throughput "
                                     f"outside (0, capacity]: {p}")
        want = base[f"frontier.{name}.max_throughput"]
        got = row["max_throughput"]
        if abs(got - want) > 0.10 * want:
            raise AssertionError(f"[soak] (a) {name}: best throughput "
                                 f"{got:.4f} not within 10 % of the "
                                 f"committed 1M-slot {want:.4f}")
        n_cells += len(pts)
        n_pareto += sum(p["pareto"] for p in pts)
        log(f"[soak] (a) {name}: max throughput {got:.4f} (committed "
            f"1M-slot frontier {want:.4f}), max jain "
            f"{row['max_jain']:.4f}, max mean qtot "
            f"{row['max_mean_qtot']:.2f}, max drift ratio "
            f"{row['max_drift_ratio']:.4f}, pareto V "
            f"{['%g' % p['V'] for p in pts if p['pareto']]}")
    lane_slots = n_cells * SOAK_SLOTS
    out = {"frontier": {"card_s": card_s, "cpu_s": cpu_s,
                        "cells": n_cells,
                        "card_lane_slots_per_s": lane_slots / card_s,
                        "cpu_lane_slots_per_s": lane_slots / cpu_s},
           "groups": []}
    log(f"[soak] (a) run_frontier({SOAK_SLOTS}): {n_cells} cells finite "
        f"and within their envelopes, each scenario's best within 10 % of "
        f"the committed 1M-slot frontier; card {card_s:.2f} s "
        f"({lane_slots / card_s:.0f} lane-slots/s), CPU {cpu_s:.2f} s "
        f"({lane_slots / cpu_s:.0f} lane-slots/s); points and pareto marks "
        f"({n_pareto} of {n_cells}) equal ({smi})")

    # (b), (c): each stacked group on its own
    cells = policy_grid([scenario_spec(s) for s in SCENARIOS]) + \
        paper_cells()
    lanes = [c.lane for c in cells]
    worst = 0.0
    for idxs in plan_groups(lanes, key=soak_compat_key):
        group = [lanes[i] for i in idxs]
        M, kind = soak_compat_key(group[0])
        tag = f"M={M} {kind} x {len(group)} lanes"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        on_card = run_soak(group, SOAK_SLOTS, device="cuda")
        torch.cuda.synchronize()
        c_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        on_cpu = run_soak(group, SOAK_SLOTS, device="cpu")
        p_s = time.perf_counter() - t0
        worst = max(worst, _soak_equal(f"[soak] (b) {tag}", on_card, on_cpu,
                                       rtol=1e-12))
        t0 = time.perf_counter()
        small = run_soak(group, SOAK_SLOTS, chunk=500, device="cuda")
        s_s = time.perf_counter() - t0
        _soak_equal(f"[soak] (c) {tag} chunk 500", small, on_card, rtol=0)
        g = {"group": tag, "lanes": len(group), "card_s": c_s,
             "cpu_s": p_s, "card_ms_slot": 1e3 * c_s / SOAK_SLOTS,
             "cpu_ms_slot": 1e3 * p_s / SOAK_SLOTS,
             "card_lane_slots_per_s": len(group) * SOAK_SLOTS / c_s,
             "cpu_lane_slots_per_s": len(group) * SOAK_SLOTS / p_s,
             "chunk500_s": s_s}
        out["groups"].append(g)
        log(f"[soak] (b) {tag}: {SOAK_SLOTS} slots on the card in "
            f"{c_s:.2f} s ({g['card_ms_slot']:.3f} ms a slot, "
            f"{g['card_lane_slots_per_s']:.0f} lane-slots/s), on the CPU in "
            f"{p_s:.2f} s ({g['cpu_ms_slot']:.3f} ms a slot, "
            f"{g['cpu_lane_slots_per_s']:.0f} lane-slots/s); final float32 "
            f"states bit-equal; (c) chunks of 500 ({s_s:.2f} s) bit-equal "
            f"({smi})")
    log(f"[soak] (b) moments within rtol 1e-12 (largest relative "
        f"difference {worst:.3g}); (c) chunks 500 and {SOAK_SLOTS} "
        f"bit-equal on the card")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[soak] phase passed in {out['seconds']:.1f} s ({smi})")
    return out


# --------------------------------------------------------------------- #
# 16. grid: one cell of each shape through the step builders
# --------------------------------------------------------------------- #
#: (arch, shape, batch): one cell of each shape of the (arch x shape)
#: grid, at the shape's full sequence length, the config at full width
#: and depth; each batch cut to what fits on the card.  train_4k: 256 ->
#: 24 sequences (the functional step holds params, both moments and the
#: residuals, 26.3 GB, and a backward takes 2.65 + 1.31 GB a sequence:
#: ~60 GB at 24; 31 ran out of memory at the second step);
#: prefill_32k: 32 -> 8 prompts (17.7 GB + 6.44 a prompt: ~63 GB)
GRID = (("stablelm-1.6b", "train_4k", 24),
        ("recurrentgemma-2b", "prefill_32k", 8),
        ("recurrentgemma-2b", "decode_32k", 128),
        ("rwkv6-1.6b", "long_500k", 1))
#: train_4k: EF int8 steps (the first a warm-up), then one EF top-k step
#: at this fraction and one plain step
GRID_EF_STEPS, GRID_TOPK = 3, 0.05
#: prefill_32k: timed prefills after a warm-up; decode_32k: timed steps
#: after a warm-up (from position 32,767)
GRID_PREFILLS, GRID_DECODE_STEPS = 2, 4
#: long_500k: the warm-up prefill's length before the whole context
GRID_LONG_WARMUP = 32768
#: the WKV check at long_500k: the plain recurrence over the first and
#: the last steps of the context (see ``grid_wkv_check``)
GRID_WKV_HEAD, GRID_WKV_TAIL = 4096, 49152
#: the quantizer's codes against the host's: rows of 256 entries in each
#: window of the largest leaf
GRID_CODE_ROWS = 4096


def _event_ms(fn):
    """``(fn(), ms)``: the call timed by CUDA events around it."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def grid_terms(cfg, shape, ms: float) -> dict:
    """The cut shape's model FLOPs over the step's time against the H100's
    bf16 peak (``mfu``), and the roofline's terms and bottleneck for the
    cut shape on one card (``model_flops`` as the compute, the analytic
    HBM bytes, no collective)."""
    from repro_torch.analysis.roofline import (analytic_hbm_bytes,
                                               model_flops, roofline_terms)
    flops = model_flops(cfg, shape)
    terms = roofline_terms(flops, analytic_hbm_bytes(cfg, shape, {}), 0.0,
                           n_devices=1, model_total_flops=flops, hw=HW_H100)
    return {"ms": ms, "model_flops": flops,
            "mfu": flops / (ms / 1e3) / HW_H100["peak_flops_bf16"],
            "compute_ms": terms.compute_s * 1e3,
            "memory_ms": terms.memory_s * 1e3,
            "bottleneck": terms.bottleneck}


def grid_line(cell, cfg, shape, what, ms_list, peak, smi) -> dict:
    import numpy as np
    ms = float(np.median(ms_list))
    t = grid_terms(cfg, shape, ms)
    log(f"[grid] {cell} {cfg.name} ({cfg.n_layers} layers) at "
        f"{shape.global_batch} x {shape.seq_len} ({shape.kind}): {what} "
        f"median {ms:.1f} ms (all {[round(x, 1) for x in ms_list]}); peak "
        f"{peak / 1e9:.2f} GB; mfu {t['mfu']:.4f} ({t['model_flops']:.4g} "
        f"model FLOPs); roofline compute {t['compute_ms']:.2f} ms, memory "
        f"{t['memory_ms']:.2f} ms -> bottleneck {t['bottleneck']} ({smi})")
    t.update(cell=cell, arch=cfg.name, what=what, peak=peak,
             batch=shape.global_batch, seq=shape.seq_len)
    return t


def _host_codes(blocks, scale, key, row0: int):
    """The int8 codes of rows ``row0...`` of a leaf's (rows, 256) blocks by
    the host's route: numpy threefry draws (``threefry.threefry2x32`` at
    the rows' flat counters), numpy float32 arithmetic."""
    import numpy as np

    from repro_torch.sim import threefry
    i = np.arange(row0 * 256, (row0 + blocks.shape[0]) * 256,
                  dtype=np.uint64)
    y0, y1 = threefry.threefry2x32(
        key, (i >> np.uint64(32)).astype(np.uint32),
        (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    noise = threefry.bits_to_unit_float32(y0 ^ y1).reshape(blocks.shape)
    y = blocks / scale
    return np.clip(np.floor(y + noise), -127, 127).astype(np.int8)


class _CheckedEF:
    """The train_4k cell's ``grad_transform``: the EF int8 compressor
    (``ErrorFeedback``), its time on the card by CUDA events, and its
    checks on each call: every leaf's output within one quantization
    step of its block of the gradient it was given (the batch's gradient
    plus the carried residual; on the first call the batch's gradient
    alone), the residual exactly their difference; on the first call the
    codes on the card of a whole leaf and of windows of the largest leaf
    equal to the host's route, and their dequantized values what the step
    sent."""

    def __init__(self, params, key):
        from repro_torch.compress import ErrorFeedback, make_ef_quantizer
        self.ef = ErrorFeedback(make_ef_quantizer(), params, key)
        self.ms, self.worst, self.code_rows = [], 0.0, 0

    def __call__(self, grads):
        errors, call = self.ef.errors, self.ef.calls
        out, ms = _event_ms(lambda: self.ef(grads))
        self.ms.append(ms)
        self.check(grads, errors, out, self.ef.errors, call)
        return out

    def check(self, grads, errors, out, new, call):
        import torch
        import torch.nn.functional as F

        from repro_torch.optim.optimizers import tree_leaves
        leaves = [tree_leaves(t) for t in (grads, errors, out, new)]
        for i, (g, e, o, e_new) in enumerate(zip(*leaves)):
            c = g.float() + e
            if call == 0 and not torch.equal(c, g):
                raise AssertionError(f"[grid] leaf {i}: the first residual "
                                     f"is not zero")
            if not torch.equal(e_new, c - o.float()):
                raise AssertionError(f"[grid] EF int8 call {call} leaf {i}: "
                                     f"the residual is not the gradient "
                                     f"minus what was sent")
            pad = (-c.numel()) % 256
            blocks = F.pad(c.reshape(-1), (0, pad)).view(-1, 256)
            step = torch.clamp_min(blocks.abs().amax(1, keepdim=True) /
                                   127.0, 1e-12)
            dev = F.pad((o.float() - c).reshape(-1), (0, pad)).view(-1, 256)
            ratio = float((dev.abs() / step).max())
            # one step, and the float32 roundings of y = x/s, y + u and
            # q·s, each under 2^-17 of a step at |y| <= 128
            if not ratio <= 1.0 + 2.0 ** -15:
                raise AssertionError(f"[grid] EF int8 call {call} leaf {i}: "
                                     f"{ratio:.6f} quantization steps from "
                                     f"its gradient")
            self.worst = max(self.worst, ratio)
            del c, blocks, step, dev
        if call == 0:
            self.check_codes(leaves[0], leaves[2])

    def check_codes(self, grads, out):
        import numpy as np
        import torch

        from repro_torch.compress import dequantize_int8, quantize_int8
        from repro_torch.compress.quantize import DRAW_SLICE
        from repro_torch.sim import threefry
        keys = threefry.split(threefry.fold_in(self.ef.key, 0), len(grads))
        sizes = [g.numel() for g in grads]
        # the smallest leaf of at least 2^14 entries, whole (the host's
        # numpy route takes ~0.2 s a million); windows of the largest
        whole = min(range(len(grads)), key=lambda i: (sizes[i] < 2 ** 14,
                                                      sizes[i]))
        big = max(range(len(grads)), key=lambda i: sizes[i])
        for i in (whole, big):
            g = grads[i]
            q, s = quantize_int8(g, keys[i])
            if not torch.equal(dequantize_int8(q, s, g.shape, g.numel()),
                               out[i]):
                raise AssertionError(f"[grid] leaf {i}: the codes do not "
                                     f"give what the step sent")
            n_rows = q.shape[0]
            mid = DRAW_SLICE // 256          # a slice of draws ends here
            starts = [0] if i == whole else sorted(
                {0, max(0, mid - GRID_CODE_ROWS // 2),
                 n_rows - GRID_CODE_ROWS})
            rows = n_rows if i == whole else GRID_CODE_ROWS
            flat = torch.nn.functional.pad(
                g.reshape(-1), (0, (-g.numel()) % 256)).view(-1, 256)
            for r0 in starts:
                host = _host_codes(flat[r0:r0 + rows].cpu().numpy(),
                                   s[r0:r0 + rows].cpu().numpy(), keys[i],
                                   r0)
                if not np.array_equal(q[r0:r0 + rows].cpu().numpy(), host):
                    raise AssertionError(f"[grid] leaf {i} rows {r0}+"
                                         f"{rows}: card codes differ from "
                                         f"the host route's")
                self.code_rows += rows
            log(f"[grid] EF int8 codes on the card equal the host route's: "
                f"leaf {i} ({tuple(g.shape)}, {g.numel()} entries) "
                + ("whole" if i == whole else
                   f"rows {starts} x {rows} of {n_rows}"))


def _lm_batch(vocab, B, S, gen, device):
    import torch
    tokens = torch.randint(0, vocab, (B, S), generator=gen, device=device)
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, 1),
            "weights": torch.ones((B, S), device=device)}


def grid_train(cfg, shape, smi, device="cuda") -> dict:
    """train_4k: ``make_train_step`` with the EF int8 quantizer carried by
    ``ErrorFeedback`` (``GRID_EF_STEPS`` steps), one EF top-k step, one
    plain step; finite losses, the quantizer's checks, launches."""
    import math

    import torch

    from repro_torch.compress import ErrorFeedback, make_ef_topk
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import init_params
    from repro_torch.sim import threefry

    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device=device)
    B, S = shape.global_batch, shape.seq_len
    out, losses, peaks = {}, [], []

    def run(tag, hook, n):
        nonlocal params, opt_state
        step, _ = make_train_step(cfg, 1, grad_transform=hook)
        ms = []
        torch.cuda.reset_peak_memory_stats()
        for _ in range(n):
            batch = _lm_batch(cfg.vocab, B, S, gen, device)
            (params, opt_state, aux), t = _event_ms(
                lambda: step(params, opt_state, batch))
            ms.append(t)
            losses.append(float(aux["loss"]))
            del batch, aux
        peaks.append(torch.cuda.max_memory_allocated())
        log(f"[grid] train_4k {tag}: losses {losses[-n:]}, step ms "
            f"{[round(x, 1) for x in ms]}, peak {peaks[-1] / 1e9:.2f} GB")
        return ms

    _, opt = make_train_step(cfg, 1)
    opt_state = opt.init(params)
    reset_counts()
    ef = _CheckedEF(params, threefry.prng_key(0))
    ef_ms = run("EF int8", ef, GRID_EF_STEPS)
    ef.ef.errors = None
    topk = ErrorFeedback(make_ef_topk(GRID_TOPK), params)
    topk_ms = run(f"EF top-k {GRID_TOPK}", topk, 1)
    del topk
    plain_ms = run("plain", None, 1)
    launches = read_counts()
    n, L = GRID_EF_STEPS + 2, cfg.n_layers
    want = no_launches(flash_attention_fwd=2 * L * n,
                       flash_attention_bwd=L * n)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[grid] train_4k losses {losses}")
    if launches != want:
        raise AssertionError(f"[grid] train_4k launches {launches}, the "
                             f"path implies {want}")
    log(f"[grid] train_4k: launches {launches} as the path implies "
        f"(attention forward twice a layer and step under remat, backward "
        f"once); EF int8 within {ef.worst:.6f} of one quantization step "
        f"of every block, residuals exact, {ef.code_rows} rows of codes "
        f"equal to the host route's; quantizer hook ms "
        f"{[round(x, 1) for x in ef.ms]}")
    peak = max(peaks)
    out["ef"] = grid_line("train_4k", cfg, shape, "EF int8 step (after "
                          "the first)", ef_ms[1:], peak, smi)
    out["topk"] = grid_line("train_4k", cfg, shape, "EF top-k step",
                            topk_ms, peak, smi)
    out["plain"] = grid_line("train_4k", cfg, shape, "plain step",
                             plain_ms, peak, smi)
    out.update(launches=launches, quant_ms=ef.ms, losses=losses,
               peak=peak)
    del params, opt_state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def grid_prefill(cfg, shape, smi, device="cuda") -> dict:
    """prefill_32k: ``make_prefill_step`` (a warm-up, then
    ``GRID_PREFILLS`` timed); finite logits of the right shape; the
    RG-LRU kernel once a rec layer and the windowed attention forward once
    a local layer, each prefill."""
    import torch

    from repro_torch.launch.steps import make_prefill_step
    params = rg_params(cfg, device)
    gen = torch.Generator(device=device).manual_seed(1)
    B, S = shape.global_batch, shape.seq_len
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device=device)
    step = make_prefill_step(cfg, 1)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for i in range(GRID_PREFILLS + 1):
        (logits, caches), t = _event_ms(lambda: step(params,
                                                     {"tokens": tokens}))
        if i:
            ms.append(t)
        if tuple(logits.shape) != (B, cfg.vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"[grid] prefill_32k logits "
                                 f"{tuple(logits.shape)} not finite")
        del logits, caches
    peak = torch.cuda.max_memory_allocated()
    launches, windowed = read_counts(), windowed_launches()
    kinds = [m for m, _ in cfg.layer_kinds()]
    n = GRID_PREFILLS + 1
    want = no_launches(rglru_scan=kinds.count("rec") * n,
                       flash_attention_fwd=kinds.count("local") * n)
    if launches != want or windowed != want["flash_attention_fwd"]:
        raise AssertionError(f"[grid] prefill_32k launches {launches} "
                             f"(windowed {windowed}), the path implies "
                             f"{want}, all windowed")
    log(f"[grid] prefill_32k: launches {launches} as the path implies "
        f"(all {windowed} attention launches windowed)")
    out = grid_line("prefill_32k", cfg, shape, "prefill", ms, peak, smi)
    out["launches"] = launches
    del params, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _draw_caches(caches, gen):
    """Every cache leaf drawn from ``gen``: keys, values and conv rows
    N(0, 1), recurrent states N(0, 0.1)."""
    import torch

    from repro_torch.optim.optimizers import tree_leaves
    for t in tree_leaves(caches):
        t.normal_(0.0, 1.0 if t.dtype != torch.float32 else 0.1,
                  generator=gen)
    return caches


def grid_decode(cfg, shape, smi, device="cuda") -> dict:
    """decode_32k: ``make_serve_step`` over caches of the shape's size
    drawn from the seed, from position 32,767 (a warm-up step, then
    ``GRID_DECODE_STEPS`` timed); finite logits; no kernel launched (the
    decode step has none)."""
    import torch

    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.transformer import init_cache
    from repro_torch.optim.optimizers import tree_leaves
    params = rg_params(cfg, device)
    gen = torch.Generator(device=device).manual_seed(2)
    B, S = shape.global_batch, shape.seq_len
    caches = _draw_caches(init_cache(cfg, B, S, device=device), gen)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(caches))
    tokens = torch.randint(0, cfg.vocab, (B, 1), generator=gen,
                           device=device)
    step = make_serve_step(cfg, 1)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for i in range(GRID_DECODE_STEPS + 1):
        (logits, caches), t = _event_ms(lambda: step(params, tokens, caches,
                                                     S - 1 + i))
        if i:
            ms.append(t)
        if tuple(logits.shape) != (B, cfg.vocab) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError("[grid] decode_32k logits not finite")
        tokens = logits.argmax(-1, keepdim=True)
    peak = torch.cuda.max_memory_allocated()
    launches = read_counts()
    if launches != no_launches():
        raise AssertionError(f"[grid] decode_32k launches {launches}, the "
                             f"decode step has no kernel")
    log(f"[grid] decode_32k: caches {cache_bytes / 1e9:.3f} GB drawn from "
        f"the seed; no kernel launched, as the path implies")
    out = grid_line("decode_32k", cfg, shape, "decode step", ms, peak, smi)
    out.update(launches=launches, cache_bytes=cache_bytes)
    del params, caches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def grid_long(cfg, shape, smi, device="cuda") -> dict:
    """long_500k: ``make_prefill_step`` over the whole context (after a
    ``GRID_LONG_WARMUP``-token warm-up), then ``make_serve_step`` from its
    caches (a warm-up step, then one timed); finite logits; the WKV kernel
    once a layer and prefill."""
    import dataclasses as dc

    import torch

    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    params = serve_params(cfg, device)
    gen = torch.Generator(device=device).manual_seed(3)
    B, S = shape.global_batch, shape.seq_len
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                           device=device)
    prefill, serve = make_prefill_step(cfg, 1), make_serve_step(cfg, 1)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    _, t_warm = _event_ms(lambda: prefill(
        params, {"tokens": tokens[:, :GRID_LONG_WARMUP]}))
    (logits, caches), t_pre = _event_ms(lambda: prefill(
        params, {"tokens": tokens}))
    pre_peak = torch.cuda.max_memory_allocated()
    ms = []
    tok = logits.argmax(-1, keepdim=True)
    for i in range(2):
        (logits, caches), t = _event_ms(lambda: serve(params, tok, caches,
                                                      S + i))
        ms.append(t)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("[grid] long_500k logits not finite")
        tok = logits.argmax(-1, keepdim=True)
    peak = torch.cuda.max_memory_allocated()
    launches = read_counts()
    kinds = [m for m, _ in cfg.layer_kinds()]
    want = no_launches(rwkv6_wkv=2 * kinds.count("rwkv"))
    if launches != want:
        raise AssertionError(f"[grid] long_500k launches {launches}, the "
                             f"path implies {want}")
    log(f"[grid] long_500k: launches {launches} as the path implies (WKV "
        f"once a layer and prefill; the decode step has no kernel); "
        f"warm-up prefill of {GRID_LONG_WARMUP} tokens {t_warm:.1f} ms")
    out = {"prefill": grid_line(
        "long_500k", cfg, dc.replace(shape, kind="prefill"), "prefill of "
        "the whole context", [t_pre], pre_peak, smi),
        "decode": grid_line("long_500k", cfg, shape, "serve step after it",
                            ms[1:], peak, smi),
        "launches": launches}
    del params, caches, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return out


def grid_wkv_check(shape) -> tuple:
    """The WKV kernel at the whole of long_500k's shape against the plain
    recurrence (``wkv_ref``): the first ``GRID_WKV_HEAD`` outputs exactly
    as ``wkv_kernel_phase`` holds them, and the last outputs and the final
    state against the plain recurrence over the last ``GRID_WKV_TAIL``
    steps from a zero state.  The decays are ``_wkv_inputs``'s "path"
    draws, at most exp(-exp(-8)), so what the steps before that window
    leave in the state is scaled by at most exp(-exp(-8))^(TAIL - HEAD)
    = 2.8e-7 by its end: below the outputs' bf16 tolerance.
    Returns (largest output error, the plain version's ms over the
    tail)."""
    import torch

    from repro_torch.kernels.rwkv6_wkv import wkv, wkv_ref
    r, k, v, w, u = _wkv_inputs(6, shape, torch.bfloat16, "path", card=True)
    out, s_last = wkv(r, k, v, w, u)
    torch.cuda.synchronize()
    T, H0 = shape[2], GRID_WKV_HEAD
    out_h, _ = wkv_ref(*(x[:, :, :H0] for x in (r, k, v, w)), u)
    e = check_close(f"wkv {shape} first {H0} steps", out[:, :, :H0], out_h,
                    1e-2, 1e-2)
    t0 = T - GRID_WKV_TAIL
    (out_t, s_t), ms = _event_ms(lambda: wkv_ref(
        *(x[:, :, t0:] for x in (r, k, v, w)), u))
    e = max(e, check_close(f"wkv {shape} last {H0} steps",
                           out[:, :, T - H0:], out_t[:, :, -H0:], 1e-2,
                           1e-2))
    e_s = check_close(f"wkv {shape} S_last", s_last, s_t, 2e-4,
                      2e-4 * max(1.0, float(s_t.abs().max())))
    log(f"[kernels] wkv {shape} bf16 (long_500k): max abs err out {e:.3e} "
        f"(rtol 1e-2, atol 1e-2) over the first and last {H0} steps, "
        f"S_last {e_s:.3e}; the plain recurrence over the last "
        f"{GRID_WKV_TAIL} steps {ms:.1f} ms")
    del r, k, v, w, u, out, s_last, out_h, out_t, s_t
    torch.cuda.empty_cache()
    return e, ms


def grid_kernel_checks(fa_train, fa_pre, rg_pre) -> dict:
    """Each kernel of the grid's cells against its plain version at the
    cell's shape: attention forward and backward at train_4k's, the
    windowed attention forward at prefill_32k's, the RG-LRU scan there."""
    import torch

    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_fwd_ref)
    from repro_torch.kernels.rglru_scan import rglru_ref, rglru_scan
    errs = {}
    errs["fa_train"] = fa_case(f"train_4k {fa_train}", fa_train,
                               torch.bfloat16, True, 0, chunk=1024,
                               card=True)
    q, k, v, _ = _fa_inputs(7, fa_pre, torch.bfloat16, card=True)
    kw = dict(causal=True, window=RG_WINDOW, q_chunk=1024, kv_chunk=1024)
    out, lse = flash_attention_fwd(q, k, v, **kw)
    out_r, lse_r = flash_attention_fwd_ref(q, k, v, **kw)
    (fr, fa), _ = FA_TOL["bfloat16"]
    errs["fa_pre"] = max(
        check_close(f"prefill_32k {fa_pre} out", out, out_r, fr, fa),
        check_close(f"prefill_32k {fa_pre} lse", lse, lse_r, 1e-5, 1e-5))
    log(f"[kernels] flash_attention prefill_32k {fa_pre} bf16 window="
        f"{RG_WINDOW}: max abs err fwd {errs['fa_pre']:.3e} (rtol {fr}, "
        f"atol {fa})")
    del q, k, v, out, lse, out_r, lse_r
    a, b = _scan_inputs(8, rg_pre, torch.float32, card=True)
    h, h_last = rglru_scan(a, b)
    h_r, h_last_r = rglru_ref(a, b)
    scale = max(1.0, float(h_r.abs().max()))
    errs["rg_pre"] = check_close(f"rglru prefill_32k {rg_pre}", h, h_r,
                                 2e-5, 2e-5 * scale)
    check_close(f"rglru prefill_32k {rg_pre} h_last", h_last, h_last_r,
                1e-5, 1e-5 * scale)
    log(f"[kernels] rglru_scan prefill_32k {rg_pre} f32: max abs err "
        f"{errs['rg_pre']:.3e} (rtol 2e-5, atol 2e-5·{scale:.4g})")
    del a, b, h, h_last, h_r, h_last_r
    torch.cuda.empty_cache()
    return errs


def grid_phase(smi: str) -> dict:
    """[grid]: one cell of each shape (``GRID``) through the step builders
    of ``repro_torch.launch.steps``, each line with its median step time,
    peak memory, ``mfu`` and the roofline's bottleneck; then each kernel
    of the cells against its plain version at the cell's shape and its
    times there.  Launch counts are zeroed just before each cell and read
    just after it."""
    import dataclasses as dc

    import torch

    from repro_torch.configs.base import SHAPES, get_config
    t_phase = time.perf_counter()
    runs = {"train_4k": grid_train, "prefill_32k": grid_prefill,
            "decode_32k": grid_decode, "long_500k": grid_long}
    out = {}
    for arch, name, batch in GRID:
        cfg = get_config(arch)
        shape = dc.replace(SHAPES[name], global_batch=batch)
        t0 = time.perf_counter()
        out[name] = runs[name](cfg, shape, smi)
        log(f"[grid] {name} passed in {time.perf_counter() - t0:.1f} s")
    tr = get_config("stablelm-1.6b")
    rg = get_config("recurrentgemma-2b")
    rw = get_config("rwkv6-1.6b")
    b_tr, b_pre = GRID[0][2], GRID[1][2]
    fa_train = (b_tr, SHAPES["train_4k"].seq_len, tr.n_kv_heads,
                tr.n_heads // tr.n_kv_heads, tr.head_dim)
    fa_pre = (b_pre, SHAPES["prefill_32k"].seq_len, rg.n_kv_heads,
              rg.n_heads // rg.n_kv_heads, rg.head_dim)
    rg_pre = (b_pre, SHAPES["prefill_32k"].seq_len, rg.d_rnn or rg.d_model)
    wkv_long = (1, rw.d_model // rw.rwkv_head_dim,
                SHAPES["long_500k"].seq_len, rw.rwkv_head_dim,
                rw.rwkv_head_dim)
    counts = read_counts()
    errs = grid_kernel_checks(fa_train, fa_pre, rg_pre)
    errs["wkv_long"], wkv_tail_ms = grid_wkv_check(wkv_long)
    set_counts(counts)                   # these launches are not a path's
    out["times"] = {
        "fa_train": flash_times(torch.bfloat16, fa_train, reps=0.5,
                                card=True),
        "fa_pre": flash_times(torch.bfloat16, fa_pre, RG_WINDOW,
                              backward=False, reps=0.1, card=True),
        "rg_pre": rglru_times(rg_pre, reps=10, plain_reps=1, card=True),
        "wkv_long": wkv_times(wkv_long, reps=5, plain=wkv_tail_ms,
                              card=True)}
    out.update(errs=errs, shapes={"fa_train": fa_train, "fa_pre": fa_pre,
                                  "rg_pre": rg_pre, "wkv_long": wkv_long},
               wkv_plain_steps=GRID_WKV_TAIL)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[grid] phase passed in {out['seconds']:.1f} s ({smi})")
    return out


def grid_rows(grid) -> list:
    """The ``kernels`` line's rows of the grid's cells: each kernel at its
    cell's shape, its launches in that cell."""
    import torch

    from repro_torch.kernels.flash_attention.ops import kernel_route
    src = "src/repro_torch/kernels"
    fa_src = f"{src}/flash_attention/csrc/flash_attention.cu"
    t, e, sh = grid["times"], grid["errs"], grid["shapes"]
    tr_n = grid["train_4k"]["launches"]
    pre_n = grid["prefill_32k"]["launches"]

    def fa_row(name, key, which, launches, err, **extra):
        x = t[key]
        return {"name": name, "route": "cuda",
                "kernel_route": kernel_route(torch.bfloat16, sh[key][4],
                                             which == "bwd"),
                "shape": list(sh[key]), **extra, "source": fa_src,
                "replaces": (
                    "src/repro/kernels/flash_attention/flash_attention.py:88"
                    if which == "fwd" else
                    "src/repro/models/attention.py:204"),
                "launches": launches, "max_abs_err": err,
                "ms": x[f"{which}_ms"], "plain_ms": x[f"plain_{which}_ms"],
                "bound_ms": x[f"{which}_bound_ms"],
                "bound_by": x[f"{which}_bound_by"],
                "library_ms": x[f"sdpa_{which}_ms"]}
    rg, wk = t["rg_pre"], t["wkv_long"]
    return [
        fa_row("flash_attention_fwd_train_4k", "fa_train", "fwd",
               tr_n["flash_attention_fwd"], e["fa_train"][0]),
        fa_row("flash_attention_bwd_train_4k", "fa_train", "bwd",
               tr_n["flash_attention_bwd"], e["fa_train"][1]),
        fa_row("flash_attention_fwd_prefill_32k", "fa_pre", "fwd",
               pre_n["flash_attention_fwd"], e["fa_pre"],
               window=RG_WINDOW), {
        "name": "rglru_scan_prefill_32k", "route": "cuda",
        "shape": list(sh["rg_pre"]),
        "source": f"{src}/rglru_scan/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/rglru_scan.py:54",
        "launches": pre_n["rglru_scan"], "max_abs_err": e["rg_pre"],
        "ms": rg["ms"], "plain_ms": rg["plain_ms"],
        "bound_ms": rg["bound_ms"], "bound_by": rg["bound_by"],
        "library_ms": None}, {
        "name": "rwkv6_wkv_long_500k", "route": "cuda",
        "shape": list(sh["wkv_long"]),
        "source": f"{src}/rwkv6_wkv/csrc/rwkv6_wkv.cu",
        "replaces": "src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py:76",
        "launches": grid["long_500k"]["launches"]["rwkv6_wkv"],
        "max_abs_err": e["wkv_long"], "ms": wk["ms"],
        "plain_ms": wk["plain_ms"],
        "plain_steps": grid["wkv_plain_steps"],
        "bound_ms": wk["bound_ms"], "bound_by": wk["bound_by"],
        "library_ms": None}]


# --------------------------------------------------------------------- #
# 17. times
# --------------------------------------------------------------------- #
def time_ms(fn, reps=50, cold=True) -> float:
    """Median time of one call of ``fn`` on the card, by CUDA events.
    ``cold`` overwrites a 256 MiB buffer before each call, so the call's
    inputs come from HBM and not from the 50 MB L2 cache.  A sleep kernel
    then keeps the card busy while the host enqueues the call, so that the
    events time the call on the card and not the host's launch."""
    import torch
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(min(3, reps)):
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


def coded_reduce_times(n_slots, D, reps=50) -> dict:
    import torch

    from repro_torch.kernels.coded_reduce import (coded_reduce,
                                                  coded_reduce_ref)
    g, w = _uploads(3, n_slots, D, torch.float32, scale=0.1)
    counts = read_counts()
    err = check_close(f"coded_reduce ({n_slots},{D}) timed inputs",
                      coded_reduce(g, w), coded_reduce_ref(g, w), 1e-4, 1e-4)
    row = {"ms": time_ms(lambda: coded_reduce(g, w), reps),
           "plain_ms": time_ms(lambda: coded_reduce_ref(g, w), reps),
           "library_ms": time_ms(lambda: w @ g, reps),
           "warm_ms": time_ms(lambda: coded_reduce(g, w), reps, cold=False)}
    set_counts(counts)                   # these launches are not a path's
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
    del g, w
    torch.cuda.empty_cache()
    return row


def flash_times(dtype, shape=FA_PATH, window=0, backward=True,
                causal=True, reps=1.0, card=False) -> dict:
    """The kernel's forward (and backward, and forward+backward) at
    ``shape`` beside the plain version, ``scaled_dot_product_attention``
    (timed as a yardstick only) and the bound.  Where a window is shorter
    than the sequence the library's call takes it as a boolean mask (which
    rules out its flash backend), and the bound counts only the pairs the
    window leaves.  ``reps`` scales every count of timed calls (at least
    one each), for shapes whose calls take seconds; ``card`` draws the
    inputs on the card."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_ref,
        flash_attention_fwd, flash_attention_fwd_ref)

    B, S, KV, G, D = shape
    H = KV * G
    masked = bool(window) and window < S
    assert causal or not window
    kw = dict(causal=causal, window=window)
    q, k, v, do = _fa_inputs(5, shape, dtype, card)
    counts = read_counts()
    out, lse = flash_attention_fwd(q, k, v, **kw)
    def n(count):
        return max(1, round(count * reps))
    t = {"fwd_ms": time_ms(lambda: flash_attention_fwd(q, k, v, **kw),
                           n(30)),
         "plain_fwd_ms": time_ms(
             lambda: flash_attention_fwd_ref(q, k, v, **kw), n(10))}
    # the library's layout, (B, H, S, D), kv heads repeated to H, made
    # once and not timed
    qh, kh, vh, doh = [
        x.reshape(B, S, x.shape[2], -1, D).expand(B, S, KV, G, D)
        .reshape(B, S, H, D).transpose(1, 2).contiguous()
        for x in (q, k[:, :, :, None], v[:, :, :, None], do)]
    lib_kw = dict(is_causal=causal)
    if masked:
        pos = torch.arange(S, device="cuda")
        lag = pos[:, None] - pos[None, :]
        lib_kw = dict(attn_mask=(lag >= 0) & (lag < window))
    t["sdpa_fwd_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(qh, kh, vh, **lib_kw), n(30))
    if backward:
        t["bwd_ms"] = time_ms(lambda: flash_attention_bwd(
            q, k, v, out, lse, do), n(20))
        t["plain_bwd_ms"] = time_ms(lambda: flash_attention_bwd_ref(
            q, k, v, out, lse, do), n(5))
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (q, k, v)]

        def fwd_bwd():
            o = flash_attention(*leaves, **kw)
            torch.autograd.grad(o, leaves, do)
        t["fwd_bwd_ms"] = time_ms(fwd_bwd, n(20))
        lib = [x.detach().clone().requires_grad_(True)
               for x in (qh, kh, vh)]
        lib_out = F.scaled_dot_product_attention(*lib, **lib_kw)
        t["sdpa_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            lib_out, lib, doh, retain_graph=True), n(20))
    set_counts(counts)                   # these launches are not a path's

    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S
    elt = q.element_size()
    # the visible pairs: the causal triangle (each row's last `window`
    # keys where a window is shorter), or every pair
    if causal:
        span = window if window else S
        pairs = span * (span + 1) // 2 + (S - span) * span if span < S \
            else S * (S + 1) // 2
    else:
        pairs = S * S
    flops_fwd = B * H * pairs * 4 * D
    flops_bwd = 2.5 * flops_fwd                        # 5 products, not 2
    bytes_fwd = (2 * B * S * H * D + 2 * B * S * KV * D) * elt + 4 * B * H * S
    bytes_bwd = (4 * B * S * H * D + 4 * B * S * KV * D) * elt + \
        4 * B * H * S
    for name, flops, n_bytes in (("fwd", flops_fwd, bytes_fwd),
                                 ("bwd", flops_bwd, bytes_bwd)):
        t_ops, t_bytes = flops / peak * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
        t[f"{name}_bound_ms"] = max(t_ops, t_bytes)
        t[f"{name}_bound_by"] = "operations" if t_ops >= t_bytes \
            else "bytes"
        t[f"{name}_flops"] = flops
    sdpa = "sdpa with a boolean mask" if masked else "sdpa"
    msg = (f"[times] flash_attention {shape} {str(dtype)[6:]} causal="
           f"{causal} window={window}: forward {t['fwd_ms']:.4f} ms (plain "
           f"{t['plain_fwd_ms']:.4f}, {sdpa} {t['sdpa_fwd_ms']:.4f}, bound "
           f"{t['fwd_bound_ms']:.4f} by {t['fwd_bound_by']}: "
           f"{flops_fwd / 1e9:.1f} GFLOP, "
           f"{flops_fwd / t['fwd_ms'] / 1e9:.2f} TFLOP/s)")
    if backward:
        msg += (f"; backward {t['bwd_ms']:.4f} ms (plain "
                f"{t['plain_bwd_ms']:.4f}, {sdpa} {t['sdpa_bwd_ms']:.4f}, "
                f"bound {t['bwd_bound_ms']:.4f} by {t['bwd_bound_by']}: "
                f"{flops_bwd / 1e9:.1f} GFLOP, "
                f"{flops_bwd / t['bwd_ms'] / 1e9:.2f} TFLOP/s, "
                f"{t['bwd_bound_ms'] / t['bwd_ms']:.1%} of the bound); "
                f"forward+backward through autograd {t['fwd_bwd_ms']:.4f} "
                f"ms")
    log(msg)
    torch.cuda.empty_cache()
    return t


def wkv_times(shape=WKV_PATH, reps=30, plain=None, card=False) -> dict:
    """The WKV kernel at ``shape`` (the serve path's), beside its plain
    version and the bound, and the SM clock just before it is timed (the
    kernel is bound by issue and latency, so its time moves with the
    clock).  ``plain``, where given, is the plain version's time measured
    by the caller on these inputs.  No single PyTorch call computes the
    recurrence, so there is no library time."""
    import torch

    from repro_torch.kernels.recurrence_ab import sm_clock_mhz
    from repro_torch.kernels.rwkv6_wkv import wkv, wkv_ref
    B, H, S, K, V = shape
    r, k, v, w, u = _wkv_inputs(4, shape, torch.bfloat16, "path", card)
    counts = read_counts()
    clock = sm_clock_mhz()
    t = {"ms": time_ms(lambda: wkv(r, k, v, w, u), reps),
         "warm_ms": time_ms(lambda: wkv(r, k, v, w, u), reps, cold=False),
         "plain_ms": plain if plain is not None else time_ms(
             lambda: wkv_ref(r, k, v, w, u), 3)}
    set_counts(counts)                   # these launches are not a path's
    elt = r.element_size()
    # each input read once, each output written once
    n_bytes = (2 * B * H * S * K + B * H * S * V + H * K) * elt + \
        4 * B * H * S * K + B * H * S * V * elt + 4 * B * H * K * V
    # per step and head: r·S (2KV) and diag(w)·S + k⊗v (2KV); the bonus
    # (Σ r u k)·v is O(K + V)
    flops = B * H * S * (4 * K * V + 3 * K + 2 * V)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    t.update(bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             bytes=n_bytes, flops=flops, sm_clock_mhz=clock)
    log(f"[times] wkv {shape} bf16 r/k/v/u, f32 w: kernel "
        f"{t['ms']:.5f} ms (inputs in L2: {t['warm_ms']:.5f}), plain "
        f"{t['plain_ms']:.3f} ms, library none; bound {t['bound_ms']:.5f} ms "
        f"by {t['bound_by']} ({n_bytes} bytes -> {t_bytes:.5f} ms at 3.35 "
        f"TB/s; {flops / 1e9:.3f} GFLOP float32 -> {t_ops:.5f} ms at 67 "
        f"TFLOP/s) -> {t['bound_ms'] / t['ms']:.1%} of the float32 bound; "
        f"units: the two products on the tensor cores (3xTF32 mma.sync, "
        f"float32 accuracy), the rest on the CUDA cores; SM clock "
        f"{clock:.0f} MHz")
    del r, k, v, w, u
    torch.cuda.empty_cache()
    return t


def rglru_times(shape=RG_SCAN_PATH, reps=30, plain_reps=3,
                card=False) -> dict:
    """The RG-LRU scan kernel at ``shape`` (the recurrentgemma path's),
    float32 a and b as the model gives them, beside its plain version, the
    bound and ``torch.add(a, b, out=...)``, which moves the same bytes in
    the same layout: what the card streams in practice.  No single
    PyTorch call computes the recurrence, so there is no library time."""
    import torch

    from repro_torch.kernels.rglru_scan import rglru_ref, rglru_scan
    B, S, D = shape
    a, b = _scan_inputs(4, shape, torch.float32, card=card)
    counts = read_counts()
    o = torch.empty_like(a)
    t = {"ms": time_ms(lambda: rglru_scan(a, b), reps),
         "warm_ms": time_ms(lambda: rglru_scan(a, b), reps, cold=False),
         "plain_ms": time_ms(lambda: rglru_ref(a, b), plain_reps),
         "stream_ms": time_ms(lambda: torch.add(a, b, out=o), reps)}
    set_counts(counts)                   # these launches are not a path's
    # a and b read once, out and h_last written once; a multiply and an
    # add per element
    n_bytes = 3 * B * S * D * a.element_size() + 4 * B * D
    flops = 2 * B * S * D
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    t.update(bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             bytes=n_bytes, flops=flops)
    log(f"[times] rglru_scan {shape} f32: kernel {t['ms']:.5f} ms "
        f"(inputs in L2: {t['warm_ms']:.5f}), plain {t['plain_ms']:.3f} ms, "
        f"library none; bound {t['bound_ms']:.5f} ms by {t['bound_by']} "
        f"({n_bytes} bytes -> {t_bytes:.5f} ms at 3.35 TB/s; "
        f"{flops / 1e6:.1f} MFLOP -> {t_ops:.5f} ms at 67 TFLOP/s) -> "
        f"{t['bound_ms'] / t['ms']:.1%} of the bound, "
        f"{n_bytes / t['ms'] / 1e9:.3f} TB/s; the same bytes streamed by "
        f"torch.add(a, b, out=...) {t['stream_ms']:.5f} ms "
        f"({n_bytes / t['stream_ms'] / 1e9:.3f} TB/s)")
    del a, b, o
    torch.cuda.empty_cache()
    return t


def rglru_bwd_times() -> dict:
    """The RG-LRU backward kernel at the training path's shape, float32
    with the forward's states handed over (the path's case), beside its
    plain version and the bound.  No single PyTorch call computes it."""
    import torch

    from repro_torch.kernels.rglru_scan import (rglru_bwd, rglru_bwd_ref,
                                                rglru_scan)
    B, S, D = RG_TRAIN_PATH
    a, b = _scan_inputs(7, RG_TRAIN_PATH, torch.float32)
    dout, _ = _scan_inputs(8, RG_TRAIN_PATH, torch.float32)
    counts = read_counts()
    h = rglru_scan(a, b)[0]
    t = {"ms": time_ms(lambda: rglru_bwd(a, b, dout, None, h), 30),
         "plain_ms": time_ms(lambda: rglru_bwd_ref(a, b, dout, None, h),
                             3)}
    set_counts(counts)                   # these launches are not a path's
    # a, h and dout read once, da and db written once; two multiplies and
    # an add per element
    n_bytes = 5 * B * S * D * a.element_size()
    flops = 3 * B * S * D
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    t.update(bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             bytes=n_bytes, flops=flops)
    log(f"[times] rglru_scan backward {RG_TRAIN_PATH} f32: kernel "
        f"{t['ms']:.5f} ms, plain {t['plain_ms']:.3f} ms, library none; "
        f"bound {t['bound_ms']:.5f} ms by {t['bound_by']} ({n_bytes} "
        f"bytes at 3.35 TB/s) -> {t['bound_ms'] / t['ms']:.1%} of the "
        f"bound, {n_bytes / t['ms'] / 1e9:.3f} TB/s")
    del a, b, dout, h
    torch.cuda.empty_cache()
    return t


def wkv_bwd_times() -> dict:
    """The WKV backward kernel at the training path's shape, bf16 r, k, v,
    u and float32 w as the model gives them, beside its plain version and
    the bound.  No single PyTorch call computes it."""
    import numpy as np
    import torch

    from repro_torch.kernels.rwkv6_wkv import wkv_bwd, wkv_bwd_ref
    B, H, S, K, V = WKV_TRAIN_PATH
    r, k, v, w, u = _wkv_inputs(9, WKV_TRAIN_PATH, torch.bfloat16, "path")
    dout = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (B, H, S, V)).astype(np.float32)).to("cuda", torch.bfloat16)
    counts = read_counts()
    t = {"ms": time_ms(lambda: wkv_bwd(r, k, v, w, u, dout), 10),
         "plain_ms": time_ms(lambda: wkv_bwd_ref(r, k, v, w, u, dout), 2)}
    set_counts(counts)                   # these launches are not a path's
    elt = r.element_size()
    # read r, k, v, u, dout and w once; write dr, dk, dv, du and dw once
    n_bytes = 2 * ((2 * B * H * S * K + 2 * B * H * S * V + H * K) * elt +
                   4 * B * H * S * K)
    # per step and head: the state S_{t-1} once (2KV) and five K x V
    # products (r·S, dS·v, k·dS, dS ⊙ S summed, the dS update)
    flops = 12 * B * H * S * K * V
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    t.update(bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             bytes=n_bytes, flops=flops)
    log(f"[times] wkv backward {WKV_TRAIN_PATH} bf16 r/k/v/u, f32 w: "
        f"kernel {t['ms']:.5f} ms, plain {t['plain_ms']:.3f} ms, library "
        f"none; bound {t['bound_ms']:.5f} ms by {t['bound_by']} ({n_bytes} "
        f"bytes -> {t_bytes:.5f} ms; {flops / 1e9:.3f} GFLOP float32 -> "
        f"{t_ops:.5f} ms) -> {t['bound_ms'] / t['ms']:.1%} of the bound")
    del r, k, v, w, u, dout
    torch.cuda.empty_cache()
    return t


#: kernel families of a serve profile: the port's kernels by a piece of
#: their names, then the matrix products, then the rest
SERVE_FAMILIES = {"rwkv6-1.6b": {"wkv": "wkv_fwd"},
                  "recurrentgemma-2b": {"rglru": "rglru_scan_",
                                        "flash_attention": "fa_fwd"},
                  "granite-moe-3b-a800m": {"flash_attention": "fa_fwd"}}


def serve_profile(cfg, params, n_decode=4) -> None:
    """One prefill of the serve path's batch (4 x 1,024 tokens), then a
    few decode steps, each under ``torch.profiler``: device time by kernel
    family and the share of the window in which the card ran no kernel
    (an upper bound: the profiler's own host cost is inside the window)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import (decode_step, model_specs,
                                                pad_cache, prefill)
    # weights of the layers' matrix products (2-D w*, not the mixes mu or
    # the per-head gate blocks), over every group's layers; of an expert
    # stack (layers, E, a, b), the top_k experts a token runs
    mm_params = sum(
        math.prod(sp.shape) if len(sp.shape) == 3 else
        sp.shape[0] * cfg.top_k * sp.shape[2] * sp.shape[3]
        for group in model_specs(cfg)["groups"]
        for unit in group.values() for part in unit.values()
        for key, sp in part.items() if key.startswith("w") and
        len(sp.shape) in (3, 4) and (len(sp.shape) == 3 or "router" in part))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (SERVE["batch"], SERVE["prompt_len"]))).cuda()
    counts = read_counts()

    def prefill_part():
        return prefill(params, {"tokens": toks}, cfg)

    def decode_part(last, caches, pos):
        caches = pad_cache(caches, cfg, extra=n_decode)
        tok = last.argmax(-1)[:, None]
        for i in range(n_decode):
            lg, caches = decode_step(params, tok, caches, pos + i, cfg)
            tok = lg.argmax(-1)[:, None]

    def profiled(fn, *args):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        return out, prof, wall

    decode_part(*prefill_part())                     # warm-up
    torch.cuda.synchronize()
    state, prof_pre, wall_pre = profiled(prefill_part)
    _, prof_dec, wall_dec = profiled(decode_part, *state)
    for name, what, prof, wall in (
            ("prefill", f"batch {SERVE['batch']} x {SERVE['prompt_len']} "
             f"tokens", prof_pre, wall_pre),
            ("decode", f"{n_decode} steps at batch {SERVE['batch']}",
             prof_dec, wall_dec)):
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if not kernels:
            log(f"[times] {cfg.name} {name} profile ({what}): {wall:.2f} ms "
                f"host time; no device events recorded, so device time by "
                f"kernel and the idle share are not measured")
            continue
        ours = SERVE_FAMILIES[cfg.name]
        fam = dict.fromkeys([*ours, "matmul", "other"], 0.0)
        for e in kernels:
            low = e.name.lower()
            key = next((k for k, piece in ours.items() if piece in e.name),
                       None)
            if key is None:
                key = "matmul" if any(w in low for w in (
                    "gemm", "xmma", "cutlass", "cublas", "nvjet")) \
                    else "other"
            fam[key] += e.time_range.elapsed_us() / 1e3
        busy = sum(fam.values())
        rate = ""
        if name == "prefill":
            flops = 2 * SERVE["batch"] * SERVE["prompt_len"] * mm_params
            rate = (f"; the layers' matrix products are {flops / 1e12:.2f} "
                    f"TFLOP -> {flops / fam['matmul'] / 1e9:.1f} TFLOP/s "
                    f"over the matmul kernels' time")
        log(f"[times] {cfg.name} {name} profile ({what}): {wall:.2f} ms "
            f"host time, {busy:.2f} ms of kernels ({len(kernels)} launches) "
            f"-> "
            f"the card idle {max(0.0, 1 - busy / wall):.1%}; "
            + ", ".join(f"{k} {v:.2f} ms ({v / busy:.1%})"
                        for k, v in fam.items()) + rate)
    set_counts(counts)                   # these launches are not a path's
    del params, state
    gc.collect()
    torch.cuda.empty_cache()


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


def data_ms(make, reps=3) -> float:
    """Host time to make one epoch's K partitions of a dataset (numpy
    draws, and on the card the copy there)."""
    import torch
    data = make()
    t0 = time.perf_counter()
    for epoch in range(reps):
        for k in range(data.K):
            data.partition(epoch, k)
    if data.device.type == "cuda":
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_split(tag, timer, logs):
    import numpy as np
    for name in PHASES:
        ms = timer.ms[name]
        if not ms:               # encode/decode/step skip a failed decode
            log(f"[times] {tag} phase {name}: no epoch")
            continue
        log(f"[times] {tag} phase {name}: {len(ms)} epochs, mean "
            f"{np.mean(ms):.3f} ms, median {np.median(ms):.3f}, min "
            f"{np.min(ms):.3f}, max {np.max(ms):.3f}; by epoch "
            f"{[round(x, 1) for x in ms]}")
    slots = sum(lg.n_slots for v in logs.values() for lg in v)
    log(f"[times] {tag} co-sim: {slots} slots in "
        f"{sum(timer.ms['cosim']):.1f} ms -> "
        f"{sum(timer.ms['cosim']) / max(slots, 1):.4f} ms per slot")


def fel_split(fel) -> None:
    """Median ms of each FEL phase over each backend's epochs, by scheme:
    the host's slot-batch assembly (draws, stack), the copy, the step."""
    import numpy as np
    for (backend, scheme), timer in fel["timers"].items():
        log(f"[times] fel {backend} {scheme}: " + ", ".join(
            f"{p} {float(np.median(timer.ms[p])):.1f} ms" for p in FEL_PHASES)
            + " (median of its epochs; draws are paid by the first run "
            "only)")


def lm_shard_profile():
    """One shard's forward and backward on the transformer path under
    ``torch.profiler``: device time by kernel family, and the share of the
    window in which the card ran no kernel (the profiler's own host cost
    is inside the window, so that share is an upper bound)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.models.transformer import init_params, loss_fn
    from repro_torch.core.coded_step import _value_and_grad

    cfg = lm_config()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(1),
                         device="cuda")
    batch = SyntheticLMDataset(6, 1, LM_SEQ, cfg.vocab,
                               device="cuda").partition(0, 0)
    grad = _value_and_grad(lambda p, b: loss_fn(p, b, cfg))
    counts = read_counts()
    grad(params, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        grad(params, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    set_counts(counts)                   # these launches are not a path's
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"[times] lm shard profile: {wall:.1f} ms host time; the "
            f"profiler recorded no device events, so device time by "
            f"kernel and the idle share are not measured")
        return
    fam = {"flash_attention": 0.0, "matmul": 0.0, "other": 0.0}
    top = {}
    for e in kernels:
        name, us = e.name, e.time_range.elapsed_us()
        low = name.lower()
        key = ("flash_attention" if "fa_" in name else
               "matmul" if any(w in low for w in (
                   "gemm", "xmma", "cutlass", "cublas", "nvjet"))
               else "other")
        fam[key] += us / 1e3
        top[name[:60]] = top.get(name[:60], 0.0) + us / 1e3
    busy = sum(fam.values())
    log(f"[times] lm shard profile (forward + backward of one "
        f"{LM_SEQ}-token shard): {wall:.1f} ms host time, {busy:.1f} ms of "
        f"kernels ({len(kernels)} launches) -> the card idle "
        f"{max(0.0, 1 - busy / wall):.1%} of the window; "
        + ", ".join(f"{k} {v:.1f} ms ({v / busy:.1%})"
                    for k, v in fam.items()))
    for name, ms in sorted(top.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[times]   {ms:9.2f} ms  {name}")
    del params, batch
    torch.cuda.empty_cache()


def zoo_times(moe_out, zoo_out, zoo_fa_errs) -> list:
    """The attention forward at the granite path's shape and at each zoo
    shape, beside its plain version, ``sdpa`` and the bound; a profile of
    one granite prefill and its decode steps.  Returns the kernel rows,
    each with the launches counted on its archs' paths (``ZOO_FA_PATHS``):
    the windowed ones where the row has a window, the others where not."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention.ops import kernel_route
    src = "src/repro_torch/kernels"
    paths = dict(zoo_out, **{"granite-moe-3b-a800m": moe_out})

    def launches(archs, window):
        n = 0
        for arch in archs:
            total = paths[arch]["launches"]["flash_attention_fwd"]
            windowed = paths[arch]["windowed"]
            n += windowed if window else total - windowed
        return n

    fa_g = flash_times(torch.bfloat16, GRANITE_FA_PATH, backward=False)
    ml = moe_out["launches"]["flash_attention_fwd"]
    n_pre = moe_out["res"]["prefills"]
    serve_profile(granite_config(), granite_params(granite_config(), "cuda"))
    log(f"[times] moe attention per prefill, from the kernel's timed cost x "
        f"its launches: {ml * fa_g['fwd_ms'] / n_pre:.3f} ms of "
        f"{float(np.median(moe_out['res']['prefill_ms'])):.2f} ms")
    rows = []
    for tag, name, shape, causal, window, archs in ZOO_FA_PATHS:
        t = fa_g if tag == "granite" else flash_times(
            torch.bfloat16, shape, window, backward=False, causal=causal)
        rows.append({
            "name": f"flash_attention_fwd_{name}", "route": "cuda",
            "kernel_route": kernel_route(torch.bfloat16, shape[4]),
            "shape": list(shape),
            "source": f"{src}/flash_attention/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:88",
            "launches": launches(archs, window),
            "max_abs_err": zoo_fa_errs[tag], "ms": t["fwd_ms"],
            "plain_ms": t["plain_fwd_ms"], "bound_ms": t["fwd_bound_ms"],
            "bound_by": t["fwd_bound_by"], "library_ms": t["sdpa_fwd_ms"]})
    return rows


def times_phase(mlp, lm, serve_out, rg_out, errs, fa_errs, wkv_err,
                rg_errs, fel, lmt, fam, bwd_errs) -> list:
    from collections import Counter

    import numpy as np

    from repro_torch.data.pipeline import (SyntheticClassificationDataset,
                                           SyntheticLMDataset)
    from repro_torch.sim import scenario_spec

    mlp_launches, mlp_logs, mlp_timer = mlp
    lm_launches, lm_logs, lm_timer, peak, payload_bytes = lm
    D_lm = payload_bytes // 4
    for tag, logs in (("mlp", mlp_logs), ("lm", lm_logs)):
        counts = Counter(lg.n_uploads for v in logs.values() for lg in v
                         if lg.decode_ok)
        log(f"[times] {tag} upload counts on the path: {dict(counts)}")
    # the payloads at the most uploads an epoch reduces (M = 6)
    main = coded_reduce_times(6, D_lm, reps=20)
    coded_reduce_times(6, 235_146)
    coded_reduce_times(16, 2 ** 24)
    import torch
    fa = {"bf16": flash_times(torch.bfloat16),
          "f32": flash_times(torch.float32)}

    phase_split("mlp", mlp_timer, mlp_logs)
    phase_split("lm", lm_timer, lm_logs)
    bf = fa["bf16"]
    n_ep = sum(len(v) for v in lm_logs.values())
    log(f"[times] lm attention per epoch, from the kernels' timed cost x "
        f"their launches: "
        f"{(lm_launches['flash_attention_fwd'] * bf['fwd_ms'] + lm_launches['flash_attention_bwd'] * bf['bwd_ms']) / n_ep:.1f} ms")  # noqa: E501
    lm_shard_profile()
    fel_split(fel)
    fa_lt = flash_times(torch.bfloat16, lmt["coded"]["shape"])
    lt = lmt["coded"]
    n_steps = len(lt["step_ms"])
    log(f"[times] lmtrain coded step: median "
        f"{float(np.median(lt['step_ms'])):.1f} ms (plan "
        f"{float(np.median(lt['plan_ms'])):.1f}, data "
        f"{float(np.median(lt['data_ms'])):.1f}) at n_slots "
        f"{lt['n_slots']}; attention from the kernels' timed cost at "
        f"{lt['shape']} x their launches: "
        f"{(lt['launches']['flash_attention_fwd'] * fa_lt['fwd_ms'] + lt['launches']['flash_attention_bwd'] * fa_lt['bwd_ms']) / n_steps:.1f} "  # noqa: E501
        f"ms a step; peak {lt['peak'] / 1e9:.2f} GB; plain step "
        f"{lmt['plain']['step_ms']:.1f} ms, peak "
        f"{lmt['plain']['peak'] / 1e9:.2f} GB")
    K = scenario_spec(SCENARIO).K
    log(f"[times] mlp data for one epoch (K partitions x "
        f"{EXAMPLES_PER_PARTITION} examples): "
        f"{data_ms(lambda: SyntheticClassificationDataset(K, EXAMPLES_PER_PARTITION, DIMS[0], DIMS[-1], device='cpu')):.1f} ms of numpy draws, "  # noqa: E501
        f"{data_ms(lambda: SyntheticClassificationDataset(K, EXAMPLES_PER_PARTITION, DIMS[0], DIMS[-1], device='cuda')):.1f} ms with the copy to the card")  # noqa: E501
    log(f"[times] lm data for one epoch (K sequences of {LM_SEQ} tokens): "
        f"{data_ms(lambda: SyntheticLMDataset(K, 1, LM_SEQ, lm_config().vocab, device='cuda')):.1f} ms")  # noqa: E501
    log(f"[times] co-sim slot, device part only (H2D rows, schedule_slot, "
        f"D2H decisions): {slot_round_trip_ms('cuda'):.4f} ms on the card, "
        f"{slot_round_trip_ms('cpu'):.4f} ms on the CPU")
    log(f"[times] lm peak device memory over the path: {peak} bytes "
        f"({peak / 1e9:.2f} GB)")
    wk = wkv_times()
    serve_profile(serve_config(), serve_params(serve_config(), "cuda"))
    n_pre = serve_out["res"]["prefills"]
    log(f"[times] serve WKV per prefill, from the kernel's timed cost x its "
        f"launches: {serve_out['launches']['rwkv6_wkv'] * wk['ms'] / n_pre:.3f}"
        f" ms of {float(np.median(serve_out['res']['prefill_ms'])):.2f} ms")
    rg = rglru_times()
    fa256 = flash_times(torch.bfloat16, RG_FA_PATH, RG_WINDOW,
                        backward=False)
    serve_profile(rg_config(), rg_params(rg_config(), "cuda"))
    n_pre, rl = rg_out["res"]["prefills"], rg_out["launches"]
    log(f"[times] rg per prefill, from the kernels' timed cost x their "
        f"launches: RG-LRU {rl['rglru_scan'] * rg['ms'] / n_pre:.3f} ms, "
        f"attention {rl['flash_attention_fwd'] * fa256['fwd_ms'] / n_pre:.3f}"
        f" ms of {float(np.median(rg_out['res']['prefill_ms'])):.2f} ms")

    rgb, wkb = rglru_bwd_times(), wkv_bwd_times()
    fa_bwd = flash_times(torch.bfloat16, FA256_TRAIN_PATHS[0][0],
                         FA256_TRAIN_PATHS[0][1])
    g3_shape, g3_window = FA256_TRAIN_PATHS[1]
    g3 = {w: flash_times(torch.bfloat16, g3_shape, w)
          for w in (g3_window, 0)}
    rg_fam, g3_fam = fam["recurrentgemma-2b"], fam["gemma3-12b"]
    g3_bwd = g3_fam["launches"]["flash_attention_bwd"]
    fam_times(fam, {
        "rwkv6-1.6b": [("WKV backward", fam["rwkv6-1.6b"]["launches"][
            "rwkv6_wkv_bwd"], wkb["ms"])],
        "recurrentgemma-2b": [
            ("RG-LRU backward", rg_fam["launches"]["rglru_scan_bwd"],
             rgb["ms"]),
            ("attention backward D=256", rg_fam["launches"][
                "flash_attention_bwd"], fa_bwd["bwd_ms"])],
        "gemma3-12b": [
            (f"attention backward D=256 window {g3_window}",
             g3_fam["windowed_bwd"], g3[g3_window]["bwd_ms"]),
            ("attention backward D=256 global",
             g3_bwd - g3_fam["windowed_bwd"], g3[0]["bwd_ms"])]})

    from repro_torch.kernels.flash_attention.ops import kernel_route
    src = "src/repro_torch/kernels"
    fam_count = {k: sum(row["launches"][k] for row in fam.values())
                 for k in COUNTED}
    return [{
        "name": "coded_reduce", "route": "cuda",
        "source": f"{src}/coded_reduce/csrc/coded_reduce.cu",
        "replaces": "src/repro/kernels/coded_reduce/coded_reduce.py:41",
        "launches": mlp_launches["coded_reduce"] +
        lm_launches["coded_reduce"],
        "max_abs_err": max(errs.get((6, D_lm), 0.0), main["max_abs_err"]),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"]}, {
        "name": "flash_attention_fwd", "route": "cuda",
        "kernel_route": kernel_route(torch.bfloat16, FA_PATH[4]),
        "source": f"{src}/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:88",
        "launches": lm_launches["flash_attention_fwd"],
        "max_abs_err": fa_errs["fwd"],
        "ms": bf["fwd_ms"], "plain_ms": bf["plain_fwd_ms"],
        "bound_ms": bf["fwd_bound_ms"], "bound_by": bf["fwd_bound_by"],
        "library_ms": bf["sdpa_fwd_ms"]}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "kernel_route": kernel_route(torch.bfloat16, FA_PATH[4], True),
        "source": f"{src}/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/models/attention.py:204",
        "launches": lm_launches["flash_attention_bwd"],
        "max_abs_err": fa_errs["bwd"],
        "ms": bf["bwd_ms"], "plain_ms": bf["plain_bwd_ms"],
        "bound_ms": bf["bwd_bound_ms"], "bound_by": bf["bwd_bound_by"],
        "library_ms": bf["sdpa_bwd_ms"]}, {
        "name": "flash_attention_fwd_lm_train", "route": "cuda",
        "kernel_route": kernel_route(torch.bfloat16, FA_PATH[4]),
        "shape": list(lt["shape"]),
        "source": f"{src}/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:88",
        "launches": lt["launches"]["flash_attention_fwd"] +
        lmt["plain"]["launches"]["flash_attention_fwd"],
        "max_abs_err": lt["fa_errs"][0],
        "ms": fa_lt["fwd_ms"], "plain_ms": fa_lt["plain_fwd_ms"],
        "bound_ms": fa_lt["fwd_bound_ms"], "bound_by": fa_lt["fwd_bound_by"],
        "library_ms": fa_lt["sdpa_fwd_ms"]}, {
        "name": "flash_attention_bwd_lm_train", "route": "cuda",
        "kernel_route": kernel_route(torch.bfloat16, FA_PATH[4], True),
        "shape": list(lt["shape"]),
        "source": f"{src}/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/models/attention.py:204",
        "launches": lt["launches"]["flash_attention_bwd"] +
        lmt["plain"]["launches"]["flash_attention_bwd"],
        "max_abs_err": lt["fa_errs"][1],
        "ms": fa_lt["bwd_ms"], "plain_ms": fa_lt["plain_bwd_ms"],
        "bound_ms": fa_lt["bwd_bound_ms"], "bound_by": fa_lt["bwd_bound_by"],
        "library_ms": fa_lt["sdpa_bwd_ms"]}, {
        "name": "rwkv6_wkv", "route": "cuda",
        "design": "chunked exact, L=16, 3xTF32 tensor-core products",
        "source": f"{src}/rwkv6_wkv/csrc/rwkv6_wkv.cu",
        "replaces": "src/repro/kernels/rwkv6_wkv/rwkv6_wkv.py:76",
        "launches": serve_out["launches"]["rwkv6_wkv"],
        "max_abs_err": wkv_err, "ms": wk["ms"], "plain_ms": wk["plain_ms"],
        "bound_ms": wk["bound_ms"], "bound_by": wk["bound_by"],
        "library_ms": None}, {
        "name": "rglru_scan", "route": "cuda",
        "design": "cp.async ring (64 steps x 2 stages), bit-equal",
        "source": f"{src}/rglru_scan/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/rglru_scan.py:54",
        "launches": rg_out["launches"]["rglru_scan"],
        "max_abs_err": rg_errs["scan"], "ms": rg["ms"],
        "plain_ms": rg["plain_ms"], "bound_ms": rg["bound_ms"],
        "bound_by": rg["bound_by"], "library_ms": None}, {
        "name": "flash_attention_fwd_d256", "route": "cuda",
        "kernel_route": kernel_route(torch.bfloat16, RG_FA_PATH[4]),
        "source": f"{src}/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:88",
        "launches": rg_out["launches"]["flash_attention_fwd"],
        "max_abs_err": rg_errs["fa256"], "ms": fa256["fwd_ms"],
        "plain_ms": fa256["plain_fwd_ms"],
        "bound_ms": fa256["fwd_bound_ms"],
        "bound_by": fa256["fwd_bound_by"],
        "library_ms": fa256["sdpa_fwd_ms"]}, {
        "name": "flash_attention_bwd_d256", "route": "cuda",
        "kernel_route": kernel_route(torch.bfloat16, 256, True),
        "design": FA256_BWD_DESIGN,
        "shape": list(FA256_TRAIN_PATHS[0][0]),
        "window": FA256_TRAIN_PATHS[0][1],
        "source": f"{src}/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/models/attention.py:204",
        "launches": rg_fam["launches"]["flash_attention_bwd"],
        "max_abs_err": rg_fam["fa_bwd_err"], "ms": fa_bwd["bwd_ms"],
        "plain_ms": fa_bwd["plain_bwd_ms"],
        "bound_ms": fa_bwd["bwd_bound_ms"],
        "bound_by": fa_bwd["bwd_bound_by"],
        "library_ms": fa_bwd["sdpa_bwd_ms"]}, *({
        "name": f"flash_attention_bwd_d256_{tag}", "route": "cuda",
        "kernel_route": kernel_route(torch.bfloat16, 256, True),
        "design": FA256_BWD_DESIGN,
        "shape": list(g3_shape), "window": w,
        "source": f"{src}/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/models/attention.py:204",
        "launches": g3_fam["windowed_bwd"] if w else
        g3_bwd - g3_fam["windowed_bwd"],
        "max_abs_err": g3_fam["fa_bwd_errs"][w], "ms": g3[w]["bwd_ms"],
        "plain_ms": g3[w]["plain_bwd_ms"],
        "bound_ms": g3[w]["bwd_bound_ms"],
        "bound_by": g3[w]["bwd_bound_by"],
        "library_ms": g3[w]["sdpa_bwd_ms"]}
        for tag, w in (("w1024", g3_window), ("g2", 0))), {
        "name": "rglru_scan_bwd", "route": "cuda",
        "design": "reverse scan, one thread a channel, bit-equal",
        "shape": list(RG_TRAIN_PATH),
        "source": f"{src}/rglru_scan/csrc/rglru_scan.cu",
        "replaces": "src/repro/models/rglru.py:46",
        "launches": fam_count["rglru_scan_bwd"],
        "max_abs_err": bwd_errs["rglru"], "ms": rgb["ms"],
        "plain_ms": rgb["plain_ms"], "bound_ms": rgb["bound_ms"],
        "bound_by": rgb["bound_by"], "library_ms": None}, {
        "name": "rwkv6_wkv_bwd", "route": "cuda",
        "design": "chunked exact, L=16: a chunked state pass, then each "
                  "chunk's gradients in parallel from its state and the "
                  "carried dS, 3xTF32 tensor-core products, one block a "
                  "(batch, head)",
        "shape": list(WKV_TRAIN_PATH),
        "source": f"{src}/rwkv6_wkv/csrc/rwkv6_wkv.cu",
        "replaces": "src/repro/models/rwkv6.py:54",
        "launches": fam_count["rwkv6_wkv_bwd"],
        "max_abs_err": bwd_errs["wkv"], "ms": wkb["ms"],
        "plain_ms": wkb["plain_ms"], "bound_ms": wkb["bound_ms"],
        "bound_by": wkb["bound_by"], "library_ms": None}]


def fam_times(fam, costs) -> None:
    """The family training path's step times and peaks, and each backward
    kernel's share of a step from its timed cost x its launches a step
    (``costs``: arch -> [(kernel, launches over the run, ms a call)])."""
    import numpy as np
    for arch, row in fam.items():
        step = float(np.median(row['step_ms']))
        shares = "".join(
            f"; {name} {n / FAM_STEPS:g} x {ms:.4f} = "
            f"{n / FAM_STEPS * ms:.1f} ms ({n / FAM_STEPS * ms / step:.1%})"
            for name, n, ms in costs.get(arch, ()))
        log(f"[times] famtrain {arch}: coded step median {step:.1f} ms (all "
            f"{[round(x, 1) for x in row['step_ms']]}) at {row['rows']} "
            f"rows of {row['S']} tokens; peak {row['peak'] / 1e9:.2f} GB"
            + ("" if "plain" not in row else
               f"; plain step {row['plain']['step_ms']:.1f} ms, peak "
               f"{row['plain']['peak'] / 1e9:.2f} GB") + shares)


def main() -> int:
    t0 = time.perf_counter()
    smi = device_phase()
    build_phase()
    errs = kernel_phase()
    fa_errs = flash_kernel_phase()
    wkv_err = wkv_kernel_phase()
    rg_errs = {"scan": rglru_kernel_phase(), "fa256": flash256_kernel_phase()}
    bwd_errs = {"rglru": rglru_bwd_kernel_phase(),
                "wkv": wkv_bwd_kernel_phase()}
    zoo_fa_errs = zoo_kernel_phase()
    mlp = mlp_phase()
    lm = lm_phase()
    tiny_phase()
    fel = fel_phase()
    lmt = lm_train_phase()
    fam = famtrain_phase()
    served = serve_phase()
    rg_out = rg_serve_phase()
    moe_out = moe_serve_phase()
    zoo_out = zoo_phase()
    fleet = fleet_phase(smi)
    device_engine_phase(smi, fleet)
    del fleet
    soak_phase(smi)
    grid = grid_phase(smi)
    kernels = times_phase(mlp, lm, served, rg_out, errs, fa_errs, wkv_err,
                          rg_errs, fel, lmt, fam, bwd_errs)
    kernels += zoo_times(moe_out, zoo_out, zoo_fa_errs)
    kernels += grid_rows(grid)
    import torch
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
