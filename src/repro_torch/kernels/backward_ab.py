"""Time the backward kernels redesigned for this card against the designs
they were chosen over, on the card::

    PYTHONPATH=src python -m repro_torch.kernels.backward_ab \\
        [--rounds 3] [--out results.json]

Each other design is the shipped source (``rwkv6_wkv/csrc/rwkv6_wkv.cu``
for the WKV backward, ``flash_attention/csrc/flash_attention.cu`` for the
attention backward at head width 256) with a few regions replaced
(``EDITS``), built with the port's nvcc flags into ``_build/``; nothing of
the port runs them.  Every design is first held against the plain version
at its path's shape, with the bounds of ``chip_smoke.py``; then each
kernel's designs are timed in turns, the shipped one first in each round:
the median of ``--reps`` calls by CUDA events, the L2 cache flushed before
each call.  Shapes: the WKV backward at the family training path's (30,
32, 1024, 64, 64), bf16 r/k/v/u; attention at recurrentgemma-2b's (30,
1024, 1, 10, 256), causal, window 2,048.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (flash_attention_bwd_ref,
                                                 flash_attention_fwd)
from repro_torch.kernels.flash_attention.ops import SOURCE as FA_SOURCE
from repro_torch.kernels.recurrence_ab import sm_clock_mhz, time_ms
from repro_torch.kernels.rwkv6_wkv import wkv_bwd_ref
from repro_torch.kernels.rwkv6_wkv.ops import SOURCE as WKV_SOURCE

WKV_BWD_PATH = (30, 32, 1024, 64, 64)
FA_BWD_PATH, FA_WINDOW = (30, 1024, 1, 10, 256), 2048

# The WKV backward's pairs (s, t) with each warp's loops specialised at
# compile time: warp w runs bwd_pairs<C, w>, whose steps w and L-1-w
# bound every loop exactly (no term predicated off), eight code paths.
_WKV_TEMPLATED = """// step T of the chunk, column k (rc, kc, wc: its r, k, w over the chunk,
// rows past the sequence r = k = 0, w = 1): dr, dk and dw, r_T ⊙ w[0:T]
// and k_T ⊙ w[T+1:L] for the products, row T of A into xa (still to be
// summed over k) and du.  al[s] = M[T,s] k_s and be[q] = M[q,T] r_q with
// M[t,s] = w[s+1:t], each a running product of w.  F: the working area;
// dr, dk, dw: the chunk's first row of this (batch, head)
template <class C, int T>
__device__ __forceinline__ void bwd_step(float* F, const float* rc,
                                         const float* kc, const float* wc,
                                         int k, int n, float* xa, float& du,
                                         typename C::E* dr,
                                         typename C::E* dk, float* dw) {
  constexpr int L = C::L, K = C::K, KP = C::KP, LP = C::LP;
  constexpr int NB = L - 1 - T;
  const float* P = F + C::O_P;
  const float* Z = F + C::O_Z;
  const float* Y = F + C::O_Y;
  float al[T > 0 ? T : 1], be[NB > 0 ? NB : 1];
  float pre = 1.f, suf = 1.f;                    // w[0:T], w[T+1:L]
#pragma unroll
  for (int s = T - 1; s >= 0; --s) {
    al[s] = kc[s] * pre;
    pre *= wc[s];
  }
#pragma unroll
  for (int q = T + 1; q < L; ++q) {
    be[q - T - 1] = rc[q] * suf;
    suf *= wc[q];
  }
  const float rt = rc[T], kt = kc[T], uk = F[C::O_U + k];
  float prow[16], gs[T > 0 ? T : 1];
  ld_row<T + 1>(P + T * LP, prow);               // P[T][0..T]
  const float ptt = prow[T], bonus = uk * ptt;
  float ar = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f, ak = 0.f;
#pragma unroll
  for (int s = 0; s < T; ++s) {
    gs[s] = 0.f;
    ar = fmaf(al[s], prow[s], ar);
    a2 = fmaf(al[s], Y[s * KP + k], a2);
  }
  // gs[s] = Σ_{q>T} M[q,T] r_q P[q,s]; the rows of P by 16-byte loads
#pragma unroll
  for (int q = T + 1; q < L; ++q) {
    float pq[16];
    ld_row<T + 1>(P + q * LP, pq);
    const float b = be[q - T - 1];
#pragma unroll
    for (int s = 0; s < T; ++s) gs[s] = fmaf(b, pq[s], gs[s]);
    ak = fmaf(b, pq[T], ak);
    a3 = fmaf(b, Z[q * KP + k], a3);
  }
#pragma unroll
  for (int s = 0; s < T; ++s) a4 = fmaf(al[s], gs[s], a4);
  const float g_r = fmaf(pre, Z[T * KP + k], ar) + kt * bonus;
  const float g_k = fmaf(suf, Y[T * KP + k], ak) + rt * bonus;
  const float g_w = pre * suf * F[C::O_CC + k] + suf * a2 + pre * a3 + a4;
  du = fmaf(rt * kt, ptt, du);
  F[C::O_RP + T * KP + k] = rt * pre;
  F[C::O_KD + T * KP + k] = kt * suf;
  if (T == L - 1) F[C::O_WT + k] = pre * wc[L - 1];
#pragma unroll
  for (int s = 0; s < T; ++s) xa[s] = fmaf(rt, al[s], xa[s]);
  xa[T] = fmaf(rt * uk, kt, xa[T]);
  if (T < n) {
    dr[T * K + k] = cvt_out(g_r, dr);
    dk[T * K + k] = cvt_out(g_k, dk);
    dw[T * K + k] = g_w;
  }
}

// a warp's share of a chunk: steps T0 and L-1-T0 for its lanes' columns
// (each column's r, k, w by 16-byte loads); then rows T0 and L-1-T0 of A
// summed over k (the lanes' partials in a fixed butterfly) into AT's
// columns (AT[s][t] = A[t][s], 0 for s > t)
template <class C, int T0>
__device__ __forceinline__ void bwd_pairs(float* F, int lane, int n,
                                          float* du, typename C::E* dr,
                                          typename C::E* dk, float* dw) {
  constexpr int L = C::L, K = C::K, LP = C::LP, CS = C::CS;
  constexpr int T1 = L - 1 - T0;
  float xa0[T0 + 1], xa1[T1 + 1];
#pragma unroll
  for (int s = 0; s <= T0; ++s) xa0[s] = 0.f;
#pragma unroll
  for (int s = 0; s <= T1; ++s) xa1[s] = 0.f;
#pragma unroll
  for (int i = 0; i < C::KPT; ++i) {
    const int k = lane + 32 * i;
    if (k < K) {
      float rc[L], kc[L], wc[L];
      const float* col = F + C::O_COL + k * CS;
      ld_row<L>(col, rc);
      ld_row<L>(col + K * CS, kc);
      ld_row<L>(col + 2 * K * CS, wc);
      bwd_step<C, T0>(F, rc, kc, wc, k, n, xa0, du[i], dr, dk, dw);
      bwd_step<C, T1>(F, rc, kc, wc, k, n, xa1, du[i], dr, dk, dw);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int s = 0; s <= T0; ++s)
      xa0[s] += __shfl_xor_sync(0xffffffffu, xa0[s], o);
#pragma unroll
    for (int s = 0; s <= T1; ++s)
      xa1[s] += __shfl_xor_sync(0xffffffffu, xa1[s], o);
  }
  if (lane == 0) {
    float* AT = F + C::O_AT;
#pragma unroll
    for (int s = 0; s < L; ++s) {
      AT[s * LP + T0] = s <= T0 ? xa0[s <= T0 ? s : 0] : 0.f;
      AT[s * LP + T1] = s <= T1 ? xa1[s <= T1 ? s : 0] : 0.f;
    }
  }
}

"""
_WKV_TEMPLATED_CALL = """      switch (warp) {
        case 0: bwd_pairs<C, 0>(F, lane, n, du_acc, drc, dkc, dwc); break;
        case 1: bwd_pairs<C, 1>(F, lane, n, du_acc, drc, dkc, dwc); break;
        case 2: bwd_pairs<C, 2>(F, lane, n, du_acc, drc, dkc, dwc); break;
        case 3: bwd_pairs<C, 3>(F, lane, n, du_acc, drc, dkc, dwc); break;
        case 4: bwd_pairs<C, 4>(F, lane, n, du_acc, drc, dkc, dwc); break;
        case 5: bwd_pairs<C, 5>(F, lane, n, du_acc, drc, dkc, dwc); break;
        case 6: bwd_pairs<C, 6>(F, lane, n, du_acc, drc, dkc, dwc); break;
        default: bwd_pairs<C, 7>(F, lane, n, du_acc, drc, dkc, dwc); break;
      }
    }
"""

#: (kernel, design) -> edits of the shipped source: each edit is (start,
#: end, text), the region from ``start`` up to ``end`` (both occurring
#: once; ``end`` is kept) replaced by ``text``
EDITS = {
    ("wkv_bwd", "each warp's loops specialised by template"): [
        ("// step t of the chunk, column k (rc, kc, wc: its r, k, w over",
         "template <class C>\n__global__ void __launch_bounds__(kThreads, "
         "2)\nwkv_bwd_kernel(", _WKV_TEMPLATED),
        ("      bwd_pairs<C>(F, warp, lane, n, du_acc, drc, dkc, dwc);\n",
         "    __syncthreads();", _WKV_TEMPLATED_CALL)],
    ("wkv_bwd", "the loop over a lane's two columns unrolled"): [
        ("#pragma unroll 1\n  for (int i = 0; i < C::KPT; ++i) {",
         "\n    const int k = lane + 32 * i;",
         "#pragma unroll\n  for (int i = 0; i < C::KPT; ++i) {")],
    ("fa_bwd", "dq: the Dvec loop unrolled, every load in flight"): [
        ("    float dv0 = 0.f, dv1 = 0.f;\n"
         "    for (int d = cq; d < sh.D; d += 8) {\n",
         "      if (r0 < sh.S) {",
         "    float dv0 = 0.f, dv1 = 0.f;\n#pragma unroll\n"
         "    for (int d = cq; d < NB * kBoxCols; d += 8) {\n"
         "      if (d >= sh.D) continue;\n")],
    ("fa_bwd", "dk/dv: the rows' lse and Dvec by plain loads"): [
        ("    // the rows' lse and Dvec by asynchronous copies that arrive",
         "  };\n  if (loader) {",
         "    for (int r = lane; r < kTile; r += 32) {\n"
         "      const bool in = q0 + r < sh.S;\n"
         "      rl[r] = in ? lse[row_off + q0 + r] : 0.f;\n"
         "      rl[kTile + r] = in ? dvec[row_off + q0 + r] : 0.f;\n"
         "    }\n"
         "    mbar_arrive(full);\n")],
}
_SOURCES = {"wkv_bwd": WKV_SOURCE, "fa_bwd": FA_SOURCE}


def design_source(kernel: str, design: str) -> str:
    """The source of ``design``: the shipped source with its edits."""
    text = _SOURCES[kernel].read_text()
    for start, end, new in EDITS[(kernel, design)]:
        if text.count(start) != 1:
            raise ValueError(f"{design}: {start!r} occurs "
                             f"{text.count(start)} times")
        i = text.index(start)
        j = text.index(end, i + len(start))
        text = text[:i] + new + text[j:]
    return text


def _libraries(designs):
    """Build every design, all at once; the ctypes libraries by design."""
    src_dir = _build.BUILD_DIR / "ab"
    src_dir.mkdir(parents=True, exist_ok=True)
    sources = {}
    for kernel, design in designs:
        if design == "shipped":
            sources[(kernel, design)] = _SOURCES[kernel]
            continue
        slug = re.sub(r"\W+", "_", design).strip("_")
        path = src_dir / f"{kernel}_{slug}.cu"
        path.write_text(design_source(kernel, design))
        sources[(kernel, design)] = path
    built = _build.compile_libraries(list(sources.values()))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    libs = {}
    for key, so in zip(sources, built):
        lib = ctypes.CDLL(str(so))
        if key[0] == "wkv_bwd":
            lib.wkv_bwd.argtypes = [I] + [P] * 14 + [I] * 6 + [P]
            lib.wkv_bwd.restype = I
        else:
            lib.fa_bwd_bf16.argtypes = [P] * 10 + [I] * 5 + [F] + \
                [I] * 3 + [P]
            lib.fa_bwd_bf16.restype = I
        libs[key] = lib
    return libs


def _draw(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to("cuda", dtype)


def _wkv_bwd_call(lib):
    """A call of the library's WKV backward on the path's inputs (as
    ``chip_smoke.py`` draws them), its outputs, and the plain version's."""
    B, H, S, K, V = WKV_BWD_PATH
    rng = np.random.default_rng(9)
    bf = torch.bfloat16
    r, k, v = (_draw(rng, (B, H, S, n), bf) for n in (K, K, V))
    w = torch.from_numpy(np.exp(-np.exp(rng.uniform(
        -8.0, 2.0, (B, H, S, K)))).astype(np.float32)).cuda()
    u = _draw(rng, (H, K), bf)
    dout = _draw(rng, (B, H, S, V), bf)
    f32 = dict(dtype=torch.float32, device="cuda")
    outs = (torch.empty_like(r), torch.empty_like(k), torch.empty_like(v),
            torch.empty_like(w), torch.empty_like(u))
    scratch = (torch.empty((B, H, K), **f32),
               torch.empty((B, H, -(-S // 16), K, V), **f32))
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.wkv_bwd(1, *(t.data_ptr() for t in (r, k, v, w, u, dout)),
                          None, *(t.data_ptr() for t in outs + scratch),
                          B, H, S, K, V, 0, stream)
        if err:
            raise RuntimeError(f"wkv backward launch failed: error {err}")
    return call, outs, (r, k, v, w, u, dout)


def _fa_bwd_call(lib, q, k, v, out, lse, do):
    B, S, KV, G, D = q.shape
    grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    dvec = torch.empty_like(lse)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.fa_bwd_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
            *(g.data_ptr() for g in grads), B, S, KV, G, D, D ** -0.5, 1,
            FA_WINDOW, 0, stream)
        if err:
            raise RuntimeError(f"attention backward launch failed: {err}")
    return call, grads


def _check(name, got, want, rel) -> float:
    """Largest error, within rel·max(1, max|want|) and rtol rel (bf16
    outputs: ``chip_smoke.py``'s bounds)."""
    worst = 0.0
    for g, x in zip(got, want):
        atol = rel * max(1.0, float(x.float().abs().max()))
        err = (g.float() - x.float()).abs()
        if bool((err > atol + rel * x.float().abs()).any()) or \
                not bool(torch.isfinite(g.float()).all()):
            raise AssertionError(f"{name}: outside rtol {rel}, atol {atol}")
        worst = max(worst, float(err.max()))
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    designs = [("wkv_bwd", "shipped")] + \
        [d for d in EDITS if d[0] == "wkv_bwd"] + [("fa_bwd", "shipped")] + \
        [d for d in EDITS if d[0] == "fa_bwd"]
    libs = _libraries(designs)
    calls = {}
    want = None
    for key in [d for d in designs if d[0] == "wkv_bwd"]:
        call, got, ins = _wkv_bwd_call(libs[key])
        call()
        torch.cuda.synchronize()
        if want is None:
            want = wkv_bwd_ref(*ins)
        print(f"[ab] wkv backward {key[1]} {WKV_BWD_PATH}: max abs err "
              f"{_check(key[1], got, want, 1e-2):.3e}", flush=True)
        calls[key] = call
    rng = np.random.default_rng(5)
    B, S, KV, G, D = FA_BWD_PATH
    q, do = (_draw(rng, FA_BWD_PATH, torch.bfloat16) for _ in range(2))
    k, v = (_draw(rng, (B, S, KV, D), torch.bfloat16) for _ in range(2))
    out, lse = flash_attention_fwd(q, k, v, window=FA_WINDOW)
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, window=FA_WINDOW)
    for key in [d for d in designs if d[0] == "fa_bwd"]:
        call, got = _fa_bwd_call(libs[key], q, k, v, out, lse, do)
        call()
        torch.cuda.synchronize()
        print(f"[ab] attention backward {key[1]} {FA_BWD_PATH}: max abs err "
              f"{_check(key[1], got, want, 2e-2):.3e}", flush=True)
        calls[key] = call

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    times = {key: [] for key in designs}
    clocks = [sm_clock_mhz()]
    for _ in range(args.rounds):
        for key in designs:
            times[key].append(time_ms(calls[key], args.reps, flush, True))
        clocks.append(sm_clock_mhz())
    result = {"device": torch.cuda.get_device_name(0),
              "sm_clock_mhz": clocks, "rows": []}
    print("[ab] SM clock before and after each round, MHz: " +
          " ".join(f"{c:.0f}" for c in clocks), flush=True)
    for key in designs:
        result["rows"].append({"kernel": key[0], "design": key[1],
                               "ms": times[key]})
        print(f"[ab] {key[0]} {key[1]}: ms a call " +
              " ".join(f"{t:.4f}" for t in times[key]), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
