"""Time the WKV and RG-LRU kernels against the designs they were chosen
over, on the card::

    PYTHONPATH=src python -m repro_torch.kernels.recurrence_ab \\
        [--rounds 4] [--out results.json]

Each other design is the shipped source (``rwkv6_wkv/csrc/rwkv6_wkv.cu``,
``rglru_scan/csrc/rglru_scan.cu``) with a few regions replaced (``EDITS``),
built with the port's nvcc flags into ``_build/``; the shipped libraries
hold one tiling each, and nothing of the port runs these.  Every design is
first held against the plain version at the serve path's shape, with the
bounds of ``chip_smoke.py``; then all of a kernel's designs are timed in
turns, the shipped one first in each round: the median of ``--reps`` calls
by CUDA events, the L2 cache flushed before each call by writing 256 MiB
(the lines left dirty, as ``chip_smoke.py`` times) and, separately, by
reading them (the lines left clean).
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
from repro_torch.kernels.rglru_scan import rglru_ref
from repro_torch.kernels.rglru_scan.ops import SOURCE as RG_SOURCE
from repro_torch.kernels.rwkv6_wkv import wkv_ref
from repro_torch.kernels.rwkv6_wkv.ops import SOURCE as WKV_SOURCE

WKV_PATH = (4, 32, 1024, 64, 64)
RG_PATH = (4, 1024, 2560)

# The WKV kernel's two products (and A's lower-left block) on the CUDA
# cores in float32, register-tiled, in the shipped kernel's tiling: the
# first half computes the outputs, a 1 x 4 tile a thread; the second half
# keeps the state, a 4 x 4 tile a thread.
_WKV_CC_STATE = """  // The state, in float32 registers of the second half: thread h = tid -
  // HALF holds rows sr..sr+3 and columns sc..sc+3.  After each chunk it is
  // also written to SB[parity], the B operand of the next chunk's outputs.
  constexpr int NCG = VT / 4;
  const int hs = tid - HALF, sr = hs / NCG * 4, sc = hs % NCG * 4;
  const bool holds = hs >= 0 && hs < K / 4 * NCG;
  float st[4][4] = {};
  auto put_state = [&](float* dst, int64_t ld) {
    if (!holds) return;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(dst + (sr + i) * ld + sc) =
          make_float4(st[i][0], st[i][1], st[i][2], st[i][3]);
  };

"""
_WKV_CC_A10 = """      {
        const int e = tid % (H2 * H2), t = e / H2, s = e % H2;
        const int q0 = tid / (H2 * H2) * 2;     // two quarters of K a thread
#pragma unroll
        for (int dq = 0; dq < 2; ++dq) {
          const int i0 = (q0 + dq) * (K / 4);
          float a = 0.0f;
#pragma unroll
          for (int j = 0; j < K / 4; j += 4) {
            const float4 x = ld4(Q + t * QS + i0 + j);
            const float4 y = ld4(KQ + s * QS + i0 + j);
            a = fmaf(x.x, y.x, a);
            a = fmaf(x.y, y.y, a);
            a = fmaf(x.z, y.z, a);
            a = fmaf(x.w, y.w, a);
          }
          SQ[e * 4 + q0 + dq] = a;
        }
      }
"""
_WKV_CC_OUT = """      // 4. out = X·[S ; v] on the CUDA cores, a 1 x 4 tile a thread
      if (tid < L * NCG) {
        const int t = tid / NCG, j0 = tid % NCG * 4;
        const float* sb = SB + (c % 2) * K * YS;
        auto fma4 = [](float4& a, float x, float4 y) {
          a.x = fmaf(x, y.x, a.x);
          a.y = fmaf(x, y.y, a.y);
          a.z = fmaf(x, y.z, a.z);
          a.w = fmaf(x, y.w, a.w);
        };
        float4 a0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), a1 = a0;
#pragma unroll
        for (int i = 0; i < IN; i += 4) {
          const float4 x = ld4(X + t * XS + i);
          const float* y = (i < K ? sb + i * YS : VB + (i - K) * YS) + j0;
          fma4(a0, x.x, ld4(y));
          fma4(a1, x.y, ld4(y + YS));
          fma4(a0, x.z, ld4(y + 2 * YS));
          fma4(a1, x.w, ld4(y + 3 * YS));
        }
        if (t < n) {
          T* o = out + ((int64_t)bh * S + t0 + t) * V + v0 + j0;
          st2(o, a0.x + a1.x, a0.y + a1.y);
          st2(o + 2, a0.z + a1.z, a0.w + a1.w);
        }
      }
"""
_WKV_CC_UPDATE = """      // 5. the state update S <- diag(w[0:L]) S + KDᵀ·v on the CUDA cores
      //    (rows s >= n add 0), then into SB for the next chunk
      if (holds) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float cp = CPL[sr + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) st[i][j] *= cp;
        }
#pragma unroll
        for (int s = 0; s < L; ++s) {
          const float4 kd = ld4(KD + s * KDS + sr);
          const float4 vy = ld4(VB + s * YS + sc);
          const float kq[4] = {kd.x, kd.y, kd.z, kd.w};
          const float vq[4] = {vy.x, vy.y, vy.z, vy.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) st[i][j] = fmaf(kq[i], vq[j], st[i][j]);
        }
      }
"""

_WKV_CFG = "using PathCfg = Cfg<T, K, V, (V < 32 ? V : 32), 16, 4>;"
_RG_RING = "using PathRing = Ring<T, 64, 2, 32>;"


def _ring(ts, nst, cw):
    return (_RG_RING, "\n", f"using PathRing = Ring<T, {ts}, {nst}, {cw}>;")


# The RG-LRU ring's copies asking L2 to fetch the 256-byte block around
# each 16-byte piece (a neighbouring block's channels), and its stores
# marked streaming (evict first) in float32
_RG_PREFETCH = ('"cp.async.cg.shared.global [%0], [%1], 16;\\n"', "::",
                '"cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\\n" ')
_RG_STREAM = [
    ("__device__ __forceinline__ float step(", "__device__ __forceinline__ "
     "void cp_async16", """__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}
__device__ __forceinline__ void put(float* p, float h) { __stcs(p, h); }
__device__ __forceinline__ void put(__nv_bfloat16* p, float h) {
  *p = __float2bfloat16(h);
}

"""),
    ("    if (n == TS) {", "    __syncthreads();                             "
     "// before", """    if (n == TS) {
#pragma unroll
      for (int j = 0; j < TS; ++j) {
        h = step(to_f(as[j * CW + lane]), h, to_f(bs[j * CW + lane]));
        if (live) put(o + (int64_t)(t0 + j) * D, h);
      }
    } else {
      for (int j = 0; j < n; ++j) {
        h = step(to_f(as[j * CW + lane]), h, to_f(bs[j * CW + lane]));
        if (live) put(o + (int64_t)(t0 + j) * D, h);
      }
    }
""")]

#: (kernel, design) -> edits of the shipped source: each edit is (start,
#: end, text), the region from ``start`` up to ``end`` (both occurring
#: once; ``end`` is kept) replaced by ``text``
EDITS = {
    ("wkv", "products on the CUDA cores (float32 FMA)"): [
        ("  // The state, in float32 registers of the second half's warps",
         "  // Two barriers a chunk", _WKV_CC_STATE),
        ("      float d[4] = {}, e[4] = {};", "    } else {\n      // 2b.",
         _WKV_CC_A10),
        ("      // 4. out = X·[S ; v] on the tensor cores",
         "    } else {\n      // 5.", _WKV_CC_OUT),
        ("      // 5. the state update", "      put_state(SB + (c + 1)",
         _WKV_CC_UPDATE)],
    ("wkv", "three copy stages"): [
        (_WKV_CFG, "\n", _WKV_CFG.replace("16, 4>", "16, 3>"))],
    ("wkv", "V tiles of 16 columns"): [
        (_WKV_CFG, "\n", _WKV_CFG.replace("(V < 32 ? V : 32)", "16"))],
    **{("rglru", f"{ts} steps x {nst} stages, {cw} channels a block"): [
        _ring(ts, nst, cw)]
       for ts, nst, cw in ((32, 4, 32), (16, 8, 32), (64, 4, 32),
                           (128, 2, 32), (64, 2, 128))},
    ("rglru", "L2 prefetch of 256 B a copy"): [_RG_PREFETCH],
    ("rglru", "streaming stores"): _RG_STREAM,
    ("rglru", "L2 prefetch and streaming stores"): [_RG_PREFETCH,
                                                    *_RG_STREAM],
    **{("rglru", f"L2 prefetch and streaming stores, {ts} steps x {nst} "
                 f"stages"): [_ring(ts, nst, 32), _RG_PREFETCH, *_RG_STREAM]
       for ts, nst in ((64, 4), (32, 4))},
    ("rglru", "the rows kernel (registers, 16 steps ahead)"): [
        ("  if (aligned)\n", "    return launch_ring", "  if (false)\n")],
}


def design_source(kernel: str, design: str) -> str:
    """The source of ``design``: the shipped source with its edits."""
    text = (WKV_SOURCE if kernel == "wkv" else RG_SOURCE).read_text()
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
            sources[(kernel, design)] = WKV_SOURCE if kernel == "wkv" \
                else RG_SOURCE
            continue
        slug = re.sub(r"\W+", "_", design).strip("_")
        path = src_dir / f"{kernel}_{slug}.cu"
        path.write_text(design_source(kernel, design))
        sources[(kernel, design)] = path
    built = _build.compile_libraries(list(sources.values()))
    P, I = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for key, so in zip(sources, built):
        lib = ctypes.CDLL(str(so))
        if key[0] == "wkv":
            fn, n_ptr, n_int = lib.wkv_fwd, 7, 5
        else:
            fn, n_ptr, n_int = lib.rglru_scan_fwd, 4, 3
        fn.argtypes = [I] + [P] * n_ptr + [I] * n_int + [P]
        fn.restype = I
        libs[key] = lib
    return libs


def time_ms(fn, reps: int, flush: torch.Tensor, dirty: bool) -> float:
    """Median time of one call of ``fn`` by CUDA events, the L2 cache
    flushed before each call (by writing ``flush`` if ``dirty``, else by
    reading it), a sleep kernel keeping the card busy while the host
    enqueues the call."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if dirty:
            flush.zero_()
        else:
            flush.sum()
        torch.cuda._sleep(1_000_000)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(sorted(times)[len(times) // 2])


def sm_clock_mhz(cycles: int = 20_000_000) -> float:
    """The SM clock while one thread spins for ``cycles`` clock ticks
    (``torch.cuda._sleep``), by CUDA events: the card's clock at the time
    of the call, which moves the times of kernels bound by issue or
    latency."""
    torch.cuda._sleep(cycles)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    stop.record()
    stop.synchronize()
    return cycles / start.elapsed_time(stop) / 1e3


def _max_err(name, got, want, rtol, atol) -> float:
    err = (got.float() - want.float()).abs()
    bad = int((err > atol + rtol * want.float().abs()).sum()) + \
        int((~torch.isfinite(got.float())).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} entries outside rtol {rtol}, "
                             f"atol {atol:.3g}; max abs err "
                             f"{float(err.max()):.3e}")
    return float(err.max())


def _wkv_case(dtype):
    """The serve path's inputs: r, k, v, u normal in ``dtype``, w =
    exp(-exp(U(-8, 2))) float32 (``chip_smoke.py``'s "path" draw)."""
    B, H, S, K, V = WKV_PATH
    rng = np.random.default_rng(4)

    def draw(*sh):
        return torch.from_numpy(rng.standard_normal(sh).astype(
            np.float32)).to("cuda", dtype)
    r, k, v = draw(B, H, S, K), draw(B, H, S, K), draw(B, H, S, V)
    w = torch.from_numpy(np.exp(-np.exp(rng.uniform(
        -8.0, 2.0, (B, H, S, K)))).astype(np.float32)).cuda()
    return r, k, v, w, draw(H, K)


def _wkv_call(lib, r, k, v, w, u):
    B, H, S, K = r.shape
    V = v.shape[3]
    out = torch.empty((B, H, S, V), dtype=r.dtype, device="cuda")
    s_last = torch.empty((B, H, K, V), dtype=torch.float32, device="cuda")
    dt = 0 if r.dtype == torch.float32 else 1
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.wkv_fwd(dt, r.data_ptr(), k.data_ptr(), v.data_ptr(),
                          w.data_ptr(), u.data_ptr(), out.data_ptr(),
                          s_last.data_ptr(), B, H, S, K, V, stream)
        if err:
            raise RuntimeError(f"wkv launch failed: CUDA error {err}")
    return call, out, s_last


def _rg_call(lib, a, b):
    B, S, D = a.shape
    out = torch.empty_like(a)
    h_last = torch.empty((B, D), dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.rglru_scan_fwd(0, a.data_ptr(), b.data_ptr(),
                                 out.data_ptr(), h_last.data_ptr(), B, S, D,
                                 stream)
        if err:
            raise RuntimeError(f"rglru launch failed: CUDA error {err}")
    return call, out, h_last


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    designs = [("wkv", "shipped")] + [d for d in EDITS if d[0] == "wkv"] + \
        [("rglru", "shipped")] + [d for d in EDITS if d[0] == "rglru"]
    libs = _libraries(designs)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    result = {"device": torch.cuda.get_device_name(0), "rows": []}

    # WKV: bf16 r/k/v/u as the serve path gives them, and float32
    calls = {}
    for dtype in (torch.bfloat16, torch.float32):
        r, k, v, w, u = _wkv_case(dtype)
        want_out, want_s = wkv_ref(r, k, v, w, u)
        tol = (2e-4, 2e-4 * max(1.0, float(want_out.abs().max()))) \
            if dtype == torch.float32 else (1e-2, 1e-2)
        for key in [d for d in designs if d[0] == "wkv"]:
            call, out, s_last = _wkv_call(libs[key], r, k, v, w, u)
            call()
            torch.cuda.synchronize()
            e = _max_err(f"wkv {key[1]} {dtype}", out, want_out, *tol)
            e_s = _max_err(f"wkv {key[1]} {dtype} S_last", s_last, want_s,
                           2e-4, 2e-4 * max(1.0, float(want_s.abs().max())))
            print(f"[ab] wkv {key[1]} {str(dtype)[6:]} {WKV_PATH}: max abs "
                  f"err out {e:.3e}, S_last {e_s:.3e}", flush=True)
            if dtype == torch.bfloat16:
                calls[key] = call
    a = torch.from_numpy(np.random.default_rng(4).uniform(
        0.5, 0.999, RG_PATH).astype(np.float32)).cuda()
    b = torch.from_numpy((np.random.default_rng(5).standard_normal(
        RG_PATH) * 0.1).astype(np.float32)).cuda()
    want_out, want_h = rglru_ref(a, b)
    for key in [d for d in designs if d[0] == "rglru"]:
        call, out, h_last = _rg_call(libs[key], a, b)
        call()
        torch.cuda.synchronize()
        if not (torch.equal(out, want_out) and torch.equal(h_last, want_h)):
            raise AssertionError(f"rglru {key[1]} is not bit-equal to the "
                                 f"plain version")
        print(f"[ab] rglru {key[1]} {RG_PATH}: bit-equal", flush=True)
        calls[key] = call
    # the same bytes in the same layout, streamed by PyTorch
    o = torch.empty_like(a)
    key = ("rglru", "reference: torch.add(a, b, out=...), the same bytes")
    designs.append(key)
    calls[key] = lambda: torch.add(a, b, out=o)

    times = {key: {"dirty": [], "clean": []} for key in designs}
    clocks = [sm_clock_mhz()]
    for _ in range(args.rounds):
        for key in designs:
            for mode in ("dirty", "clean"):
                times[key][mode].append(time_ms(calls[key], args.reps, flush,
                                                mode == "dirty"))
        clocks.append(sm_clock_mhz())
    result["sm_clock_mhz"] = clocks
    print("[ab] SM clock before and after each round, MHz: " +
          " ".join(f"{c:.0f}" for c in clocks), flush=True)
    for key in designs:
        row = {"kernel": key[0], "design": key[1], **times[key]}
        result["rows"].append(row)
        print(f"[ab] {key[0]} {key[1]}: ms a call, L2 flushed dirty " +
              " ".join(f"{t:.5f}" for t in row["dirty"]) + "; clean " +
              " ".join(f"{t:.5f}" for t in row["clean"]), flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
