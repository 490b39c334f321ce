"""Two designs of the eigenvalue kernel, timed on one NVIDIA GPU in turns.

    python3 scripts/eig_designs.py [--dims 10 100] [--calls 50] [--parent DIR]

(a) is the port's kernel, `tempest_tpu_torch/csrc/sym_eigvals.cu`:
Householder tridiagonalization in shared memory, then Sturm-count
multisection. (b) is parallel cyclic Jacobi with a round made one phase,
built here from `JACOBI_SOURCE` below and used nowhere else: each thread
applies J_k^T A_kl J_l to the 2x2 blocks of its pairs of pairs (k, l),
computing both rotations itself from a read-only copy of the matrix and
writing the other copy (so a round takes one barrier), the round's pairs
read from a table built once a launch (no % or / in the rounds), and the
off-diagonal sum once a sweep. Both run one CTA a matrix on one float32
matrix a call, the CV's shape, and are held against torch.linalg.eigvalsh
of the float64 copy (16 d eps max|lambda|). Printed for each d: each
design's device time a launch (torch.profiler, the kernel's own records),
the library's (torch.linalg.eigvalsh in float32, every device record of
the call), and (b)'s sweeps. With `--parent DIR` (a checkout of another
commit, e.g. `git archive <commit> | tar -x -C build/parent`), that
commit's `csrc/sym_eigvals.cu` is built too and timed in the same turns.
The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from tempest_tpu_torch.ops import _build, cuda_linalg  # noqa: E402

JACOBI_SOURCE = r"""
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {
constexpr int kMaxSweeps = 30;
constexpr int kMaxBlocks = 4;  // (k, l) blocks a thread: h^2 <= 4 * 1024

__device__ float rsqrt1(float a) { const float y = rsqrtf(a); return y * (1.5f - 0.5f * a * y * y); }
__device__ float div1(float a, float b) { const float y = __fdividef(1.0f, b); return a * (y * (2.0f - b * y)); }

// The rotation (c, s) that zeroes a_pq of the 2x2 block (a_pp, a_pq, a_qq).
__device__ void rotation(float app, float apq, float aqq, float& c, float& s) {
  const float g = 2.0f * apq, diff = aqq - app;
  c = 1.0f;
  s = 0.0f;
  if (fabsf(g) > 1e-18f) {
    const float r = diff * diff + g * g;
    float t = div1(fabsf(g), fabsf(diff) + r * rsqrt1(r));
    if ((diff < 0 && g > 0) || (diff > 0 && g < 0)) t = -t;
    c = rsqrt1(1.0f + t * t);
    s = t * c;
  }
}

__global__ void __launch_bounds__(1024) jacobi1(const float* __restrict__ in, float* __restrict__ out,
                                                int32_t* __restrict__ sweeps_out, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int m = d + (d & 1), ld = m + 1, h = m / 2;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* X = reinterpret_cast<float*>(smem);
  float* Y = X + m * ld;
  float* red = Y + m * ld;
  int* P = reinterpret_cast<int*>(red + 32);  // (m - 1) rounds x h pairs
  int* Q = P + (m - 1) * h;
  const float* a = in + static_cast<int64_t>(blockIdx.x) * d * d;
  for (int idx = tid; idx < m * m; idx += nt) {
    const int i = idx / m, j = idx - i * m;
    float v = 0.0f;
    if (i < d && j < d) v = i >= j ? a[i * d + j] : a[j * d + i];
    X[i * ld + j] = v;
  }
  for (int idx = tid; idx < (m - 1) * h; idx += nt) {
    const int r = idx / h, k = idx - r * h;
    int p = k == 0 ? 0 : (k - 1 + r) % (m - 1) + 1;
    int q = (m - 2 - k + r) % (m - 1) + 1;
    P[idx] = p < q ? p : q;
    Q[idx] = p < q ? q : p;
  }
  // This thread's blocks (k, l), fixed for the launch.
  int bk[kMaxBlocks], bl[kMaxBlocks];
#pragma unroll
  for (int t = 0; t < kMaxBlocks; ++t) {
    const int bi = tid + t * nt;
    bk[t] = bi < h * h ? bi / h : -1;
    bl[t] = bi < h * h ? bi - bk[t] * h : -1;
  }
  __syncthreads();
  float norm2 = 0.0f;
  for (int idx = tid; idx < m * m; idx += nt) {
    const int i = idx / m, j = idx - i * m;
    norm2 += X[i * ld + j] * X[i * ld + j];
  }
  for (int o = 16; o > 0; o >>= 1) norm2 += __shfl_xor_sync(0xffffffffu, norm2, o);
  if ((tid & 31) == 0) red[tid >> 5] = norm2;
  __syncthreads();
  norm2 = 0.0f;
  for (int w = 0; w < nt / 32; ++w) norm2 += red[w];
  const float tol2 = FLT_EPSILON * FLT_EPSILON * norm2;
  int sweep = 0;
  for (; sweep < kMaxSweeps; ++sweep) {
    float off2 = 0.0f;
    for (int idx = tid; idx < m * m; idx += nt) {
      const int i = idx / m, j = idx - i * m;
      if (i != j) off2 += X[i * ld + j] * X[i * ld + j];
    }
    for (int o = 16; o > 0; o >>= 1) off2 += __shfl_xor_sync(0xffffffffu, off2, o);
    __syncthreads();
    if ((tid & 31) == 0) red[tid >> 5] = off2;
    __syncthreads();
    off2 = 0.0f;
    for (int w = 0; w < nt / 32; ++w) off2 += red[w];
    if (!(off2 > tol2)) break;
    for (int r = 0; r < m - 1; ++r) {
      const int* Pr = P + r * h;
      const int* Qr = Q + r * h;
#pragma unroll
      for (int t = 0; t < kMaxBlocks; ++t) {
        const int k = bk[t], l = bl[t];
        if (k < 0) continue;
        const int pk = Pr[k], qk = Qr[k], pl = Pr[l], ql = Qr[l];
        float ck, sk, cl, sl;
        rotation(X[pk * ld + pk], X[pk * ld + qk], X[qk * ld + qk], ck, sk);
        rotation(X[pl * ld + pl], X[pl * ld + ql], X[ql * ld + ql], cl, sl);
        const float m00 = X[pk * ld + pl], m01 = X[pk * ld + ql];
        const float m10 = X[qk * ld + pl], m11 = X[qk * ld + ql];
        const float n00 = ck * m00 - sk * m10, n01 = ck * m01 - sk * m11;
        const float n10 = sk * m00 + ck * m10, n11 = sk * m01 + ck * m11;
        Y[pk * ld + pl] = cl * n00 - sl * n01;
        Y[pk * ld + ql] = k == l ? 0.0f : sl * n00 + cl * n01;
        Y[qk * ld + pl] = k == l ? 0.0f : cl * n10 - sl * n11;
        Y[qk * ld + ql] = sl * n10 + cl * n11;
      }
      __syncthreads();
      float* tmp = X;
      X = Y;
      Y = tmp;
    }
  }
  for (int i = tid; i < d; i += nt) {
    const float v = X[i * ld + i];
    int rank = 0;
    for (int j = 0; j < d; ++j) {
      const float w = X[j * ld + j];
      rank += (w < v) || (w == v && j < i);
    }
    out[static_cast<int64_t>(blockIdx.x) * d + rank] = v;
  }
  if (sweeps_out != nullptr && tid == 0) sweeps_out[blockIdx.x] = sweep;
}
}  // namespace

extern "C" int jacobi1_launch(const void* a, void* w, void* sweeps, int batch, int d, void* stream) {
  const int m = d + (d & 1), h = m / 2;
  if (h * h > 4 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (2 * m * (m + 1) + 32) * sizeof(float) + 2 * (m - 1) * h * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(jacobi1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = (h * h + 31) / 32 * 32;
  threads = threads > 1024 ? 1024 : threads;
  jacobi1<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<float*>(w), static_cast<int32_t*>(sweeps), d);
  return static_cast<int>(cudaGetLastError());
}
"""


def build(src: Path, name: str) -> ctypes.CDLL:
    """Compile `src` with the port's nvcc flags into build/; print ptxas's
    registers and spills."""
    out_dir = _build.BUILD_DIR / "designs"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{name}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    print(f"ptxas ({name}): " + " ".join(ln.strip() for ln in proc.stderr.splitlines()
                                         if "registers" in ln or "spill" in ln), flush=True)
    return ctypes.CDLL(str(lib))


def build_jacobi() -> ctypes.CDLL:
    """(b), from JACOBI_SOURCE."""
    src = _build.BUILD_DIR / "designs" / "jacobi1.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(JACOBI_SOURCE)
    handle = build(src, "jacobi1")
    handle.jacobi1_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    handle.jacobi1_launch.restype = ctypes.c_int
    return handle


def build_parent(root: str) -> ctypes.CDLL:
    """Another commit's kernel: its float32 C entry, the same signature."""
    handle = build(Path(root) / "tempest_tpu_torch" / "csrc" / "sym_eigvals.cu", "sym_eigvals_parent")
    handle.tempest_sym_eigvals.argtypes = list(cuda_linalg._SIGNATURE)
    handle.tempest_sym_eigvals.restype = ctypes.c_int
    return handle


def device_ms(fn, kernel=None, calls: int = 50) -> float:
    """Device time a call (ms) from torch.profiler's device records: the
    kernels whose name holds `kernel`, or every record (a library call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then records no device activity
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and (kernel is None or kernel in e.key))
        if us > 0:
            return us / 1e3 / calls
    raise RuntimeError(f"no device time recorded for {kernel}")


def spd(d: int, seed: int = 7) -> torch.Tensor:
    """chip_smoke.py's timed matrix: x x^T / d + 0.1 I in float32."""
    g = torch.Generator(device="cpu")
    g.manual_seed(seed + d)
    x = torch.randn(1, d, d, generator=g, dtype=torch.float64)
    a = x @ x.transpose(1, 2) / d + 0.1 * torch.eye(d, dtype=torch.float64)
    return a.to(device="cuda", dtype=torch.float32)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dims", type=int, nargs="+", default=[10, 100])
    parser.add_argument("--calls", type=int, default=50)
    parser.add_argument("--parent", metavar="DIR", help="a checkout of another commit")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script times kernels on an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    jacobi = build_jacobi()
    parent = build_parent(args.parent) if args.parent else None
    rows = {}
    for d in args.dims:
        a = spd(d)
        want = torch.linalg.eigvalsh(a.double())
        w = torch.empty(1, d, device="cuda")
        sweeps = torch.empty(1, dtype=torch.int32, device="cuda")

        def design_b():
            err = jacobi.jacobi1_launch(a.data_ptr(), w.data_ptr(), sweeps.data_ptr(), 1, d,
                                        torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"jacobi1 launch failed with CUDA error {err}")

        wp = torch.empty(1, d, device="cuda")

        def parent_kernel():
            err = parent.tempest_sym_eigvals(a.data_ptr(), wp.data_ptr(), None, None, 1, d, 1,
                                             torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"the parent's launch failed with CUDA error {err}")

        design_a = lambda: cuda_linalg.eigvalsh(a)  # noqa: E731
        fns = [("a", design_a, "sym_eigvals"), ("b", design_b, "jacobi1"),
               ("library", lambda: torch.linalg.eigvalsh(a), None)]
        if parent is not None:
            fns.append(("parent", parent_kernel, "sym_eigvals"))
            parent_kernel()
        design_b()
        got_a, rounds = cuda_linalg._launch(a, True)
        torch.cuda.synchronize()
        bar = 16 * d * torch.finfo(torch.float32).eps * float(want.abs().max())
        errs = {"a": float((got_a.double() - want).abs().max()),
                "b": float((w.double() - want).abs().max())}
        if parent is not None:
            errs["parent"] = float((wp.double() - want).abs().max())
        for k, e in errs.items():
            if not e <= bar:
                sys.exit(f"design ({k}) at d = {d}: |dlambda| {e} above 16 d eps max|lambda|")
        times = {k: [] for k, _, _ in fns}
        for order in (fns, fns[::-1]):  # in turns, forth and back
            for k, fn, kernel in order:
                times[k].append(device_ms(fn, kernel, args.calls))
        rows[d] = {**{f"{k}_ms": v for k, v in times.items()}, "a_rounds": int(rounds.item()),
                   "b_sweeps": int(sweeps.item()), "max_abs_err": errs}
        print(f"d={d}: (a) tridiagonal + multisection {times['a']} ms, (b) one-phase Jacobi "
              f"{times['b']} ms ({int(sweeps.item())} sweeps), torch.linalg.eigvalsh "
              f"{times['library']} ms" + (f", the parent's kernel {times['parent']} ms"
                                          if parent is not None else "")
              + f" (device a launch, in turns forth and back); |dlambda| {errs}", flush=True)
    print(json.dumps({"card": card, "designs": rows}), flush=True)


if __name__ == "__main__":
    main()
