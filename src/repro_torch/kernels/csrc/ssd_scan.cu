// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// ssd_scan_chunked (body _kernel), and on the serving path the JAX
// package's XLA mirror mamba2.ssd_chunked. For one (batch b, head h) pair
// and a sequence cut into chunks of Q = min(chunk, S) steps, with cum the
// running sum of dt * A inside the chunk:
//   carry-in  y_i  = exp(cum_i) * (C_i . h)
//   intra     y_i += sum_{j<=i} ((C_i . B_j) * exp(cum_i - cum_j) * dt_j) x_j
//   state     h    = exp(cum_last) * h + sum_j x_j (B_j * exp(cum_last - cum_j) * dt_j)
// all in f32 (plain FMA, no TF32 and no tensor cores), with y rounded once to
// bf16. A ragged last chunk (S not a multiple of Q) is the XLA mirror's
// zero-padded chunk without the padding: a zero row adds nothing to y or h.
//
// Translation. The TPU kernel walks the chunks along a sequential grid axis
// and keeps the (P, N) state in VMEM scratch between grid steps. Here one
// block owns one (b, h) pair and walks the chunks in a loop; the state
// stays in shared memory from chunk to chunk and never goes to device
// memory until the end. A chunk's B (Q, N) and x (Q, P) tiles sit in shared
// memory as bf16 (160 KB at Q=256, N=128, P=64, of the 227 KB a block may
// have). The (Q, Q) decay-weighted score matrix would not fit in f32 (256 KB
// at Q=256), so it is built kR query rows at a time: C rows of the tile,
// their row of W = (C B^T * decay * dt) over j <= i, then their outputs.
//
// Bound on an H100: operations. At the mamba2-370m prefill shape (B=1,
// S=199, H=32, P=64, N=128) the scan does ~0.7 GFLOP on ~4 MB, ~10 us at
// the 67 TFLOP/s f32 peak against ~1 us of bytes at 3.35 TB/s. This first
// kernel runs 1 block of 1,024 threads per (b, h) (32 blocks on 132 SMs)
// with scalar FMA from shared memory; each inner loop is one dependent FMA
// chain, so the warps of a block are what hides the shared-memory latency.
// Computing C B^T once per (b, chunk) rather than per head (it does not
// depend on h), splitting P across blocks, register tiles, and the three
// products on tensor cores (TF32 or bf16 operands) are later work.
//
// Layouts (strides in elements): x (B, S, H, P) bf16 with P contiguous and
// head stride P, given batch and step strides (the model passes a view of
// its conv output without a copy); dt (B, S, H) f32 contiguous; A (H,) f32;
// Bm, Cm (B, S, N) bf16 with N contiguous, given batch and step strides;
// h0 and h_out (B, H, P, N) f32 contiguous; y (B, S, H, P) bf16 contiguous.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (src/repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kR = 16;  // query rows of W built at a time

struct Smem {
  // f32 arrays first, then bf16 (all offsets in bytes, 16-byte aligned)
  size_t h, c, w, cum, dts, dend, bs, xs, total;
};

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~size_t(15); }

__host__ __device__ inline Smem smem_layout(int q, int p, int n) {
  Smem s;
  size_t o = 0;
  s.h = o;    o = align16(o + sizeof(float) * p * (n + 1));
  s.c = o;    o = align16(o + sizeof(float) * kR * (n + 1));
  s.w = o;    o = align16(o + sizeof(float) * kR * q);
  s.cum = o;  o = align16(o + sizeof(float) * q);
  s.dts = o;  o = align16(o + sizeof(float) * q);
  s.dend = o; o = align16(o + sizeof(float) * q);
  s.bs = o;   o = align16(o + sizeof(__nv_bfloat16) * q * (n + 2));
  s.xs = o;   o = align16(o + sizeof(__nv_bfloat16) * q * p);
  s.total = o;
  return s;
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
                const __nv_bfloat16* __restrict__ Cm, const float* __restrict__ h0,
                __nv_bfloat16* __restrict__ y, float* __restrict__ h_out,
                int S, int H, int P, int N, int Q,
                long long s_xb, long long s_xs, long long s_bb, long long s_bs,
                long long s_cb, long long s_cs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(Q, P, N);
  float* Hs = reinterpret_cast<float*>(smem + L.h);      // [P][N+1] state
  float* Cs = reinterpret_cast<float*>(smem + L.c);      // [kR][N+1] C rows
  float* Ws = reinterpret_cast<float*>(smem + L.w);      // [kR][Q] W rows
  float* cum = reinterpret_cast<float*>(smem + L.cum);   // [Q]
  float* dts = reinterpret_cast<float*>(smem + L.dts);   // [Q]
  float* dend = reinterpret_cast<float*>(smem + L.dend); // [Q]
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + L.bs);  // [Q][N+2]
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem + L.xs);  // [Q][P]
  const int HN = N + 1, BN = N + 2;

  const int tid = threadIdx.x;
  const int hh = blockIdx.x;
  const int bb = blockIdx.y;
  const float a = A[hh];
  const long long state0 = (static_cast<long long>(bb) * H + hh) * P * N;

  for (int idx = tid; idx < P * N; idx += kThreads) {
    Hs[(idx / N) * HN + idx % N] = h0[state0 + idx];
  }

  const int n_chunks = (S + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    const int qc = min(Q, S - t0);
    __syncthreads();  // the previous chunk is done with the tiles
    for (int j = tid; j < qc; j += kThreads) {
      dts[j] = dt[(static_cast<long long>(bb) * S + t0 + j) * H + hh];
    }
    for (int idx = tid; idx < qc * (N / 2); idx += kThreads) {
      const int j = idx / (N / 2), n2 = idx % (N / 2);
      const __nv_bfloat162* src = reinterpret_cast<const __nv_bfloat162*>(
          Bm + bb * s_bb + (t0 + j) * s_bs);
      reinterpret_cast<__nv_bfloat162*>(Bs + j * BN)[n2] = src[n2];
    }
    for (int idx = tid; idx < qc * P; idx += kThreads) {
      const int j = idx / P, p = idx % P;
      Xs[j * P + p] = x[bb * s_xb + (t0 + j) * s_xs + static_cast<long long>(hh) * P + p];
    }
    __syncthreads();
    if (tid == 0) {  // sequential, as the plain version's cumsum
      float run = 0.f;
      for (int j = 0; j < qc; ++j) {
        run += dts[j] * a;
        cum[j] = run;
      }
    }
    __syncthreads();

    for (int i0 = 0; i0 < qc; i0 += kR) {
      const int rn = min(kR, qc - i0);
      const int jn = i0 + rn;  // causal: these rows see columns j < jn
      for (int idx = tid; idx < rn * N; idx += kThreads) {
        const int r = idx / N, n = idx % N;
        Cs[r * HN + n] = __bfloat162float(Cm[bb * s_cb + (t0 + i0 + r) * s_cs + n]);
      }
      __syncthreads();
      // W[r][j] = (C_i . B_j) * exp(cum_i - cum_j) * dt_j for j <= i
      for (int idx = tid; idx < rn * jn; idx += kThreads) {
        const int r = idx / jn, j = idx % jn;
        const int i = i0 + r;
        float w = 0.f;
        if (j <= i) {
          const float* cr = Cs + r * HN;
          const __nv_bfloat162* br = reinterpret_cast<const __nv_bfloat162*>(Bs + j * BN);
          float cb = 0.f;
#pragma unroll 4
          for (int n2 = 0; n2 < N / 2; ++n2) {
            const float2 bf = __bfloat1622float2(br[n2]);
            cb = fmaf(cr[2 * n2], bf.x, cb);
            cb = fmaf(cr[2 * n2 + 1], bf.y, cb);
          }
          w = cb * expf(cum[i] - cum[j]) * dts[j];
        }
        Ws[r * Q + j] = w;
      }
      __syncthreads();
      // y_i = exp(cum_i) * (C_i . h) + sum_j W[i][j] x_j
      for (int idx = tid; idx < rn * P; idx += kThreads) {
        const int r = idx / P, p = idx % P;
        const int i = i0 + r;
        const float* cr = Cs + r * HN;
        const float* hp = Hs + p * HN;
        float off = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) off = fmaf(cr[n], hp[n], off);
        off *= expf(cum[i]);
        const float* wr = Ws + r * Q;
        float diag = 0.f;
#pragma unroll 4
        for (int j = 0; j <= i; ++j) diag = fmaf(wr[j], __bfloat162float(Xs[j * P + p]), diag);
        y[((static_cast<long long>(bb) * S + t0 + i) * H + hh) * P + p] =
            __float2bfloat16(off + diag);
      }
      __syncthreads();  // Cs / Ws are refilled by the next row tile
    }

    // state: h = exp(cum_last) h + sum_j x_j (B_j * exp(cum_last - cum_j) dt_j)
    const float last = cum[qc - 1];
    for (int j = tid; j < qc; j += kThreads) dend[j] = expf(last - cum[j]) * dts[j];
    __syncthreads();
    const float decay = expf(last);
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int p = idx / N, n = idx % N;
      float acc = 0.f;
#pragma unroll 4
      for (int j = 0; j < qc; ++j) {
        const float bd = __bfloat162float(Bs[j * BN + n]) * dend[j];
        acc = fmaf(__bfloat162float(Xs[j * P + p]), bd, acc);
      }
      Hs[p * HN + n] = decay * Hs[p * HN + n] + acc;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < P * N; idx += kThreads) {
    h_out[state0 + idx] = Hs[(idx / N) * HN + idx % N];
  }
}

}  // namespace

// Shared memory one block needs at these sizes (the wrapper refuses shapes
// above the card's 227 KB per block).
extern "C" long long ssd_scan_smem_bytes(int q, int p, int n) {
  return static_cast<long long>(smem_layout(q, p, n).total);
}

// Plain C entry point (loaded with ctypes). Returns the CUDA error code of
// the launch (0 on success).
extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                             const void* Cm, const void* h0, void* y, void* h_out, int b,
                             int s, int h, int p, int n, int chunk, long long s_xb,
                             long long s_xs, long long s_bb, long long s_bs, long long s_cb,
                             long long s_cs, void* stream) {
  if (b < 1 || s < 1 || h < 1 || p < 1 || n < 2 || n % 2 || chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int q = chunk < s ? chunk : s;
  const size_t bytes = smem_layout(q, p, n).total;
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<<<dim3(h, b), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), static_cast<const float*>(h0),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(h_out), s, h, p, n, q, s_xb, s_xs,
      s_bb, s_bs, s_cb, s_cs);
  return static_cast<int>(cudaGetLastError());
}
