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
// with y rounded once to bf16. A ragged last chunk (S not a multiple of Q)
// is the XLA mirror's zero-padded chunk without the padding: a zero row adds
// nothing to y or h.
//
// Translation. The TPU kernel walks the chunks along a sequential grid axis
// and keeps the (P, N) state in VMEM scratch between grid steps. Here a
// block walks the chunks in a loop with its part of the state in shared
// memory, and two kernels share the work:
//   1. ssd_gram_kernel: CB = C B^T over the causal triangle of each (b,
//      chunk), once for all heads (it does not depend on h), into an f32
//      scratch (Q*Q*4 bytes per (b, chunk), 256 KB at Q = 256, L2-resident).
//      bf16 operands on mma.sync m16n8k16 with f32 sums: the products are
//      exact, so only the order of the sums differs from f32 FMA.
//   2. ssd_scan_kernel: one block per (16-column slice of P, h, b). The
//      state rows of a slice, y's columns of a slice and the carry-in C.h of
//      a slice are independent of the other slices, so at the mamba2-370m
//      prefill shape (B=1, H=32, P=64) 128 blocks share the card's 132 SMs
//      (one block per (b, h) gave 32). Per chunk a block stages C, B and its
//      x columns in shared memory, takes cum by a block-wide parallel scan,
//      builds the decay-weighted W = CB * exp(cum_i - cum_j) * dt_j of its
//      head straight into mma fragments (each W element once per block; the
//      4 slices of a head each repeat the exps, cheap against the
//      products), and runs the three products with an f32 operand on the
//      tensor cores as 2xTF32: the f32 operand is split into two tf32
//      parts (hi + lo, ~22 significant bits) and the other operand (C, x,
//      bf16 values) is exact in tf32, so each product is two m16n8k8 tf32
//      mma with f32 sums:
//        C.h (carry-in)      A = C  (exact), B = h^T       (split)
//        W.x (intra-chunk)   A = W  (split), B = x         (exact)
//        x^T.(B*dend) (state) A = x^T (exact), B = B*dend  (split)
//      The elementwise steps (cum, the exps, W, dend, the decays and the
//      sums around the products) are f32 on the CUDA cores.
//
// Bound on an H100 (chip_smoke.py's _ssd_bound): at the mamba2-370m
// prefill shape the 3.9 MB read and written once take 1.15 us at 3.35 TB/s,
// more than the 0.30 GFLOP take (0.64 us) with C.B^T at the bf16 peak, the
// three products at the tf32 peak and the elementwise steps at the f32 peak;
// all at the f32 peak they would take 4.5 us (the first kernel's count).
//
// Layouts (strides in elements): x (B, S, H, P) bf16 with P contiguous and
// head stride P, given batch and step strides (the model passes a view of
// its conv output without a copy); dt (B, S, H) f32 contiguous; A (H,) f32;
// Bm, Cm (B, S, N) bf16 with N contiguous, given batch and step strides;
// h0 and h_out (B, H, P, N) f32 contiguous; y (B, S, H, P) bf16 contiguous.
// x, Bm and Cm are read in 16-byte vectors (the wrapper checks alignment);
// P and N are multiples of 16, N <= 256.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (src/repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSlice = 16;     // P columns per block
constexpr int kXs = 24;        // row stride (floats) of the x tile: conflict-free fragments
constexpr int kMaxN = 256;     // state dim: N / 8 n-tiles over 8 warps, at most 4 each
constexpr int kCbTile = 64;    // C.B^T tile edge (4 warps of 16 rows)
constexpr int kPrefetch = 8;   // k-steps of CB fragments a warp loads at once
constexpr int kStage = 8;      // 16-byte loads a thread has in flight while staging

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }
__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~size_t(15); }

struct Smem {
  size_t cs, bs, xs, hs, cum, dts, dend, tot, total;  // byte offsets
};

__host__ __device__ inline Smem smem_layout(int q, int n) {
  const int q16 = round16(q);
  Smem s;
  size_t o = 0;
  s.cs = o;   o = align16(o + sizeof(__nv_bfloat16) * q16 * (n + 8));
  s.bs = o;   o = align16(o + sizeof(__nv_bfloat16) * q16 * (n + 8));
  s.xs = o;   o = align16(o + sizeof(float) * q16 * kXs);
  s.hs = o;   o = align16(o + sizeof(float) * kSlice * (n + 4));
  s.cum = o;  o = align16(o + sizeof(float) * q16);
  s.dts = o;  o = align16(o + sizeof(float) * q16);
  s.dend = o; o = align16(o + sizeof(float) * q16);
  s.tot = o;  o = align16(o + sizeof(float) * kWarps);
  s.total = o;
  return s;
}

// Position of CB[i][j] in a (b, chunk)'s scratch: the scan reads W's A
// fragments of m16n8k8 tf32 (rows i0.., columns k0..) as one float4 per lane
// per k-step, {(g, t), (g+8, t), (g, t+4), (g+8, t+4)}, so CB is stored in
// that order: [i/16][j/8][lane = (i%8)*4 + j%4][(i%16)/8 + 2*((j%8)/4)].
__host__ __device__ inline long long cb_index(int i, int j, int q16) {
  const int lane = (i % 8) * 4 + j % 4, e = (i % 16) / 8 + 2 * ((j % 8) / 4);
  return ((static_cast<long long>(i / 16) * (q16 / 8) + j / 8) * 32 + lane) * 4 + e;
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* row, int k) {
  return row != nullptr ? __ldg(reinterpret_cast<const unsigned int*>(row + k)) : 0u;
}

// Gram matrices of a chunk's rows, out[z][i][j] = A_i . B_j over K for the
// chunk's rows i, j < qc, lower-triangle 64x64 tiles (the users read j <= i
// only), z = (b * n_chunks + chunk) * n_heads + head, the rows of head h at
// head_a * h and head_b * h. The forward's CB = C B^T (K = N, one head) and
// the backward's G = dy x^T (K = P, per head). Warp w computes 16 rows x 64
// columns from fragments loaded straight from device memory (each A element
// once per block; B's rows are shared by the 4 warps through L1).
__global__ void __launch_bounds__(128)
ssd_gram_kernel(const __nv_bfloat16* __restrict__ Am, const __nv_bfloat16* __restrict__ Bm,
                float* __restrict__ out, int S, int K, int Q, int n_chunks, int n_heads,
                long long s_ab, long long s_as, long long s_bb, long long s_bs, long long head_a,
                long long head_b) {
  const int ti = blockIdx.x, tj = blockIdx.y;
  if (tj > ti) return;
  const int hh = blockIdx.z % n_heads, bc = blockIdx.z / n_heads;
  const int bb = bc / n_chunks, c = bc % n_chunks;
  const int t0 = c * Q, qc = min(Q, S - t0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int i0 = ti * kCbTile + warp * 16, j0 = tj * kCbTile;
  if (i0 >= qc || j0 >= qc) return;
  const __nv_bfloat16* ar[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = i0 + g + 8 * hf;
    ar[hf] = i < qc ? Am + bb * s_ab + (t0 + i) * s_as + hh * head_a : nullptr;
  }
  const __nv_bfloat16* br[8];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = j0 + nt * 8 + g;
    br[nt] = j < qc ? Bm + bb * s_bb + (t0 + j) * s_bs + hh * head_b : nullptr;
  }
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 16) {
    const uint32_t a[4] = {ld_pair(ar[0], k0 + 2 * t), ld_pair(ar[1], k0 + 2 * t),
                           ld_pair(ar[0], k0 + 8 + 2 * t), ld_pair(ar[1], k0 + 8 + 2 * t)};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mma::bf16_16816(acc[nt], a, ld_pair(br[nt], k0 + 2 * t), ld_pair(br[nt], k0 + 8 + 2 * t));
    }
  }
  // stored in the order the scan loads W's tf32 A fragments (cb_index)
  const int q16 = round16(Q);
  float* o = out + static_cast<long long>(blockIdx.z) * q16 * q16;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + 8 * (e >> 1), j = j0 + nt * 8 + 2 * t + (e & 1);
      if (i < qc && j < qc) o[cb_index(i, j, q16)] = acc[nt][e];
    }
  }
}

// d += a * b, the f32 A operand split into two tf32 parts (b exact in tf32)
__device__ __forceinline__ void mma_split_a(float (&d)[4], const float (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) mma::split_tf32(a[e], hi[e], lo[e]);
  mma::tf32_1688(d, hi, b0, b1);
  mma::tf32_1688(d, lo, b0, b1);
}

// d += a * b, the f32 B operand split into two tf32 parts (a exact in tf32)
__device__ __forceinline__ void mma_split_b(float (&d)[4], const uint32_t (&a)[4], float b0,
                                            float b1) {
  uint32_t hi0, lo0, hi1, lo1;
  mma::split_tf32(b0, hi0, lo0);
  mma::split_tf32(b1, hi1, lo1);
  mma::tf32_1688(d, a, hi0, hi1);
  mma::tf32_1688(d, a, lo0, lo1);
}

// cum[j] = sum_{j' <= j} dts[j'] * a for j < qc: warp scans by shuffles,
// then each thread adds the totals of the warps before it, in warp order.
__device__ void chunk_cumsum(const float* dts, float a, float* cum, int qc, float* tot) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float carry = 0.f;
  for (int base = 0; base < qc; base += kThreads) {
    const int j = base + tid;
    float v = j < qc ? dts[j] * a : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane == 31) tot[warp] = v;
    __syncthreads();
    float before = carry;
    for (int w = 0; w < warp; ++w) before += tot[w];
    if (j < qc) cum[j] = before + v;
    for (int w = 0; w < kWarps; ++w) carry += tot[w];
    __syncthreads();  // tot is rewritten by the next segment; cum is complete
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
                const __nv_bfloat16* __restrict__ Cm, const float* __restrict__ h0,
                const float* __restrict__ cb, __nv_bfloat16* __restrict__ y,
                float* __restrict__ h_out, float* __restrict__ states, int S, int H, int P,
                int N, int Q,
                long long s_xb, long long s_xs, long long s_bb, long long s_bs,
                long long s_cb, long long s_cs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(Q, N);
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem + L.cs);  // [q16][N+8]
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + L.bs);  // [q16][N+8]
  float* Xs = reinterpret_cast<float*>(smem + L.xs);      // [q16][kXs] this slice of x
  float* Hs = reinterpret_cast<float*>(smem + L.hs);      // [kSlice][N+4] state rows
  float* cum = reinterpret_cast<float*>(smem + L.cum);    // [q16]
  float* dts = reinterpret_cast<float*>(smem + L.dts);    // [q16]
  float* dend = reinterpret_cast<float*>(smem + L.dend);  // [q16]
  float* tot = reinterpret_cast<float*>(smem + L.tot);    // [kWarps]
  const int CN = N + 8, HN = N + 4, NV = N / 8, NT = N / 8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int p0 = blockIdx.x * kSlice, hh = blockIdx.y, bb = blockIdx.z;
  const float a = A[hh];
  const long long state0 = ((static_cast<long long>(bb) * H + hh) * P + p0) * N;
  const int n_chunks = (S + Q - 1) / Q;

  for (int idx = tid; idx < kSlice * N; idx += kThreads) {
    Hs[(idx / N) * HN + idx % N] = h0[state0 + idx];
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q;
    const int qc = min(Q, S - t0), q16 = round16(qc);
    __syncthreads();  // the previous chunk is done with the tiles and the state
    if (states != nullptr) {  // training: the chunk's start state, for the backward
      const long long st = (((static_cast<long long>(bb) * n_chunks + c) * H + hh) * P + p0) * N;
      for (int idx = tid; idx < kSlice * N; idx += kThreads) {
        states[st + idx] = Hs[(idx / N) * HN + idx % N];
      }
    }
    for (int j = tid; j < qc; j += kThreads) {
      dts[j] = dt[(static_cast<long long>(bb) * S + t0 + j) * H + hh];
    }
    // C and B rows (zero past qc: a zero row adds nothing and cannot hold
    // NaN), kStage vectors a thread in flight before any is stored
    for (int base = tid; base < q16 * NV; base += kThreads * kStage) {
      uint4 cv[kStage], bv[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int idx = base + u * kThreads, j = idx / NV, e = (idx % NV) * 8;
        cv[u] = bv[u] = make_uint4(0u, 0u, 0u, 0u);
        if (idx < q16 * NV && j < qc) {
          cv[u] = __ldg(reinterpret_cast<const uint4*>(Cm + bb * s_cb + (t0 + j) * s_cs + e));
          bv[u] = __ldg(reinterpret_cast<const uint4*>(Bm + bb * s_bb + (t0 + j) * s_bs + e));
        }
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int idx = base + u * kThreads, j = idx / NV, e = (idx % NV) * 8;
        if (idx < q16 * NV) {
          *reinterpret_cast<uint4*>(Cs + j * CN + e) = cv[u];
          *reinterpret_cast<uint4*>(Bs + j * CN + e) = bv[u];
        }
      }
    }
    for (int idx = tid; idx < q16 * 2; idx += kThreads) {  // x: 2 x 8 values per row
      const int j = idx / 2, e = (idx % 2) * 8;
      uint4 xv = make_uint4(0u, 0u, 0u, 0u);
      if (j < qc) {
        xv = __ldg(reinterpret_cast<const uint4*>(
            x + bb * s_xb + (t0 + j) * s_xs + static_cast<long long>(hh) * P + p0 + e));
      }
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
      float* dst = Xs + j * kXs + e;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f = __bfloat1622float2(xp[u]);
        dst[2 * u] = f.x;
        dst[2 * u + 1] = f.y;
      }
    }
    __syncthreads();
    chunk_cumsum(dts, a, cum, qc, tot);
    const float last = cum[qc - 1];
    for (int j = tid; j < q16; j += kThreads) {
      dend[j] = j < qc ? expf(last - cum[j]) * dts[j] : 0.f;
    }
    __syncthreads();
    const float decay = expf(last);
    const float4* cbc = reinterpret_cast<const float4*>(cb) +
                        (static_cast<long long>(bb) * n_chunks + c) * (round16(Q) * round16(Q) / 4);
    const int n_ks = round16(Q) / 8;  // k-steps per CB row of m-tiles

    // y for the slice, one 16-row m-tile at a time; warps take the tiles
    // in a snake order (w, 15 - w, 16 + w, ...) so the causal work balances
    const int n_mt = q16 / 16;
    for (int k = 0; k * kWarps < n_mt; ++k) {
      const int mt = k * kWarps + (k % 2 == 0 ? warp : kWarps - 1 - warp);
      if (mt >= n_mt) continue;
      const int i0 = mt * 16;
      float off[2][4], dg[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) off[nt][e] = dg[nt][e] = 0.f;
      }
      // carry-in C.h^T: A = C rows (exact), B = h^T (split)
      const __nv_bfloat16* ca = Cs + (i0 + g) * CN;
      const __nv_bfloat16* cbr = Cs + (i0 + g + 8) * CN;
      for (int k0 = 0; k0 < N; k0 += 8) {
        const uint32_t af[4] = {mma::bf16_as_tf32(ca[k0 + t]), mma::bf16_as_tf32(cbr[k0 + t]),
                                mma::bf16_as_tf32(ca[k0 + t + 4]),
                                mma::bf16_as_tf32(cbr[k0 + t + 4])};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float* hr = Hs + (nt * 8 + g) * HN + k0;
          mma_split_b(off[nt], af, hr[t], hr[t + 4]);
        }
      }
      // intra-chunk W.x: A = W (split), B = x (exact); W[i][j] = 0 for j > i.
      // The causal row of m-tiles needs k-steps 0 .. 2 mt + 1; their CB
      // fragments are loaded kPrefetch k-steps at a time, one float4 each.
      const int ia = i0 + g, ib = i0 + g + 8;
      const float4* cbm = cbc + static_cast<long long>(mt) * n_ks * 32 + lane;
      const int n_k = 2 * mt + 2;
      for (int k = 0; k < n_k; k += kPrefetch) {
        float4 cv[kPrefetch];
#pragma unroll
        for (int u = 0; u < kPrefetch; ++u) {
          cv[u] = k + u < n_k ? __ldg(cbm + (k + u) * 32) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kPrefetch; ++u) {
          if (k + u >= n_k) break;
          const int ja = (k + u) * 8 + t, jb = ja + 4;
          const float w[4] = {
              ja <= ia && ia < qc ? cv[u].x * expf(cum[ia] - cum[ja]) * dts[ja] : 0.f,
              ja <= ib && ib < qc ? cv[u].y * expf(cum[ib] - cum[ja]) * dts[ja] : 0.f,
              jb <= ia && ia < qc ? cv[u].z * expf(cum[ia] - cum[jb]) * dts[jb] : 0.f,
              jb <= ib && ib < qc ? cv[u].w * expf(cum[ib] - cum[jb]) * dts[jb] : 0.f};
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            mma_split_a(dg[nt], w, __float_as_uint(Xs[ja * kXs + nt * 8 + g]),
                        __float_as_uint(Xs[jb * kXs + nt * 8 + g]));
          }
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = i0 + g + 8 * hf;
        if (i >= qc) continue;
        const float e = expf(cum[i]);
        __nv_bfloat16* yr = y + ((static_cast<long long>(bb) * S + t0 + i) * H + hh) * P + p0;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          *reinterpret_cast<uint32_t*>(yr + nt * 8 + 2 * t) =
              mma::pack_bf16(off[nt][2 * hf] * e + dg[nt][2 * hf],
                             off[nt][2 * hf + 1] * e + dg[nt][2 * hf + 1]);
        }
      }
    }

    // state: h = exp(cum_last) h + x^T (B * dend); warp w owns n-tiles w, w + 8, ...
    float sacc[kMaxN / 64][4];
#pragma unroll
    for (int u = 0; u < kMaxN / 64; ++u) sacc[u][0] = sacc[u][1] = sacc[u][2] = sacc[u][3] = 0.f;
    for (int k0 = 0; k0 < q16; k0 += 8) {
      const float* xa = Xs + (k0 + t) * kXs;
      const float* xb = Xs + (k0 + t + 4) * kXs;
      const uint32_t af[4] = {__float_as_uint(xa[g]), __float_as_uint(xa[g + 8]),
                              __float_as_uint(xb[g]), __float_as_uint(xb[g + 8])};
      const float d0 = dend[k0 + t], d1 = dend[k0 + t + 4];
#pragma unroll
      for (int u = 0; u < kMaxN / 64; ++u) {
        const int n = (warp + kWarps * u) * 8 + g;
        if (n >= N) continue;
        mma_split_b(sacc[u], af, __bfloat162float(Bs[(k0 + t) * CN + n]) * d0,
                    __bfloat162float(Bs[(k0 + t + 4) * CN + n]) * d1);
      }
    }
    __syncthreads();  // every warp is done reading the old state
#pragma unroll
    for (int u = 0; u < kMaxN / 64; ++u) {
      const int nt = warp + kWarps * u;
      if (nt >= NT) continue;
      float* r0 = Hs + g * HN + nt * 8 + 2 * t;
      float* r1 = Hs + (g + 8) * HN + nt * 8 + 2 * t;
      r0[0] = decay * r0[0] + sacc[u][0];
      r0[1] = decay * r0[1] + sacc[u][1];
      r1[0] = decay * r1[0] + sacc[u][2];
      r1[1] = decay * r1[1] + sacc[u][3];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kSlice * N; idx += kThreads) {
    h_out[state0 + idx] = Hs[(idx / N) * HN + idx % N];
  }
}

// ---------------------------------------------------------------------------
// The backward: the gradient of the scan above, (dx, ddt, dA, dB, dC, dh0)
// from dy (the cotangent of y) and dh_out (of the final state). No Pallas
// kernel has it: the JAX package autodiffs its XLA mirror
// mamba2.ssd_chunked. kernels/ref.py ssd_scan_bwd_ref is its closed form
// and ssd_scan_bwd_split_ref restates this decomposition:
//   (a) ssd_bwd_dstate_kernel, the reverse pass, one block per (16-column
//       slice of P, h, b), the mirror of ssd_scan_kernel: dh, the cotangent
//       of the state at a chunk's end, walks the chunks from the last to the
//       first in shared memory, dh_end[c] = dh, then
//         dh = exp(cum_last) dh + sum_i (exp(cum_i) dy_i)^T C_i,
//       and dh0 is dh after the first chunk;
//   (b) ssd_gram_kernel twice, CB = C B^T per (b, chunk) and G = dy x^T per
//       (b, chunk, h), into f32 scratch in cb_index order; then
//       ssd_bwd_chunk_kernel, one block per (h, chunk, b), on the chunk's
//       start state (the forward's states) and its end cotangent. With
//       V_ij = CB_ij exp(cum_i - cum_j) and dS_ij = G_ij exp(cum_i - cum_j)
//       dt_j on the causal triangle (the exp evaluated there only, so it
//       cannot overflow):
//         rows i:    Y = exp(cum) C h^T + (V dt_j) x (the forward's f32 y),
//                    a_i = dy_i . Y_i, the head's dC_i = exp(cum_i) dy_i h
//                    + sum_j dS_ij B_j;
//         columns j: U = V^T dy, T = B dh^T, dx = dt U + d_end T,
//                    u_j = x_j . U_j, s_j = x_j . T_j, the head's dB_j =
//                    sum_i dS_ij C_i + d_end_j x_j dh;
//         rows t:    dcum = a - dt u - d_end s (and at the last row
//                    sum_j d_end_j s_j + exp(cum_last) sum dh h), dda its
//                    reverse running sum, ddt = u + exp(cum_last - cum) s
//                    + A dda, and the (b, chunk, h) part of dA, sum dda dt;
//   (c) ssd_bwd_reduce_kernel: dB and dC, the heads' partials summed in head
//       order, and dA, the (b, chunk) parts summed in that order. No atomics
//       anywhere: two calls give the same bits.
// The products whose operands are both bf16 values (C B^T, dy x^T) run on
// bf16 mma.sync; the others have one f32 operand and run as 2xTF32, as the
// forward's. The elementwise steps are f32 on the CUDA cores.
//
// Bound on an H100 (chip_smoke.py's _ssd_bwd_bound): at mamba2-370m's
// training rows (B 8, S 128, H 32, P 64, N 128, one chunk) the inputs read
// once and the outputs written once are 39.1 MB (the f32 chunk states,
// dh_out and dh0 most of it), 11.7 us at 3.35 TB/s, more than the products
// (9.2 us with the tf32 ones at the tf32 peak). The design moves more: it
// rereads the state and its cotangent from L2 for every 16-row tile and
// writes and rereads the f32 scratch (G, the per-head partials of dB and
// dC), which a later redesign is to remove.

__device__ __forceinline__ uint32_t tf(__nv_bfloat16 v) { return mma::bf16_as_tf32(v); }

// The sum of v over the block in a fixed order (a butterfly inside each
// warp, then the warps' totals in warp order), returned to every thread.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // red is free (an earlier call's readers are done)
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kWarps; ++w) total += red[w];
  return total;
}

// (a): see above. Shared memory as ssd_scan_kernel's (smem_layout): C rows
// in cs, this slice of dy in xs, the dh rows in hs, exp(cum) in dend.
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_dstate_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                      const __nv_bfloat16* __restrict__ Cm, const __nv_bfloat16* __restrict__ dy,
                      const float* __restrict__ dh_out, float* __restrict__ dh_end,
                      float* __restrict__ dh0, int S, int H, int P, int N, int Q, long long s_cb,
                      long long s_cs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem L = smem_layout(Q, N);
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem + L.cs);  // [q16][N+8]
  float* Ys = reinterpret_cast<float*>(smem + L.xs);      // [q16][kXs] this slice of dy
  float* Hs = reinterpret_cast<float*>(smem + L.hs);      // [kSlice][N+4] rows of dh
  float* cum = reinterpret_cast<float*>(smem + L.cum);    // [q16]
  float* dts = reinterpret_cast<float*>(smem + L.dts);    // [q16]
  float* esc = reinterpret_cast<float*>(smem + L.dend);   // [q16] exp(cum)
  float* tot = reinterpret_cast<float*>(smem + L.tot);    // [kWarps]
  const int CN = N + 8, HN = N + 4, NV = N / 8, NT = N / 8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int p0 = blockIdx.x * kSlice, hh = blockIdx.y, bb = blockIdx.z;
  const float a = A[hh];
  const long long state0 = ((static_cast<long long>(bb) * H + hh) * P + p0) * N;
  const int n_chunks = (S + Q - 1) / Q;

  for (int idx = tid; idx < kSlice * N; idx += kThreads) {
    Hs[(idx / N) * HN + idx % N] = dh_out != nullptr ? dh_out[state0 + idx] : 0.f;
  }
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * Q;
    const int qc = min(Q, S - t0), q16 = round16(qc);
    __syncthreads();  // the later chunk is done with the tiles and dh
    const long long st = (((static_cast<long long>(bb) * n_chunks + c) * H + hh) * P + p0) * N;
    for (int idx = tid; idx < kSlice * N; idx += kThreads) {
      dh_end[st + idx] = Hs[(idx / N) * HN + idx % N];
    }
    for (int j = tid; j < qc; j += kThreads) {
      dts[j] = dt[(static_cast<long long>(bb) * S + t0 + j) * H + hh];
    }
    for (int idx = tid; idx < q16 * NV; idx += kThreads) {  // C rows, zero past qc
      const int j = idx / NV, e = (idx % NV) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (j < qc) v = __ldg(reinterpret_cast<const uint4*>(Cm + bb * s_cb + (t0 + j) * s_cs + e));
      *reinterpret_cast<uint4*>(Cs + j * CN + e) = v;
    }
    for (int idx = tid; idx < q16 * 2; idx += kThreads) {  // dy: 2 x 8 values per row
      const int j = idx / 2, e = (idx % 2) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (j < qc) {
        v = __ldg(reinterpret_cast<const uint4*>(
            dy + ((static_cast<long long>(bb) * S + t0 + j) * H + hh) * P + p0 + e));
      }
      const __nv_bfloat162* vp = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 f = __bfloat1622float2(vp[u]);
        Ys[j * kXs + e + 2 * u] = f.x;
        Ys[j * kXs + e + 2 * u + 1] = f.y;
      }
    }
    __syncthreads();
    chunk_cumsum(dts, a, cum, qc, tot);
    for (int j = tid; j < q16; j += kThreads) esc[j] = j < qc ? expf(cum[j]) : 0.f;
    __syncthreads();
    const float decay = expf(cum[qc - 1]);
    // dy^T (C * exp(cum)): A = dy^T (exact), B = C * exp(cum) (split);
    // warp w owns n-tiles w, w + 8, ...
    float sacc[kMaxN / 64][4];
#pragma unroll
    for (int u = 0; u < kMaxN / 64; ++u) sacc[u][0] = sacc[u][1] = sacc[u][2] = sacc[u][3] = 0.f;
    for (int k0 = 0; k0 < q16; k0 += 8) {
      const float* ya = Ys + (k0 + t) * kXs;
      const float* yb = Ys + (k0 + t + 4) * kXs;
      const uint32_t af[4] = {__float_as_uint(ya[g]), __float_as_uint(ya[g + 8]),
                              __float_as_uint(yb[g]), __float_as_uint(yb[g + 8])};
      const float e0 = esc[k0 + t], e1 = esc[k0 + t + 4];
#pragma unroll
      for (int u = 0; u < kMaxN / 64; ++u) {
        const int n = (warp + kWarps * u) * 8 + g;
        if (n >= N) continue;
        mma_split_b(sacc[u], af, __bfloat162float(Cs[(k0 + t) * CN + n]) * e0,
                    __bfloat162float(Cs[(k0 + t + 4) * CN + n]) * e1);
      }
    }
    __syncthreads();  // every warp is done reading the old dh
#pragma unroll
    for (int u = 0; u < kMaxN / 64; ++u) {
      const int nt = warp + kWarps * u;
      if (nt >= NT) continue;
      float* r0 = Hs + g * HN + nt * 8 + 2 * t;
      float* r1 = Hs + (g + 8) * HN + nt * 8 + 2 * t;
      r0[0] = decay * r0[0] + sacc[u][0];
      r0[1] = decay * r0[1] + sacc[u][1];
      r1[0] = decay * r1[0] + sacc[u][2];
      r1[1] = decay * r1[1] + sacc[u][3];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < kSlice * N; idx += kThreads) {
    dh0[state0 + idx] = Hs[(idx / N) * HN + idx % N];
  }
}

struct BwdSmem {
  size_t xs, ys, bs, cs, cum, dts, ecum, eend, dend, ra, ru, rs, rev, dda, tot, red, total;
};

__host__ __device__ inline BwdSmem bwd_layout(int q, int n, int p) {
  const int q16 = round16(q);
  BwdSmem s;
  size_t o = 0;
  s.xs = o;   o = align16(o + sizeof(__nv_bfloat16) * q16 * (p + 8));
  s.ys = o;   o = align16(o + sizeof(__nv_bfloat16) * q16 * (p + 8));
  s.bs = o;   o = align16(o + sizeof(__nv_bfloat16) * q16 * (n + 8));
  s.cs = o;   o = align16(o + sizeof(__nv_bfloat16) * q16 * (n + 8));
  size_t* rows[] = {&s.cum, &s.dts, &s.ecum, &s.eend, &s.dend, &s.ra, &s.ru, &s.rs, &s.rev, &s.dda};
  for (size_t* r : rows) {
    *r = o;
    o = align16(o + sizeof(float) * q16);
  }
  s.tot = o;  o = align16(o + sizeof(float) * kWarps);
  s.red = o;  o = align16(o + sizeof(float) * kWarps);
  s.total = o;
  return s;
}

constexpr int kGroup = 32;  // P or N columns a warp's tile takes at once (4 n-tiles)

// (b): see above. One block per (h, chunk, b); warps take 16-row tiles in
// the forward's snake order, first as rows i, then as columns j.
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
                     const __nv_bfloat16* __restrict__ Cm, const __nv_bfloat16* __restrict__ dy,
                     const float* __restrict__ states, const float* __restrict__ dh_end,
                     const float* __restrict__ cb, const float* __restrict__ gm,
                     __nv_bfloat16* __restrict__ dx, float* __restrict__ ddt,
                     float* __restrict__ dBp, float* __restrict__ dCp, float* __restrict__ dAp,
                     int S, int H, int P, int N, int Q, long long s_xb, long long s_xs,
                     long long s_bb, long long s_bs, long long s_cb, long long s_cs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdSmem L = bwd_layout(Q, N, P);
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem + L.xs);  // [q16][P+8]
  __nv_bfloat16* Ys = reinterpret_cast<__nv_bfloat16*>(smem + L.ys);  // [q16][P+8] dy
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + L.bs);  // [q16][N+8]
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem + L.cs);  // [q16][N+8]
  float* cum = reinterpret_cast<float*>(smem + L.cum);
  float* dts = reinterpret_cast<float*>(smem + L.dts);
  float* ecum = reinterpret_cast<float*>(smem + L.ecum);  // exp(cum)
  float* eend = reinterpret_cast<float*>(smem + L.eend);  // exp(cum_last - cum)
  float* dend = reinterpret_cast<float*>(smem + L.dend);  // eend * dt
  float* ra = reinterpret_cast<float*>(smem + L.ra);      // dy . Y
  float* ru = reinterpret_cast<float*>(smem + L.ru);      // x . U
  float* rs = reinterpret_cast<float*>(smem + L.rs);      // x . T
  float* rev = reinterpret_cast<float*>(smem + L.rev);    // dcum, last row first
  float* dda = reinterpret_cast<float*>(smem + L.dda);    // its running sum
  float* tot = reinterpret_cast<float*>(smem + L.tot);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const int XP = P + 8, BN = N + 8, PV = P / 8, NV = N / 8;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int hh = blockIdx.x, c = blockIdx.y, bb = blockIdx.z, n_chunks = gridDim.y;
  const int t0 = c * Q, qc = min(Q, S - t0), q16 = round16(qc);
  const int Q16 = round16(Q), n_ks = Q16 / 8;
  const float a = A[hh];
  const long long zc = static_cast<long long>(bb) * n_chunks + c;
  const float* hst = states + (zc * H + hh) * P * N;   // (P, N): the chunk's start state
  const float* dhst = dh_end + (zc * H + hh) * P * N;  // (P, N): its end cotangent
  const float* cbz = cb + zc * Q16 * Q16;
  const float* gz = gm + (zc * H + hh) * Q16 * Q16;

  for (int j = tid; j < qc; j += kThreads) {
    dts[j] = dt[(static_cast<long long>(bb) * S + t0 + j) * H + hh];
  }
  for (int idx = tid; idx < q16 * PV; idx += kThreads) {  // x and dy rows, zero past qc
    const int j = idx / PV, e = (idx % PV) * 8;
    uint4 xv = make_uint4(0u, 0u, 0u, 0u), yv = xv;
    if (j < qc) {
      xv = __ldg(reinterpret_cast<const uint4*>(
          x + bb * s_xb + (t0 + j) * s_xs + static_cast<long long>(hh) * P + e));
      yv = __ldg(reinterpret_cast<const uint4*>(
          dy + ((static_cast<long long>(bb) * S + t0 + j) * H + hh) * P + e));
    }
    *reinterpret_cast<uint4*>(Xs + j * XP + e) = xv;
    *reinterpret_cast<uint4*>(Ys + j * XP + e) = yv;
  }
  for (int idx = tid; idx < q16 * NV; idx += kThreads) {  // B and C rows
    const int j = idx / NV, e = (idx % NV) * 8;
    uint4 bv = make_uint4(0u, 0u, 0u, 0u), cv = bv;
    if (j < qc) {
      bv = __ldg(reinterpret_cast<const uint4*>(Bm + bb * s_bb + (t0 + j) * s_bs + e));
      cv = __ldg(reinterpret_cast<const uint4*>(Cm + bb * s_cb + (t0 + j) * s_cs + e));
    }
    *reinterpret_cast<uint4*>(Bs + j * BN + e) = bv;
    *reinterpret_cast<uint4*>(Cs + j * BN + e) = cv;
  }
  __syncthreads();
  chunk_cumsum(dts, a, cum, qc, tot);
  const float last = cum[qc - 1];
  for (int j = tid; j < q16; j += kThreads) {
    ecum[j] = j < qc ? expf(cum[j]) : 0.f;
    eend[j] = j < qc ? expf(last - cum[j]) : 0.f;
    dend[j] = j < qc ? eend[j] * dts[j] : 0.f;
  }
  __syncthreads();

  const int n_mt = q16 / 16;
  // rows i: a_i and the head's dC
  for (int k = 0; k * kWarps < n_mt; ++k) {
    const int mt = k * kWarps + (k % 2 == 0 ? warp : kWarps - 1 - warp);
    if (mt >= n_mt) continue;
    const int i0 = mt * 16, ia = i0 + g, ib = i0 + g + 8, n_k = 2 * mt + 2;
    const float4* cbm = reinterpret_cast<const float4*>(cbz) + static_cast<long long>(mt) * n_ks * 32 + lane;
    const float4* gmm = reinterpret_cast<const float4*>(gz) + static_cast<long long>(mt) * n_ks * 32 + lane;
    float apart[2] = {0.f, 0.f};
    for (int pg = 0; pg < P; pg += kGroup) {
      float off[4][4], dg[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) off[nt][e] = dg[nt][e] = 0.f;
      }
      // carry-in C h^T: A = C rows (exact), B = h^T (split)
      for (int k0 = 0; k0 < N; k0 += 8) {
        const uint32_t af[4] = {tf(Cs[ia * BN + k0 + t]), tf(Cs[ib * BN + k0 + t]),
                                tf(Cs[ia * BN + k0 + t + 4]), tf(Cs[ib * BN + k0 + t + 4])};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (pg + nt * 8 >= P) break;
          const float* hr = hst + static_cast<long long>(pg + nt * 8 + g) * N + k0;
          mma_split_b(off[nt], af, __ldg(hr + t), __ldg(hr + t + 4));
        }
      }
      // intra-chunk W x: A = W (split), B = x (exact)
      for (int kk = 0; kk < n_k; ++kk) {
        const float4 cv = __ldg(cbm + kk * 32);
        const int ja = kk * 8 + t, jb = ja + 4;
        const float w[4] = {
            ja <= ia && ia < qc ? cv.x * expf(cum[ia] - cum[ja]) * dts[ja] : 0.f,
            ja <= ib && ib < qc ? cv.y * expf(cum[ib] - cum[ja]) * dts[ja] : 0.f,
            jb <= ia && ia < qc ? cv.z * expf(cum[ia] - cum[jb]) * dts[jb] : 0.f,
            jb <= ib && ib < qc ? cv.w * expf(cum[ib] - cum[jb]) * dts[jb] : 0.f};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (pg + nt * 8 >= P) break;
          const int p = pg + nt * 8 + g;
          mma_split_a(dg[nt], w, tf(Xs[ja * XP + p]), tf(Xs[jb * XP + p]));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (pg + nt * 8 >= P) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? ia : ib, p = pg + nt * 8 + 2 * t + (e & 1);
          apart[e >> 1] += __bfloat162float(Ys[i * XP + p]) * (off[nt][e] * ecum[i] + dg[nt][e]);
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      apart[hf] += __shfl_xor_sync(0xffffffffu, apart[hf], 1);
      apart[hf] += __shfl_xor_sync(0xffffffffu, apart[hf], 2);
    }
    if (t == 0) {
      if (ia < qc) ra[ia] = apart[0];
      if (ib < qc) ra[ib] = apart[1];
    }
    // the head's dC: exp(cum_i) dy_i h + sum_j dS_ij B_j
    for (int ng = 0; ng < N; ng += kGroup) {
      float dco[4][4], dcd[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dco[nt][e] = dcd[nt][e] = 0.f;
      }
      // A = dy rows (exact), B = h (split)
      for (int k0 = 0; k0 < P; k0 += 8) {
        const uint32_t af[4] = {tf(Ys[ia * XP + k0 + t]), tf(Ys[ib * XP + k0 + t]),
                                tf(Ys[ia * XP + k0 + t + 4]), tf(Ys[ib * XP + k0 + t + 4])};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (ng + nt * 8 >= N) break;
          const int n = ng + nt * 8 + g;
          mma_split_b(dco[nt], af, __ldg(hst + static_cast<long long>(k0 + t) * N + n),
                      __ldg(hst + static_cast<long long>(k0 + t + 4) * N + n));
        }
      }
      // A = dS (split), B = B rows (exact)
      for (int kk = 0; kk < n_k; ++kk) {
        const float4 gv = __ldg(gmm + kk * 32);
        const int ja = kk * 8 + t, jb = ja + 4;
        const float ds[4] = {
            ja <= ia && ia < qc ? gv.x * expf(cum[ia] - cum[ja]) * dts[ja] : 0.f,
            ja <= ib && ib < qc ? gv.y * expf(cum[ib] - cum[ja]) * dts[ja] : 0.f,
            jb <= ia && ia < qc ? gv.z * expf(cum[ia] - cum[jb]) * dts[jb] : 0.f,
            jb <= ib && ib < qc ? gv.w * expf(cum[ib] - cum[jb]) * dts[jb] : 0.f};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (ng + nt * 8 >= N) break;
          const int n = ng + nt * 8 + g;
          mma_split_a(dcd[nt], ds, tf(Bs[ja * BN + n]), tf(Bs[jb * BN + n]));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (ng + nt * 8 >= N) break;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = hf ? ib : ia;
          if (i >= qc) continue;
          const float e = ecum[i];
          *reinterpret_cast<float2*>(
              dCp + ((static_cast<long long>(bb) * H + hh) * S + t0 + i) * N + ng + nt * 8 + 2 * t) =
              make_float2(dco[nt][2 * hf] * e + dcd[nt][2 * hf],
                          dco[nt][2 * hf + 1] * e + dcd[nt][2 * hf + 1]);
        }
      }
    }
  }

  // columns j: dx, u_j, s_j and the head's dB; the k-steps run over i >= j0
  for (int k = 0; k * kWarps < n_mt; ++k) {
    const int mt = k * kWarps + (k % 2 == 0 ? warp : kWarps - 1 - warp);
    if (mt >= n_mt) continue;
    const int j0 = mt * 16, ja = j0 + g, jb = j0 + g + 8;
    float upart[2] = {0.f, 0.f}, spart[2] = {0.f, 0.f};
    for (int pg = 0; pg < P; pg += kGroup) {
      float U[4][4], T[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) U[nt][e] = T[nt][e] = 0.f;
      }
      // U = V^T dy: A = V^T (split; (row j, column i) = V_ij), B = dy rows (exact)
      for (int k0 = j0; k0 < q16; k0 += 8) {
        const int i_a = k0 + t, i_b = i_a + 4;
        const float v[4] = {
            ja <= i_a && i_a < qc ? __ldg(cbz + cb_index(i_a, ja, Q16)) * expf(cum[i_a] - cum[ja]) : 0.f,
            jb <= i_a && i_a < qc ? __ldg(cbz + cb_index(i_a, jb, Q16)) * expf(cum[i_a] - cum[jb]) : 0.f,
            ja <= i_b && i_b < qc ? __ldg(cbz + cb_index(i_b, ja, Q16)) * expf(cum[i_b] - cum[ja]) : 0.f,
            jb <= i_b && i_b < qc ? __ldg(cbz + cb_index(i_b, jb, Q16)) * expf(cum[i_b] - cum[jb]) : 0.f};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (pg + nt * 8 >= P) break;
          const int p = pg + nt * 8 + g;
          mma_split_a(U[nt], v, tf(Ys[i_a * XP + p]), tf(Ys[i_b * XP + p]));
        }
      }
      // T = B dh^T: A = B rows (exact), B = dh^T (split)
      for (int k0 = 0; k0 < N; k0 += 8) {
        const uint32_t af[4] = {tf(Bs[ja * BN + k0 + t]), tf(Bs[jb * BN + k0 + t]),
                                tf(Bs[ja * BN + k0 + t + 4]), tf(Bs[jb * BN + k0 + t + 4])};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (pg + nt * 8 >= P) break;
          const float* dr = dhst + static_cast<long long>(pg + nt * 8 + g) * N + k0;
          mma_split_b(T[nt], af, __ldg(dr + t), __ldg(dr + t + 4));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (pg + nt * 8 >= P) break;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int j = hf ? jb : ja, p = pg + nt * 8 + 2 * t;
          const float u0 = U[nt][2 * hf], u1 = U[nt][2 * hf + 1];
          const float s0 = T[nt][2 * hf], s1 = T[nt][2 * hf + 1];
          const float x0 = __bfloat162float(Xs[j * XP + p]), x1 = __bfloat162float(Xs[j * XP + p + 1]);
          upart[hf] += x0 * u0 + x1 * u1;
          spart[hf] += x0 * s0 + x1 * s1;
          if (j < qc) {
            *reinterpret_cast<uint32_t*>(
                dx + ((static_cast<long long>(bb) * S + t0 + j) * H + hh) * P + p) =
                mma::pack_bf16(dts[j] * u0 + dend[j] * s0, dts[j] * u1 + dend[j] * s1);
          }
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      upart[hf] += __shfl_xor_sync(0xffffffffu, upart[hf], 1);
      upart[hf] += __shfl_xor_sync(0xffffffffu, upart[hf], 2);
      spart[hf] += __shfl_xor_sync(0xffffffffu, spart[hf], 1);
      spart[hf] += __shfl_xor_sync(0xffffffffu, spart[hf], 2);
    }
    if (t == 0) {
      if (ja < qc) { ru[ja] = upart[0]; rs[ja] = spart[0]; }
      if (jb < qc) { ru[jb] = upart[1]; rs[jb] = spart[1]; }
    }
    // the head's dB: sum_i dS_ij C_i + d_end_j x_j dh
    for (int ng = 0; ng < N; ng += kGroup) {
      float dbd[4][4], dbs[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dbd[nt][e] = dbs[nt][e] = 0.f;
      }
      // A = dS^T (split), B = C rows (exact)
      for (int k0 = j0; k0 < q16; k0 += 8) {
        const int i_a = k0 + t, i_b = i_a + 4;
        const float ds[4] = {
            ja <= i_a && i_a < qc ? __ldg(gz + cb_index(i_a, ja, Q16)) * expf(cum[i_a] - cum[ja]) * dts[ja] : 0.f,
            jb <= i_a && i_a < qc ? __ldg(gz + cb_index(i_a, jb, Q16)) * expf(cum[i_a] - cum[jb]) * dts[jb] : 0.f,
            ja <= i_b && i_b < qc ? __ldg(gz + cb_index(i_b, ja, Q16)) * expf(cum[i_b] - cum[ja]) * dts[ja] : 0.f,
            jb <= i_b && i_b < qc ? __ldg(gz + cb_index(i_b, jb, Q16)) * expf(cum[i_b] - cum[jb]) * dts[jb] : 0.f};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (ng + nt * 8 >= N) break;
          const int n = ng + nt * 8 + g;
          mma_split_a(dbd[nt], ds, tf(Cs[i_a * BN + n]), tf(Cs[i_b * BN + n]));
        }
      }
      // A = x rows (exact), B = dh (split)
      for (int k0 = 0; k0 < P; k0 += 8) {
        const uint32_t af[4] = {tf(Xs[ja * XP + k0 + t]), tf(Xs[jb * XP + k0 + t]),
                                tf(Xs[ja * XP + k0 + t + 4]), tf(Xs[jb * XP + k0 + t + 4])};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (ng + nt * 8 >= N) break;
          const int n = ng + nt * 8 + g;
          mma_split_b(dbs[nt], af, __ldg(dhst + static_cast<long long>(k0 + t) * N + n),
                      __ldg(dhst + static_cast<long long>(k0 + t + 4) * N + n));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (ng + nt * 8 >= N) break;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int j = hf ? jb : ja;
          if (j >= qc) continue;
          const float e = dend[j];
          *reinterpret_cast<float2*>(
              dBp + ((static_cast<long long>(bb) * H + hh) * S + t0 + j) * N + ng + nt * 8 + 2 * t) =
              make_float2(dbd[nt][2 * hf] + e * dbs[nt][2 * hf],
                          dbd[nt][2 * hf + 1] + e * dbs[nt][2 * hf + 1]);
        }
      }
    }
  }
  __syncthreads();  // ra, ru and rs are complete

  // rows t: dcum, its reverse running sum, ddt and this block's part of dA
  float v = 0.f;
  for (int j = tid; j < qc; j += kThreads) v += dend[j] * rs[j];
  const float send = block_sum(v, red);
  float w = 0.f;
  for (int idx = tid; idx < P * N; idx += kThreads) w += __ldg(dhst + idx) * __ldg(hst + idx);
  const float dhh = block_sum(w, red);
  for (int j = tid; j < qc; j += kThreads) {
    float dc = ra[j] - dts[j] * ru[j] - dend[j] * rs[j];
    if (j == qc - 1) dc += send + ecum[j] * dhh;
    rev[qc - 1 - j] = dc;
  }
  __syncthreads();
  chunk_cumsum(rev, 1.f, dda, qc, tot);  // dda[r]: the sum of dcum over t >= qc - 1 - r
  float part = 0.f;
  for (int j = tid; j < qc; j += kThreads) {
    const float d = dda[qc - 1 - j];
    ddt[(static_cast<long long>(bb) * S + t0 + j) * H + hh] = ru[j] + eend[j] * rs[j] + a * d;
    part += d * dts[j];
  }
  part = block_sum(part, red);
  if (tid == 0) dAp[zc * H + hh] = part;
}

// (c): dB and dC (B, S, N) bf16, the heads' f32 partials (B, H, S, N)
// summed in head order; then H more threads, dA (H,), the (b, chunk) parts
// (B, n_chunks, H) summed in that order.
__global__ void __launch_bounds__(256)
ssd_bwd_reduce_kernel(const float* __restrict__ dBp, const float* __restrict__ dCp,
                      const float* __restrict__ dAp, __nv_bfloat16* __restrict__ dB,
                      __nv_bfloat16* __restrict__ dC, float* __restrict__ dA, int Bsz, int S,
                      int H, int N, int n_chunks) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long per_b = static_cast<long long>(S) * N, total = Bsz * per_b;
  if (idx < total) {
    const long long b = idx / per_b, r = idx % per_b;
    const float* pb = dBp + b * H * per_b + r;
    const float* pc = dCp + b * H * per_b + r;
    float sb = pb[0], sc = pc[0];
    for (int h = 1; h < H; ++h) {
      sb += pb[h * per_b];
      sc += pc[h * per_b];
    }
    dB[idx] = __float2bfloat16(sb);
    dC[idx] = __float2bfloat16(sc);
  } else if (idx < total + H) {
    const int h = static_cast<int>(idx - total);
    float s = dAp[h];
    for (int k = 1; k < Bsz * n_chunks; ++k) s += dAp[static_cast<long long>(k) * H + h];
    dA[h] = s;
  }
}

// raise a kernel's dynamic shared-memory limit once per device and larger
// size (a host-side attribute; a call captured into a CUDA graph then sets
// none)
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t (&allowed)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || bytes > allowed[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    if (dev < 64) allowed[dev] = bytes;
  }
  return cudaSuccess;
}

}  // namespace

// Shared memory one scan block needs at these sizes (the wrapper refuses
// shapes above the card's 227 KB per block).
extern "C" long long ssd_scan_smem_bytes(int q, int n) {
  return static_cast<long long>(smem_layout(q, n).total);
}

// Plain C entry point (loaded with ctypes): the C.B^T kernel into cb, an f32
// scratch of B * n_chunks * Q16 * Q16 values (Q16: Q rounded up to 16), then
// the scan. states (B, n_chunks, H, P, N) f32 takes each chunk's start state
// (training; null for a serve, whose y and h_out keep their bits). Returns
// the CUDA error code of the launches (0 on success).
extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                             const void* Cm, const void* h0, void* cb, void* y, void* h_out,
                             void* states, int b, int s, int h, int p, int n, int chunk,
                             long long s_xb,
                             long long s_xs, long long s_bb, long long s_bs, long long s_cb,
                             long long s_cs, void* stream) {
  if (b < 1 || s < 1 || h < 1 || p < kSlice || p % kSlice || n < 16 || n % 16 || n > kMaxN ||
      chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int q = chunk < s ? chunk : s;
  const int n_chunks = (s + q - 1) / q;
  const int cb_tiles = (q + kCbTile - 1) / kCbTile;
  ssd_gram_kernel<<<dim3(cb_tiles, cb_tiles, b * n_chunks), 128, 0, st>>>(
      static_cast<const __nv_bfloat16*>(Cm), static_cast<const __nv_bfloat16*>(Bm),
      static_cast<float*>(cb), s, n, q, n_chunks, 1, s_cb, s_cs, s_bb, s_bs, 0, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = smem_layout(q, n).total;
  static size_t smem_allowed[64] = {};
  err = allow_smem(ssd_scan_kernel, bytes, smem_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<<<dim3(p / kSlice, h, b), kThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), static_cast<const float*>(h0),
      static_cast<const float*>(cb), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(h_out), static_cast<float*>(states), s, h, p, n, q, s_xb, s_xs, s_bb,
      s_bs, s_cb, s_cs);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory one backward chunk block needs (the wrapper refuses shapes
// above the card's 227 KB per block; the reverse pass needs the forward's).
extern "C" long long ssd_scan_bwd_smem_bytes(int q, int n, int p) {
  return static_cast<long long>(bwd_layout(q, n, p).total);
}

// Plain C entry point of the backward (loaded with ctypes): C.B^T into cb (as
// the forward), dy.x^T into gm (B * n_chunks * H * Q16 * Q16 f32), the
// reverse pass (dh_end (B, n_chunks, H, P, N) f32, dh0), the chunk pass
// (dx, ddt, the partials dBp and dCp (B, H, S, N) f32 and dAp (B, n_chunks,
// H) f32), then the reduction into dB, dC (B, S, N) bf16 and dA (H,) f32.
// x, Bm and Cm as the forward takes them; dy (B, S, H, P) bf16 and the
// outputs contiguous; states (B, n_chunks, H, P, N) f32 from the forward;
// dh_out (B, H, P, N) f32 or null (zeros). Returns the CUDA error code of
// the launches (0 on success).
extern "C" int ssd_scan_bwd_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                                 const void* Cm, const void* dy, const void* states,
                                 const void* dh_out, void* cb, void* gm, void* dh_end, void* dBp,
                                 void* dCp, void* dAp, void* dx, void* ddt, void* dA, void* dB,
                                 void* dC, void* dh0, int b, int s, int h, int p, int n,
                                 int chunk, long long s_xb, long long s_xs, long long s_bb,
                                 long long s_bs, long long s_cb, long long s_cs, void* stream) {
  if (b < 1 || s < 1 || h < 1 || p < kSlice || p % kSlice || n < 16 || n % 16 || n > kMaxN ||
      chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int q = chunk < s ? chunk : s;
  const int n_chunks = (s + q - 1) / q;
  const int tiles = (q + kCbTile - 1) / kCbTile;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* bm = static_cast<const __nv_bfloat16*>(Bm);
  const __nv_bfloat16* cm = static_cast<const __nv_bfloat16*>(Cm);
  const __nv_bfloat16* dyb = static_cast<const __nv_bfloat16*>(dy);
  ssd_gram_kernel<<<dim3(tiles, tiles, b * n_chunks), 128, 0, st>>>(
      cm, bm, static_cast<float*>(cb), s, n, q, n_chunks, 1, s_cb, s_cs, s_bb, s_bs, 0, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_gram_kernel<<<dim3(tiles, tiles, b * n_chunks * h), 128, 0, st>>>(
      dyb, xb, static_cast<float*>(gm), s, p, q, n_chunks, h, static_cast<long long>(s) * h * p,
      static_cast<long long>(h) * p, s_xb, s_xs, p, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t dstate_bytes = smem_layout(q, n).total;
  static size_t dstate_allowed[64] = {};
  err = allow_smem(ssd_bwd_dstate_kernel, dstate_bytes, dstate_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dstate_kernel<<<dim3(p / kSlice, h, b), kThreads, dstate_bytes, st>>>(
      static_cast<const float*>(dt), static_cast<const float*>(A), cm, dyb,
      static_cast<const float*>(dh_out), static_cast<float*>(dh_end), static_cast<float*>(dh0), s,
      h, p, n, q, s_cb, s_cs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t chunk_bytes = bwd_layout(q, n, p).total;
  static size_t chunk_allowed[64] = {};
  err = allow_smem(ssd_bwd_chunk_kernel, chunk_bytes, chunk_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_kernel<<<dim3(h, n_chunks, b), kThreads, chunk_bytes, st>>>(
      xb, static_cast<const float*>(dt), static_cast<const float*>(A), bm, cm, dyb,
      static_cast<const float*>(states), static_cast<const float*>(dh_end),
      static_cast<const float*>(cb), static_cast<const float*>(gm),
      static_cast<__nv_bfloat16*>(dx), static_cast<float*>(ddt), static_cast<float*>(dBp),
      static_cast<float*>(dCp), static_cast<float*>(dAp), s, h, p, n, q, s_xb, s_xs, s_bb, s_bs,
      s_cb, s_cs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long total = static_cast<long long>(b) * s * n + h;
  ssd_bwd_reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(dBp), static_cast<const float*>(dCp),
      static_cast<const float*>(dAp), static_cast<__nv_bfloat16*>(dB),
      static_cast<__nv_bfloat16*>(dC), static_cast<float*>(dA), b, s, h, n, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
