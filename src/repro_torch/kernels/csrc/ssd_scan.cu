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
// head_a * h and head_b * h: the forward's CB = C B^T (K = N, one head).
// Warp w computes 16 rows x 64 columns from fragments loaded straight from
// device memory (each A element once per block; B's rows are shared by the
// 4 warps through L1).
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
//       first in shared memory, dh_end[c] = dh for every chunk but the last
//       (whose end cotangent is dh_out itself), then
//         dh = exp(cum_last) dh + sum_i (exp(cum_i) dy_i)^T C_i,
//       and dh0 is dh after the first chunk;
//   (b) ssd_bwd_chunk_kernel, one block per (h, chunk, b), on the chunk's
//       start state h (the forward's states) and its end cotangent dh. With
//       V_ij = (C_i . B_j) exp(cum_i - cum_j) and dS_ij = (dy_i . x_j)
//       exp(cum_i - cum_j) dt_j on the causal triangle (the exp evaluated
//       there only, so it cannot overflow):
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
//
// The chunk pass. Its x, dy, B and C rows arrive in shared memory as bf16
// tiles by 16-byte cp.async, and the chunk's start state h and end
// cotangent dh as f32 tiles by cp.async tracked by an mbarrier, so a warp
// starts its first products (which need no state) before they land and
// waits on the mbarrier only before its first product with them. Warps 0-3
// take the row pass of the 16-row tiles, warps 4-7 the column pass, in the
// forward's snake order (at 8 tiles a warp's two row tiles, m + 1 and 8 - m
// blocks of 16 columns, add up to the same). Every product runs on the
// tensor cores:
//   - the Gram blocks C B^T and dy x^T (row pass) and B C^T and x dy^T
//     (column pass: the transposes, formed with the operands swapped), 16 x
//     16 at a time from the bf16 tiles by ldmatrix on bf16 mma.sync m16n8k16
//     with f32 sums (exact products, as the forward's C.B^T); no Gram
//     scratch leaves the block;
//   - each pass evaluates a block's decay exp(cum_i - cum_j) once, on the
//     triangle only, for both of its Gram blocks and every column group;
//     the weighted block enters the next product as the A operand of m16n8k8
//     tf32 straight from the accumulator: the accumulator holds columns
//     (2t, 2t + 1) where the A fragment wants (t, t + 4), so the k index is
//     permuted and the B operand (x, dy, B or C rows, exact in tf32, by
//     ldmatrix.trans) is read in the same order; the weighted block is f32
//     and is split into two tf32 parts (2xTF32);
//   - C h^T, dy h, B dh^T and x dh: the bf16 rows exact in tf32, the f32
//     state read from shared memory and split into two tf32 parts.
// The elementwise steps (cum, the exps, the weights, the row sums a, u, s,
// dcum, ddt) are f32 on the CUDA cores. The kernel is instantiated for P 64
// with N 128 and N 64 (mamba2's and zamba2's widths: constant strides and
// n-tile counts; at N 64 two blocks share an SM) and for any other P, N.
// Where the two f32 tiles do not fit beside the bf16 tiles (chunks above
// ~176 rows at P 64, N 128), the block stages h and dh in strips instead (a
// P group's state rows by a k-slab of N, or a k-slab of P by 32 state
// columns), one strip at a time with the warps in step; the products and
// their orders are the same.
//
// Bound on an H100 (chip_smoke.py's _ssd_bwd_bound): at mamba2-370m's
// training rows (B 8, S 128, H 32, P 64, N 128, one chunk) the inputs read
// once and the outputs written once are 39.1 MB (the f32 chunk states,
// dh_out and dh0 most of it), 11.7 us at 3.35 TB/s, more than the products
// (9.2 us with the tf32 ones at the tf32 peak). What the design still moves
// beyond that: the per-head f32 partials of dB and dC (2 x B x H x S x N
// floats, written by (b) and read by (c)) and, with several chunks, the
// tiles that (a) reads too. What holds the chunk pass back is mma.sync at
// one or two blocks an SM: the products run at a fraction of the tensor
// cores' rate (wgmma is the next step).

__device__ __forceinline__ uint32_t tf(__nv_bfloat16 v) { return mma::bf16_as_tf32(v); }

// the lower / upper bf16 of a register, widened to f32 (exact in tf32)
__device__ __forceinline__ uint32_t lo_tf(uint32_t r) { return r << 16; }
__device__ __forceinline__ uint32_t hi_tf(uint32_t r) { return r & 0xffff0000u; }

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
    if (c + 1 < n_chunks) {  // the last chunk's end cotangent is dh_out
      const long long st =
          (((static_cast<long long>(bb) * (n_chunks - 1) + c) * H + hh) * P + p0) * N;
      for (int idx = tid; idx < kSlice * N; idx += kThreads) {
        dh_end[st + idx] = Hs[(idx / N) * HN + idx % N];
      }
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

constexpr size_t kSmemLimit = 232448;  // bytes of shared memory a block may use on an H100
constexpr int kGP = 64;   // P columns of one output group: 8 n-tiles, 32 accumulators
constexpr int kGN = 128;  // N columns of one output group: 16 n-tiles, 64 accumulators

struct BwdSmem {
  size_t xs, ys, bs, cs, cum, dts, ecum, dend, ra, ru, rs, tot, red, bar, total;  // then the state
};

// The chunk pass's shared memory before the f32 state: the bf16 tiles (rows
// padded by 8 values, so the 8 rows an ldmatrix reads fall in distinct
// banks) and the per-row f32 values.
__host__ __device__ inline BwdSmem bwd_layout(int q, int n, int p) {
  const int q16 = round16(q);
  BwdSmem s;
  size_t o = 0;
  s.xs = o;   o = align16(o + sizeof(__nv_bfloat16) * q16 * (p + 8));
  s.ys = o;   o = align16(o + sizeof(__nv_bfloat16) * q16 * (p + 8));
  s.bs = o;   o = align16(o + sizeof(__nv_bfloat16) * q16 * (n + 8));
  s.cs = o;   o = align16(o + sizeof(__nv_bfloat16) * q16 * (n + 8));
  size_t* rows[] = {&s.cum, &s.dts, &s.ecum, &s.dend, &s.ra, &s.ru, &s.rs};
  for (size_t* r : rows) {
    *r = o;
    o = align16(o + sizeof(float) * q16);
  }
  s.tot = o;  o = align16(o + sizeof(float) * kWarps);
  s.red = o;  o = align16(o + sizeof(float) * kWarps);
  s.bar = o;  o = align16(o + sizeof(uint64_t));
  s.total = o;
  return s;
}

// How the chunk pass holds h and dh, and its output groups of gp columns
// of P (those of N are kGN wide). Resident: both whole ([P][N+4] f32
// each), loaded once. Else
// one strip at a time, the warps in step: a P group's gp state rows by a
// k-slab of kn state columns for C h^T and B dh^T, a k-slab of kp state
// rows by 32 state columns for dy h and x dh (the P group narrowed where
// even 8 columns of k would not fit).
struct BwdPlan {
  int resident, gp, kn, kp;
  size_t smem;  // bytes of shared memory per block
};

inline BwdPlan bwd_plan(int q, int n, int p) {
  const size_t base = bwd_layout(q, n, p).total;
  const size_t whole = 2 * sizeof(float) * p * (n + 4);
  BwdPlan pl;
  pl.gp = p < kGP ? p : kGP;
  if (base + whole <= kSmemLimit) {
    pl.resident = 1;
    pl.kn = n;
    pl.kp = p;
    pl.smem = base + whole;
    return pl;
  }
  pl.resident = 0;
  const long long left = static_cast<long long>(kSmemLimit) - static_cast<long long>(base);
  const long long f4 = static_cast<long long>(sizeof(float));
  while (pl.gp > 16 && pl.gp * 12 * f4 > left) pl.gp = pl.gp > 32 ? 32 : 16;
  const long long kn = left / (f4 * pl.gp) - 4, kp = left / (f4 * 36);
  pl.kn = static_cast<int>(kn < 8 ? 8 : (kn > n ? n : kn & ~7LL));
  pl.kp = static_cast<int>(kp < 8 ? 8 : (kp > p ? p : kp & ~7LL));
  const long long a = pl.gp * (pl.kn + 4), b = pl.kp * 36;
  pl.smem = base + sizeof(float) * static_cast<size_t>(a > b ? a : b);  // over the limit: refused
  return pl;
}

// x = hi + lo + O(2^-22 |x|), both parts tf32, each rounded to nearest with
// ties away from zero (cvt.rna.tf32.f32's rounding for finite x) by integer
// arithmetic on the bit pattern, which issues on the ALU pipe.
__device__ __forceinline__ void split2(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// acc[s] (s = 0, 1: columns c0 + 8s ..) = the 16 x 16 Gram block
// A[r0 ..][0, K) . Bt[c0 ..][0, K)^T of two bf16 tiles (row strides sa,
// sb); the k16 steps alternate between two sets of sums, added at the end.
__device__ __forceinline__ void gram16(float (&acc)[2][4], const __nv_bfloat16* A, int sa, int r0,
                                       const __nv_bfloat16* Bt, int sb, int c0, int K, int lane) {
  float odd[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[s][e] = odd[s][e] = 0.f;
  }
  const __nv_bfloat16* ap = A + (r0 + (lane & 15)) * sa + (lane >> 4) * 8;
  const __nv_bfloat16* bp =
      Bt + (c0 + (lane & 7) + ((lane >> 4) << 3)) * sb + ((lane >> 3) & 1) * 8;
  for (int k0 = 0; k0 < K; k0 += 32) {
    uint32_t af[4], bf[4];
    mma::ldmatrix_x4(af, ap + k0);
    mma::ldmatrix_x4(bf, bp + k0);
    mma::bf16_16816(acc[0], af, bf[0], bf[1]);
    mma::bf16_16816(acc[1], af, bf[2], bf[3]);
    if (k0 + 16 < K) {
      mma::ldmatrix_x4(af, ap + k0 + 16);
      mma::ldmatrix_x4(bf, bp + k0 + 16);
      mma::bf16_16816(odd[0], af, bf[0], bf[1]);
      mma::bf16_16816(odd[1], af, bf[2], bf[3]);
    }
  }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[s][e] += odd[s][e];
  }
}

// The decay of a 16 x 16 block on the causal triangle, in accumulator
// layout: e = exp(cum_i - cum_j) and ed = e dt_j where j <= i < qc, both 0
// off it (the exp is taken there only). The fragment's rows are i and its
// columns j, or (kRowsAreJ) the other way round. One evaluation serves both
// products of a pass.
template <bool kRowsAreJ>
__device__ __forceinline__ void decay(float (&e)[2][4], float (&ed)[2][4], int r0, int c0,
                                      const float* cum, const float* dts, int qc, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = r0 + g + 8 * (k >> 1), cc = c0 + 8 * s + 2 * t + (k & 1);
      const int i = kRowsAreJ ? cc : r, j = kRowsAreJ ? r : cc;
      const bool in = j <= i && i < qc;  // off the triangle: exp(0), then 0
      const float v = expf(in ? cum[i] - cum[j] : 0.f);
      e[s][k] = in ? v : 0.f;
      ed[s][k] = in ? v * dts[j] : 0.f;
    }
  }
}

// w *= f elementwise (a Gram block by its decay)
__device__ __forceinline__ void scale(float (&w)[2][4], const float (&f)[2][4]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[s][k] *= f[s][k];
  }
}

// d[nt] += w . T[c0 .. c0 + 16)[nb + 8 nt ..] for nt < n_nt (even): w the
// 16 x 16 weighted block in accumulator layout, split into two tf32 parts,
// entering as the A operand with its columns (2t, 2t + 1) as k = (t, t + 4);
// T's rows in the same order from ldmatrix.trans of the bf16 tile T (exact).
template <int NT>
__device__ __forceinline__ void mma_weighted(float (&d)[NT][4], const float (&w)[2][4],
                                             const __nv_bfloat16* T, int ts, int c0, int nb,
                                             int n_nt, int lane) {
  uint32_t hi[2][4], lo[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    split2(w[s][0], hi[s][0], lo[s][0]);
    split2(w[s][2], hi[s][1], lo[s][1]);
    split2(w[s][1], hi[s][2], lo[s][2]);
    split2(w[s][3], hi[s][3], lo[s][3]);
  }
  const __nv_bfloat16* tp = T + (c0 + (lane & 15)) * ts + nb + (lane >> 4) * 8;
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    if (2 * np >= n_nt) break;
    uint32_t r[4];
    mma::ldmatrix_x4_trans(r, tp + 16 * np);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint32_t b0 = lo_tf(r[2 * u + s]), b1 = hi_tf(r[2 * u + s]);
        mma::tf32_1688(d[2 * np + u], hi[s], b0, b1);
        mma::tf32_1688(d[2 * np + u], lo[s], b0, b1);
      }
    }
  }
}

// d[nt] += A[r0 ..][k] . F[p0 + 8 nt + g][k] over k in [k_lo, k_hi), nt <
// n_nt: A's bf16 rows exact in tf32, F (f32, element [p][k] at
// f[(p - fp) * fs + k - fk]) split into two tf32 parts; the hi products of
// all n-tiles, then the lo ones. C h^T and B dh^T.
__device__ __forceinline__ void rowdot(float (&d)[8][4], const __nv_bfloat16* A, int sa, int r0,
                                       const float* f, int fs, int fp, int fk, int p0, int n_nt,
                                       int k_lo, int k_hi, int lane) {
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* a0 = A + (r0 + g) * sa;
  const __nv_bfloat16* a1 = a0 + 8 * sa;
  const float* f0 = f + (p0 + g - fp) * fs + t - fk;
  for (int k0 = k_lo; k0 < k_hi; k0 += 8) {
    const uint32_t af[4] = {tf(a0[k0 + t]), tf(a1[k0 + t]), tf(a0[k0 + t + 4]),
                            tf(a1[k0 + t + 4])};
    uint32_t hi[8][2], lo[8][2];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt >= n_nt) break;
      const float* fr = f0 + 8 * nt * fs + k0;
      split2(fr[0], hi[nt][0], lo[nt][0]);
      split2(fr[4], hi[nt][1], lo[nt][1]);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt >= n_nt) break;
      mma::tf32_1688(d[nt], af, hi[nt][0], hi[nt][1]);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt >= n_nt) break;
      mma::tf32_1688(d[nt], af, lo[nt][0], lo[nt][1]);
    }
  }
}

// d[nt] += A[r0 ..][k] . F[k][n0 + 8 nt + g] over k in [k_lo, k_hi), nt <
// n_nt: A's fragments by ldmatrix (k = 2t, 2t + 1 as k = t, t + 4), F's
// rows in the same order, split into two tf32 parts; the hi products of all
// n-tiles, then the lo ones. dy h and x dh.
template <int NT>
__device__ __forceinline__ void coldot(float (&d)[NT][4], const __nv_bfloat16* A, int sa, int r0,
                                       const float* f, int fs, int fp, int fk, int n0, int n_nt,
                                       int k_lo, int k_hi, int lane) {
  const int g = lane / 4, t = lane % 4;
  const __nv_bfloat16* ap = A + (r0 + (lane & 15)) * sa;
  const float* f0 = f + (2 * t - fp) * fs + n0 + g - fk;
  for (int k0 = k_lo; k0 < k_hi; k0 += 8) {
    uint32_t r[2];
    mma::ldmatrix_x2(r, ap + k0);
    const uint32_t af[4] = {lo_tf(r[0]), lo_tf(r[1]), hi_tf(r[0]), hi_tf(r[1])};
    const float* fr = f0 + k0 * fs;
    uint32_t hi[NT][2], lo[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt >= n_nt) break;
      split2(fr[8 * nt], hi[nt][0], lo[nt][0]);
      split2(fr[fs + 8 * nt], hi[nt][1], lo[nt][1]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt >= n_nt) break;
      mma::tf32_1688(d[nt], af, hi[nt][0], hi[nt][1]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt >= n_nt) break;
      mma::tf32_1688(d[nt], af, lo[nt][0], lo[nt][1]);
    }
  }
}

// Copy F[p_lo, p_lo + rows)[n_lo, n_lo + cols) of a (P, N) f32 state (zeros
// where F is null; dummy is any readable address) into dst, row stride ds,
// between two block barriers (the strip's last readers are done before it
// is overwritten; every warp sees it after).
__device__ void stage_strip(float* dst, int ds, const float* F, const float* dummy, int N,
                            int p_lo, int rows, int n_lo, int cols) {
  __syncthreads();
  const int cv = cols / 4;
  for (int idx = threadIdx.x; idx < rows * cv; idx += kThreads) {
    const int r = idx / cv, e = (idx % cv) * 4;
    mma::cp_async16(dst + r * ds + e,
                    F != nullptr ? F + static_cast<long long>(p_lo + r) * N + n_lo + e : dummy,
                    F != nullptr);
  }
  mma::cp_async_commit();
  mma::cp_async_wait<0>();
  __syncthreads();
}

// Where one product reads the state: element (p, n) at
// f[(p - fp) * fs + n - fk].
struct StateView {
  const float* f;
  int fs, fp, fk;
};

// The view of F's rows [p_lo, p_lo + rows) and columns [n_lo, n_lo + cols)
// for one product: the resident tile (row stride rs), or the strip staged
// into st.
__device__ __forceinline__ StateView state_view(bool resident, const float* tile, int rs,
                                                float* st, const float* F, const float* dummy,
                                                int N, int p_lo, int rows, int n_lo, int cols) {
  if (resident) return {tile, rs, 0, 0};
  stage_strip(st, cols + 4, F, dummy, N, p_lo, rows, n_lo, cols);
  return {st, cols + 4, p_lo, n_lo};
}

// (b): see above. One block per (h, chunk, b); plan: bwd_plan. Warps 0-3
// take the row pass of the 16-row tiles (a, dC), warps 4-7 the column pass
// (dx, u, s, dB), one tile each per round, in the forward's snake order (at
// 8 tiles each warp's two tiles add up to the same triangle work). kP, kN:
// P and N fixed at compile time (0: the arguments), so that the tiles'
// strides and the n-tile counts of the main shapes are constants. Resident,
// the two passes run unsynchronized, each warp waiting on the mbarrier for
// the state before its first product with it; with strips every warp walks
// both passes for the barriers. With one chunk
// (dh0 not null) the block also writes dh0, which (a) would have computed
// from the same tiles, and (a) is not launched.
template <int kP, int kN>
__global__ void __launch_bounds__(kThreads, kN == 64 ? 2 : 1)
ssd_bwd_chunk_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
                     const __nv_bfloat16* __restrict__ Cm, const __nv_bfloat16* __restrict__ dy,
                     const float* __restrict__ states, const float* __restrict__ dh_end,
                     const float* __restrict__ dh_out, __nv_bfloat16* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dBp, float* __restrict__ dCp,
                     float* __restrict__ dAp, float* __restrict__ dh0, int S, int H, int P_,
                     int N_, int Q, BwdPlan plan, long long s_xb, long long s_xs, long long s_bb,
                     long long s_bs, long long s_cb, long long s_cs) {
  const int P = kP > 0 ? kP : P_, N = kN > 0 ? kN : N_;
  const int GP = kP > 0 ? (kP < kGP ? kP : kGP) : plan.gp;  // output groups
  const int GN = N < kGN ? N : kGN;
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdSmem L = bwd_layout(Q, N, P);
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem + L.xs);  // [q16][P+8]
  __nv_bfloat16* Ys = reinterpret_cast<__nv_bfloat16*>(smem + L.ys);  // [q16][P+8] dy
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + L.bs);  // [q16][N+8]
  __nv_bfloat16* Cs = reinterpret_cast<__nv_bfloat16*>(smem + L.cs);  // [q16][N+8]
  float* cum = reinterpret_cast<float*>(smem + L.cum);
  float* dts = reinterpret_cast<float*>(smem + L.dts);
  float* ecum = reinterpret_cast<float*>(smem + L.ecum);  // exp(cum)
  float* dend = reinterpret_cast<float*>(smem + L.dend);  // exp(cum_last - cum) dt
  float* ra = reinterpret_cast<float*>(smem + L.ra);      // dy . Y
  float* ru = reinterpret_cast<float*>(smem + L.ru);      // x . U
  float* rs = reinterpret_cast<float*>(smem + L.rs);      // x . T
  float* tot = reinterpret_cast<float*>(smem + L.tot);
  float* red = reinterpret_cast<float*>(smem + L.red);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar);  // the state has arrived
  float* st = reinterpret_cast<float*>(smem + L.total);       // h and dh, or a strip
  const int XP = P + 8, BN = N + 8, HN = N + 4, PV = P / 8, NV = N / 8;
  const bool resident = plan.resident != 0;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int hh = blockIdx.x, c = blockIdx.y, bb = blockIdx.z, n_chunks = gridDim.y;
  const int t0 = c * Q, qc = min(Q, S - t0), q16 = round16(qc);
  const float a = A[hh];
  const long long zc = static_cast<long long>(bb) * n_chunks + c;
  const long long PN = static_cast<long long>(P) * N;
  const float* hg = states + (zc * H + hh) * PN;  // (P, N): the chunk's start state
  const float* dhg =                              // (P, N): its end cotangent, or null (zeros)
      c + 1 < n_chunks ? dh_end + ((static_cast<long long>(bb) * (n_chunks - 1) + c) * H + hh) * PN
      : dh_out != nullptr ? dh_out + (static_cast<long long>(bb) * H + hh) * PN
                          : nullptr;
  float* Hs = st;           // resident: [P][N+4]
  float* Ds = st + P * HN;  // resident: [P][N+4]

  if (tid == 0) mma::mbar_init(bar, kThreads);
  __syncthreads();
  for (int idx = tid; idx < q16 * PV; idx += kThreads) {  // x and dy rows, zero past qc
    const int j = idx / PV, e = (idx % PV) * 8;
    const bool live = j < qc;
    mma::cp_async16(Xs + j * XP + e,
                    live ? x + bb * s_xb + (t0 + j) * s_xs + static_cast<long long>(hh) * P + e : x,
                    live);
    mma::cp_async16(Ys + j * XP + e,
                    live ? dy + ((static_cast<long long>(bb) * S + t0 + j) * H + hh) * P + e : dy,
                    live);
  }
  for (int idx = tid; idx < q16 * NV; idx += kThreads) {  // B and C rows
    const int j = idx / NV, e = (idx % NV) * 8;
    const bool live = j < qc;
    mma::cp_async16(Bs + j * BN + e, live ? Bm + bb * s_bb + (t0 + j) * s_bs + e : Bm, live);
    mma::cp_async16(Cs + j * BN + e, live ? Cm + bb * s_cb + (t0 + j) * s_cs + e : Cm, live);
  }
  mma::cp_async_commit();
  if (resident) {  // the state and its cotangent, tracked by the mbarrier
    const int NQ = N / 4;
    for (int idx = tid; idx < P * NQ; idx += kThreads) {
      const int p = idx / NQ, e = (idx % NQ) * 4;
      mma::cp_async16(Hs + p * HN + e, hg + p * N + e, true);
      mma::cp_async16(Ds + p * HN + e, dhg != nullptr ? dhg + p * N + e : hg, dhg != nullptr);
    }
  }
  mma::cp_async_commit();
  mma::cp_async_arrive(bar);
  for (int j = tid; j < qc; j += kThreads) {
    dts[j] = dt[(static_cast<long long>(bb) * S + t0 + j) * H + hh];
  }
  mma::cp_async_wait<1>();
  __syncthreads();
  chunk_cumsum(dts, a, cum, qc, tot);
  const float last = cum[qc - 1];
  for (int j = tid; j < q16; j += kThreads) {
    ecum[j] = j < qc ? expf(cum[j]) : 0.f;
    dend[j] = j < qc ? expf(last - cum[j]) * dts[j] : 0.f;
  }
  __syncthreads();

  constexpr int kPass = kWarps / 2;  // warps per pass
  const bool row_pass = warp < kPass;
  const int n_mt = q16 / 16, n_rounds = (n_mt + kPass - 1) / kPass;
  // P and N in output groups of GP and GN columns, one of each per step
  const int n_steps = max((P + GP - 1) / GP, (N + GN - 1) / GN);
  for (int rd = 0; rd < n_rounds; ++rd) {
    const int wi = warp % kPass;
    const int mt = rd * kPass + (rd % 2 == 0 ? wi : kPass - 1 - wi);
    const int r0 = mt * 16, ia = r0 + g, ib = ia + 8;
    float w[2][4], e[2][4], ed[2][4];

    if (!resident || row_pass) {  // rows i: a_i and the head's dC
      const bool on = row_pass && mt < n_mt;  // warp-uniform
      float apart[2] = {0.f, 0.f};
      for (int it = 0; it < n_steps; ++it) {
        const int pg = it * GP, ng = it * GN;
        const int p_nt = pg < P ? min(GP, P - pg) / 8 : 0;
        const int n_nt = ng < N ? min(GN, N - ng) / 8 : 0;
        float dg[8][4], dcd[16][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) dg[nt][0] = dg[nt][1] = dg[nt][2] = dg[nt][3] = 0.f;
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) dcd[nt][0] = dcd[nt][1] = dcd[nt][2] = dcd[nt][3] = 0.f;
        if (on) {
          for (int c0 = 0; c0 <= r0; c0 += 16) {
            decay<false>(e, ed, r0, c0, cum, dts, qc, lane);
            if (p_nt > 0) {  // W = C B^T exp(cum_i - cum_j) dt_j
              gram16(w, Cs, BN, r0, Bs, BN, c0, N, lane);
              scale(w, ed);
              mma_weighted(dg, w, Xs, XP, c0, pg, p_nt, lane);
            }
            if (n_nt > 0) {  // dS = dy x^T exp(cum_i - cum_j) dt_j
              gram16(w, Ys, XP, r0, Xs, XP, c0, P, lane);
              scale(w, ed);
              mma_weighted(dcd, w, Bs, BN, c0, ng, n_nt, lane);
            }
          }
          if (resident) mma::mbar_wait(bar, 0);
        }
        // the head's dC = exp(cum_i) dy_i h + sum_j dS_ij B_j, 4 n-tiles at a time
#pragma unroll
        for (int qn = 0; qn < 4; ++qn) {
          if (4 * qn >= n_nt) break;
          const int n0 = ng + 32 * qn, m_nt = min(4, n_nt - 4 * qn);
          float dco[4][4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) dco[nt][0] = dco[nt][1] = dco[nt][2] = dco[nt][3] = 0.f;
          for (int k_lo = 0; k_lo < P; k_lo += plan.kp) {  // dy h
            const int k_hi = min(P, k_lo + plan.kp);
            const StateView v = state_view(resident, Hs, HN, st, hg, hg, N, k_lo, k_hi - k_lo,
                                           n0, 8 * m_nt);
            if (on) coldot(dco, Ys, XP, r0, v.f, v.fs, v.fp, v.fk, n0, m_nt, k_lo, k_hi, lane);
          }
          if (on) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              if (nt >= m_nt) break;
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const int i = hf ? ib : ia;
                if (i >= qc) continue;
                const float ei = ecum[i];
                *reinterpret_cast<float2*>(
                    dCp + ((static_cast<long long>(bb) * H + hh) * S + t0 + i) * N + n0 + 8 * nt +
                    2 * t) = make_float2(dco[nt][2 * hf] * ei + dcd[4 * qn + nt][2 * hf],
                                         dco[nt][2 * hf + 1] * ei + dcd[4 * qn + nt][2 * hf + 1]);
              }
            }
          }
        }
        // a_i += dy_i . (exp(cum_i) C_i h^T + (W x)_i) over the P group
        if (p_nt > 0) {
          float off[8][4];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) off[nt][0] = off[nt][1] = off[nt][2] = off[nt][3] = 0.f;
          for (int k_lo = 0; k_lo < N; k_lo += plan.kn) {  // C h^T
            const int k_hi = min(N, k_lo + plan.kn);
            const StateView v = state_view(resident, Hs, HN, st, hg, hg, N, pg, 8 * p_nt, k_lo,
                                           k_hi - k_lo);
            if (on) rowdot(off, Cs, BN, r0, v.f, v.fs, v.fp, v.fk, pg, p_nt, k_lo, k_hi, lane);
          }
          if (on) {
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              if (nt >= p_nt) break;
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const int i = k < 2 ? ia : ib, p = pg + 8 * nt + 2 * t + (k & 1);
                apart[k >> 1] +=
                    __bfloat162float(Ys[i * XP + p]) * (off[nt][k] * ecum[i] + dg[nt][k]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        apart[hf] += __shfl_xor_sync(0xffffffffu, apart[hf], 1);
        apart[hf] += __shfl_xor_sync(0xffffffffu, apart[hf], 2);
      }
      if (on && t == 0) {
        if (ia < qc) ra[ia] = apart[0];
        if (ib < qc) ra[ib] = apart[1];
      }
    }

    if (!resident || !row_pass) {  // columns j: dx, u_j, s_j and the head's dB
      const bool on = !row_pass && mt < n_mt;
      const int ja = ia, jb = ib;
      float upart[2] = {0.f, 0.f}, spart[2] = {0.f, 0.f};
      for (int it = 0; it < n_steps; ++it) {
        const int pg = it * GP, ng = it * GN;
        const int p_nt = pg < P ? min(GP, P - pg) / 8 : 0;
        const int n_nt = ng < N ? min(GN, N - ng) / 8 : 0;
        float U[8][4], dbd[16][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) U[nt][0] = U[nt][1] = U[nt][2] = U[nt][3] = 0.f;
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) dbd[nt][0] = dbd[nt][1] = dbd[nt][2] = dbd[nt][3] = 0.f;
        if (on) {
          for (int c0 = r0; c0 < q16; c0 += 16) {
            decay<true>(e, ed, r0, c0, cum, dts, qc, lane);
            if (p_nt > 0) {  // V^T = B C^T exp(cum_i - cum_j)
              gram16(w, Bs, BN, r0, Cs, BN, c0, N, lane);
              scale(w, e);
              mma_weighted(U, w, Ys, XP, c0, pg, p_nt, lane);
            }
            if (n_nt > 0) {  // dS^T = x dy^T exp(cum_i - cum_j) dt_j
              gram16(w, Xs, XP, r0, Ys, XP, c0, P, lane);
              scale(w, ed);
              mma_weighted(dbd, w, Cs, BN, c0, ng, n_nt, lane);
            }
          }
          if (resident) mma::mbar_wait(bar, 0);
        }
        // the head's dB = sum_i dS_ij C_i + d_end_j x_j dh, 4 n-tiles at a time
#pragma unroll
        for (int qn = 0; qn < 4; ++qn) {
          if (4 * qn >= n_nt) break;
          const int n0 = ng + 32 * qn, m_nt = min(4, n_nt - 4 * qn);
          float dbs[4][4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) dbs[nt][0] = dbs[nt][1] = dbs[nt][2] = dbs[nt][3] = 0.f;
          for (int k_lo = 0; k_lo < P; k_lo += plan.kp) {  // x dh
            const int k_hi = min(P, k_lo + plan.kp);
            const StateView v = state_view(resident, Ds, HN, st, dhg, hg, N, k_lo, k_hi - k_lo,
                                           n0, 8 * m_nt);
            if (on) coldot(dbs, Xs, XP, r0, v.f, v.fs, v.fp, v.fk, n0, m_nt, k_lo, k_hi, lane);
          }
          if (on) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              if (nt >= m_nt) break;
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const int j = hf ? jb : ja;
                if (j >= qc) continue;
                const float dj = dend[j];
                *reinterpret_cast<float2*>(
                    dBp + ((static_cast<long long>(bb) * H + hh) * S + t0 + j) * N + n0 + 8 * nt +
                    2 * t) = make_float2(dbd[4 * qn + nt][2 * hf] + dj * dbs[nt][2 * hf],
                                         dbd[4 * qn + nt][2 * hf + 1] + dj * dbs[nt][2 * hf + 1]);
              }
            }
          }
        }
        // dx = dt U + d_end T, u_j += x_j . U_j, s_j += x_j . T_j over the P group
        if (p_nt > 0) {
          float T[8][4];
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) T[nt][0] = T[nt][1] = T[nt][2] = T[nt][3] = 0.f;
          for (int k_lo = 0; k_lo < N; k_lo += plan.kn) {  // T = B dh^T
            const int k_hi = min(N, k_lo + plan.kn);
            const StateView v = state_view(resident, Ds, HN, st, dhg, hg, N, pg, 8 * p_nt, k_lo,
                                           k_hi - k_lo);
            if (on) rowdot(T, Bs, BN, r0, v.f, v.fs, v.fp, v.fk, pg, p_nt, k_lo, k_hi, lane);
          }
          if (on) {
#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              if (nt >= p_nt) break;
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const int j = hf ? jb : ja, p = pg + 8 * nt + 2 * t;
                const float u0 = U[nt][2 * hf], u1 = U[nt][2 * hf + 1];
                const float s0 = T[nt][2 * hf], s1 = T[nt][2 * hf + 1];
                const float x0 = __bfloat162float(Xs[j * XP + p]);
                const float x1 = __bfloat162float(Xs[j * XP + p + 1]);
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
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        upart[hf] += __shfl_xor_sync(0xffffffffu, upart[hf], 1);
        upart[hf] += __shfl_xor_sync(0xffffffffu, upart[hf], 2);
        spart[hf] += __shfl_xor_sync(0xffffffffu, spart[hf], 1);
        spart[hf] += __shfl_xor_sync(0xffffffffu, spart[hf], 2);
      }
      if (on && t == 0) {
        if (ja < qc) { ru[ja] = upart[0]; rs[ja] = spart[0]; }
        if (jb < qc) { ru[jb] = upart[1]; rs[jb] = spart[1]; }
      }
    }
  }
  if (resident) mma::mbar_wait(bar, 0);  // a warp with no tile still reads the state below
  if (dh0 != nullptr) {
    // one chunk: dh0 = exp(cum_last) dh + (dy exp(cum))^T C, A = (dy
    // exp(cum))^T (split; dy by ldmatrix.trans, k = 2t, 2t + 1 as k = t,
    // t + 4), B = C (exact, ldmatrix.trans), in tiles of 16 state rows by
    // 8 kD0 state columns
    constexpr int kD0 = 4;
    const float decay = ecum[qc - 1];
    const int n_pt = P / 16, n_ngr = (N + 8 * kD0 - 1) / (8 * kD0);
    for (int tile = warp; tile < n_pt * n_ngr; tile += kWarps) {
      const int p0 = (tile % n_pt) * 16, ng = (tile / n_pt) * 8 * kD0;
      const int n_nt = min(8 * kD0, N - ng) / 8;
      float acc[kD0][4];
#pragma unroll
      for (int nt = 0; nt < kD0; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
      const __nv_bfloat16* yp = Ys + (lane & 7) * XP + p0 + ((lane >> 3) & 1) * 8;
      const __nv_bfloat16* cp = Cs + (lane & 7) * BN + ng + (lane >> 3) * 8;
      for (int k0 = 0; k0 < q16; k0 += 8) {
        uint32_t r[2], cb[kD0];
        mma::ldmatrix_x2_trans(r, yp + k0 * XP);
#pragma unroll
        for (int q4 = 0; q4 < kD0 / 4; ++q4) {
          uint32_t c4[4];
          mma::ldmatrix_x4_trans(c4, cp + k0 * BN + 32 * q4);
#pragma unroll
          for (int m = 0; m < 4; ++m) cb[4 * q4 + m] = c4[m];
        }
        const float e0 = ecum[k0 + 2 * t], e1 = ecum[k0 + 2 * t + 1];
        const float av[4] = {__uint_as_float(lo_tf(r[0])) * e0, __uint_as_float(lo_tf(r[1])) * e0,
                             __uint_as_float(hi_tf(r[0])) * e1, __uint_as_float(hi_tf(r[1])) * e1};
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split2(av[e], ahi[e], alo[e]);
#pragma unroll
        for (int nt = 0; nt < kD0; ++nt) {
          if (nt >= n_nt) break;
          mma::tf32_1688(acc[nt], ahi, lo_tf(cb[nt]), hi_tf(cb[nt]));
        }
#pragma unroll
        for (int nt = 0; nt < kD0; ++nt) {
          if (nt >= n_nt) break;
          mma::tf32_1688(acc[nt], alo, lo_tf(cb[nt]), hi_tf(cb[nt]));
        }
      }
#pragma unroll
      for (int nt = 0; nt < kD0; ++nt) {
        if (nt >= n_nt) break;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int p = p0 + g + 8 * hf, n = ng + 8 * nt + 2 * t;
          float2 d = make_float2(0.f, 0.f);
          if (resident) {
            d = *reinterpret_cast<const float2*>(Ds + p * HN + n);
          } else if (dhg != nullptr) {
            d = __ldg(reinterpret_cast<const float2*>(dhg + p * N + n));
          }
          *reinterpret_cast<float2*>(dh0 + (static_cast<long long>(bb) * H + hh) * PN + p * N +
                                     n) = make_float2(decay * d.x + acc[nt][2 * hf],
                                                      decay * d.y + acc[nt][2 * hf + 1]);
        }
      }
    }
  }
  __syncthreads();  // ra, ru and rs are complete; the tiles are free

  // rows t: dcum, its reverse running sum, ddt and this block's part of dA
  float v = 0.f;
  for (int j = tid; j < qc; j += kThreads) v += dend[j] * rs[j];
  const float send = block_sum(v, red);
  float hd = 0.f;
  if (resident) {
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int p = idx / N, n = idx % N;
      hd += Ds[p * HN + n] * Hs[p * HN + n];
    }
  } else if (dhg != nullptr) {
    for (int idx = tid; idx < P * N; idx += kThreads) hd += __ldg(dhg + idx) * __ldg(hg + idx);
  }
  const float dhh = block_sum(hd, red);
  float* rev = reinterpret_cast<float*>(Xs);  // dcum, last row first
  float* dda = reinterpret_cast<float*>(Ys);  // its running sum
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
    ddt[(static_cast<long long>(bb) * S + t0 + j) * H + hh] =
        ru[j] + expf(last - cum[j]) * rs[j] + a * d;
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
  return static_cast<long long>(bwd_plan(q, n, p).smem);
}

// Plain C entry point of the backward (loaded with ctypes): with more than
// one chunk the reverse pass (dh_end (B, n_chunks - 1, H, P, N) f32, the end
// cotangents of all chunks but the last, and dh0); the chunk pass (dx, ddt,
// the partials dBp and dCp (B, H, S, N) f32 and dAp (B, n_chunks, H) f32,
// and with one chunk dh0); then the reduction into dB, dC (B, S, N) bf16 and
// dA (H,) f32. x, Bm and Cm as the forward takes them; dy (B, S, H, P) bf16
// and the outputs contiguous; states (B, n_chunks, H, P, N) f32 from the
// forward; dh_out (B, H, P, N) f32 or null (zeros). Returns the CUDA error
// code of the launches (0 on success).
extern "C" int ssd_scan_bwd_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                                 const void* Cm, const void* dy, const void* states,
                                 const void* dh_out, void* dh_end, void* dBp, void* dCp,
                                 void* dAp, void* dx, void* ddt, void* dA, void* dB, void* dC,
                                 void* dh0, int b, int s, int h, int p, int n, int chunk,
                                 long long s_xb, long long s_xs, long long s_bb, long long s_bs,
                                 long long s_cb, long long s_cs, void* stream) {
  if (b < 1 || s < 1 || h < 1 || p < kSlice || p % kSlice || n < 16 || n % 16 || n > kMaxN ||
      chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int q = chunk < s ? chunk : s;
  const int n_chunks = (s + q - 1) / q;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* bm = static_cast<const __nv_bfloat16*>(Bm);
  const __nv_bfloat16* cm = static_cast<const __nv_bfloat16*>(Cm);
  const __nv_bfloat16* dyb = static_cast<const __nv_bfloat16*>(dy);
  cudaError_t err;

  if (n_chunks > 1) {
    const size_t dstate_bytes = smem_layout(q, n).total;
    static size_t dstate_allowed[64] = {};
    err = allow_smem(ssd_bwd_dstate_kernel, dstate_bytes, dstate_allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_bwd_dstate_kernel<<<dim3(p / kSlice, h, b), kThreads, dstate_bytes, st>>>(
        static_cast<const float*>(dt), static_cast<const float*>(A), cm, dyb,
        static_cast<const float*>(dh_out), static_cast<float*>(dh_end), static_cast<float*>(dh0),
        s, h, p, n, q, s_cb, s_cs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  const BwdPlan plan = bwd_plan(q, n, p);
  if (plan.smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  // mamba2's and zamba2's widths with their full groups: the compiled-in
  // instantiations; anything else the generic one
  auto* kernel = ssd_bwd_chunk_kernel<0, 0>;
  static size_t allowed[3][64] = {};
  int which = 0;
  if (p == 64 && n == 128 && plan.gp == 64) {
    kernel = ssd_bwd_chunk_kernel<64, 128>;
    which = 1;
  } else if (p == 64 && n == 64 && plan.gp == 64) {
    kernel = ssd_bwd_chunk_kernel<64, 64>;
    which = 2;
  }
  err = allow_smem(kernel, plan.smem, allowed[which]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(h, n_chunks, b), kThreads, plan.smem, st>>>(
      xb, static_cast<const float*>(dt), static_cast<const float*>(A), bm, cm, dyb,
      static_cast<const float*>(states), static_cast<const float*>(dh_end),
      static_cast<const float*>(dh_out), static_cast<__nv_bfloat16*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dBp), static_cast<float*>(dCp), static_cast<float*>(dAp),
      n_chunks == 1 ? static_cast<float*>(dh0) : nullptr, s, h, p, n, q, plan, s_xb, s_xs, s_bb,
      s_bs, s_cb, s_cs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long total = static_cast<long long>(b) * s * n + h;
  ssd_bwd_reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(dBp), static_cast<const float*>(dCp),
      static_cast<const float*>(dAp), static_cast<__nv_bfloat16*>(dB),
      static_cast<__nv_bfloat16*>(dC), static_cast<float*>(dA), b, s, h, n, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
