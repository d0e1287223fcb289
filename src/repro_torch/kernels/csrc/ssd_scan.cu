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
//   1. ssd_cb_kernel: CB = C B^T over the causal triangle of each (b,
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

// CB[b, c][i][j] = C_i . B_j for the chunk's rows i, j < qc, lower-triangle
// 64x64 tiles (W reads j <= i only). Warp w computes 16 rows x 64 columns
// from fragments loaded straight from device memory (each C element once per
// block; B's rows are shared by the 4 warps through L1).
__global__ void __launch_bounds__(128)
ssd_cb_kernel(const __nv_bfloat16* __restrict__ Bm, const __nv_bfloat16* __restrict__ Cm,
              float* __restrict__ cb, int S, int N, int Q, int n_chunks,
              long long s_bb, long long s_bs, long long s_cb, long long s_cs) {
  const int ti = blockIdx.x, tj = blockIdx.y;
  if (tj > ti) return;
  const int bb = blockIdx.z / n_chunks, c = blockIdx.z % n_chunks;
  const int t0 = c * Q, qc = min(Q, S - t0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int i0 = ti * kCbTile + warp * 16, j0 = tj * kCbTile;
  if (i0 >= qc || j0 >= qc) return;
  const __nv_bfloat16* cr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = i0 + g + 8 * hf;
    cr[hf] = i < qc ? Cm + bb * s_cb + (t0 + i) * s_cs : nullptr;
  }
  const __nv_bfloat16* br[8];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = j0 + nt * 8 + g;
    br[nt] = j < qc ? Bm + bb * s_bb + (t0 + j) * s_bs : nullptr;
  }
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll 4
  for (int k0 = 0; k0 < N; k0 += 16) {
    const uint32_t a[4] = {ld_pair(cr[0], k0 + 2 * t), ld_pair(cr[1], k0 + 2 * t),
                           ld_pair(cr[0], k0 + 8 + 2 * t), ld_pair(cr[1], k0 + 8 + 2 * t)};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mma::bf16_16816(acc[nt], a, ld_pair(br[nt], k0 + 2 * t), ld_pair(br[nt], k0 + 8 + 2 * t));
    }
  }
  // stored in the order the scan loads W's tf32 A fragments (cb_index)
  const int q16 = round16(Q);
  float* out = cb + (static_cast<long long>(bb) * n_chunks + c) * q16 * q16;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + 8 * (e >> 1), j = j0 + nt * 8 + 2 * t + (e & 1);
      if (i < qc && j < qc) out[cb_index(i, j, q16)] = acc[nt][e];
    }
  }
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
                float* __restrict__ h_out, int S, int H, int P, int N, int Q,
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
          uint32_t hi0, lo0, hi1, lo1;
          mma::split_tf32(hr[t], hi0, lo0);
          mma::split_tf32(hr[t + 4], hi1, lo1);
          mma::tf32_1688(off[nt], af, hi0, hi1);
          mma::tf32_1688(off[nt], af, lo0, lo1);
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
          uint32_t whi[4], wlo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) mma::split_tf32(w[e], whi[e], wlo[e]);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const uint32_t x0 = __float_as_uint(Xs[ja * kXs + nt * 8 + g]);
            const uint32_t x1 = __float_as_uint(Xs[jb * kXs + nt * 8 + g]);
            mma::tf32_1688(dg[nt], whi, x0, x1);
            mma::tf32_1688(dg[nt], wlo, x0, x1);
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
        uint32_t hi0, lo0, hi1, lo1;
        mma::split_tf32(__bfloat162float(Bs[(k0 + t) * CN + n]) * d0, hi0, lo0);
        mma::split_tf32(__bfloat162float(Bs[(k0 + t + 4) * CN + n]) * d1, hi1, lo1);
        mma::tf32_1688(sacc[u], af, hi0, hi1);
        mma::tf32_1688(sacc[u], af, lo0, lo1);
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

}  // namespace

// Shared memory one scan block needs at these sizes (the wrapper refuses
// shapes above the card's 227 KB per block).
extern "C" long long ssd_scan_smem_bytes(int q, int n) {
  return static_cast<long long>(smem_layout(q, n).total);
}

// Plain C entry point (loaded with ctypes): the C.B^T kernel into cb, an f32
// scratch of B * n_chunks * Q16 * Q16 values (Q16: Q rounded up to 16), then
// the scan. Returns the CUDA error code of
// the launches (0 on success).
extern "C" int ssd_scan_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                             const void* Cm, const void* h0, void* cb, void* y, void* h_out,
                             int b, int s, int h, int p, int n, int chunk, long long s_xb,
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
  ssd_cb_kernel<<<dim3(cb_tiles, cb_tiles, b * n_chunks), 128, 0, st>>>(
      static_cast<const __nv_bfloat16*>(Bm), static_cast<const __nv_bfloat16*>(Cm),
      static_cast<float*>(cb), s, n, q, n_chunks, s_bb, s_bs, s_cb, s_cs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = smem_layout(q, n).total;
  // raise the kernel's shared-memory limit once per device and larger size
  // (a host-side attribute; a call captured into a CUDA graph then sets none)
  static size_t smem_allowed[64] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || bytes > smem_allowed[dev]) {
    err = cudaFuncSetAttribute(ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) smem_allowed[dev] = bytes;
  }
  ssd_scan_kernel<<<dim3(p / kSlice, h, b), kThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const __nv_bfloat16*>(Bm),
      static_cast<const __nv_bfloat16*>(Cm), static_cast<const float*>(h0),
      static_cast<const float*>(cb), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(h_out), s, h, p, n, q, s_xb, s_xs, s_bb, s_bs, s_cb, s_cs);
  return static_cast<int>(cudaGetLastError());
}
