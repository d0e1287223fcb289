// The gradient of attention over fresh K/V for Hopper (sm_90a): dQ, dK, dV.
//
// Replaces no Pallas kernel: the JAX package trains through the XLA mirror
// flash_attention (src/repro/models/layers.py:215) and takes its gradient by
// autodiff. The port's training forward runs the hand-written forward kernel
// (verify_attn.cu, dense entry, layer = none), which has no gradient of its
// own; these three kernels are its backward (kernels/ops.py: attention).
//
// Math (that of kernels/ref.py: attention_bwd_ref). Query row i of Sq sees KV
// position j iff j <= lim(i) and j < Skv, lim(i) = kv_valid - Sq + i when
// causal (the forward's causal-offset mask), kv_valid - 1 when not (the
// encoder and cross-attention). S = q.k * scale, scores f32 sums of bf16
// products.
//   attn_bwd_stats: LSE(i) = log sum_j exp(S_ij) over the visible j (an online
//       max and sum, f32; 0 for a row that sees nothing) and
//       Delta(i) = sum_d dO_id * O_id (f32), both (B, Hq, Sq).
//   attn_bwd_dkdv:  P = exp(S - LSE) under the mask, dP = dO.v, dS = P * (dP -
//       Delta); dV_j = sum_i bf16(P_ij) dO_i (P rounded as the forward rounds
//       it before P.V), dK_j = scale * sum_i dS_ij q_i, summed over the G query
//       heads of the KV head in f32.
//   attn_bwd_dq:    dQ_i = scale * sum_j dS_ij k_j.
// No atomics: every output element has one owner block and one f32 FMA
// chain in a fixed order, so two calls give the same bits, and a row's (a
// batch entry's) result does not depend on the other rows of its call.
//
// Design (a simple kernel first; PERF.md has its times). Every product runs
// as FMA chains on the CUDA cores over f32 copies of the bf16 tiles in
// shared memory; tiles are 32 query rows by 64 KV positions:
//   - stats and dq: one block (128 threads) per (32-row tile, query head, b);
//     the block loops over the 64-position chunks its last row sees.
//   - dkdv: one block (256 threads) per (64-position KV block, KV head, b);
//     it loops over the G query heads and the 32-row tiles whose rows see
//     the block, recomputing S, P and dS for each, and keeps dK and dV in
//     registers until it writes them once.
// Thread tiles: a score tile's thread holds rows rq + (NT/16)*a and
// positions cq + 16*b (rq = t / 16, cq = t % 16); an accumulator's thread
// holds rows (or positions) t/16 + (NT/16)*i and columns t%16 + 16*j. Rows
// in shared memory are padded by one float (stride D + 1, 65 for a 64-wide
// P row), so the 16 positions or rows a half-warp reads fall in 16 banks.
//
// Bound on an H100: operations at training shapes (qwen2-1.5b: S 128, 12
// query heads on 2 of 128; whisper-tiny's encoder: 1500 rows over 1500
// positions), bytes at a decode-like Sq. The tensor cores (wgmma), TMA and
// an LSE kept by the forward are later work (ROADMAP Queue B).
//
// Layouts: q, out, dout, dq (B, Sq, Hq, D); k, v, dk, dv (B, Skv, Hkv, D);
// all contiguous bf16. kv_valid (B,) int32; lse, delta (B, Hq, Sq) f32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (src/repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;     // query rows per tile
constexpr int kPos = 64;      // KV positions per chunk / block
constexpr int kPP = kPos + 1; // padded stride of a P or dS row
constexpr float kNegInf = -1e30f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ int row_limit(int kv, int sq, int i, int causal, int skv) {
  const int lim = causal ? kv - sq + i : kv - 1;
  return lim < skv - 1 ? lim : skv - 1;
}

// n rows of D bf16 (row stride ld elements) into shared f32 rows of stride
// D + 1; rows at and past ``valid`` are zero. 16-byte loads of 8 elements.
template <int D, int NT>
__device__ __forceinline__ void load_rows(float* dst, const bf16* src, long long ld, int n,
                                          int valid) {
  constexpr int kVec = D / 8;
  for (int idx = threadIdx.x; idx < n * kVec; idx += NT) {
    const int r = idx / kVec, c = (idx % kVec) * 8;
    float* d = dst + r * (D + 1) + c;
    if (r < valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * ld + c);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        d[2 * e] = f.x;
        d[2 * e + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = 0.f;
    }
  }
}

// s[a][b] = sum_d A[rq + step*a][d] * Bm[cq + 16*b][d]: one FMA chain over d
// in order per element (A and Bm shared f32 rows of stride D + 1).
template <int D, int RA>
__device__ __forceinline__ void dot_tile(float (&s)[RA][4], const float* A, const float* Bm,
                                         int rq, int cq, int step) {
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[RA], bv[4];
#pragma unroll
    for (int a = 0; a < RA; ++a) av[a] = A[(rq + step * a) * (D + 1) + d];
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = Bm[(cq + 16 * b) * (D + 1) + d];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = fmaf(av[a], bv[b], s[a][b]);
  }
}

// the 16 lanes of a half-warp share a row of the score tile
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// attn_bwd_stats: LSE and Delta of one 32-row tile of one query head
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(128)
stats_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ out, const bf16* __restrict__ dout,
             const int* __restrict__ kv_valid, float* __restrict__ lse,
             float* __restrict__ delta, int sq, int hq, int hkv, int skv, float scale,
             int causal) {
  extern __shared__ float smem[];
  float* qs = smem;                  // kRows x (D + 1)
  float* ks = smem + kRows * (D + 1); // kPos x (D + 1)
  const int i0 = blockIdx.x * kRows, head = blockIdx.y, b = blockIdx.z;
  const int h = head / (hq / hkv);
  const int nrows = min(kRows, sq - i0);
  const int kv = kv_valid[b];
  const long long ldq = static_cast<long long>(hq) * D, ldk = static_cast<long long>(hkv) * D;
  const long long row0 = (static_cast<long long>(b) * sq + i0) * ldq + head * D;
  float* lse_row = lse + (static_cast<long long>(b) * hq + head) * sq + i0;
  float* delta_row = delta + (static_cast<long long>(b) * hq + head) * sq + i0;

  {  // Delta: 4 lanes a row, columns part, part + 4, ...
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
    float acc = 0.f;
    if (r < nrows) {
      const bf16* o = out + row0 + r * ldq;
      const bf16* g = dout + row0 + r * ldq;
      for (int d = part; d < D; d += 4) acc = fmaf(bf(g[d]), bf(o[d]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (r < nrows && part == 0) delta_row[r] = acc;
  }

  load_rows<D, 128>(qs, q + row0, ldq, kRows, nrows);
  const int rq = threadIdx.x >> 4, cq = threadIdx.x & 15;
  int lim[4];
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + rq + 8 * a;
    lim[a] = i < sq ? row_limit(kv, sq, i, causal, skv) : -1;
    m[a] = kNegInf;
    l[a] = 0.f;
  }
  const int last = row_limit(kv, sq, i0 + nrows - 1, causal, skv);
  const bf16* kb = k + static_cast<long long>(b) * skv * ldk + h * D;
  for (int j0 = 0; j0 <= last; j0 += kPos) {
    __syncthreads();
    load_rows<D, 128>(ks, kb + j0 * ldk, ldk, kPos, min(kPos, skv - j0));
    __syncthreads();
    float s[4][4];
    dot_tile<D, 4>(s, qs, ks, rq, cq, 8);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float cm = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool vis = j0 + cq + 16 * c <= lim[a];
        s[a][c] = vis ? s[a][c] * scale : kNegInf;
        cm = fmaxf(cm, s[a][c]);
      }
      const float mn = fmaxf(m[a], half_max(cm));
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (j0 + cq + 16 * c <= lim[a]) ps += expf(s[a][c] - mn);
      l[a] = l[a] * expf(m[a] - mn) + half_sum(ps);
      m[a] = mn;
    }
  }
  if (cq == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = rq + 8 * a;
      if (r < nrows) lse_row[r] = l[a] > 0.f ? m[a] + logf(l[a]) : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// attn_bwd_dq: dQ of one 32-row tile of one query head
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(128)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ dout, const int* __restrict__ kv_valid,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int sq, int hq, int hkv, int skv, float scale, int causal) {
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;                     // kRows x (D + 1)
  float* dos = qs + kRows * (D + 1);    // kRows x (D + 1)
  float* ks = dos + kRows * (D + 1);    // kPos x (D + 1)
  float* vs = ks + kPos * (D + 1);      // kPos x (D + 1)
  float* dss = vs + kPos * (D + 1);     // kRows x kPP
  const int i0 = blockIdx.x * kRows, head = blockIdx.y, b = blockIdx.z;
  const int h = head / (hq / hkv);
  const int nrows = min(kRows, sq - i0);
  const int kv = kv_valid[b];
  const long long ldq = static_cast<long long>(hq) * D, ldk = static_cast<long long>(hkv) * D;
  const long long row0 = (static_cast<long long>(b) * sq + i0) * ldq + head * D;
  const long long stat0 = (static_cast<long long>(b) * hq + head) * sq + i0;

  load_rows<D, 128>(qs, q + row0, ldq, kRows, nrows);
  load_rows<D, 128>(dos, dout + row0, ldq, kRows, nrows);
  const int rq = threadIdx.x >> 4, cq = threadIdx.x & 15;
  int lim[4];
  float lse_r[4], del_r[4], acc[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = rq + 8 * a;
    lim[a] = r < nrows ? row_limit(kv, sq, i0 + r, causal, skv) : -1;
    lse_r[a] = r < nrows ? lse[stat0 + r] : 0.f;
    del_r[a] = r < nrows ? delta[stat0 + r] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[a][c] = 0.f;
  }
  const int last = row_limit(kv, sq, i0 + nrows - 1, causal, skv);
  const long long kv0 = static_cast<long long>(b) * skv * ldk + h * D;
  for (int j0 = 0; j0 <= last; j0 += kPos) {
    __syncthreads();
    const int valid = min(kPos, skv - j0);
    load_rows<D, 128>(ks, k + kv0 + j0 * ldk, ldk, kPos, valid);
    load_rows<D, 128>(vs, v + kv0 + j0 * ldk, ldk, kPos, valid);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<D, 4>(s, qs, ks, rq, cq, 8);
    dot_tile<D, 4>(dp, dos, vs, rq, cq, 8);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool vis = j0 + cq + 16 * c <= lim[a];
        const float p = vis ? expf(s[a][c] * scale - lse_r[a]) : 0.f;
        dss[(rq + 8 * a) * kPP + cq + 16 * c] = p * (dp[a][c] - del_r[a]);
      }
    __syncthreads();
    const int npos = min(kPos, last - j0 + 1);
    for (int pos = 0; pos < npos; ++pos) {
      float dsv[4], kc[kCols];
#pragma unroll
      for (int a = 0; a < 4; ++a) dsv[a] = dss[(rq + 8 * a) * kPP + pos];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kc[c] = ks[pos * (D + 1) + cq + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[a][c] = fmaf(dsv[a], kc[c], acc[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = rq + 8 * a;
    if (r >= nrows) continue;
    bf16* o = dq + row0 + r * ldq;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[cq + 16 * c] = __float2bfloat16(acc[a][c] * scale);
  }
}

// ---------------------------------------------------------------------------
// attn_bwd_dkdv: dK and dV of one 64-position block of one KV head
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(256)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const int* __restrict__ kv_valid, const float* __restrict__ lse,
            const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
            int sq, int hq, int hkv, int skv, float scale, int causal) {
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;                     // kPos x (D + 1)
  float* vs = ks + kPos * (D + 1);      // kPos x (D + 1)
  float* qs = vs + kPos * (D + 1);      // kRows x (D + 1)
  float* dos = qs + kRows * (D + 1);    // kRows x (D + 1)
  float* ps = dos + kRows * (D + 1);    // kRows x kPP, bf16-rounded P
  float* dss = ps + kRows * kPP;        // kRows x kPP
  const int j0 = blockIdx.x * kPos, h = blockIdx.y, b = blockIdx.z;
  const int group = hq / hkv;
  const int kv = kv_valid[b];
  const long long ldq = static_cast<long long>(hq) * D, ldk = static_cast<long long>(hkv) * D;
  const long long kv0 = (static_cast<long long>(b) * skv + j0) * ldk + h * D;
  const int valid = min(kPos, skv - j0);
  load_rows<D, 256>(ks, k + kv0, ldk, kPos, valid);
  load_rows<D, 256>(vs, v + kv0, ldk, kPos, valid);

  const int rq = threadIdx.x >> 4, cq = threadIdx.x & 15;  // score rows rq, rq + 16
  float acc_k[4][kCols], acc_v[4][kCols];                  // positions rq + 16*a
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[a][c] = acc_v[a][c] = 0.f;
  // the first query row that sees position j0
  const int first = causal ? max(0, j0 - (kv - sq)) : (j0 <= kv - 1 ? 0 : sq);
  for (int g = 0; g < group; ++g) {
    const int head = h * group + g;
    const long long stat0 = (static_cast<long long>(b) * hq + head) * sq;
    for (int i0 = (first / kRows) * kRows; i0 < sq; i0 += kRows) {
      const int nrows = min(kRows, sq - i0);
      const long long row0 = (static_cast<long long>(b) * sq + i0) * ldq + head * D;
      __syncthreads();
      load_rows<D, 256>(qs, q + row0, ldq, kRows, nrows);
      load_rows<D, 256>(dos, dout + row0, ldq, kRows, nrows);
      int lim[2];
      float lse_r[2], del_r[2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int r = rq + 16 * a;
        lim[a] = r < nrows ? row_limit(kv, sq, i0 + r, causal, skv) : -1;
        lse_r[a] = r < nrows ? lse[stat0 + i0 + r] : 0.f;
        del_r[a] = r < nrows ? delta[stat0 + i0 + r] : 0.f;
      }
      __syncthreads();
      float s[2][4], dp[2][4];
      dot_tile<D, 2>(s, qs, ks, rq, cq, 16);
      dot_tile<D, 2>(dp, dos, vs, rq, cq, 16);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool vis = j0 + cq + 16 * c <= lim[a];
          const float p = vis ? expf(s[a][c] * scale - lse_r[a]) : 0.f;
          const int at = (rq + 16 * a) * kPP + cq + 16 * c;
          ps[at] = __bfloat162float(__float2bfloat16(p));
          dss[at] = p * (dp[a][c] - del_r[a]);
        }
      __syncthreads();
      for (int r = 0; r < nrows; ++r) {
        float pv[4], dsv[4], oc[kCols], qc[kCols];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pv[a] = ps[r * kPP + rq + 16 * a];
          dsv[a] = dss[r * kPP + rq + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          oc[c] = dos[r * (D + 1) + cq + 16 * c];
          qc[c] = qs[r * (D + 1) + cq + 16 * c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc_v[a][c] = fmaf(pv[a], oc[c], acc_v[a][c]);
            acc_k[a][c] = fmaf(dsv[a], qc[c], acc_k[a][c]);
          }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int p = rq + 16 * a;
    if (p >= valid) continue;
    const long long at = kv0 + p * ldk;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dk[at + cq + 16 * c] = __float2bfloat16(acc_k[a][c] * scale);
      dv[at + cq + 16 * c] = __float2bfloat16(acc_v[a][c]);
    }
  }
}

// dynamic shared memory above 48 KB: raised once per device for each kernel
// instantiation (a host-side attribute; a call captured into a CUDA graph
// then sets none). ``done`` is the instantiation's own flag array.
template <typename K>
int prepare(K kernel, size_t smem, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && done[dev]) return 0;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64) done[dev] = true;
  return 0;
}

template <int D>
int run_stats(const bf16* q, const bf16* k, const bf16* out, const bf16* dout,
              const int* kv_valid, float* lse, float* delta, int b, int sq, int hq, int hkv,
              int skv, float scale, int causal, cudaStream_t stream) {
  const size_t smem = (kRows + kPos) * (D + 1) * sizeof(float);
  static bool done[64] = {};
  if (int e = prepare(stats_kernel<D>, smem, done)) return e;
  stats_kernel<D><<<dim3((sq + kRows - 1) / kRows, hq, b), 128, smem, stream>>>(
      q, k, out, dout, kv_valid, lse, delta, sq, hq, hkv, skv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const int* kv_valid,
           const float* lse, const float* delta, bf16* dq, int b, int sq, int hq, int hkv,
           int skv, float scale, int causal, cudaStream_t stream) {
  const size_t smem = ((2 * kRows + 2 * kPos) * (D + 1) + kRows * kPP) * sizeof(float);
  static bool done[64] = {};
  if (int e = prepare(dq_kernel<D>, smem, done)) return e;
  dq_kernel<D><<<dim3((sq + kRows - 1) / kRows, hq, b), 128, smem, stream>>>(
      q, k, v, dout, kv_valid, lse, delta, dq, sq, hq, hkv, skv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run_dkdv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
             const int* kv_valid, const float* lse, const float* delta, bf16* dk, bf16* dv,
             int b, int sq, int hq, int hkv, int skv, float scale, int causal,
             cudaStream_t stream) {
  const size_t smem = ((2 * kRows + 2 * kPos) * (D + 1) + 2 * kRows * kPP) * sizeof(float);
  static bool done[64] = {};
  if (int e = prepare(dkdv_kernel<D>, smem, done)) return e;
  dkdv_kernel<D><<<dim3((skv + kPos - 1) / kPos, hkv, b), 256, smem, stream>>>(
      q, k, v, dout, kv_valid, lse, delta, dk, dv, sq, hq, hkv, skv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns the CUDA error of
// its launch (0 on success); it launches on ``stream`` and does not wait.

extern "C" int attn_bwd_stats(const void* q, const void* k, const void* out, const void* dout,
                              const void* kv_valid, void* lse, void* delta, int b, int sq,
                              int hq, int hkv, int d, int skv, float scale, int causal,
                              void* stream) {
#define CALL(D)                                                                             \
  run_stats<D>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),                    \
               static_cast<const bf16*>(out), static_cast<const bf16*>(dout),               \
               static_cast<const int*>(kv_valid), static_cast<float*>(lse),                 \
               static_cast<float*>(delta), b, sq, hq, hkv, skv, scale, causal,              \
               static_cast<cudaStream_t>(stream))
  switch (d) {
    case 16: return CALL(16);
    case 64: return CALL(64);
    case 96: return CALL(96);
    case 128: return CALL(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CALL
}

extern "C" int attn_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                             const void* kv_valid, const void* lse, const void* delta, void* dk,
                             void* dv, int b, int sq, int hq, int hkv, int d, int skv,
                             float scale, int causal, void* stream) {
#define CALL(D)                                                                             \
  run_dkdv<D>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),                     \
              static_cast<const bf16*>(v), static_cast<const bf16*>(dout),                  \
              static_cast<const int*>(kv_valid), static_cast<const float*>(lse),            \
              static_cast<const float*>(delta), static_cast<bf16*>(dk),                     \
              static_cast<bf16*>(dv), b, sq, hq, hkv, skv, scale, causal,                   \
              static_cast<cudaStream_t>(stream))
  switch (d) {
    case 16: return CALL(16);
    case 64: return CALL(64);
    case 96: return CALL(96);
    case 128: return CALL(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CALL
}

extern "C" int attn_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* kv_valid, const void* lse, const void* delta, void* dq,
                           int b, int sq, int hq, int hkv, int d, int skv, float scale,
                           int causal, void* stream) {
#define CALL(D)                                                                             \
  run_dq<D>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),                       \
            static_cast<const bf16*>(v), static_cast<const bf16*>(dout),                    \
            static_cast<const int*>(kv_valid), static_cast<const float*>(lse),              \
            static_cast<const float*>(delta), static_cast<bf16*>(dq), b, sq, hq, hkv, skv,  \
            scale, causal, static_cast<cudaStream_t>(stream))
  switch (d) {
    case 16: return CALL(16);
    case 64: return CALL(64);
    case 96: return CALL(96);
    case 128: return CALL(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CALL
}
