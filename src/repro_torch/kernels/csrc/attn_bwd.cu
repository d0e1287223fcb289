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
// products. LSE(i) = log sum_j exp(S_ij) over the visible j (f32; 0 for a
// row that sees nothing) is the forward's: verify_attn.cu writes it from its
// merge when training asks for it (verify_attention_packed(return_lse=True)),
// so no kernel here computes it again.
//   attn_bwd_delta: Delta(i) = sum_d dO_id * O_id (f32), (B, Hq, Sq).
//   attn_bwd_dkdv:  P = exp(S - LSE) under the mask, dP = dO.v, dS = P * (dP -
//       Delta); dV_j = sum_i bf16(P_ij) dO_i (P rounded as the forward rounds
//       it before P.V), dK_j = scale * sum_i bf16(dS_ij) q_i, summed over the
//       G query heads of the KV head in f32, in head order.
//   attn_bwd_dq:    dQ_i = scale * sum_j bf16(dS_ij) k_j.
// dS is rounded to bf16 (round to nearest even) for its two products, the
// one rounding point the plain version does not have
// (kernels/ref.py: attention_bwd_split_ref restates this decomposition).
// No atomics on data: every output element has one f32 sum in a fixed
// order, so two calls give the same bits, and a batch entry's result does
// not depend on the other entries of its call.
//
// Design. Bound on an H100: dq and dkdv by operations at training shapes
// (qwen2-1.5b: S 128, 12 query heads on 2 of 128; whisper-tiny's encoder:
// 1500 rows over 1500 positions), by bytes at a decode-like Sq; at qwen2's
// rows the grid's latency more than either. delta by bytes: it reads O and
// dO once (3.1 MB at qwen2's rows, ~1 us at 3.35 TB/s), so a launch's
// latency sets its time. Every product of dq and dkdv runs on the
// tensor cores (mma.sync m16n8k16, bf16 operands, f32 sums) with its
// fragments read by ldmatrix from bf16 tiles in shared memory; the tiles
// come in by 16-byte cp.async, double-buffered, so that the next tile is in
// flight while the current one is multiplied. Tiles are 64 query rows by
// 64 KV positions; shared rows are padded by 8 elements (16 bytes), so the
// 8 rows an ldmatrix reads fall in distinct banks.
//   - dq: one block (4 warps) per (64-row tile, query head, b); warp w owns
//     rows 16w..16w+15 and keeps their dQ in registers. Per 64-position KV
//     block that its last row sees: S and dP (16 x 64 each warp), dS in
//     registers, re-packed as the bf16 A operand of dQ += dS.K.
//   - dkdv: one block (8 warps) per (64-position block, query head, b), so
//     the grid does not depend on B for its size, and 2 x 12 x 8 = 192
//     blocks at qwen2's rows. K and V stay in shared memory; per 64-row
//     query tile that sees the block: S and dP (warp w: rows 16(w % 4),
//     positions 32(w / 4)), bf16 P and dS to shared memory, then dV +=
//     P^T.dO and dK += dS^T.Q (warp w: positions 16(w % 4), D/2 columns
//     from (D/2)(w / 4)), accumulated in registers. With G = 1 the block
//     writes dK and dV. With G > 1 it writes its f32 partials to a
//     workspace that the wrapper allocates; the last block of each
//     (position block, KV head, b) to finish, told by a ticket counter that
//     it returns to 0 (so a CUDA graph can replay the call), sums the G
//     partials in head order and writes bf16. The split and the order
//     depend on (Sq, Skv, Hq, Hkv, D) only.
//   - delta: a bandwidth-bound reduction, one warp per (b, i) token row
//     reading its Hq * D contiguous elements of O and dO in 16-byte loads,
//     4 rows a block (256 blocks at qwen2's 1024 token rows, ~2 on each of
//     the 132 SMs), a fixed lane and shuffle order (see delta_kernel).
// wgmma and TMA are later work (ROADMAP Queue B).
//
// Layouts: q, out, dout, dq (B, Sq, Hq, D); k, v, dk, dv (B, Skv, Hkv, D);
// all contiguous bf16. kv_valid (B,) int32; lse (the forward's), delta
// (B, Hq, Sq) f32.
// dkdv's workspace (B, Hkv, ceil(Skv/64), G, 2, 64, D) f32 (dK's partial,
// then dV's) and its tickets (B, Hkv, ceil(Skv/64)) int32, both unused
// when G = 1.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (src/repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kPos = 64;        // KV positions per chunk / block
constexpr int kTile = 64;       // dq, dkdv: query rows per tile
constexpr int kPLd = kPos + 8;  // padded stride of a bf16 P or dS row
constexpr int kDeltaWarps = 4;  // delta: token rows (warps) per block
constexpr int kDeltaBatch = 4;  // delta: head steps whose loads go out together

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ int row_limit(int kv, int sq, int i, int causal, int skv) {
  const int lim = causal ? kv - sq + i : kv - 1;
  return lim < skv - 1 ? lim : skv - 1;
}

// ---------------------------------------------------------------------------
// attn_bwd_delta: Delta = rowsum(dO * O) of one token row's Hq heads
// ---------------------------------------------------------------------------

// One warp per (b, i) token row, its Hq * D bf16 elements of O and dO
// contiguous. Each head row is kLanes lanes of one 16-byte vector each (the
// power of two at or above D / 8: 2, 8, 16, 16 at D = 16, 64, 96, 128; at
// D = 96 four lanes of each group read nothing), so a warp takes 32 / kLanes
// heads at once and kDeltaBatch such steps' loads go out before any sum. A
// lane's 8 products are one f32 FMA chain in column order, and the group's
// sums meet in a butterfly (xor kLanes / 2 down to 1), which leaves the same
// bits in every lane of the group: a head's Delta depends on its row alone.
template <int D>
__global__ void __launch_bounds__(kDeltaWarps * 32)
delta_kernel(const bf16* __restrict__ out, const bf16* __restrict__ dout,
             float* __restrict__ delta, int rows, int sq, int hq) {
  constexpr int kVec = D / 8;
  constexpr int kLanes = kVec <= 2 ? 2 : kVec <= 8 ? 8 : 16;
  constexpr int kHeads = 32 / kLanes;
  const int lane = threadIdx.x & 31, sub = lane % kLanes, slot = lane / kLanes;
  const int t = blockIdx.x * kDeltaWarps + (threadIdx.x >> 5);  // b * sq + i
  if (t >= rows) return;  // the whole warp
  const long long row0 = static_cast<long long>(t) * hq * D;
  const long long stat0 = static_cast<long long>(t / sq) * hq * sq + t % sq;
  for (int h0 = 0; h0 < hq; h0 += kHeads * kDeltaBatch) {
    uint4 o[kDeltaBatch], g[kDeltaBatch];
#pragma unroll
    for (int u = 0; u < kDeltaBatch; ++u) {
      const int h = h0 + u * kHeads + slot;
      const bool live = h < hq && sub < kVec;
      const long long at = row0 + h * D + sub * 8;
      o[u] = live ? __ldg(reinterpret_cast<const uint4*>(out + at)) : make_uint4(0, 0, 0, 0);
      g[u] = live ? __ldg(reinterpret_cast<const uint4*>(dout + at)) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kDeltaBatch; ++u) {
      const __nv_bfloat162* ov = reinterpret_cast<const __nv_bfloat162*>(&o[u]);
      const __nv_bfloat162* gv = reinterpret_cast<const __nv_bfloat162*>(&g[u]);
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(ov[e]), y = __bfloat1622float2(gv[e]);
        acc = fmaf(y.x, x.x, acc);
        acc = fmaf(y.y, x.y, acc);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      const int h = h0 + u * kHeads + slot;
      if (sub == 0 && h < hq) delta[stat0 + static_cast<long long>(h) * sq] = acc;
    }
  }
}

// dq, dkdv: n rows of D bf16 (row stride ld elements) into shared bf16 rows
// of stride D + 8 by 16-byte cp.async (not committed here); rows at and
// past ``valid`` are zero-filled and read nothing.
template <int D, int NT>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, long long ld, int n,
                                          int valid) {
  constexpr int kVec = D / 8;
  for (int idx = threadIdx.x; idx < n * kVec; idx += NT) {
    const int r = idx / kVec, c = (idx % kVec) * 8;
    const bool live = r < valid;
    mma::cp_async16(dst + r * (D + 8) + c, src + (live ? r * ld : 0) + c, live);
  }
}

// s[2 np + h] += A B^T over D: A the 16 rows at a, B the 16 NP rows at bt
// (both row-major bf16 in shared memory, strides lda, ldb); S = Q K^T and
// dP = dO V^T, n8 tile 2 np + h holding B's rows 16 np + 8 h ...
template <int D, int NP>
__device__ __forceinline__ void rows_by_rows(float (&s)[2 * NP][4], const bf16* a, int lda,
                                             const bf16* bt, int ldb, int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    mma::ldmatrix_x4(af, a + (lane & 15) * lda + 16 * kk + 8 * (lane >> 4));
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      uint32_t bfr[4];
      mma::ldmatrix_x4(bfr, bt + (16 * np + (lane & 7) + 8 * (lane >> 4)) * ldb + 16 * kk +
                                8 * ((lane >> 3) & 1));
      mma::bf16_16816(s[2 * np], af, bfr[0], bfr[1]);
      mma::bf16_16816(s[2 * np + 1], af, bfr[2], bfr[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// attn_bwd_dq: dQ of one 64-row tile of one query head
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(128)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ dout, const int* __restrict__ kv_valid,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int sq, int hq, int hkv, int skv, float scale, int causal) {
  constexpr int kLd = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kTile x kLd
  bf16* dos = qs + kTile * kLd;                  // kTile x kLd
  bf16* ks = dos + kTile * kLd;                  // 2 x kPos x kLd, double-buffered
  bf16* vs = ks + 2 * kPos * kLd;                // 2 x kPos x kLd
  const int i0 = blockIdx.x * kTile, head = blockIdx.y, b = blockIdx.z;
  const int h = head / (hq / hkv);
  const int nrows = min(kTile, sq - i0);
  const int kv = kv_valid[b];
  const long long ldq = static_cast<long long>(hq) * D, ldk = static_cast<long long>(hkv) * D;
  const long long row0 = (static_cast<long long>(b) * sq + i0) * ldq + head * D;
  const long long stat0 = (static_cast<long long>(b) * hq + head) * sq + i0;
  const long long kv0 = static_cast<long long>(b) * skv * ldk + h * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int last = row_limit(kv, sq, i0 + nrows - 1, causal, skv);

  copy_rows<D, 128>(qs, q + row0, ldq, kTile, nrows);
  copy_rows<D, 128>(dos, dout + row0, ldq, kTile, nrows);
  if (last >= 0) {
    copy_rows<D, 128>(ks, k + kv0, ldk, kPos, min(kPos, skv));
    copy_rows<D, 128>(vs, v + kv0, ldk, kPos, min(kPos, skv));
  }
  mma::cp_async_commit();

  // this thread's rows 16 warp + g + 8 hf of the tile; the warp's last row
  // sees the most (lim grows with the row)
  int lim[2];
  float lse_r[2], del_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = 16 * warp + g + 8 * hf;
    lim[hf] = r < nrows ? row_limit(kv, sq, i0 + r, causal, skv) : -1;
    lse_r[hf] = r < nrows ? lse[stat0 + r] : 0.f;
    del_r[hf] = r < nrows ? delta[stat0 + r] : 0.f;
  }
  const int wrow = min(16 * warp + 15, nrows - 1);
  const int wlast = wrow >= 16 * warp ? row_limit(kv, sq, i0 + wrow, causal, skv) : -1;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const bf16* qw = qs + 16 * warp * kLd;
  const bf16* dow = dos + 16 * warp * kLd;
  int buf = 0;
  for (int j0 = 0; j0 <= last; j0 += kPos, buf ^= 1) {
    if (j0 + kPos <= last) {  // the next block, into the other buffer
      const long long at = kv0 + (j0 + kPos) * ldk;
      const int valid = min(kPos, skv - j0 - kPos);
      copy_rows<D, 128>(ks + (buf ^ 1) * kPos * kLd, k + at, ldk, kPos, valid);
      copy_rows<D, 128>(vs + (buf ^ 1) * kPos * kLd, v + at, ldk, kPos, valid);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // this block's K and V (and Q, dO) have landed
    __syncthreads();
    const bf16* kb = ks + buf * kPos * kLd;
    const bf16* vb = vs + buf * kPos * kLd;
    if (j0 <= wlast) {
      float s[8][4] = {}, dp[8][4] = {};
      rows_by_rows<D, 4>(s, qw, kLd, kb, kLd, lane);
      rows_by_rows<D, 4>(dp, dow, kLd, vb, kLd, lane);
      // dS, rounded to bf16 as the A operand over the 64 positions: k16
      // step c takes n8 tiles 2c (a0, a1) and 2c + 1 (a2, a3)
      uint32_t ds[4][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int j = j0 + 8 * nt + 2 * t;
          float d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = j + e <= lim[hf] ? expf(s[nt][2 * hf + e] * scale - lse_r[hf]) : 0.f;
            d[e] = p * (dp[nt][2 * hf + e] - del_r[hf]);
          }
          ds[nt >> 1][2 * (nt & 1) + hf] = mma::pack_bf16(d[0], d[1]);
        }
      // dQ += dS K: K as B[position][column], stored row-major, so .trans
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t bfr[4];
          mma::ldmatrix_x4_trans(bfr, kb + (16 * c + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLd +
                                          16 * np + 8 * (lane >> 4));
          mma::bf16_16816(acc[2 * np], ds[c], bfr[0], bfr[1]);
          mma::bf16_16816(acc[2 * np + 1], ds[c], bfr[2], bfr[3]);
        }
    }
    __syncthreads();  // before the next copy overwrites this buffer
  }
  mma::cp_async_wait<0>();
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = 16 * warp + g + 8 * hf;
    if (r >= nrows) continue;
    bf16* o = dq + row0 + r * ldq + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(o + 8 * n) =
          mma::pack_bf16(acc[n][2 * hf] * scale, acc[n][2 * hf + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// attn_bwd_dkdv: dK and dV of one 64-position block for one query head
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(256)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const int* __restrict__ kv_valid, const float* __restrict__ lse,
            const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
            float* __restrict__ work, int* __restrict__ tickets, int sq, int hq, int hkv,
            int skv, float scale, int causal) {
  constexpr int kLd = D + 8;
  constexpr int kNt = D / 16;  // n8 tiles of a warp's D/2 columns of dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // kPos x kLd
  bf16* vs = ks + kPos * kLd;                    // kPos x kLd
  bf16* qs = vs + kPos * kLd;                    // 2 x kTile x kLd, double-buffered
  bf16* dos = qs + 2 * kTile * kLd;              // 2 x kTile x kLd
  bf16* ps = dos + 2 * kTile * kLd;              // kTile x kPLd, bf16(P)
  bf16* dss = ps + kTile * kPLd;                 // kTile x kPLd, bf16(dS)
  __shared__ int is_last;
  const int pb = blockIdx.x, j0 = pb * kPos, head = blockIdx.y, b = blockIdx.z;
  const int group = hq / hkv, h = head / group;
  const int kv = kv_valid[b];
  const long long ldq = static_cast<long long>(hq) * D, ldk = static_cast<long long>(hkv) * D;
  const long long kv0 = (static_cast<long long>(b) * skv + j0) * ldk + h * D;
  const long long q0 = static_cast<long long>(b) * sq * ldq + head * D;
  const long long stat0 = (static_cast<long long>(b) * hq + head) * sq;
  const int valid = min(kPos, skv - j0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // the first query row that sees position j0 (and the rows after it do)
  const int first = causal ? max(0, j0 - (kv - sq)) : (j0 <= kv - 1 ? 0 : sq);
  const int ntiles = (sq + kTile - 1) / kTile;
  const int tile0 = first < sq ? first / kTile : ntiles;  // none when no row sees it

  copy_rows<D, 256>(ks, k + kv0, ldk, kPos, valid);
  copy_rows<D, 256>(vs, v + kv0, ldk, kPos, valid);
  if (tile0 < ntiles) {
    const int i0 = tile0 * kTile;
    copy_rows<D, 256>(qs, q + q0 + i0 * ldq, ldq, kTile, min(kTile, sq - i0));
    copy_rows<D, 256>(dos, dout + q0 + i0 * ldq, ldq, kTile, min(kTile, sq - i0));
  }
  mma::cp_async_commit();

  const int ra = 16 * (warp & 3), pa = 32 * (warp >> 2);      // S and dP of these
  const int pw = 16 * (warp & 3), cw = (D / 2) * (warp >> 2);  // dK and dV of these
  float acc_k[kNt][4], acc_v[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  int buf = 0;
  for (int tile = tile0; tile < ntiles; ++tile, buf ^= 1) {
    const int i0 = tile * kTile, nrows = min(kTile, sq - i0);
    if (tile + 1 < ntiles) {  // the next tile, into the other buffer
      const int in = i0 + kTile;
      copy_rows<D, 256>(qs + (buf ^ 1) * kTile * kLd, q + q0 + in * ldq, ldq, kTile,
                        min(kTile, sq - in));
      copy_rows<D, 256>(dos + (buf ^ 1) * kTile * kLd, dout + q0 + in * ldq, ldq, kTile,
                        min(kTile, sq - in));
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // this tile's Q and dO (and K, V) have landed
    __syncthreads();
    const bf16* qb = qs + buf * kTile * kLd;
    const bf16* dob = dos + buf * kTile * kLd;
    {  // S and dP of rows ra.., positions pa..; bf16 P and dS to shared memory
      int lim[2];
      float lse_r[2], del_r[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = ra + g + 8 * hf;
        lim[hf] = r < nrows ? row_limit(kv, sq, i0 + r, causal, skv) : -1;
        lse_r[hf] = r < nrows ? lse[stat0 + i0 + r] : 0.f;
        del_r[hf] = r < nrows ? delta[stat0 + i0 + r] : 0.f;
      }
      const int wrow = min(ra + 15, nrows - 1);
      const int wlast = wrow >= ra ? row_limit(kv, sq, i0 + wrow, causal, skv) : -1;
      float s[4][4] = {}, dp[4][4] = {};
      if (j0 + pa <= wlast) {
        rows_by_rows<D, 2>(s, qb + ra * kLd, kLd, ks + pa * kLd, kLd, lane);
        rows_by_rows<D, 2>(dp, dob + ra * kLd, kLd, vs + pa * kLd, kLd, lane);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int c = pa + 8 * nt + 2 * t;
          float p[2], d[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            p[e] = j0 + c + e <= lim[hf] ? expf(s[nt][2 * hf + e] * scale - lse_r[hf]) : 0.f;
            d[e] = p[e] * (dp[nt][2 * hf + e] - del_r[hf]);
          }
          const int at = (ra + g + 8 * hf) * kPLd + c;
          *reinterpret_cast<uint32_t*>(ps + at) = mma::pack_bf16(p[0], p[1]);
          *reinterpret_cast<uint32_t*>(dss + at) = mma::pack_bf16(d[0], d[1]);
        }
    }
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q over the tile's rows that see the block
    // (k16 steps; the rows before ``first`` see none of it)
    const int kk0 = max(0, first - i0) / 16, kk1 = (nrows + 15) / 16;
    for (int kk = kk0; kk < kk1; ++kk) {
      uint32_t ap[4], ad[4];
      const int at = (16 * kk + (lane & 7) + 8 * (lane >> 4)) * kPLd + pw + 8 * ((lane >> 3) & 1);
      mma::ldmatrix_x4_trans(ap, ps + at);
      mma::ldmatrix_x4_trans(ad, dss + at);
      const int row = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int np = 0; np + 1 < kNt; np += 2) {
        uint32_t bo[4], bq[4];
        const int col = cw + 8 * np + 8 * (lane >> 4);
        mma::ldmatrix_x4_trans(bo, dob + row * kLd + col);
        mma::ldmatrix_x4_trans(bq, qb + row * kLd + col);
        mma::bf16_16816(acc_v[np], ap, bo[0], bo[1]);
        mma::bf16_16816(acc_v[np + 1], ap, bo[2], bo[3]);
        mma::bf16_16816(acc_k[np], ad, bq[0], bq[1]);
        mma::bf16_16816(acc_k[np + 1], ad, bq[2], bq[3]);
      }
      if (kNt & 1) {  // D = 16: one n8 tile a warp
        uint32_t bo[2], bq[2];
        const int col = cw + 8 * (kNt - 1);
        mma::ldmatrix_x2_trans(bo, dob + row * kLd + col);
        mma::ldmatrix_x2_trans(bq, qb + row * kLd + col);
        mma::bf16_16816(acc_v[kNt - 1], ap, bo[0], bo[1]);
        mma::bf16_16816(acc_k[kNt - 1], ad, bq[0], bq[1]);
      }
    }
    __syncthreads();  // before the next copy and the next P, dS overwrite these
  }
  mma::cp_async_wait<0>();

  // this warp's positions pw + g + 8 hf, columns cw + 8 n + 2 t (+ 1)
  if (group == 1) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int p = pw + g + 8 * hf;
      if (p >= valid) continue;
      const long long at = kv0 + p * ldk + cw + 2 * t;
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        *reinterpret_cast<uint32_t*>(dk + at + 8 * n) =
            mma::pack_bf16(acc_k[n][2 * hf] * scale, acc_k[n][2 * hf + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + at + 8 * n) =
            mma::pack_bf16(acc_v[n][2 * hf], acc_v[n][2 * hf + 1]);
      }
    }
    return;
  }
  // G > 1: this head's f32 partials, then the last head block of (pb, h, b)
  // sums all G of them in head order
  const long long slot = (static_cast<long long>(b) * hkv + h) * gridDim.x + pb;
  constexpr int kPart = 2 * kPos * D;  // one head's dK and dV partials
  float* mine = work + (slot * group + head % group) * kPart;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int p = pw + g + 8 * hf;
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      const int at = p * D + cw + 8 * n + 2 * t;
      *reinterpret_cast<float2*>(mine + at) = make_float2(acc_k[n][2 * hf], acc_k[n][2 * hf + 1]);
      *reinterpret_cast<float2*>(mine + kPos * D + at) =
          make_float2(acc_v[n][2 * hf], acc_v[n][2 * hf + 1]);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int n = atomicAdd(tickets + slot, 1);
    is_last = n == group - 1;
    if (is_last) tickets[slot] = 0;  // every head block has taken its ticket
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* parts = work + slot * group * kPart;
  for (int idx = threadIdx.x; idx < valid * (D / 4); idx += 256) {
    const int at = idx * 4;  // position at / D, columns at % D ..
    float4 sk = __ldcg(reinterpret_cast<const float4*>(parts + at));
    float4 sv = __ldcg(reinterpret_cast<const float4*>(parts + kPos * D + at));
    for (int hd = 1; hd < group; ++hd) {
      const float4 pk = __ldcg(reinterpret_cast<const float4*>(parts + hd * kPart + at));
      const float4 pv = __ldcg(reinterpret_cast<const float4*>(parts + hd * kPart + kPos * D + at));
      sk.x += pk.x; sk.y += pk.y; sk.z += pk.z; sk.w += pk.w;
      sv.x += pv.x; sv.y += pv.y; sv.z += pv.z; sv.w += pv.w;
    }
    const long long out = kv0 + (at / D) * ldk + at % D;
    *reinterpret_cast<uint2*>(dk + out) =
        make_uint2(mma::pack_bf16(sk.x * scale, sk.y * scale), mma::pack_bf16(sk.z * scale, sk.w * scale));
    *reinterpret_cast<uint2*>(dv + out) =
        make_uint2(mma::pack_bf16(sv.x, sv.y), mma::pack_bf16(sv.z, sv.w));
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
int run_delta(const bf16* out, const bf16* dout, float* delta, int b, int sq, int hq,
              cudaStream_t stream) {
  const int rows = b * sq;
  delta_kernel<D><<<(rows + kDeltaWarps - 1) / kDeltaWarps, kDeltaWarps * 32, 0, stream>>>(
      out, dout, delta, rows, sq, hq);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run_dq(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const int* kv_valid,
           const float* lse, const float* delta, bf16* dq, int b, int sq, int hq, int hkv,
           int skv, float scale, int causal, cudaStream_t stream) {
  const size_t smem = (2 * kTile + 4 * kPos) * (D + 8) * sizeof(bf16);
  static bool done[64] = {};
  if (int e = prepare(dq_kernel<D>, smem, done)) return e;
  dq_kernel<D><<<dim3((sq + kTile - 1) / kTile, hq, b), 128, smem, stream>>>(
      q, k, v, dout, kv_valid, lse, delta, dq, sq, hq, hkv, skv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int run_dkdv(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
             const int* kv_valid, const float* lse, const float* delta, bf16* dk, bf16* dv,
             float* work, int* tickets, int b, int sq, int hq, int hkv, int skv, float scale,
             int causal, cudaStream_t stream) {
  if (hq != hkv && (work == nullptr || tickets == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ((2 * kPos + 4 * kTile) * (D + 8) + 2 * kTile * kPLd) * sizeof(bf16);
  static bool done[64] = {};
  if (int e = prepare(dkdv_kernel<D>, smem, done)) return e;
  dkdv_kernel<D><<<dim3((skv + kPos - 1) / kPos, hq, b), 256, smem, stream>>>(
      q, k, v, dout, kv_valid, lse, delta, dk, dv, work, tickets, sq, hq, hkv, skv, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each returns the CUDA error of
// its launch (0 on success); it launches on ``stream`` and does not wait.

extern "C" int attn_bwd_delta(const void* out, const void* dout, void* delta, int b, int sq,
                              int hq, int d, void* stream) {
#define CALL(D)                                                                             \
  run_delta<D>(static_cast<const bf16*>(out), static_cast<const bf16*>(dout),               \
               static_cast<float*>(delta), b, sq, hq, static_cast<cudaStream_t>(stream))
  switch (d) {
    case 16: return CALL(16);
    case 64: return CALL(64);
    case 96: return CALL(96);
    case 128: return CALL(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CALL
}

// attn_bwd_dkdv's ``work`` and ``tickets`` (see the layouts above) may be
// null when hq == hkv; the tickets start at 0 and the call leaves them at 0.
extern "C" int attn_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                             const void* kv_valid, const void* lse, const void* delta, void* dk,
                             void* dv, void* work, void* tickets, int b, int sq, int hq, int hkv,
                             int d, int skv, float scale, int causal, void* stream) {
#define CALL(D)                                                                             \
  run_dkdv<D>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),                     \
              static_cast<const bf16*>(v), static_cast<const bf16*>(dout),                  \
              static_cast<const int*>(kv_valid), static_cast<const float*>(lse),            \
              static_cast<const float*>(delta), static_cast<bf16*>(dk),                     \
              static_cast<bf16*>(dv), static_cast<float*>(work), static_cast<int*>(tickets), \
              b, sq, hq, hkv, skv, scale, causal, static_cast<cudaStream_t>(stream))
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
