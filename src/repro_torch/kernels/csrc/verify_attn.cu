// SLED verification attention for Hopper (sm_90a): dense and paged KV,
// bf16 or int8 cache.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/verify_attn.py:
//   verify_attention_packed (body _kernel -> _attend_chunk)       : dense KV
//   verify_attention_paged, bf16 branch (_paged_kernel -> _attend_chunk): pool KV
//   verify_attention_paged, int8 branch (_paged_quant_kernel)     : int8 pool KV
// One template serves all: the dense entry reads cache row b for batch
// entry b; the paged entry reads pool row slots[b], which each block loads
// itself from a device int32 vector (the TPU kernel's scalar prefetch).
// An int8 cache adds one load path: each raw int8 K/V tile is dequantized in
// shared memory as (int8 -> f32 * scale[row, h]) -> bf16, the rounding of the
// JAX package's kv_dequant. The dense entry takes int8 too: the JAX package's
// XLA path dequantizes dense int8 caches in its chunk loop, and the slot
// prefill and lock-step reference read such caches.
//
// Math (that of _attend_chunk): for batch entry b and KV head h the Sq*G
// query rows are packed as r = i*G + g (query i, head h*G + g). Query i sits
// at absolute position kv_valid[b] - Sq + i, so KV position j is visible iff
// j <= kv_valid[b] - Sq + i and j < Skv. A non-causal call (causal == 0:
// the encdec family's encoder over fresh K/V and its cross-attention over
// the cross_k/cross_v leaves; the JAX package's flash_attention with
// causal=False) gives every row the limit kv_valid[b] - 1 instead, in the
// same splits, merge order and FMA chains. The softmax runs online over
// 64-position chunks with f32 running max m, sum l and accumulator; scores
// are f32 sums of bf16 products, and P is rounded to bf16 before the P.V
// product (p.astype(v.dtype)). A row that sees no position gives 0.
//
// Bound on an H100: bytes. A verify step does O(Sq*G) work per cached K/V
// element, far below the ~295 flop/byte ridge of bf16 on this card, so the
// least time is one read of the visible K/V rows (and q, out) at 3.35 TB/s;
// an int8 cache halves those bytes. At serving shapes (B*Hkv = 2..12 (b, h)
// pairs, ~230 positions) the call is latency bound, and the design puts
// more SMs on the read and keeps each block's chain short:
//   - Split-KV. Block (split, row tile, b, h) owns kSplit = 64 KV positions
//     of one (b, h) and a 32-row tile of its packed query rows (a verify
//     step's 30 rows are one tile, a 199-token prefill's 1,194 rows are 38;
//     64-row tiles measured slower, PERF.md). The packing is generic in G:
//     at G = 48 (MQA, 48 query heads on one KV head) a query's rows span two
//     tiles, and a tile reads as far as its last row's query sees, each row
//     masked at its own limit. The split length is a
//     compile-time constant and the merge runs in split order, so a row's
//     result depends only on its own row, its kv_valid and the cache: the
//     same row gives the same bits at any B. A block whose split starts past
//     its tile's limit (the causal one, or kv_valid - 1) exits at once.
//   - The plain version's arithmetic, in its order. A split is one of the
//     plain version's 64-position chunks (its default block_k): P is rounded
//     at the running max through the split (each split publishes its rows'
//     local maxima and reads those of the splits before it), and each score
//     and each P.V output is one f32 FMA chain over d or over the chunk's
//     positions in order, as the plain version's f32 products sum on the
//     card; the row sum takes the plain version's order too, and the merge
//     is its rescaling chain. So the kernel gives the plain version's bits,
//     which chip_smoke.py's 2e-3 bound (under one bf16 ulp above 0.5)
//     requires. This is why both products run on the CUDA cores: on
//     mma.sync the tensor cores sum in their own order, a few P values per
//     call round the other way, and outputs above 0.5 move by a bf16 ulp
//     (0.0039). The products run as register tiles (4 rows x 4 positions,
//     and for P.V 4 rows x D/16 columns at D = 64 and 128, 2 rows x 12
//     columns at D = 96, 1 row x 4 columns at D = 16: PvLayout) on f32
//     tiles in shared memory, and the softmax on
//     the score tile in registers (a row's 64 positions across the 16
//     lanes of a half-warp).
//   - cp.async: the K rows of both 32-position chunks of a split go out in
//     one group and the V rows in a second, so the scores are computed while
//     V is still in flight. Positions past the tile's limit are zero-filled.
//   - The merge, in the same launch: every split but the tile's last writes
//     its f32 partial (m_s, l_s, acc_s) to a scratch buffer the wrapper
//     allocates; the last split waits for them and merges in split order as
//     the plain version's online softmax does, acc = acc * e^{m_prev - m_s}
//     + acc_s and l likewise (a product and a sum, each rounded), then
//     returns the tile's flags to zero. out = acc / max(l, 1e-30). When the
//     caller asks for it (training's forward, whose backward needs it), the
//     same block also writes each row's log-sum-exp m + log l, 0 for a row
//     that sees no position; a serve asks for none and its out is unchanged.
//   - The shard form (verify_attn_bf16_shard; the JAX package's
//     flash_attention(pos_offset=, return_stats=True) inside
//     sp_append_attend): the cache is one sequence shard whose position 0 is
//     the global position pos_offset, so every limit above moves down by
//     pos_offset and kv_valid may pass Skv. The output is the merge's f32
//     acc / max(l, 1e-30), normalised over the shard and never rounded to
//     bf16, and the LSE of a row that sees nothing in the shard is -inf, so
//     that the cross-shard combine weighs it 0. The splits, the merge and
//     every FMA chain are the other forms'.
//   - Forward progress: a block waits only for blocks of lower split index,
//     and blocks take their index from a device counter in the order they
//     start, so every block waited for is already running.
//
// Layouts: q and out are (B, Sq, Hq, D) contiguous bf16. k and v are any
// strided view whose last dimension is contiguous: a stacked cache buffer
// (L, rows, Skv, Hkv, D) addressed by (layer, row) without a copy, with the
// strides in elements. An int8 cache's scales are the stacked (L, rows, Hkv)
// f32 leaves, addressed by the same (layer, row) with their own strides and
// the head contiguous. kv_valid and slots are (B,) int32 on the device. The
// LSE, where asked for, is (B, Hq, Sq) f32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (src/repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 128;             // 4 warps
constexpr int kTileRows = 32;             // packed query rows per block: rq + 8v, v < 4
constexpr int kBlockK = 32;               // KV positions per chunk
constexpr int kSplit = 64;                // KV positions per split (a plain version's chunk)
constexpr int kChunks = kSplit / kBlockK; // chunks per split, each with its own buffer
constexpr float kNegInf = -1e30f;

// P.V's thread tile: kCols groups of kDC adjacent output columns (a
// multiple of 4: float4 reads, stores and partials) by kRowGroups groups of
// rows, kRows rows a thread (rows rp + kRowGroups*i, thread tid =
// rp*kCols + cp). kCols is the most groups, of 16, 8 or 4, whose width is a
// multiple of 4. At D = 64 and 128 that is the scores' tile: 16 column
// groups and 8 row groups of 4 rows (rp, cp = the score tile's rq, cq). At
// D = 96 (phi3-mini; 16 groups would be 6 columns wide) it is 8 groups of
// 12 columns by 16 row groups of 2 rows, and at D = 16 (the reduced
// configs) 4 groups of 4 columns by 32 row groups of 1 row: neither is the
// scores' tile. Each output is one f32 FMA chain over positions in order at
// every D.
template <int D>
struct PvLayout {
  static constexpr int kCols = (D / 16) % 4 == 0 ? 16 : (D / 8) % 4 == 0 ? 8 : D / 4;
  static constexpr int kDC = D / kCols;
  static constexpr int kRowGroups = kThreads / kCols;
  static constexpr int kRows = kTileRows / kRowGroups;
  static_assert(kDC % 4 == 0 && kRowGroups * kRows == kTileRows, "P.V tile");
};

// Shared memory of one block (dynamic). The copies land in bf16 (or raw
// int8) tiles; K and then V are widened to f32 in kv (V once the scores are
// taken); qs holds the tile's query rows in f32 and then the scores, which
// become P in place. f32 rows are padded by 4 floats so that float4 reads of
// consecutive rows hit different banks.
template <int D>
struct Tiles {
  float kv[kSplit][D + 4];
  union {
    float q[kTileRows][D + 4];
    float s[kTileRows][kSplit + 1];
  } qs;
  float row_m[kTileRows];  // each row's running max through this split
  float row_l[kTileRows];  // and its sum of P
};

template <int D, typename KV>
struct Smem : Tiles<D> {
  __nv_bfloat16 raw[2][kChunks][kBlockK][D + 8];  // [K, V] as copied
};

template <int D>
struct Smem<D, int8_t> : Tiles<D> {
  int8_t raw[2][kChunks][kBlockK][D];
};

// Issue the cp.async copies of rows j_begin.. (which == 0: K, 1: V).
template <int D, typename KV>
__device__ void load_rows(Smem<D, KV>& sm, int which, const KV* base, int j_begin, int kv_end,
                          int n_chunks, long long s_seq) {
  constexpr int VEC = 16 / sizeof(KV);  // elements per 16-byte copy
  constexpr int NV = D / VEC;
  for (int idx = threadIdx.x; idx < n_chunks * kBlockK * NV; idx += kThreads) {
    const int jj = idx / NV, e = (idx % NV) * VEC, j = j_begin + jj;
    const bool live = j < kv_end;
    mma::cp_async16(&sm.raw[which][jj / kBlockK][jj % kBlockK][e],
                    base + (live ? j * s_seq + e : 0), live);
  }
  mma::cp_async_commit();
}

// The split's K (which == 0) or V rows in f32: a bf16 cache widened, an
// int8 cache as (f32(q) * s) rounded to bf16 (round to nearest even, the JAX
// package's kv_dequant) and widened; positions past the copied chunks are 0.
template <int D, typename KV>
__device__ void widen(Smem<D, KV>& sm, int which, int n_chunks, float scale) {
  constexpr int NV = D / 8;
  for (int idx = threadIdx.x; idx < kSplit * NV; idx += kThreads) {
    const int p = idx / NV, e = (idx % NV) * 8;
    const int c = p / kBlockK, r = p % kBlockK;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (p < n_chunks * kBlockK) {
      if constexpr (sizeof(KV) == 1) {
        const uint2 w = *reinterpret_cast<const uint2*>(&sm.raw[which][c][r][e]);
        const int8_t* qv = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          f[i] = __bfloat162float(__float2bfloat16(static_cast<float>(qv[i]) * scale));
        }
      } else {
        const uint4 w = *reinterpret_cast<const uint4*>(&sm.raw[which][c][r][e]);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 x = __bfloat1622float2(h2[i]);
          f[2 * i] = x.x;
          f[2 * i + 1] = x.y;
        }
      }
    }
    float4* dst = reinterpret_cast<float4*>(&sm.kv[p][e]);
    dst[0] = make_float4(f[0], f[1], f[2], f[3]);
    dst[1] = make_float4(f[4], f[5], f[6], f[7]);
  }
}

// Raise a flag once every thread's device-memory writes are done: the
// barrier orders them before thread 0's release store.
__device__ __forceinline__ void publish(int* flag, int value) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("st.release.gpu.global.b32 [%0], %1;\n" :: "l"(flag), "r"(value) : "memory");
  }
}

// Wait until flags[0..n) all reach at least value (warp 0 polls them side by
// side, a lane per flag, with acquire loads); the barrier then orders every
// thread's reads after them.
__device__ __forceinline__ void wait_for(const int* flags, int n, int value) {
  if (threadIdx.x < 32) {
    for (int i = threadIdx.x; i < n; i += 32) {
      int seen;
      do {
        asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(seen) : "l"(flags + i)
                     : "memory");
      } while (seen < value);
    }
    __syncwarp();
  }
  __syncthreads();
}

// Q.K^T for rows r, r + 8, ... (NV of them) and positions cq + 16u (u < 4):
// each score one f32 FMA chain over d in order.
template <int NV, int D>
__device__ __forceinline__ void qk_rows(const float (*q)[D + 4], const float (*k)[D + 4], int r,
                                        int cq, float (&a)[4][4]) {
#pragma unroll
  for (int vv = 0; vv < 4; ++vv) {
#pragma unroll
    for (int u = 0; u < 4; ++u) a[vv][u] = 0.f;
  }
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 qv[NV], kv[4];
#pragma unroll
    for (int vv = 0; vv < NV; ++vv) qv[vv] = *reinterpret_cast<const float4*>(&q[r + 8 * vv][d]);
#pragma unroll
    for (int u = 0; u < 4; ++u) kv[u] = *reinterpret_cast<const float4*>(&k[cq + 16 * u][d]);
#pragma unroll
    for (int vv = 0; vv < NV; ++vv) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float& x = a[vv][u];
        x = fmaf(qv[vv].x, kv[u].x, x);
        x = fmaf(qv[vv].y, kv[u].y, x);
        x = fmaf(qv[vv].z, kv[u].z, x);
        x = fmaf(qv[vv].w, kv[u].w, x);
      }
    }
  }
}

// acc += P.V for rows r + RG*i (i < NV; RG the row groups) and columns
// cq*DC .. cq*DC + DC over positions c < nc: each output one f32 FMA chain
// over c in order.
template <int NV, int D>
__device__ __forceinline__ void pv_rows(const float (*p)[kSplit + 1], const float (*v)[D + 4],
                                        int r, int cq, int nc,
                                        float (&acc)[PvLayout<D>::kRows][PvLayout<D>::kDC]) {
  constexpr int DC = PvLayout<D>::kDC, RG = PvLayout<D>::kRowGroups;
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    float vr[DC], pr[NV];
#pragma unroll
    for (int e = 0; e < DC; e += 4) {
      const float4 x = *reinterpret_cast<const float4*>(&v[c][cq * DC + e]);
      vr[e] = x.x;
      vr[e + 1] = x.y;
      vr[e + 2] = x.z;
      vr[e + 3] = x.w;
    }
#pragma unroll
    for (int vv = 0; vv < NV; ++vv) pr[vv] = p[r + RG * vv][c];
#pragma unroll
    for (int vv = 0; vv < NV; ++vv) {
#pragma unroll
      for (int e = 0; e < DC; ++e) acc[vv][e] = fmaf(pr[vv], vr[e], acc[vv][e]);
    }
  }
}

// P.V for a thread's nv row groups (nv a template argument inside, so the
// inner loops carry no branch; never more than the layout's kRows).
template <int D>
__device__ __forceinline__ void pv_tile(const float (*p)[kSplit + 1], const float (*v)[D + 4],
                                        int r, int cq, int nc, int nv,
                                        float (&acc)[PvLayout<D>::kRows][PvLayout<D>::kDC]) {
  if constexpr (PvLayout<D>::kRows == 1) {
    pv_rows<1, D>(p, v, r, cq, nc, acc);
  } else if constexpr (PvLayout<D>::kRows == 2) {
    if (nv == 1) {
      pv_rows<1, D>(p, v, r, cq, nc, acc);
    } else {
      pv_rows<2, D>(p, v, r, cq, nc, acc);
    }
  } else {
    static_assert(PvLayout<D>::kRows == 4, "P.V rows per thread");
    switch (nv) {
      case 1: pv_rows<1, D>(p, v, r, cq, nc, acc); break;
      case 2: pv_rows<2, D>(p, v, r, cq, nc, acc); break;
      case 3: pv_rows<3, D>(p, v, r, cq, nc, acc); break;
      default: pv_rows<4, D>(p, v, r, cq, nc, acc); break;
    }
  }
}

template <int D, typename KV>
__global__ void __launch_bounds__(kThreads)
verify_attn_kernel(const __nv_bfloat16* __restrict__ q,
                   const KV* __restrict__ k,
                   const KV* __restrict__ v,
                   const float* __restrict__ k_scale,  // int8 only: row-addressed
                   const float* __restrict__ v_scale,  // (rows, Hkv) of the layer
                   const int* __restrict__ kv_valid,
                   const int* __restrict__ slots,
                   __nv_bfloat16* __restrict__ out,
                   float* __restrict__ out_f32,   // the shard form's output, else null
                   float* __restrict__ lse,       // (B, Hq, Sq) or null
                   float* __restrict__ part_acc,  // [tile, split][thread][kRows][kDC]
                   float* __restrict__ part_ml,   // [tile, split][row] (m, l)
                   float* __restrict__ part_lm,   // [tile, split][row] local max
                   int* __restrict__ sync,        // block counter, then [tile][split] flags
                   int n_split, int n_tiles, int sq, int hq, int hkv, int skv,
                   long long s_row, long long s_seq, long long s_head,
                   long long sc_row, float scale, int causal, int pos_offset) {
  using PV = PvLayout<D>;
  constexpr int D2 = D / 2;
  constexpr int DC = PV::kDC;  // output columns per thread in P.V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D, KV>& sm = *reinterpret_cast<Smem<D, KV>*>(smem_raw);
  __shared__ int bid_s;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {  // block index in start order: blocks waited for are running
    const int id = atomicAdd(sync, 1);
    if (id == static_cast<int>(gridDim.x) - 1) *sync = 0;  // every block has its index
    bid_s = id;
  }
  __syncthreads();
  const int split = bid_s % n_split;
  const int tile = (bid_s / n_split) % n_tiles;
  const int bh = bid_s / (n_split * n_tiles);
  const int b = bh / hkv, h = bh % hkv;
  const int group = hq / hkv;
  const int n_rows = sq * group;
  const int r0 = tile * kTileRows;
  const int rn = min(kTileRows, n_rows - r0);
  const int valid = kv_valid[b];
  const long long row = slots != nullptr ? static_cast<long long>(slots[b])
                                         : static_cast<long long>(b);
  // the last position query i sees: its own (causal) or the row's last,
  // counted from the shard's first position (pos_offset 0 but in the shard
  // form)
  auto limit = [&](int i) { return (causal ? valid - sq + i : valid - 1) - pos_offset; };
  const bool shard = out_f32 != nullptr;
  // the LSE of a row that sees no position: 0 (training), -inf (the shard
  // form: no weight in the combine)
  const float lse_empty = shard ? -__int_as_float(0x7f800000) : 0.f;
  // the tile's last row sets how far its blocks must read
  const int kv_end = max(0, min(skv, limit((r0 + rn - 1) / group) + 1));
  const int n_live = (kv_end + kSplit - 1) / kSplit;
  const int tile_id = bh * n_tiles + tile;
  int* flags = sync + 1 + static_cast<long long>(tile_id) * n_split;
  const long long part0 = static_cast<long long>(tile_id) * n_split;

  auto row_of = [&](int r) {  // packed row r of the tile -> its (b, i, head) offset
    const int pr = r0 + r;
    return ((static_cast<long long>(b) * sq + pr / group) * hq + h * group + pr % group) * D;
  };
  auto lse_of = [&](int r) {  // and its (b, head, i) entry of the (B, Hq, Sq) LSE
    const int pr = r0 + r;
    return (static_cast<long long>(b) * hq + h * group + pr % group) * sq + pr / group;
  };
  if (n_live == 0) {  // no row of the tile sees a position: zeros (and the empty LSE)
    if (split == 0) {
      for (int idx = tid; idx < rn * D2; idx += kThreads) {
        if (shard) {
          reinterpret_cast<float2*>(out_f32 + row_of(idx / D2))[idx % D2] = make_float2(0.f, 0.f);
        } else {
          reinterpret_cast<uint32_t*>(out + row_of(idx / D2))[idx % D2] = 0u;
        }
      }
      if (lse != nullptr && tid < rn) lse[lse_of(tid)] = lse_empty;
    }
    return;
  }
  if (split >= n_live) return;
  const bool last = split == n_live - 1;
  const int j_begin = split * kSplit;
  const int n_chunks = (min(j_begin + kSplit, kv_end) - j_begin + kBlockK - 1) / kBlockK;
  load_rows(sm, 0, k + row * s_row + h * s_head, j_begin, kv_end, n_chunks, s_seq);
  load_rows(sm, 1, v + row * s_row + h * s_head, j_begin, kv_end, n_chunks, s_seq);
  // the tile's query rows as f32 (all loads issued before any store), while
  // the copies are in flight
  {
    constexpr int QPT = kTileRows * D2 / kThreads;  // bf16 pairs per thread
    uint32_t qv[QPT];
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      const int r = (u * kThreads + tid) / D2, dp = (u * kThreads + tid) % D2;
      qv[u] = r < rn ? __ldg(reinterpret_cast<const unsigned int*>(q + row_of(r)) + dp) : 0u;
    }
#pragma unroll
    for (int u = 0; u < QPT; ++u) {
      const int r = (u * kThreads + tid) / D2, dp = (u * kThreads + tid) % D2;
      *reinterpret_cast<float2*>(&sm.qs.q[r][2 * dp]) =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qv[u]));
    }
  }
  mma::cp_async_wait<1>();  // K has landed (V may still be in flight)
  __syncthreads();
  widen(sm, 0, n_chunks, sizeof(KV) == 1 ? k_scale[row * sc_row + h] : 1.f);
  __syncthreads();

  // Thread tile of the two products: rows rq + 8v (v < nv, nv = the tile's
  // real rows / 8 rounded up, a template argument so the inner loops carry
  // no branch).
  const int rq = warp * 2 + lane / 16, cq = lane % 16;
  const int nv = (rn + 7) / 8;

  // S = Q K^T, each score one f32 FMA chain over d in order (the plain
  // version's order: its scores bit for bit). Columns: positions cq + 16u.
  // The softmax then runs on the scores in registers: a row's 64 positions
  // sit with the 16 lanes of equal lane / 16.
  float a[4][4];
  switch (nv) {
    case 1: qk_rows<1, D>(sm.qs.q, sm.kv, rq, cq, a); break;
    case 2: qk_rows<2, D>(sm.qs.q, sm.kv, rq, cq, a); break;
    case 3: qk_rows<3, D>(sm.qs.q, sm.kv, rq, cq, a); break;
    default: qk_rows<4, D>(sm.qs.q, sm.kv, rq, cq, a); break;
  }
  // scale and mask as the plain version does; each row's local max
  int lim[4];  // last position (split-relative) each row sees
#pragma unroll
  for (int vv = 0; vv < 4; ++vv) {
    if (vv >= nv) continue;
    const int r = rq + 8 * vv;
    lim[vv] = min(limit((r0 + r) / group), skv - 1) - j_begin;
    float mx = kNegInf;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[vv][u] = cq + 16 * u <= lim[vv] ? a[vv][u] * scale : kNegInf;
      mx = fmaxf(mx, a[vv][u]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (cq == 0 && r < rn) {
      sm.row_m[r] = mx;
      if (!last) part_lm[(part0 + split) * kTileRows + r] = mx;
    }
  }
  mma::cp_async_wait<0>();  // V has landed
  __syncthreads();          // every thread is done with the query rows and K
  widen(sm, 1, n_chunks, sizeof(KV) == 1 ? v_scale[row * sc_row + h] : 1.f);
  // the running max through this split: its own and every earlier split's
  if (!last) publish(&flags[split], 1);
  if (split > 0) {
    wait_for(flags, split, 1);
    if (tid < rn) {
      float m = sm.row_m[tid];
      for (int sp = 0; sp < split; ++sp) m = fmaxf(m, __ldcg(&part_lm[(part0 + sp) * kTileRows + tid]));
      sm.row_m[tid] = m;
    }
  }
  __syncthreads();  // V in f32 and the running maxima are in shared memory
  // P = exp(S - m) rounded to bf16 (masked positions weigh exactly 0) into
  // shared memory; l is the sum of the unrounded values in the order the
  // plain version's sum over a 64-position chunk adds: position c with
  // c + 32, then a butterfly over c (here over the row's 16 lanes, each
  // holding c and c + 16)
#pragma unroll
  for (int vv = 0; vv < 4; ++vv) {
    if (vv >= nv) continue;
    const int r = rq + 8 * vv;
    const float m = sm.row_m[min(r, rn - 1)];
    float p[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      p[u] = cq + 16 * u <= lim[vv] ? expf(a[vv][u] - m) : 0.f;
      sm.qs.s[r][cq + 16 * u] = __bfloat162float(__float2bfloat16(p[u]));
    }
    float sum = (p[0] + p[2]) + (p[1] + p[3]);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (cq == 0 && r < rn) sm.row_l[r] = sum;
  }
  __syncthreads();  // P and the row sums are in shared memory

  // acc = P V, each output one f32 FMA chain over the split's positions in
  // order (the plain version's order within its chunk). The thread's rows
  // rp + RG*i and columns cp*DC.. (PvLayout; rq and cq at D = 64 and 128)
  constexpr int RG = PV::kRowGroups;
  const int rp = tid / PV::kCols, cp = tid % PV::kCols;
  const int nvp = (rn + RG - 1) / RG;
  float acc[PV::kRows][DC];
#pragma unroll
  for (int vv = 0; vv < PV::kRows; ++vv) {
#pragma unroll
    for (int e = 0; e < DC; ++e) acc[vv][e] = 0.f;
  }
  pv_tile<D>(sm.qs.s, sm.kv, rp, cp, n_chunks * kBlockK, nvp, acc);

  // Merge in split order as the plain version's online softmax does: per
  // split, acc = acc * e^{m_prev - m} + acc_s and l = l * e^{m_prev - m} + l_s
  // (a product and a sum, each rounded). Every split but the last writes its
  // partial to device memory; the last merges them and its own.
  float4* pacc = reinterpret_cast<float4*>(part_acc);
  float2* pml = reinterpret_cast<float2*>(part_ml);
  constexpr int F4 = PV::kRows * DC / 4;  // float4 of accumulators per thread
  if (n_live > 1 && !last) {
    float4* dst = &pacc[((part0 + split) * kThreads + tid) * F4];
#pragma unroll
    for (int vv = 0; vv < PV::kRows; ++vv) {
      if (vv >= nvp) continue;  // rows the tile does not have
#pragma unroll
      for (int e = 0; e < DC; e += 4) {
        dst[(vv * DC + e) / 4] =
            make_float4(acc[vv][e], acc[vv][e + 1], acc[vv][e + 2], acc[vv][e + 3]);
      }
    }
    if (tid < kTileRows) {
      pml[(part0 + split) * kTileRows + tid] = make_float2(sm.row_m[tid], sm.row_l[tid]);
    }
    publish(&flags[split], 2);
    return;
  }
  if (n_live > 1) {
    wait_for(flags, split, 2);
    if (tid == 0) {
      for (int sp = 0; sp < split; ++sp) flags[sp] = 0;  // every reader is done with them
    }
  }
  // per split, every row's loads go out together: one round trip a split
  float o[PV::kRows][DC], lt[PV::kRows], m_prev[PV::kRows];
#pragma unroll
  for (int vv = 0; vv < PV::kRows; ++vv) {
    lt[vv] = 0.f;
    m_prev[vv] = kNegInf;
#pragma unroll
    for (int e = 0; e < DC; ++e) o[vv][e] = 0.f;
  }
  for (int sp = 0; sp <= split; ++sp) {
    float2 ml[PV::kRows];
    float x[PV::kRows][DC];
#pragma unroll
    for (int vv = 0; vv < PV::kRows; ++vv) {
      const int r = min(rp + RG * vv, rn - 1);  // rows past rn: any real row
      if (sp < split && vv < nvp) {
        ml[vv] = __ldcg(&pml[(part0 + sp) * kTileRows + r]);
        const float4* src = &pacc[((part0 + sp) * kThreads + tid) * F4 + vv * DC / 4];
#pragma unroll
        for (int e = 0; e < DC; e += 4) {
          const float4 y = __ldcg(src + e / 4);
          x[vv][e] = y.x;
          x[vv][e + 1] = y.y;
          x[vv][e + 2] = y.z;
          x[vv][e + 3] = y.w;
        }
      } else {  // this split (or rows the tile does not have)
        ml[vv] = make_float2(sm.row_m[r], sm.row_l[r]);
#pragma unroll
        for (int e = 0; e < DC; ++e) x[vv][e] = acc[vv][e];
      }
    }
#pragma unroll
    for (int vv = 0; vv < PV::kRows; ++vv) {
      const float corr = expf(m_prev[vv] - ml[vv].x);
      lt[vv] = __fadd_rn(__fmul_rn(lt[vv], corr), ml[vv].y);
#pragma unroll
      for (int e = 0; e < DC; ++e) o[vv][e] = __fadd_rn(__fmul_rn(o[vv][e], corr), x[vv][e]);
      m_prev[vv] = ml[vv].x;
    }
  }
#pragma unroll
  for (int vv = 0; vv < PV::kRows; ++vv) {
    const int r = rp + RG * vv;
    if (r >= rn) continue;
    const float den = fmaxf(lt[vv], 1e-30f);
    if (shard) {
      float4* dst = reinterpret_cast<float4*>(out_f32 + row_of(r) + cp * DC);
#pragma unroll
      for (int e = 0; e < DC; e += 4) {
        dst[e / 4] = make_float4(o[vv][e] / den, o[vv][e + 1] / den, o[vv][e + 2] / den,
                                 o[vv][e + 3] / den);
      }
    } else {
      uint32_t* dst = reinterpret_cast<uint32_t*>(out + row_of(r) + cp * DC);
#pragma unroll
      for (int e = 0; e < DC; e += 2) {
        dst[e / 2] = mma::pack_bf16(o[vv][e] / den, o[vv][e + 1] / den);
      }
    }
    // the row's log-sum-exp from the merge's max and sum (the empty LSE where
    // the row sees no position), for the backward and the shards' combine
    if (lse != nullptr && cp == 0) {
      lse[lse_of(r)] = lt[vv] > 0.f ? m_prev[vv] + logf(lt[vv]) : lse_empty;
    }
  }
}

template <int D, typename KV>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* kv_valid, const void* slots, void* out,
           void* out_f32, void* lse, void* part, void* sync, int b, int sq, int hq, int hkv,
           int skv, long long layer, long long s_layer, long long s_row, long long s_seq,
           long long s_head, long long sc_layer, long long sc_row, float scale, int causal,
           int pos_offset, cudaStream_t stream) {
  const int n_tiles = (sq * (hq / hkv) + kTileRows - 1) / kTileRows;
  const int n_split = (skv + kSplit - 1) / kSplit;
  const long long n_part = static_cast<long long>(b) * hkv * n_tiles * n_split;
  const KV* kl = static_cast<const KV*>(k) + layer * s_layer;
  const KV* vl = static_cast<const KV*>(v) + layer * s_layer;
  const float* ksl = k_scale != nullptr ? static_cast<const float*>(k_scale) + layer * sc_layer
                                        : nullptr;
  const float* vsl = v_scale != nullptr ? static_cast<const float*>(v_scale) + layer * sc_layer
                                        : nullptr;
  // one buffer: the partials' accumulators, their (m, l), the local maxima
  float* part_acc = static_cast<float*>(part);
  float* part_ml = part_acc != nullptr ? part_acc + n_part * kTileRows * D : nullptr;
  float* part_lm = part_acc != nullptr ? part_ml + n_part * kTileRows * 2 : nullptr;
  // dynamic shared memory above 48 KB: raised once per device and instantiation
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(verify_attn_kernel<D, KV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(Smem<D, KV>)));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) smem_set[dev] = true;
  }
  verify_attn_kernel<D, KV><<<static_cast<unsigned>(n_part), kThreads, sizeof(Smem<D, KV>),
                              stream>>>(
      static_cast<const __nv_bfloat16*>(q), kl, vl, ksl, vsl,
      static_cast<const int*>(kv_valid), static_cast<const int*>(slots),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(out_f32), static_cast<float*>(lse),
      part_acc, part_ml, part_lm, static_cast<int*>(sync),
      n_split, n_tiles, sq, hq, hkv, skv, s_row, s_seq, s_head, sc_row, scale, causal,
      pos_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
int dispatch(const void* q, const void* k, const void* v, const void* k_scale,
             const void* v_scale, const void* kv_valid, const void* slots, void* out,
             void* out_f32, void* lse, void* part, void* sync, int b, int sq, int hq, int hkv,
             int d, int skv, long long layer, long long s_layer, long long s_row,
             long long s_seq, long long s_head, long long sc_layer, long long sc_row,
             float scale, int causal, int pos_offset, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch<16, KV>(q, k, v, k_scale, v_scale, kv_valid, slots, out, out_f32, lse, part,
                            sync, b, sq, hq, hkv, skv, layer, s_layer, s_row, s_seq, s_head,
                            sc_layer, sc_row, scale, causal, pos_offset, st);
    case 64:
      return launch<64, KV>(q, k, v, k_scale, v_scale, kv_valid, slots, out, out_f32, lse, part,
                            sync, b, sq, hq, hkv, skv, layer, s_layer, s_row, s_seq, s_head,
                            sc_layer, sc_row, scale, causal, pos_offset, st);
    case 96:
      return launch<96, KV>(q, k, v, k_scale, v_scale, kv_valid, slots, out, out_f32, lse, part,
                            sync, b, sq, hq, hkv, skv, layer, s_layer, s_row, s_seq, s_head,
                            sc_layer, sc_row, scale, causal, pos_offset, st);
    case 128:
      return launch<128, KV>(q, k, v, k_scale, v_scale, kv_valid, slots, out, out_f32, lse, part,
                             sync, b, sq, hq, hkv, skv, layer, s_layer, s_row, s_seq, s_head,
                             sc_layer, sc_row, scale, causal, pos_offset, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Scratch one call needs: *part_floats f32 for the split partials (0 when
// Skv fits one split) and *sync_ints int32 for the block counter and the
// flags, which must be zero before the call and are zero again after it.
extern "C" void verify_attn_scratch(int b, int sq, int hq, int hkv, int d, int skv,
                                    long long* part_floats, long long* sync_ints) {
  const long long n_tiles = (sq * (hq / hkv) + kTileRows - 1) / kTileRows;
  const long long n_split = (skv + kSplit - 1) / kSplit;
  const long long n_part = static_cast<long long>(b) * hkv * n_tiles * n_split;
  *part_floats = n_split > 1 ? n_part * kTileRows * (d + 3) : 0;
  *sync_ints = 1 + n_part;
}

// Plain C entry points (loaded with ctypes). slots == nullptr selects the
// dense layout (row b of the cache for batch entry b). part and sync are
// the scratch verify_attn_scratch sizes. causal != 0 selects the causal-offset
// mask, 0 the non-causal one (every j < kv_valid). The bf16 entry's lse, when
// not null, receives each query row's log-sum-exp, (B, Hq, Sq) f32 (the
// training forward's; a serve passes null). Each returns the CUDA error code
// of the launch (0 on success).
extern "C" int verify_attn_bf16(const void* q, const void* k, const void* v,
                                const void* kv_valid, const void* slots, void* out, void* lse,
                                void* part, void* sync,
                                int b, int sq, int hq, int hkv, int d, int skv,
                                long long layer, long long s_layer, long long s_row,
                                long long s_seq, long long s_head, float scale, int causal,
                                void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, nullptr, nullptr, kv_valid, slots, out, nullptr, lse,
                                 part, sync, b, sq, hq, hkv, d, skv, layer, s_layer, s_row, s_seq,
                                 s_head, 0, 0, scale, causal, 0, stream);
}

// The shard form over a dense bf16 cache that is one sequence shard: its
// position 0 is the global position pos_offset (>= 0). out_f32 receives
// the shard's normalised (B, Sq, Hq, D) f32 output and lse each query
// row's (B, Hq, Sq) f32 log-sum-exp over the shard, -inf (with output 0)
// for a row that sees no position of it. Both are required.
extern "C" int verify_attn_bf16_shard(const void* q, const void* k, const void* v,
                                      const void* kv_valid, void* out_f32, void* lse,
                                      void* part, void* sync,
                                      int b, int sq, int hq, int hkv, int d, int skv,
                                      long long layer, long long s_layer, long long s_row,
                                      long long s_seq, long long s_head, int pos_offset,
                                      float scale, int causal, void* stream) {
  if (out_f32 == nullptr || lse == nullptr || pos_offset < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch<__nv_bfloat16>(q, k, v, nullptr, nullptr, kv_valid, nullptr, nullptr, out_f32,
                                 lse, part, sync, b, sq, hq, hkv, d, skv, layer, s_layer, s_row,
                                 s_seq, s_head, 0, 0, scale, causal, pos_offset, stream);
}

// int8 K/V with (L, rows, Hkv) f32 scale leaves: sc_layer / sc_row are their
// layer and row strides in elements (the head stride is 1).
extern "C" int verify_attn_int8(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* kv_valid, const void* slots, void* out,
                                void* part, void* sync,
                                int b, int sq, int hq, int hkv, int d, int skv,
                                long long layer, long long s_layer, long long s_row,
                                long long s_seq, long long s_head, long long sc_layer,
                                long long sc_row, float scale, int causal, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<int8_t>(q, k, v, k_scale, v_scale, kv_valid, slots, out, nullptr, nullptr, part,
                          sync, b, sq, hq, hkv, d, skv, layer, s_layer, s_row, s_seq, s_head,
                          sc_layer, sc_row, scale, causal, 0, stream);
}
