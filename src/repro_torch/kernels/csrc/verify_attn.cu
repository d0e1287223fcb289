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
// An int8 cache adds one load path: each K/V tile is dequantized while it is
// stored to shared memory as (int8 -> f32 * scale[row, h]) -> bf16, the
// rounding of the JAX package's kv_dequant, so both products then run on
// the same bf16 tile as in the bf16 path. The dense entry takes int8 too:
// the JAX package's XLA path dequantizes dense int8 caches in its chunk
// loop, and the slot prefill and lock-step reference read such caches.
//
// Math (identical to _attend_chunk): for batch entry b and KV head h the
// Sq*G query rows are packed as r = i*G + g (query i, head h*G + g). Query i
// sits at absolute position kv_valid[b] - Sq + i, so KV position j is visible
// iff j <= kv_valid[b] - Sq + i and j < Skv. The softmax runs online over
// chunks of kBlockK positions with f32 running max m, sum l and accumulator;
// scores are f32 dot products of bf16 inputs, and P is rounded to bf16 before
// the P.V product, as the TPU kernel does (p.astype(v.dtype)).
//
// Bound on an H100: bytes. A verify step does O(Sq*G) work per cached K/V
// element, far below the ~295 flop/byte ridge of bf16 on this card, so the
// least time is one read of the visible K/V rows (and q, out) at 3.35 TB/s;
// an int8 cache halves those bytes. The design streams each K/V chunk from
// device memory once per block into shared memory and keeps scores, P and
// the accumulator on chip; a block stops at its rows' causal limit instead
// of walking the whole buffer.
// It does not yet reach that bound: the products are plain f32 FMA from
// shared memory (no mma/wgmma), there is no split of the sequence across
// SMs (a verify step has only B*Hkv (b, head) pairs, 12 at 6 devices on
// 132 SMs), and loads are not pipelined. Those are later work.
//
// Layouts: q and out are (B, Sq, Hq, D) contiguous bf16. k and v are any
// strided view whose last dimension is contiguous: a stacked cache buffer
// (L, rows, Skv, Hkv, D) addressed by (layer, row) without a copy, with the
// strides in elements. An int8 cache's scales are the stacked (L, rows, Hkv)
// f32 leaves, addressed by the same (layer, row) with their own strides and
// the head contiguous. kv_valid and slots are (B,) int32 on the device.
// Rows past kv_valid / Skv are never read; V (and K) rows of a chunk past
// the tile's limit are zeroed in shared memory so no stale value can reach
// the accumulator.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (src/repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kRows = 16;       // packed query rows per block
constexpr int kBlockK = 64;     // KV positions per chunk (2 per lane)
constexpr float kNegInf = -1e30f;

// One 16-byte vector of cache elements -> VEC bf16 values in shared memory.
// bf16: a copy (8 values). int8: 16 values, each (int8 -> f32 * s) -> bf16.
template <typename KV>
struct CacheVec;

template <>
struct CacheVec<__nv_bfloat16> {
  static constexpr int VEC = 8;
  __device__ static void store(const __nv_bfloat16* src, float, __nv_bfloat16* dst, bool live) {
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (live) w = *reinterpret_cast<const uint4*>(src);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    d[0] = w.x; d[1] = w.y; d[2] = w.z; d[3] = w.w;
  }
};

template <>
struct CacheVec<int8_t> {
  static constexpr int VEC = 16;
  __device__ static void store(const int8_t* src, float s, __nv_bfloat16* dst, bool live) {
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (live) w = *reinterpret_cast<const uint4*>(src);
    const int8_t* e = reinterpret_cast<const int8_t*>(&w);
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst);
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      // f32 product rounded once to bf16 (round to nearest even)
      d[i] = __floats2bfloat162_rn(static_cast<float>(e[2 * i]) * s,
                                   static_cast<float>(e[2 * i + 1]) * s);
    }
  }
};

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
                   int sq, int hq, int hkv, int skv,
                   long long s_row, long long s_seq, long long s_head,
                   long long sc_row, float scale) {
  constexpr int KP = D + 2;                     // padded smem row: 65 words for
                                                // D=128, so a warp reading one
                                                // column of 32 rows hits 32 banks
  constexpr int NDP = D / 2;                    // bf16 pairs per row
  constexpr int PV_GROUPS = kThreads / NDP;     // row groups in the P.V phase
  constexpr int PV_ROWS = kRows / PV_GROUPS;    // rows per thread in P.V
  constexpr int S_GROUPS = kThreads / kBlockK;  // row groups in the score phase
  constexpr int S_ROWS = kRows / S_GROUPS;      // rows per thread in scores
  constexpr int VEC = CacheVec<KV>::VEC;        // elements per 16-byte load
  constexpr int NV = D / VEC;

  __shared__ float q_s[kRows][D];
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockK][KP];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockK][KP];
  __shared__ float p_s[kRows][kBlockK];
  __shared__ float m_s[kRows];
  __shared__ float l_s[kRows];
  __shared__ float corr_s[kRows];

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int group = hq / hkv;
  const int n_rows = sq * group;
  const int r0 = blockIdx.x * kRows;
  const int valid = kv_valid[b];
  const long long row = slots != nullptr ? static_cast<long long>(slots[b])
                                         : static_cast<long long>(b);
  const KV* kb = k + row * s_row + h * s_head;
  const KV* vb = v + row * s_row + h * s_head;
  // int8: the row's dequant scales (unused for bf16)
  const float ks = k_scale != nullptr ? k_scale[row * sc_row + h] : 1.f;
  const float vs = v_scale != nullptr ? v_scale[row * sc_row + h] : 1.f;

  // the tile's last row sets how far its blocks must read
  const int r_last = min(r0 + kRows, n_rows) - 1;
  const int kv_end = max(0, min(skv, valid - sq + r_last / group + 1));

  for (int idx = tid; idx < kRows * NDP; idx += kThreads) {
    const int r = idx / NDP, dp = idx % NDP;
    const int pr = r0 + r;
    float2 val = make_float2(0.f, 0.f);
    if (pr < n_rows) {
      const int i = pr / group, g = pr % group;
      const __nv_bfloat162* src = reinterpret_cast<const __nv_bfloat162*>(
          q + ((static_cast<long long>(b) * sq + i) * hq + h * group + g) * D);
      val = __bfloat1622float2(src[dp]);
    }
    q_s[r][2 * dp] = val.x;
    q_s[r][2 * dp + 1] = val.y;
  }
  if (tid < kRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int col = tid % kBlockK;   // score phase: this thread's KV column
  const int s_g = tid / kBlockK;
  const int dp = tid % NDP;        // P.V phase: this thread's d pair
  const int pv_g = tid / NDP;
  const int warp = tid / 32, lane = tid % 32;

  float acc[PV_ROWS][2];
#pragma unroll
  for (int rr = 0; rr < PV_ROWS; ++rr) acc[rr][0] = acc[rr][1] = 0.f;

  for (int j0 = 0; j0 < kv_end; j0 += kBlockK) {
    __syncthreads();  // the previous chunk's readers are done with k_s/v_s/p_s
    for (int idx = tid; idx < kBlockK * NV; idx += kThreads) {
      const int jj = idx / NV, c = idx % NV;
      const int j = j0 + jj;
      const bool live = j < kv_end;
      const long long off = live ? j * s_seq + c * VEC : 0;
      CacheVec<KV>::store(kb + off, ks, &k_s[jj][c * VEC], live);
      CacheVec<KV>::store(vb + off, vs, &v_s[jj][c * VEC], live);
    }
    __syncthreads();

    // scores: thread (col, s_g) computes rows s_g, s_g + S_GROUPS, ...
    {
      float s[S_ROWS];
#pragma unroll
      for (int rr = 0; rr < S_ROWS; ++rr) s[rr] = 0.f;
      const __nv_bfloat162* krow = reinterpret_cast<const __nv_bfloat162*>(&k_s[col][0]);
#pragma unroll 4
      for (int d2 = 0; d2 < NDP; ++d2) {
        const float2 kf = __bfloat1622float2(krow[d2]);
#pragma unroll
        for (int rr = 0; rr < S_ROWS; ++rr) {
          const float2 qf = *reinterpret_cast<const float2*>(&q_s[s_g + rr * S_GROUPS][2 * d2]);
          s[rr] = fmaf(qf.x, kf.x, s[rr]);
          s[rr] = fmaf(qf.y, kf.y, s[rr]);
        }
      }
      const int j = j0 + col;
#pragma unroll
      for (int rr = 0; rr < S_ROWS; ++rr) {
        const int r = s_g + rr * S_GROUPS;
        const int i = (r0 + r) / group;
        const bool visible = (j <= valid - sq + i) && (j < skv);
        p_s[r][col] = visible ? s[rr] * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows w, w + 4, ...; lane owns 2 columns
    for (int r = warp; r < kRows; r += kThreads / 32) {
      const float a = p_s[r][lane];
      const float c = p_s[r][lane + 32];
      const float m_prev = m_s[r];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_prev, mx);
      const float pa = expf(a - m_new);
      const float pc = expf(c - m_new);
      float sum = pa + pc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      p_s[r][lane] = __bfloat162float(__float2bfloat16(pa));
      p_s[r][lane + 32] = __bfloat162float(__float2bfloat16(pc));
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        corr_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P . V: thread (dp, pv_g) owns d pair dp of rows
    // pv_g, pv_g + PV_GROUPS, ...
#pragma unroll
    for (int rr = 0; rr < PV_ROWS; ++rr) {
      const float corr = corr_s[pv_g + rr * PV_GROUPS];
      acc[rr][0] *= corr;
      acc[rr][1] *= corr;
    }
    const __nv_bfloat162* vcol = reinterpret_cast<const __nv_bfloat162*>(&v_s[0][0]) + dp;
#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      const float2 vf = __bfloat1622float2(vcol[c * (KP / 2)]);
#pragma unroll
      for (int rr = 0; rr < PV_ROWS; ++rr) {
        const float p = p_s[pv_g + rr * PV_GROUPS][c];
        acc[rr][0] = fmaf(p, vf.x, acc[rr][0]);
        acc[rr][1] = fmaf(p, vf.y, acc[rr][1]);
      }
    }
  }
  __syncthreads();  // l_s is final (also when the block read no chunk)

#pragma unroll
  for (int rr = 0; rr < PV_ROWS; ++rr) {
    const int r = pv_g + rr * PV_GROUPS;
    const int pr = r0 + r;
    if (pr < n_rows) {
      const int i = pr / group, g = pr % group;
      const float l = fmaxf(l_s[r], 1e-30f);
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
          out + ((static_cast<long long>(b) * sq + i) * hq + h * group + g) * D);
      dst[dp] = __floats2bfloat162_rn(acc[rr][0] / l, acc[rr][1] / l);
    }
  }
}

template <int D, typename KV>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* kv_valid, const void* slots, void* out,
           int b, int sq, int hq, int hkv, int skv, long long layer, long long s_layer,
           long long s_row, long long s_seq, long long s_head, long long sc_layer,
           long long sc_row, float scale, cudaStream_t stream) {
  const int n_rows = sq * (hq / hkv);
  const dim3 grid((n_rows + kRows - 1) / kRows, hkv, b);
  const KV* kl = static_cast<const KV*>(k) + layer * s_layer;
  const KV* vl = static_cast<const KV*>(v) + layer * s_layer;
  const float* ksl = k_scale != nullptr ? static_cast<const float*>(k_scale) + layer * sc_layer
                                        : nullptr;
  const float* vsl = v_scale != nullptr ? static_cast<const float*>(v_scale) + layer * sc_layer
                                        : nullptr;
  verify_attn_kernel<D, KV><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), kl, vl, ksl, vsl,
      static_cast<const int*>(kv_valid), static_cast<const int*>(slots),
      static_cast<__nv_bfloat16*>(out), sq, hq, hkv, skv, s_row, s_seq, s_head, sc_row, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV>
int dispatch(const void* q, const void* k, const void* v, const void* k_scale,
             const void* v_scale, const void* kv_valid, const void* slots, void* out,
             int b, int sq, int hq, int hkv, int d, int skv, long long layer,
             long long s_layer, long long s_row, long long s_seq, long long s_head,
             long long sc_layer, long long sc_row, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64, KV>(q, k, v, k_scale, v_scale, kv_valid, slots, out, b, sq, hq, hkv,
                            skv, layer, s_layer, s_row, s_seq, s_head, sc_layer, sc_row,
                            scale, st);
    case 128:
      return launch<128, KV>(q, k, v, k_scale, v_scale, kv_valid, slots, out, b, sq, hq, hkv,
                             skv, layer, s_layer, s_row, s_seq, s_head, sc_layer, sc_row,
                             scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). slots == nullptr selects the
// dense layout (row b of the cache for batch entry b). Each returns the
// CUDA error code of the launch (0 on success).
extern "C" int verify_attn_bf16(const void* q, const void* k, const void* v,
                                const void* kv_valid, const void* slots, void* out,
                                int b, int sq, int hq, int hkv, int d, int skv,
                                long long layer, long long s_layer, long long s_row,
                                long long s_seq, long long s_head, float scale,
                                void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, nullptr, nullptr, kv_valid, slots, out, b, sq, hq,
                                 hkv, d, skv, layer, s_layer, s_row, s_seq, s_head, 0, 0,
                                 scale, stream);
}

// int8 K/V with (L, rows, Hkv) f32 scale leaves: sc_layer / sc_row are their
// layer and row strides in elements (the head stride is 1).
extern "C" int verify_attn_int8(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* kv_valid, const void* slots, void* out,
                                int b, int sq, int hq, int hkv, int d, int skv,
                                long long layer, long long s_layer, long long s_row,
                                long long s_seq, long long s_head, long long sc_layer,
                                long long sc_row, float scale, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<int8_t>(q, k, v, k_scale, v_scale, kv_valid, slots, out, b, sq, hq, hkv, d,
                          skv, layer, s_layer, s_row, s_seq, s_head, sc_layer, sc_row, scale,
                          stream);
}
