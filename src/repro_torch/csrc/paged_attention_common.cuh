// Shared pieces of the attention kernels: the two paged ones
// (ragged_paged_attention.cu, paged_decode_attention.cu) and the two over
// slot-contiguous K/V (flash_attention.cu, decode_attention.cu): dtype
// conversion, the shared-memory layout of one block, the K/V tile load and
// the online-softmax step over one tile.
//
// One block owns R query rows that read the same kv head. It walks its K/V
// rows in tiles (a page of a block-table row, or KB consecutive rows of a
// contiguous cache); for each tile it loads the K and V rows into shared
// memory as float32, scores every (row, key) pair, folds the tile into each
// row's running max m, sum l and accumulator acc, and moves on. Row r attends
// keys at positions kpos < vlen[r]: a key past vlen is never scored and never
// multiplied into acc (a row past a sequence's end may hold anything, so it
// must not meet a zero probability as 0 * x). A row with no valid key keeps
// l == 0 and acc == 0, and is written as acc / max(l, 1e-30) == 0.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pattn {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;

// dtype codes shared with the Python wrappers (kernels/_build.py)
enum DType { F32 = 0, BF16 = 1, F16 = 2, I8 = 3 };

// q and the output: float32, bf16 or fp16 (K/V are unpacked by PageLoader)
template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

// Shared memory of one block, in floats: q (R x HD), K page (bs x HD+1, the
// +1 staggers rows across banks for the per-key dot products), V page
// (bs x HD), scores/probabilities (R x bs), acc (R x HD), then m, l, corr
// and the per-row valid length (R each).
__host__ __device__ inline size_t smem_floats(int R, int bs, int hd) {
  return (size_t)R * (2 * hd + bs + 4) + (size_t)bs * (2 * hd + 1);
}

struct Smem {
  float* q;
  float* k;
  float* v;
  float* p;
  float* acc;
  float* m;
  float* l;
  float* corr;
  int* vlen;
};

__device__ inline Smem carve(float* base, int R, int bs, int hd) {
  Smem s;
  s.q = base;
  s.k = s.q + R * hd;
  s.v = s.k + bs * (hd + 1);
  s.p = s.v + bs * hd;
  s.acc = s.p + R * bs;
  s.m = s.acc + R * hd;
  s.l = s.m + R;
  s.corr = s.l + R;
  s.vlen = reinterpret_cast<int*>(s.corr + R);
  return s;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Zero acc and l, set m to -inf. The caller has filled q and vlen.
__device__ inline void softmax_init(const Smem& s, int R, int hd) {
  for (int e = threadIdx.x; e < R * hd; e += blockDim.x) s.acc[e] = 0.f;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    s.m[r] = NEG_INF;
    s.l[r] = 0.f;
  }
}

// The loads of one tile's K and V rows for kv head h, in 16-byte vectors: a
// row is HD * sizeof(KT) bytes, a multiple of 16 for HD >= 16, and
// neighbouring threads read neighbouring vectors of a row. A tile is nrows
// consecutive rows of the (rows, hkv, HD) K/V arrays from row row0: a page
// of a pool (fetch: row0 = page * bs) or a span of a contiguous cache
// (fetch_rows). fetch_rows() issues a thread's first VPT vectors of K and
// of V together into registers and returns without waiting for them, so
// the caller fetches tile ib + 1 before it scores tile ib and the loads
// are in flight meanwhile. store()
// writes them to shared memory as float32, loading any vectors past the
// first VPT * THREADS (pages larger than the main path's) there and then.
// int8 pages are dequantized on the way as q * scale + zero, rounded as the
// plain version rounds it (a product, then a sum).
template <typename KT, int HD>
struct PageLoader {
  static constexpr bool Q8 = sizeof(KT) == 1;
  static constexpr int EPV = 16 / sizeof(KT);  // elements per vector
  static constexpr int VPR = HD / EPV;         // vectors per row
  static constexpr int VPT = 4;                // vectors in flight a thread, each of K and V
  static_assert(HD % EPV == 0, "a K/V row must be a whole number of 16-byte vectors");

  const KT* k_pages;
  const KT* v_pages;
  const float* k_scale;  // int8 pages only: (N, bs, Hkv) scale/zero pools
  const float* k_zero;
  const float* v_scale;
  const float* v_zero;
  int bs, hkv, h;
  int64_t row0;
  int nvec;
  uint4 k[VPT], v[VPT];
  float qk[2 * VPT], qv[2 * VPT];  // int8: (scale, zero) of each vector's row

  __device__ __forceinline__ void load(int e, uint4& kr, uint4& vr, float* sk, float* sv) const {
    const int64_t tok = (row0 + e / VPR) * hkv + h;
    kr = __ldg(reinterpret_cast<const uint4*>(k_pages + tok * HD) + e % VPR);
    vr = __ldg(reinterpret_cast<const uint4*>(v_pages + tok * HD) + e % VPR);
    if constexpr (Q8) {
      sk[0] = __ldg(k_scale + tok);
      sk[1] = __ldg(k_zero + tok);
      sv[0] = __ldg(v_scale + tok);
      sv[1] = __ldg(v_zero + tok);
    }
  }

  __device__ __forceinline__ void fetch(int64_t page_id, int nrows) {
    fetch_rows(page_id * bs, nrows);
  }

  __device__ __forceinline__ void fetch_rows(int64_t first_row, int nrows) {
    row0 = first_row;
    nvec = nrows * VPR;
#pragma unroll
    for (int u = 0; u < VPT; ++u) {
      const int e = u * THREADS + threadIdx.x;
      if (e < nvec) load(e, k[u], v[u], qk + 2 * u, qv + 2 * u);
    }
  }

  // Element j of a 16-byte vector as float32, taken from its 32-bit words
  // with shifts (a KT array copied out of the vector would sit in local
  // memory).
  __device__ static __forceinline__ float unpack(const uint4& raw, int j) {
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
    constexpr int PER = 4 / sizeof(KT);  // elements per word
    const unsigned x = w[j / PER];
    const int b = (j % PER) * 8 * sizeof(KT);  // bit offset in the word
    if constexpr (sizeof(KT) == 4) {
      return __uint_as_float(x);
    } else if constexpr (Q8) {
      return static_cast<float>(static_cast<int8_t>((x >> b) & 0xffu));
    } else if constexpr (std::is_same<KT, __nv_bfloat16>::value) {
      return __uint_as_float(((x >> b) & 0xffffu) << 16);
    } else {
      return __half2float(__ushort_as_half(static_cast<unsigned short>((x >> b) & 0xffffu)));
    }
  }

  __device__ static __forceinline__ void put(float* dst, const uint4& raw, const float* sz) {
#pragma unroll
    for (int j = 0; j < EPV; ++j) {
      float f = unpack(raw, j);
      if constexpr (Q8) f = __fadd_rn(__fmul_rn(f, sz[0]), sz[1]);
      dst[j] = f;
    }
  }

  __device__ __forceinline__ void store(const Smem& s) const {
#pragma unroll
    for (int u = 0; u < VPT; ++u) {
      const int e = u * THREADS + threadIdx.x;
      if (e < nvec) {
        const int i = e / VPR, d = (e % VPR) * EPV;
        put(s.k + i * (HD + 1) + d, k[u], qk + 2 * u);
        put(s.v + i * HD + d, v[u], qv + 2 * u);
      }
    }
    for (int e = VPT * THREADS + threadIdx.x; e < nvec; e += THREADS) {
      uint4 kr, vr;
      float sk[2], sv[2];
      load(e, kr, vr, sk, sv);
      const int i = e / VPR, d = (e % VPR) * EPV;
      put(s.k + i * (HD + 1) + d, kr, sk);
      put(s.v + i * HD + d, vr, sv);
    }
  }
};

// Fold one tile (keys at positions kpos0 .. kpos0 + bs - 1, stored by
// PageLoader) into the R rows' running softmax state. Ends synchronised.
template <int HD>
__device__ inline void softmax_page(const Smem& s, int R, int bs, int kpos0, float scale) {
  // 1. scores of the valid (row, key) pairs
  for (int e = threadIdx.x; e < R * bs; e += blockDim.x) {
    const int r = e / bs;
    const int j = e % bs;
    float sc = NEG_INF;
    if (kpos0 + j < s.vlen[r]) {
      const float* qr = s.q + r * HD;
      const float* kj = s.k + j * (HD + 1);
      // four independent sums, so the products do not wait on each other
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) a[u] = fmaf(qr[d + u], kj[d + u], a[u]);
      }
      sc = ((a[0] + a[1]) + (a[2] + a[3])) * scale;
    }
    s.p[e] = sc;
  }
  __syncthreads();
  // 2. per-row running max and sum: one warp per row, lanes over keys
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  for (int r = warp; r < R; r += nwarps) {
    const int nvalid = min(max(s.vlen[r] - kpos0, 0), bs);
    if (nvalid == 0) {
      if (lane == 0) s.corr[r] = 1.f;
      continue;
    }
    float mx = NEG_INF;
    for (int j = lane; j < nvalid; j += 32) mx = fmaxf(mx, s.p[r * bs + j]);
    mx = warp_max(mx);
    const float m_prev = s.m[r];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int j = lane; j < nvalid; j += 32) {
      const float pj = expf(s.p[r * bs + j] - m_new);
      s.p[r * bs + j] = pj;
      sum += pj;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float c = expf(m_prev - m_new);
      s.corr[r] = c;
      s.l[r] = s.l[r] * c + sum;
      s.m[r] = m_new;
    }
  }
  __syncthreads();
  // 3. acc = acc * corr + p @ V over the valid keys only
  for (int e = threadIdx.x; e < R * HD; e += blockDim.x) {
    const int r = e / HD;
    const int d = e % HD;
    const int nvalid = min(max(s.vlen[r] - kpos0, 0), bs);
    if (nvalid == 0) continue;
    const float* pr = s.p + r * bs;
    const float* vd = s.v + d;
    float a[4] = {0.f, 0.f, 0.f, 0.f};  // independent sums, as above
    int j = 0;
    for (; j + 4 <= nvalid; j += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = fmaf(pr[j + u], vd[(j + u) * HD], a[u]);
    }
    for (; j < nvalid; ++j) a[0] = fmaf(pr[j], vd[j * HD], a[0]);
    s.acc[e] = fmaf(s.acc[e], s.corr[r], (a[0] + a[1]) + (a[2] + a[3]));
  }
  __syncthreads();
}

// Fold rows [row0, row0 + len) of slot-contiguous K/V (kv head h) into the
// R rows' softmax state, in tiles of kb keys, the next tile's loads in flight
// while the current one is scored. The caller has filled q and vlen (every
// vlen <= len), run softmax_init and synchronised. Ends synchronised.
template <typename KT, int HD>
__device__ inline void softmax_rows(const Smem& s, int R, const KT* k, const KT* v, int hkv,
                                    int h, int64_t row0, int len, int kb, float scale) {
  const int n_tiles = (max(len, 0) + kb - 1) / kb;
  PageLoader<KT, HD> ld{k, v, nullptr, nullptr, nullptr, nullptr, kb, hkv, h};
  if (n_tiles > 0) ld.fetch_rows(row0, min(kb, len));
  for (int ib = 0; ib < n_tiles; ++ib) {
    ld.store(s);
    __syncthreads();
    if (ib + 1 < n_tiles) {
      ld.fetch_rows(row0 + static_cast<int64_t>(ib + 1) * kb, min(kb, len - (ib + 1) * kb));
    }
    softmax_page<HD>(s, R, kb, ib * kb, scale);
  }
}

// Raise the dynamic shared-memory cap of a kernel once it needs more than the
// default 48 KB. Host side; one card per process.
template <typename Kernel>
inline cudaError_t ensure_smem(Kernel kernel, size_t bytes, size_t* configured) {
  if (bytes <= 48 * 1024 || bytes <= *configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e == cudaSuccess) *configured = bytes;
  return e;
}

}  // namespace pattn
