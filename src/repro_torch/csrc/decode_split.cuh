// The split of a decode row's keys over blocks (flash-decoding), shared by
// the tensor-core bodies of paged_decode_attention.cu and
// decode_attention.cu.
//
// One query token per sequence leaves B x Hkv blocks for a decode step (32
// at granite-3-8b batch 4, on 132 SMs), each walking its whole span alone.
// Here block (b, h, s) owns kv positions [s KPS, (s + 1) KPS) of sequence
// b: it runs the tensor-core body (mma_attention.cuh) on those keys for
// the G query rows of kv head h and writes each row's unnormalised f32
// state to a workspace:
//   o  (B, Hq, n_split, HD)   sum_j p_j v_j, p_j = 2^(score_j - m)
//   m  (B, Hq, n_split)       the base-2 row max (score * scale * log2 e)
//   l  (B, Hq, n_split)       sum_j p_j, from the rounded p
// A block whose first position is at or past the row's length exits at
// once. A second kernel, one warp per (sequence, q head), reads the row's
// n = ceil(len / KPS) partials, takes their max M and writes
//   (sum_s o_s 2^(m_s - M)) / max(sum_s l_s 2^(m_s - M), 1e-30)
// in q's dtype, the sums taken in split order; n = 0 gives exactly 0.
//
// Which split a key lands in depends on its position alone (KPS is fixed,
// never derived from the table width, S or the batch), and splits past a
// row's end are never read, so the same K/V give the same bits whatever
// the table's width or the cache's S. No atomics: every sum is taken in
// the same order every run.
//
// The ragged kernel (ragged_paged_attention.cu) runs the same body on its
// decode runs, over bf16 pages and int8 pages (Q8: the partial's o holds
// the zero term, mma_attention.cuh), and combines a row through
// combine_row, so a decode row's bits over bf16 pages are the paged decode
// kernel's.

#pragma once

#include "mma_attention.cuh"
#include "paged_attention_common.cuh"

namespace dsplit {

// kv positions a split: two stages of the body. kernels/decode_attention.py
// sizes the workspace with the same constant (SPLIT_KEYS) and the C entry
// points refuse a workspace of another split count.
constexpr int KPS = 128;
static_assert(KPS % mma_attn::KEYS == 0, "a split is whole stages");

constexpr int COMBINE_WARPS = 4;  // (sequence, q head) rows a combine block

__host__ __device__ inline int n_splits(int n_keys) { return (n_keys + KPS - 1) / KPS; }

// The workspace, one f32 buffer: o, then m, then l.
struct Workspace {
  float* o;
  float* m;
  float* l;
};

inline Workspace carve(void* ws, int B, int hq, int n_split, int hd) {
  float* base = static_cast<float*>(ws);
  const size_t rows = size_t(B) * hq * n_split;
  return {base, base + rows * hd, base + rows * (hd + 1)};
}

// The query rows of split (b, h, s), for the body: row r is q head
// h G + r of sequence b, attending the split's first vlen keys.
struct SplitRows {
  float* po;
  float* pm;
  float* pl;
  int b, h, s, hq, G, hd, n_split, vlen;
  __device__ __forceinline__ bool query(int r, int64_t& off, int& vl) const {
    off = (static_cast<int64_t>(b) * hq + h * G + r) * hd;
    vl = vlen;
    return true;
  }
  __device__ __forceinline__ int64_t part(int r) const {
    return (static_cast<int64_t>(b) * hq + h * G + r) * n_split + s;
  }
};

// The body on one split: len (>= 1) keys of the split, G rows, the row
// groups and key split of the body chosen by G. KT, Q8, sc: the pages, as
// mma_attention.cuh's attend takes them (T, false and null but for the
// ragged kernel's int8 pages).
template <typename T, typename KT, bool Q8, int HD, class Map>
__device__ __forceinline__ void attend_split(const Map& mp, const T* q, const KT* kp,
                                             const KT* vp, const float* const* sc, int G,
                                             int len, float scale, char* smem) {
  using mma_attn::attend;
  if (G <= 16) {
    attend<T, KT, Q8, HD, 4, Map, true>(mp, q, kp, vp, sc, nullptr, G, len, scale, smem);
  } else if (G <= 32) {
    attend<T, KT, Q8, HD, 2, Map, true>(mp, q, kp, vp, sc, nullptr, G, len, scale, smem);
  } else {
    attend<T, KT, Q8, HD, 1, Map, true>(mp, q, kp, vp, sc, nullptr, G, len, scale, smem);
  }
}

// One warp writes one output row orow (HD values of QT) from its n
// partials at po/pm/pl[p0 ..]: (sum_s o_s 2^(m_s - M)) / max(sum_s l_s
// 2^(m_s - M), 1e-30), the sums in split order; n = 0 gives exactly 0.
template <typename QT, int HD>
__device__ __forceinline__ void combine_row(const float* __restrict__ po,
                                            const float* __restrict__ pm,
                                            const float* __restrict__ pl, int64_t p0, int n,
                                            QT* __restrict__ orow, int lane) {
  float mx = mma_attn::NEG;
  for (int s = lane; s < n; s += 32) mx = fmaxf(mx, pm[p0 + s]);
  mx = pattn::warp_max(mx);
  constexpr int PER = (HD + 31) / 32;  // columns a lane; at HD 16 half the lanes idle
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  float l = 0.f;
#pragma unroll 4
  for (int s = 0; s < n; ++s) {
    const float c = exp2f(pm[p0 + s] - mx);
    l += pl[p0 + s] * c;
    const float* o = po + (p0 + s) * HD;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      if (lane + 32 * i < HD) acc[i] += o[lane + 32 * i] * c;
    }
  }
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (lane + 32 * i < HD) orow[lane + 32 * i] = pattn::from_f32<QT>(acc[i] / den);
  }
}

// The second pass: one warp per (sequence, q head) row of out (B, 1, Hq,
// HD). A row's length is kv_len[b] clamped to [0, cap] (cap: the table's
// nb bs, or S), as the split kernel clamps it.
template <typename QT, int HD>
__global__ void __launch_bounds__(32 * COMBINE_WARPS)
decode_combine_kernel(const float* __restrict__ po, const float* __restrict__ pm,
                      const float* __restrict__ pl, const int* __restrict__ kv_len,
                      QT* __restrict__ out, int n_rows, int hq, int n_split, int cap) {
  const int row = blockIdx.x * COMBINE_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int n = n_splits(min(max(kv_len[row / hq], 0), cap));
  combine_row<QT, HD>(po, pm, pl, static_cast<int64_t>(row) * n_split, n,
                      out + static_cast<int64_t>(row) * HD, lane);
}

// Launch the split kernel over grid (B, Hkv, n_split), then the combine.
// kernel: the split kernel, taking (Workspace, ...) as launch() passes.
template <typename QT, int HD, typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t* configured, const Workspace& ws, const int* kv_len,
                   void* out, int B, int hq, int hkv, int n_split, int cap, cudaStream_t stream,
                   Args... args) {
  if (n_split > 0) {
    const size_t bytes = mma_attn::Layout<HD>::bytes(false);
    cudaError_t e = pattn::ensure_smem(kernel, bytes, configured);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(B, hkv, n_split), mma_attn::THREADS, bytes, stream>>>(ws, args...);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  const int n_rows = B * hq;
  decode_combine_kernel<QT, HD>
      <<<(n_rows + COMBINE_WARPS - 1) / COMBINE_WARPS, 32 * COMBINE_WARPS, 0, stream>>>(
          ws.o, ws.m, ws.l, kv_len, static_cast<QT*>(out), n_rows, hq, n_split, cap);
  return cudaGetLastError();
}

}  // namespace dsplit
