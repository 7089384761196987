// Ragged-batch paged attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ragged_attention.py:
// ragged_paged_attention (bodies _ragged_kernel and _ragged_kernel_q8).
//
// What it computes: one launch over a whole mixed serving step. q (T,Hq,hd)
// holds the step's query tokens flattened across requests (prefill chunks of
// any length and history, and decode rows); token t reads the pages of
// block-table row row[t] and attends causally over kv positions [0, pos[t]].
// Pad tokens (pos = -1) come back exactly 0. T is a multiple of tile_q and
// row is constant over each tile of tile_q tokens (the runner's layout);
// tile_q is the wrapper's one constant, ragged_attention.py::TILE_Q.
// With scale/zero pools the pages are int8 and are dequantized in the load
// (q * scale + zero), so no dequantized copy of a pool is ever written.
//
// Design: one block per (tile of tile_q tokens, kv head). Its tile_q * G
// query rows (G = Hq / Hkv; 8 * 4 = 32 rows at granite-3-8b, hd 128) share
// every K/V page load. The TPU grid's sequential page axis is a loop inside
// the block, which reads its own page ids from the table and stops after
// ceil((max pos of the tile + 1) / bs) pages instead of walking all nb.
//
// What bounds it: the bytes of K/V it reads. Each tile reads its sequence's
// history once per kv head, so a prefill chunk of n tokens reads the history
// n / tile_q times (from L2 for all but the first); a decode row reads it once.
// Pages are read in 16-byte vectors, and the next page's loads are in flight
// while the block scores the current one (PageLoader), so a page costs its
// arithmetic rather than a memory latency. That arithmetic (scores and sums
// in float32 on the CUDA cores, 32 rows against each key) is what is left:
// tensor-core (wgmma) products, TMA page loads and a deeper q tile are the
// later speed items.

#include "paged_attention_common.cuh"

namespace {

using namespace pattn;

template <typename QT, typename KT, int HD>
__global__ void __launch_bounds__(THREADS)
ragged_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pages,
              const KT* __restrict__ v_pages, const float* __restrict__ k_scale,
              const float* __restrict__ k_zero, const float* __restrict__ v_scale,
              const float* __restrict__ v_zero, const int* __restrict__ tables,
              const int* __restrict__ row, const int* __restrict__ pos,
              QT* __restrict__ out, int hq, int hkv, int nb, int bs, int tile_q,
              float scale) {
  extern __shared__ float smem[];
  const int it = blockIdx.x;
  const int h = blockIdx.y;
  const int G = hq / hkv;
  const int R = tile_q * G;
  const Smem s = carve(smem, R, bs, HD);
  const int64_t t0 = static_cast<int64_t>(it) * tile_q;

  // query rows r = token * G + g of kv head h: q[t0 + token, h * G + g, :]
  for (int e = threadIdx.x; e < R * HD; e += blockDim.x) {
    const int r = e / HD;
    const int d = e % HD;
    const int64_t t = t0 + r / G;
    s.q[e] = to_f32<QT>(q[(t * hq + h * G + r % G) * HD + d]);
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) s.vlen[r] = pos[t0 + r / G] + 1;
  softmax_init(s, R, HD);
  int max_len = 0;
  for (int i = 0; i < tile_q; ++i) max_len = max(max_len, pos[t0 + i] + 1);
  const int n_pages = min((max_len + bs - 1) / bs, nb);
  const int* trow = tables + static_cast<int64_t>(row[t0]) * nb;
  __syncthreads();

  PageLoader<KT, HD> ld{k_pages, v_pages, k_scale, k_zero, v_scale, v_zero, bs, hkv, h};
  if (n_pages > 0) ld.fetch(trow[0], min(bs, max_len));
  for (int ib = 0; ib < n_pages; ++ib) {
    ld.store(s);
    __syncthreads();
    // the next page's loads fly while this one is scored
    if (ib + 1 < n_pages) ld.fetch(trow[ib + 1], min(bs, max_len - (ib + 1) * bs));
    softmax_page<HD>(s, R, bs, ib * bs, scale);
  }

  for (int e = threadIdx.x; e < R * HD; e += blockDim.x) {
    const int r = e / HD;
    const int d = e % HD;
    const int64_t t = t0 + r / G;
    out[(t * hq + h * G + r % G) * HD + d] = from_f32<QT>(s.acc[e] / fmaxf(s.l[r], 1e-30f));
  }
}

template <typename QT, typename KT, int HD>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const float* k_scale, const float* k_zero, const float* v_scale,
                   const float* v_zero, const int* tables, const int* row, const int* pos,
                   void* out, int T, int hq, int hkv, int nb, int bs, int tile_q,
                   float scale, cudaStream_t stream) {
  static size_t configured = 0;
  const int R = tile_q * (hq / hkv);
  const size_t bytes = smem_floats(R, bs, HD) * sizeof(float);
  auto kernel = ragged_kernel<QT, KT, HD>;
  cudaError_t e = ensure_smem(kernel, bytes, &configured);
  if (e != cudaSuccess) return e;
  const dim3 grid(T / tile_q, hkv);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), k_scale, k_zero, v_scale, v_zero, tables, row,
      pos, static_cast<QT*>(out), hq, hkv, nb, bs, tile_q, scale);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t by_hd(int hd, const void* q, const void* kp, const void* vp, const float* ks,
                  const float* kz, const float* vs, const float* vz, const int* tables,
                  const int* row, const int* pos, void* out, int T, int hq, int hkv,
                  int nb, int bs, int tile_q, float scale, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch<QT, KT, 16>(q, kp, vp, ks, kz, vs, vz, tables, row, pos, out, T, hq,
                                hkv, nb, bs, tile_q, scale, st);
    case 32:
      return launch<QT, KT, 32>(q, kp, vp, ks, kz, vs, vz, tables, row, pos, out, T, hq,
                                hkv, nb, bs, tile_q, scale, st);
    case 64:
      return launch<QT, KT, 64>(q, kp, vp, ks, kz, vs, vz, tables, row, pos, out, T, hq,
                                hkv, nb, bs, tile_q, scale, st);
    case 128:
      return launch<QT, KT, 128>(q, kp, vp, ks, kz, vs, vz, tables, row, pos, out, T, hq,
                                 hkv, nb, bs, tile_q, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename QT>
cudaError_t by_kv(int kv_dtype, int hd, const void* q, const void* kp, const void* vp,
                  const float* ks, const float* kz, const float* vs, const float* vz,
                  const int* tables, const int* row, const int* pos, void* out, int T,
                  int hq, int hkv, int nb, int bs, int tile_q, float scale,
                  cudaStream_t st) {
  switch (kv_dtype) {
    case F32:
      return by_hd<QT, float>(hd, q, kp, vp, ks, kz, vs, vz, tables, row, pos, out, T, hq,
                              hkv, nb, bs, tile_q, scale, st);
    case BF16:
      return by_hd<QT, __nv_bfloat16>(hd, q, kp, vp, ks, kz, vs, vz, tables, row, pos, out,
                                       T, hq, hkv, nb, bs, tile_q, scale, st);
    case F16:
      return by_hd<QT, __half>(hd, q, kp, vp, ks, kz, vs, vz, tables, row, pos, out, T, hq,
                               hkv, nb, bs, tile_q, scale, st);
    case I8:
      return by_hd<QT, int8_t>(hd, q, kp, vp, ks, kz, vs, vz, tables, row, pos, out, T,
                               hq, hkv, nb, bs, tile_q, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point bound with ctypes (kernels/ragged_attention.py). The scale/
// zero pointers are null for float pages and all four set for int8 pages.
// Returns the launch's cudaGetLastError() (0 = launched).
extern "C" int ragged_paged_attention(const void* q, const void* k_pages,
                                      const void* v_pages, const void* k_scale,
                                      const void* k_zero, const void* v_scale,
                                      const void* v_zero, const void* tables,
                                      const void* row, const void* pos, void* out, int T,
                                      int hq, int hkv, int hd, int nb, int bs, int tile_q,
                                      float scale, int q_dtype, int kv_dtype,
                                      void* stream) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* kz = static_cast<const float*>(k_zero);
  const float* vs = static_cast<const float*>(v_scale);
  const float* vz = static_cast<const float*>(v_zero);
  const int* tb = static_cast<const int*>(tables);
  const int* rw = static_cast<const int*>(row);
  const int* ps = static_cast<const int*>(pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T == 0) return 0;
  switch (q_dtype) {
    case F32:
      return by_kv<float>(kv_dtype, hd, q, k_pages, v_pages, ks, kz, vs, vz, tb, rw, ps,
                          out, T, hq, hkv, nb, bs, tile_q, scale, st);
    case BF16:
      return by_kv<__nv_bfloat16>(kv_dtype, hd, q, k_pages, v_pages, ks, kz, vs, vz, tb,
                                  rw, ps, out, T, hq, hkv, nb, bs, tile_q, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
