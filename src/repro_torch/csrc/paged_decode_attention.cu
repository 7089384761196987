// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// paged_decode_attention (body _paged_kernel, sharing _softmax_step).
//
// What it computes: one query token per sequence, q (B,1,Hq,hd), against the
// shared page pool (N,bs,Hkv,hd) through block_tables (B,nb), over the first
// kv_len[b] positions. Table entries past kv_len may name any valid page;
// they are never read.
//
// Design: one block per (sequence, kv head) with the G = Hq / Hkv query rows
// of that head's group; the TPU grid's page axis is a loop inside the block
// over ceil(kv_len / bs) pages, whose ids the block reads from its table row.
// The per-page online softmax is the one the ragged kernel uses
// (paged_attention_common.cuh), as the TPU kernels share _softmax_step.
//
// What bounds it: the bytes of K/V read, each page once per kv head. Pages
// are read in 16-byte vectors with the next page's loads in flight while the
// current one is scored (PageLoader), so the walk does not wait on memory at
// every page. But at granite-3-8b batch 4 the grid is only 4 x 8 = 32 blocks
// on the H100's 132 SMs, so one block's serial walk over its pages sets the
// time, not the card's memory rate. Splitting the page walk over several
// blocks with a combine pass (flash-decoding) is the later speed item.

#include "paged_attention_common.cuh"

namespace {

using namespace pattn;

template <typename QT, typename KT, int HD>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pages,
                    const KT* __restrict__ v_pages, const int* __restrict__ tables,
                    const int* __restrict__ kv_len, QT* __restrict__ out, int hq, int hkv,
                    int nb, int bs, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = hq / hkv;
  const Smem s = carve(smem, G, bs, HD);
  const int64_t q0 = (static_cast<int64_t>(b) * hq + h * G) * HD;

  for (int e = threadIdx.x; e < G * HD; e += blockDim.x) s.q[e] = to_f32<QT>(q[q0 + e]);
  const int len = kv_len[b];
  for (int r = threadIdx.x; r < G; r += blockDim.x) s.vlen[r] = len;
  softmax_init(s, G, HD);
  const int n_pages = min((max(len, 0) + bs - 1) / bs, nb);
  const int* trow = tables + static_cast<int64_t>(b) * nb;
  __syncthreads();

  PageLoader<KT, HD> ld{k_pages, v_pages, nullptr, nullptr, nullptr, nullptr, bs, hkv, h};
  if (n_pages > 0) ld.fetch(trow[0], min(bs, len));
  for (int ib = 0; ib < n_pages; ++ib) {
    ld.store(s);
    __syncthreads();
    // the next page's loads fly while this one is scored
    if (ib + 1 < n_pages) ld.fetch(trow[ib + 1], min(bs, len - (ib + 1) * bs));
    softmax_page<HD>(s, G, bs, ib * bs, scale);
  }

  for (int e = threadIdx.x; e < G * HD; e += blockDim.x) {
    out[q0 + e] = from_f32<QT>(s.acc[e] / fmaxf(s.l[e / HD], 1e-30f));
  }
}

template <typename QT, typename KT, int HD>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages, const int* tables,
                   const int* kv_len, void* out, int B, int hq, int hkv, int nb, int bs,
                   float scale, cudaStream_t stream) {
  static size_t configured = 0;
  const size_t bytes = smem_floats(hq / hkv, bs, HD) * sizeof(float);
  auto kernel = paged_decode_kernel<QT, KT, HD>;
  cudaError_t e = ensure_smem(kernel, bytes, &configured);
  if (e != cudaSuccess) return e;
  const dim3 grid(B, hkv);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), tables, kv_len, static_cast<QT*>(out), hq, hkv, nb,
      bs, scale);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t by_hd(int hd, const void* q, const void* kp, const void* vp, const int* tables,
                  const int* kv_len, void* out, int B, int hq, int hkv, int nb, int bs,
                  float scale, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch<QT, KT, 16>(q, kp, vp, tables, kv_len, out, B, hq, hkv, nb, bs, scale, st);
    case 32:
      return launch<QT, KT, 32>(q, kp, vp, tables, kv_len, out, B, hq, hkv, nb, bs, scale, st);
    case 64:
      return launch<QT, KT, 64>(q, kp, vp, tables, kv_len, out, B, hq, hkv, nb, bs, scale, st);
    case 128:
      return launch<QT, KT, 128>(q, kp, vp, tables, kv_len, out, B, hq, hkv, nb, bs, scale,
                                 st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename QT>
cudaError_t by_kv(int kv_dtype, int hd, const void* q, const void* kp, const void* vp,
                  const int* tables, const int* kv_len, void* out, int B, int hq, int hkv,
                  int nb, int bs, float scale, cudaStream_t st) {
  switch (kv_dtype) {
    case F32:
      return by_hd<QT, float>(hd, q, kp, vp, tables, kv_len, out, B, hq, hkv, nb, bs, scale,
                              st);
    case BF16:
      return by_hd<QT, __nv_bfloat16>(hd, q, kp, vp, tables, kv_len, out, B, hq, hkv, nb, bs,
                                      scale, st);
    case F16:
      return by_hd<QT, __half>(hd, q, kp, vp, tables, kv_len, out, B, hq, hkv, nb, bs, scale,
                               st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point bound with ctypes (kernels/decode_attention.py). Returns the
// launch's cudaGetLastError() (0 = launched).
extern "C" int paged_decode_attention(const void* q, const void* k_pages, const void* v_pages,
                                      const void* block_tables, const void* kv_len, void* out,
                                      int B, int hq, int hkv, int hd, int nb, int bs,
                                      float scale, int q_dtype, int kv_dtype, void* stream) {
  const int* tb = static_cast<const int*>(block_tables);
  const int* kl = static_cast<const int*>(kv_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  switch (q_dtype) {
    case F32:
      return by_kv<float>(kv_dtype, hd, q, k_pages, v_pages, tb, kl, out, B, hq, hkv, nb, bs,
                          scale, st);
    case BF16:
      return by_kv<__nv_bfloat16>(kv_dtype, hd, q, k_pages, v_pages, tb, kl, out, B, hq, hkv,
                                  nb, bs, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
