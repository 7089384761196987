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
// What bounds it: the bytes of K/V read, each page once per kv head. But a
// decode step has one query row per (sequence, q head), so B x Hkv blocks
// (32 at granite-3-8b batch 4, on 132 SMs) that each walk a whole span
// alone would leave the card's memory rate unused: a block's serial walk
// over its pages would set the time. Two bodies:
//
// - tensor cores (paged_decode_mma_kernel), for a bf16 q over bf16 pages
//   with G = Hq / Hkv <= 64: the walk is split over blocks
//   (decode_split.cuh). Block (b, h, s) takes kv positions
//   [s KPS, (s + 1) KPS) of sequence b, reads their page ids from its table
//   row, and runs the body of flash and ragged attention
//   (mma_attention.cuh: cp.async stages of 64 keys, QK and PV on
//   mma.sync, the four warps splitting each stage's keys for G <= 16); a
//   combine pass adds the splits' partials in split order. At granite
//   batch 4 and kv_len up to 1,024 that is up to 8 splits, 256 blocks.
// - CUDA cores (paged_decode_kernel), for f32 q or pages and fp16 pages
//   under a bf16 q: one block per (sequence, kv head) with the G query
//   rows; the TPU grid's page axis is a loop inside the block over
//   ceil(kv_len / bs) pages, each widened to f32 in shared memory and
//   scored with f32 FMAs, the next page's loads in flight meanwhile
//   (PageLoader; the per-page online softmax is the ragged kernel's, as
//   the TPU kernels share _softmax_step). The f32 tests hold it to 1e-5.
// The C entry point picks the body by dtype and G, and reports which.

#include "decode_split.cuh"
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

// ---------------------------------------------------------------------------
// the tensor-core body, split over keys
// ---------------------------------------------------------------------------

// Split (b, h, s): key kpos is position k0 + kpos of sequence b, slot
// (k0 + kpos) % bs of page trow[(k0 + kpos) / bs].
struct PagedDecodeMap : dsplit::SplitRows {
  const int* trow;
  int k0, bs, hkv;
  __device__ __forceinline__ int64_t key(int kpos) const {
    const int p = k0 + kpos;
    return (static_cast<int64_t>(trow[p / bs]) * bs + p % bs) * hkv + h;
  }
};

template <int HD>
__global__ void __launch_bounds__(mma_attn::THREADS)
paged_decode_mma_kernel(dsplit::Workspace ws, const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k_pages,
                        const __nv_bfloat16* __restrict__ v_pages,
                        const int* __restrict__ tables, const int* __restrict__ kv_len, int hq,
                        int hkv, int nb, int bs, int n_split, float scale) {
  extern __shared__ __align__(128) char smem_mma[];
  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int k0 = s * dsplit::KPS;
  const int len = min(min(max(kv_len[b], 0), nb * bs) - k0, dsplit::KPS);
  if (len <= 0) return;  // past the row's end: the combine reads no partial here
  const int G = hq / hkv;
  const PagedDecodeMap mp{{ws.o, ws.m, ws.l, b, h, s, hq, G, HD, n_split, len},
                          tables + static_cast<int64_t>(b) * nb,
                          k0,
                          bs,
                          hkv};
  dsplit::attend_split<__nv_bfloat16, __nv_bfloat16, false, HD>(mp, q, k_pages, v_pages,
                                                                 nullptr, G, len, scale,
                                                                 smem_mma);
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k_pages, const void* v_pages,
                       const int* tables, const int* kv_len, void* out, void* ws, int B, int hq,
                       int hkv, int nb, int bs, int n_split, float scale, cudaStream_t stream) {
  using T = __nv_bfloat16;
  static size_t configured = 0;
  return dsplit::launch<T, HD>(paged_decode_mma_kernel<HD>, &configured,
                               dsplit::carve(ws, B, hq, n_split, HD), kv_len, out, B, hq, hkv,
                               n_split, nb * bs, stream, static_cast<const T*>(q),
                               static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
                               tables, kv_len, hq, hkv, nb, bs, n_split, scale);
}

cudaError_t mma_by_hd(int hd, const void* q, const void* kp, const void* vp, const int* tables,
                      const int* kv_len, void* out, void* ws, int B, int hq, int hkv, int nb,
                      int bs, int n_split, float scale, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch_mma<16>(q, kp, vp, tables, kv_len, out, ws, B, hq, hkv, nb, bs, n_split,
                            scale, st);
    case 32:
      return launch_mma<32>(q, kp, vp, tables, kv_len, out, ws, B, hq, hkv, nb, bs, n_split,
                            scale, st);
    case 64:
      return launch_mma<64>(q, kp, vp, tables, kv_len, out, ws, B, hq, hkv, nb, bs, n_split,
                            scale, st);
    case 128:
      return launch_mma<128>(q, kp, vp, tables, kv_len, out, ws, B, hq, hkv, nb, bs, n_split,
                             scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point bound with ctypes (kernels/decode_attention.py). ws: the
// tensor-core body's f32 workspace of B x Hq x n_split x (hd + 2) floats,
// n_split = ceil(nb bs / KPS) (decode_split.cuh); the CUDA-core body
// leaves it alone. *body is set to the body launched: 1 the tensor cores,
// 0 the CUDA cores. Returns the launch's cudaGetLastError() (0 = launched).
extern "C" int paged_decode_attention(const void* q, const void* k_pages, const void* v_pages,
                                      const void* block_tables, const void* kv_len, void* out,
                                      void* ws, int B, int hq, int hkv, int hd, int nb, int bs,
                                      int n_split, float scale, int q_dtype, int kv_dtype,
                                      void* stream, int* body) {
  const int* tb = static_cast<const int*>(block_tables);
  const int* kl = static_cast<const int*>(kv_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool mma = q_dtype == BF16 && kv_dtype == BF16 && hq / hkv <= mma_attn::ROWS;
  *body = mma ? 1 : 0;
  if (B == 0) return 0;
  if (mma) {
    if (n_split != dsplit::n_splits(nb * bs)) return cudaErrorInvalidValue;
    return mma_by_hd(hd, q, k_pages, v_pages, tb, kl, out, ws, B, hq, hkv, nb, bs, n_split, scale,
                     st);
  }
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
