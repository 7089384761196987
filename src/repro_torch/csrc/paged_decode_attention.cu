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
// What bounds it: the bytes of K/V read, each page once per kv head (8.6
// MB at granite-3-8b batch 4 and kv_len 1,024/777/300/1: 0.0026 ms at
// 3.35 TB/s). But a decode step has one query row per (sequence, q head),
// so B x Hkv blocks (32 at granite batch 4, on 132 SMs) that each walk a
// whole span alone would leave the card's memory rate unused: a block's
// serial walk over its pages would set the time, and at these sizes the
// walk's latency (table reads, loads, launches) costs more than its bytes.
// Two bodies:
//
// - tensor cores (decode_split.cuh's decode_cluster_kernel), for a bf16 q
//   over bf16 pages with G = Hq / Hkv <= 64: the walk is split over blocks
//   of KPS = 128 positions, and the blocks of one (sequence, kv head) form
//   a cluster of C = min(8, ceil(nb bs / KPS)) blocks, each walking every
//   C-th split, that combines the splits' partials in split order before
//   the launch ends: one launch, no second kernel and no launch gap. A
//   block reads its row's length and first split's page ids together,
//   then brings the split's K and V by TMA, one box a page (or a
//   power-of-two part of one, so no box crosses a page) into a two-stage
//   mbarrier ring; all of a split is in flight before its first product.
//   The products stay on mma.sync (mma_attention.cuh's fold): with G <= 16
//   query rows a block the tensor cores are a few percent of a split's
//   time, what bounds it is latency, and their arithmetic keeps the bits of
//   the ragged kernel's decode runs, which run the same split and combine
//   in two kernels. At granite batch 4 under the engine's table of 65
//   pages that is clusters of 8, 256 blocks, of which those past a row's
//   end only wait at the cluster barrier.
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
// the tensor-core body: one cluster launch (decode_split.cuh)
// ---------------------------------------------------------------------------

// Position p of sequence b: slot p % bs of page tables[b][p / bs], in the
// pool's map (HD, Hkv, bs, N).
struct PagedSrc {
  const int* tables;
  int nb, bs;
  __device__ __forceinline__ int page(int b, int p) const {
    return tables[static_cast<int64_t>(b) * nb + p / bs];
  }
  __device__ __forceinline__ int row(int p) const { return p % bs; }
};

template <int HD>
cudaError_t launch_mma(const void* q, const void* k_pages, const void* v_pages,
                       const int* tables, const int* kv_len, void* out, void* ws, int B, int hq,
                       int hkv, int nb, int bs, int n_pages, int n_split, int cluster, float scale,
                       cudaStream_t stream, int* launched) {
  using T = __nv_bfloat16;
  dsplit::Args a{};
  a.q = q;
  a.out = out;
  a.kv_len = kv_len;
  a.ws = dsplit::carve(ws, B, hq, n_split, HD);
  a.hq = hq;
  a.hkv = hkv;
  a.n_split = n_split;
  a.cap = nb * bs;
  a.lh = dsplit::box_log2(bs);
  a.ls = a.lh;
  while ((1 << a.ls) < dsplit::TmaTile<HD>::MINROWS) ++a.ls;
  a.scale = scale;
  CUtensorMap km{}, vm{};
  if (n_split > 0 &&
      (!dsplit::make_kv_map<T, HD>(&km, k_pages, hkv, bs, n_pages, 1 << a.lh) ||
       !dsplit::make_kv_map<T, HD>(&vm, v_pages, hkv, bs, n_pages, 1 << a.lh))) {
    return cudaErrorInvalidValue;
  }
  return dsplit::launch_cluster<T, HD>(km, vm, PagedSrc{tables, nb, bs}, a, B, cluster, launched,
                                       stream);
}

cudaError_t mma_by_hd(int hd, const void* q, const void* kp, const void* vp, const int* tables,
                      const int* kv_len, void* out, void* ws, int B, int hq, int hkv, int nb,
                      int bs, int n_pages, int n_split, int cluster, float scale, cudaStream_t st,
                      int* launched) {
  switch (hd) {
    case 16:
      return launch_mma<16>(q, kp, vp, tables, kv_len, out, ws, B, hq, hkv, nb, bs, n_pages,
                            n_split, cluster, scale, st, launched);
    case 32:
      return launch_mma<32>(q, kp, vp, tables, kv_len, out, ws, B, hq, hkv, nb, bs, n_pages,
                            n_split, cluster, scale, st, launched);
    case 64:
      return launch_mma<64>(q, kp, vp, tables, kv_len, out, ws, B, hq, hkv, nb, bs, n_pages,
                            n_split, cluster, scale, st, launched);
    case 128:
      return launch_mma<128>(q, kp, vp, tables, kv_len, out, ws, B, hq, hkv, nb, bs, n_pages,
                             n_split, cluster, scale, st, launched);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point bound with ctypes (kernels/decode_attention.py). ws: the
// tensor-core body's f32 workspace of B x Hq x n_split x (hd + 2) floats,
// its partials, n_split = ceil(nb bs / KPS) (decode_split.cuh); the
// CUDA-core body leaves it alone. cluster: the most blocks a (sequence, kv
// head) of the tensor-core launch, in [1, 16] (the wrapper's min(8,
// n_split), at least 1); n_pages: the pool's N. *launched is set to the
// cluster size the tensor-core launch took (0 for the CUDA-core body),
// *body to the body launched: 1 the tensor cores, 0 the CUDA cores.
// Returns the launch's error, else its cudaGetLastError() (0 = launched).
extern "C" int paged_decode_attention(const void* q, const void* k_pages, const void* v_pages,
                                      const void* block_tables, const void* kv_len, void* out,
                                      void* ws, int B, int hq, int hkv, int hd, int nb, int bs,
                                      int n_split, float scale, int q_dtype, int kv_dtype,
                                      int n_pages, int cluster, void* stream, int* launched,
                                      int* body) {
  const int* tb = static_cast<const int*>(block_tables);
  const int* kl = static_cast<const int*>(kv_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool mma = q_dtype == BF16 && kv_dtype == BF16 && hq / hkv <= mma_attn::ROWS;
  *body = mma ? 1 : 0;
  *launched = 0;
  if (B == 0) return 0;
  if (mma) {
    if (n_split != dsplit::n_splits(nb * bs)) return cudaErrorInvalidValue;
    return mma_by_hd(hd, q, k_pages, v_pages, tb, kl, out, ws, B, hq, hkv, nb, bs, n_pages,
                     n_split, cluster, scale, st, launched);
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
