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
// With scale/zero pools the pages are int8 and no dequantized copy of a
// pool is ever written.
//
// Design: one block per (tile of tile_q tokens, kv head). Its tile_q * G
// query rows (G = Hq / Hkv; 8 * 4 = 32 rows at granite-3-8b, hd 128) share
// every K/V page load. The TPU grid's sequential page axis is a loop inside
// the block, which reads its own page ids from the table and stops at the
// tile's largest pos instead of walking all nb pages. Two bodies:
//
// - tensor cores (ragged_mma_kernel, mma_attention.cuh), for bf16 q over
//   bf16 or int8 pages with G <= 8: a stage gathers 64 keys (4 pages of 16)
//   by cp.async, 16 bytes a copy, two stages in a ring, with the page ids
//   of the stage after next read from the table meanwhile; QK and PV run
//   on mma.sync. The tile's 32 rows are two warps' worth, so pairs of warps
//   split each stage's keys (four warps share 16 rows where the tile's real
//   tokens fill only those, as a decode row's tile does). int8 pages factor
//   their per-row scale and zero out of both products (QK a bf16 mma on the
//   raw codes, PV an fp16 mma on p * scale and the codes).
// - CUDA cores (ragged_kernel, paged_attention_common.cuh), for f32 q or
//   pages, fp16 pages under a bf16 q (no one 16-bit mma type takes that
//   pair), and G > 8: each page is widened to f32 in shared memory and every
//   score and PV term is an f32 FMA, the int8 pages dequantized in the load.
//   It serves the f32 tests, which hold it to 1e-5.
// The C entry point picks the body by dtype and G, and reports which.
//
// What bounds it: the bytes of K/V it reads. Each tile reads its sequence's
// history once per kv head, so a prefill chunk of n tokens reads the history
// n / tile_q times (from L2 for all but the first); a decode row reads it
// once. The tensor-core body's products take a few percent of a stage's
// time; what is left is the page walk's latency (a decode row's 64 pages in
// one block) and the L2 reads of the chunks' tiles.

#include "mma_attention.cuh"
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

// ---------------------------------------------------------------------------
// the tensor-core body
// ---------------------------------------------------------------------------

// Rows and keys of one (tile, kv head): row r is token t0 + r / G, q head
// h * G + r % G; key kpos is slot kpos % bs of page trow[kpos / bs].
struct RaggedMap {
  const int* trow;
  const int* pos;
  int64_t t0;
  int bs, hkv, h, hq, G, hd;
  __device__ __forceinline__ bool query(int r, int64_t& off, int& vlen) const {
    const int64_t t = t0 + r / G;
    off = (t * hq + h * G + r % G) * hd;
    vlen = pos[t] + 1;
    return true;
  }
  __device__ __forceinline__ int64_t key(int kpos) const {
    return (static_cast<int64_t>(trow[kpos / bs]) * bs + kpos % bs) * hkv + h;
  }
};

template <typename KT, bool Q8, int HD>
__global__ void __launch_bounds__(mma_attn::THREADS)
ragged_mma_kernel(const __nv_bfloat16* __restrict__ q, const KT* __restrict__ k_pages,
                  const KT* __restrict__ v_pages, const float* __restrict__ k_scale,
                  const float* __restrict__ k_zero, const float* __restrict__ v_scale,
                  const float* __restrict__ v_zero, const int* __restrict__ tables,
                  const int* __restrict__ row, const int* __restrict__ pos,
                  __nv_bfloat16* __restrict__ out, int hq, int hkv, int nb, int bs, int tile_q,
                  float scale) {
  extern __shared__ __align__(128) char smem_mma[];
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * tile_q;
  const int h = blockIdx.y;
  const int G = hq / hkv;
  // the tile's longest row, and its last real token: the rows past that
  // token's are pads, so fewer row groups may take all four warps
  int len = 0, last = -1;
  for (int i = 0; i < tile_q; ++i) {
    const int p = pos[t0 + i];
    len = max(len, p + 1);
    if (p >= 0) last = i;
  }
  len = min(len, nb * bs);
  const RaggedMap mp{tables + static_cast<int64_t>(row[t0]) * nb, pos, t0, bs, hkv, h, hq, G,
                     HD};
  const float* sc[4] = {k_scale, k_zero, v_scale, v_zero};
  const int rows = (last + 1) * G;
  const int R = tile_q * G;
  using mma_attn::attend;
  if (rows <= 16) {
    attend<__nv_bfloat16, KT, Q8, HD, 4>(mp, q, k_pages, v_pages, sc, out, R, len, scale,
                                         smem_mma);
  } else if (rows <= 32) {
    attend<__nv_bfloat16, KT, Q8, HD, 2>(mp, q, k_pages, v_pages, sc, out, R, len, scale,
                                         smem_mma);
  } else {
    attend<__nv_bfloat16, KT, Q8, HD, 1>(mp, q, k_pages, v_pages, sc, out, R, len, scale,
                                         smem_mma);
  }
}

template <typename KT, int HD>
cudaError_t launch_mma(const void* q, const void* k_pages, const void* v_pages,
                       const float* k_scale, const float* k_zero, const float* v_scale,
                       const float* v_zero, const int* tables, const int* row, const int* pos,
                       void* out, int T, int hq, int hkv, int nb, int bs, int tile_q,
                       float scale, cudaStream_t stream) {
  constexpr bool Q8 = sizeof(KT) == 1;
  static size_t configured = 0;
  const size_t bytes = mma_attn::Layout<HD>::bytes(Q8);
  auto kernel = ragged_mma_kernel<KT, Q8, HD>;
  cudaError_t e = ensure_smem(kernel, bytes, &configured);
  if (e != cudaSuccess) return e;
  const dim3 grid(T / tile_q, hkv);
  kernel<<<grid, mma_attn::THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), k_scale, k_zero, v_scale, v_zero, tables, row, pos,
      static_cast<__nv_bfloat16*>(out), hq, hkv, nb, bs, tile_q, scale);
  return cudaGetLastError();
}

template <typename KT>
cudaError_t mma_by_hd(int hd, const void* q, const void* kp, const void* vp, const float* ks,
                      const float* kz, const float* vs, const float* vz, const int* tables,
                      const int* row, const int* pos, void* out, int T, int hq, int hkv,
                      int nb, int bs, int tile_q, float scale, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch_mma<KT, 16>(q, kp, vp, ks, kz, vs, vz, tables, row, pos, out, T, hq, hkv,
                                nb, bs, tile_q, scale, st);
    case 32:
      return launch_mma<KT, 32>(q, kp, vp, ks, kz, vs, vz, tables, row, pos, out, T, hq, hkv,
                                nb, bs, tile_q, scale, st);
    case 64:
      return launch_mma<KT, 64>(q, kp, vp, ks, kz, vs, vz, tables, row, pos, out, T, hq, hkv,
                                nb, bs, tile_q, scale, st);
    case 128:
      return launch_mma<KT, 128>(q, kp, vp, ks, kz, vs, vz, tables, row, pos, out, T, hq, hkv,
                                 nb, bs, tile_q, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point bound with ctypes (kernels/ragged_attention.py). The scale/
// zero pointers are null for float pages and all four set for int8 pages.
// *body is set to the body launched: 1 the tensor cores, 0 the CUDA cores.
// Returns the launch's cudaGetLastError() (0 = launched).
extern "C" int ragged_paged_attention(const void* q, const void* k_pages,
                                      const void* v_pages, const void* k_scale,
                                      const void* k_zero, const void* v_scale,
                                      const void* v_zero, const void* tables,
                                      const void* row, const void* pos, void* out, int T,
                                      int hq, int hkv, int hd, int nb, int bs, int tile_q,
                                      float scale, int q_dtype, int kv_dtype,
                                      void* stream, int* body) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* kz = static_cast<const float*>(k_zero);
  const float* vs = static_cast<const float*>(v_scale);
  const float* vz = static_cast<const float*>(v_zero);
  const int* tb = static_cast<const int*>(tables);
  const int* rw = static_cast<const int*>(row);
  const int* ps = static_cast<const int*>(pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool mma = q_dtype == BF16 && (kv_dtype == BF16 || kv_dtype == I8) &&
                   tile_q * (hq / hkv) <= mma_attn::ROWS;
  *body = mma ? 1 : 0;
  if (T == 0) return 0;
  if (mma) {
    return kv_dtype == I8
               ? mma_by_hd<int8_t>(hd, q, k_pages, v_pages, ks, kz, vs, vz, tb, rw, ps, out,
                                   T, hq, hkv, nb, bs, tile_q, scale, st)
               : mma_by_hd<__nv_bfloat16>(hd, q, k_pages, v_pages, ks, kz, vs, vz, tb, rw,
                                          ps, out, T, hq, hkv, nb, bs, tile_q, scale, st);
  }
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
