// Flash attention (prefill) over slot-contiguous K/V for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (body _kernel).
//
// What it computes: GQA attention of q (B,Sq,Hq,hd) over k, v (B,Sk,Hkv,hd),
// causal or not. Query position t (absolute position q_offset + t) attends
// keys kpos < Sk and, when causal, kpos <= q_offset + t. Scores, the online
// softmax and the sums run in float32; the output is in q's dtype. A row
// with no valid key (Sk == 0 cannot reach the kernel) would be exactly 0.
//
// Design: one block per (tile of query positions, kv head, batch row); the
// tile's positions times the GQA group G are the block's rows, so every
// group shares the block's K/V loads. The TPU grid's sequential kv axis is a
// loop inside the block, bounded by the tile's longest row,
// min(q_offset + last position + 1, Sk) when causal: a causal tile never
// touches keys past its last query, and no tile walks Sk padded up to a
// block. Two bodies:
//
// - tensor cores (flash_mma_kernel, mma_attention.cuh), for bf16 and fp16:
//   64 rows a block (16 positions x G 4 at granite-3-8b: 26 x 8 = 208 blocks
//   at Sq 412 on 132 SMs), 4 warps of 16 rows with their Q fragments in
//   registers, K/V tiles of 64 keys by cp.async in a two-stage ring, QK and
//   PV on mma.sync, the longest causal tiles launched first.
// - CUDA cores (flash_kernel, paged_attention_common.cuh), for f32, which
//   the f32 tests hold to 1e-5: 32 rows a block, K/V tiles of 32 keys
//   widened to f32 in shared memory, every score and PV term an f32 FMA.
// The C entry point picks the body by dtype and reports which.
//
// What bounds it: at the main path's prefill (batch 1, Sq = Sk = a few
// hundred tokens, hd 128) neither the bytes (0.0025 ms at Sq 412) nor the
// tensor-core rate: each K/V tile is read once per query tile from L2, and
// a block's stages follow one another, each a load's latency plus its
// products, so the walk's latency and the L2 reads are what is left.

#include "mma_attention.cuh"
#include "paged_attention_common.cuh"

namespace {

using namespace pattn;

constexpr int KB = 32;         // keys per K/V tile of the CUDA-core body
constexpr int CORE_ROWS = 32;  // query rows a block of the CUDA-core body

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int sq, int sk, int hq, int hkv, int tile_q, int causal,
             int q_offset, float scale) {
  extern __shared__ float smem[];
  const int t0 = blockIdx.x * tile_q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = hq / hkv;
  const int R = tile_q * G;
  const Smem s = carve(smem, R, KB, HD);

  // query rows r = token * G + g of kv head h: q[b, t0 + token, h * G + g, :]
  for (int e = threadIdx.x; e < R * HD; e += blockDim.x) {
    const int r = e / HD;
    const int t = t0 + r / G;
    const int64_t src = ((static_cast<int64_t>(b) * sq + t) * hq + h * G + r % G) * HD + e % HD;
    s.q[e] = t < sq ? to_f32<T>(q[src]) : 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const int t = t0 + r / G;
    s.vlen[r] = t >= sq ? 0 : (causal ? min(q_offset + t + 1, sk) : sk);
  }
  softmax_init(s, R, HD);
  const int t_last = min(t0 + tile_q, sq) - 1;
  const int len = causal ? min(q_offset + t_last + 1, sk) : sk;
  __syncthreads();

  softmax_rows<T, HD>(s, R, k, v, hkv, h, static_cast<int64_t>(b) * sk, len, KB, scale);

  for (int e = threadIdx.x; e < R * HD; e += blockDim.x) {
    const int r = e / HD;
    const int t = t0 + r / G;
    if (t >= sq) continue;
    const int64_t dst = ((static_cast<int64_t>(b) * sq + t) * hq + h * G + r % G) * HD + e % HD;
    out[dst] = from_f32<T>(s.acc[e] / fmaxf(s.l[r], 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int sq, int sk,
                   int hq, int hkv, int tile_q, int causal, int q_offset, float scale,
                   cudaStream_t stream) {
  static size_t configured = 0;
  const size_t bytes = smem_floats(tile_q * (hq / hkv), KB, HD) * sizeof(float);
  auto kernel = flash_kernel<T, HD>;
  cudaError_t e = ensure_smem(kernel, bytes, &configured);
  if (e != cudaSuccess) return e;
  const dim3 grid((sq + tile_q - 1) / tile_q, hkv, B);
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(out), sq,
                                           sk, hq, hkv, tile_q, causal, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_hd(int hd, const void* q, const void* k, const void* v, void* out, int B, int sq,
                  int sk, int hq, int hkv, int tile_q, int causal, int q_offset, float scale,
                  cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, out, B, sq, sk, hq, hkv, tile_q, causal, q_offset, scale, st);
    case 32:
      return launch<T, 32>(q, k, v, out, B, sq, sk, hq, hkv, tile_q, causal, q_offset, scale, st);
    case 64:
      return launch<T, 64>(q, k, v, out, B, sq, sk, hq, hkv, tile_q, causal, q_offset, scale, st);
    case 128:
      return launch<T, 128>(q, k, v, out, B, sq, sk, hq, hkv, tile_q, causal, q_offset, scale,
                            st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// the tensor-core body
// ---------------------------------------------------------------------------

// Rows and keys of one (tile, kv head, batch row): row r is position
// t0 + r / G, q head h * G + r % G; key kpos is row b * Sk + kpos.
struct FlashMap {
  int b, t0, sq, sk, hq, hkv, h, G, hd, causal, q_offset;
  __device__ __forceinline__ bool query(int r, int64_t& off, int& vlen) const {
    const int t = t0 + r / G;
    if (t >= sq) return false;
    off = ((static_cast<int64_t>(b) * sq + t) * hq + h * G + r % G) * hd;
    vlen = causal ? min(q_offset + t + 1, sk) : sk;
    return true;
  }
  __device__ __forceinline__ int64_t key(int kpos) const {
    return (static_cast<int64_t>(b) * sk + kpos) * hkv + h;
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(mma_attn::THREADS)
flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int sq, int sk, int hq, int hkv, int tile_q, int causal,
                 int q_offset, float scale) {
  extern __shared__ __align__(128) char smem_mma[];
  // the longest causal tiles first, so the short ones fill the tail
  const int t0 = (gridDim.x - 1 - blockIdx.x) * tile_q;
  const int G = hq / hkv;
  const int t_last = min(t0 + tile_q, sq) - 1;
  const int len = causal ? min(q_offset + t_last + 1, sk) : sk;
  const FlashMap mp{static_cast<int>(blockIdx.z), t0, sq, sk, hq, hkv,
                    static_cast<int>(blockIdx.y), G, HD, causal, q_offset};
  mma_attn::attend<T, T, false, HD, 1>(mp, q, k, v, nullptr, out, tile_q * G, len, scale,
                                       smem_mma);
}

template <typename T, int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, int B, int sq,
                       int sk, int hq, int hkv, int causal, int q_offset, float scale,
                       cudaStream_t stream) {
  static size_t configured = 0;
  const int tile_q = max(1, mma_attn::ROWS / (hq / hkv));
  const size_t bytes = mma_attn::Layout<HD>::bytes(false);
  auto kernel = flash_mma_kernel<T, HD>;
  cudaError_t e = ensure_smem(kernel, bytes, &configured);
  if (e != cudaSuccess) return e;
  const dim3 grid((sq + tile_q - 1) / tile_q, hkv, B);
  kernel<<<grid, mma_attn::THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, sk, hq, hkv, tile_q, causal, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t mma_by_hd(int hd, const void* q, const void* k, const void* v, void* out, int B,
                      int sq, int sk, int hq, int hkv, int causal, int q_offset, float scale,
                      cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch_mma<T, 16>(q, k, v, out, B, sq, sk, hq, hkv, causal, q_offset, scale, st);
    case 32:
      return launch_mma<T, 32>(q, k, v, out, B, sq, sk, hq, hkv, causal, q_offset, scale, st);
    case 64:
      return launch_mma<T, 64>(q, k, v, out, B, sq, sk, hq, hkv, causal, q_offset, scale, st);
    case 128:
      return launch_mma<T, 128>(q, k, v, out, B, sq, sk, hq, hkv, causal, q_offset, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point bound with ctypes (kernels/flash_attention.py): q, k, v and
// out share one dtype. *body is set to the body launched: 1 the tensor
// cores (bf16, fp16, G <= 64), 0 the CUDA cores. Returns the launch's
// cudaGetLastError() (0 = launched).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                               int sq, int sk, int hq, int hkv, int hd, int causal,
                               int q_offset, float scale, int dtype, void* stream, int* body) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool mma = (dtype == BF16 || dtype == F16) && hq / hkv <= mma_attn::ROWS;
  *body = mma ? 1 : 0;
  if (B == 0 || sq == 0) return 0;
  if (mma) {
    return dtype == BF16 ? mma_by_hd<__nv_bfloat16>(hd, q, k, v, out, B, sq, sk, hq, hkv,
                                                    causal, q_offset, scale, st)
                         : mma_by_hd<__half>(hd, q, k, v, out, B, sq, sk, hq, hkv, causal,
                                             q_offset, scale, st);
  }
  const int tile_q = max(1, CORE_ROWS / (hq / hkv));
  switch (dtype) {
    case F32:
      return by_hd<float>(hd, q, k, v, out, B, sq, sk, hq, hkv, tile_q, causal, q_offset, scale,
                          st);
    case BF16:
      return by_hd<__nv_bfloat16>(hd, q, k, v, out, B, sq, sk, hq, hkv, tile_q, causal,
                                  q_offset, scale, st);
    case F16:
      return by_hd<__half>(hd, q, k, v, out, B, sq, sk, hq, hkv, tile_q, causal, q_offset,
                           scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
