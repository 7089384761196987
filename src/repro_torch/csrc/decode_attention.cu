// Decode attention over slot-contiguous caches for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention (body _kernel, sharing _softmax_step with the paged one).
//
// What it computes: one query token per sequence, q (B,1,Hq,hd), against the
// sequence's own cache strip, k/v caches (B,S,Hkv,hd), over the first
// kv_len[b] positions (clamped to [0, S]). A row with kv_len 0 is exactly 0.
// No cache row at or past kv_len is ever read, so a stale slot may hold
// anything: the TPU grid's kv axis walked all of S masked, these bodies stop
// at kv_len.
//
// What bounds it: the bytes of K/V read, each row once per kv head; but at
// granite-3-8b batch 4 one block per (sequence, kv head) is only 32 blocks
// on 132 SMs, and one block's serial walk would set the time, as for the
// paged kernel. Two bodies, as there:
//
// - tensor cores (decode_mma_kernel), for bf16 and fp16 caches with
//   G = Hq / Hkv <= 64: the walk split over blocks of KPS positions and
//   combined in a second pass (decode_split.cuh), each split on the body of
//   flash and ragged attention (mma_attention.cuh); a split's keys are rows
//   b S + k0 + kpos of the cache.
// - CUDA cores (decode_kernel), for f32: one block per (sequence, kv head),
//   a loop over tiles of KB rows widened to f32 that stops at kv_len[b]
//   (paged_attention_common.cuh's tile loader and online softmax). The f32
//   tests hold it to 1e-5.
// The C entry point picks the body by dtype and G, and reports which.

#include "decode_split.cuh"
#include "paged_attention_common.cuh"

namespace {

using namespace pattn;

constexpr int KB = 32;  // cache rows per K/V tile

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
              const T* __restrict__ v_cache, const int* __restrict__ kv_len,
              T* __restrict__ out, int S, int hq, int hkv, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = hq / hkv;
  const Smem s = carve(smem, G, KB, HD);
  const int64_t q0 = (static_cast<int64_t>(b) * hq + h * G) * HD;

  for (int e = threadIdx.x; e < G * HD; e += blockDim.x) s.q[e] = to_f32<T>(q[q0 + e]);
  const int len = min(max(kv_len[b], 0), S);
  for (int r = threadIdx.x; r < G; r += blockDim.x) s.vlen[r] = len;
  softmax_init(s, G, HD);
  __syncthreads();

  softmax_rows<T, HD>(s, G, k_cache, v_cache, hkv, h, static_cast<int64_t>(b) * S, len, KB,
                      scale);

  for (int e = threadIdx.x; e < G * HD; e += blockDim.x) {
    out[q0 + e] = from_f32<T>(s.acc[e] / fmaxf(s.l[e / HD], 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* kc, const void* vc, const int* kv_len, void* out,
                   int B, int S, int hq, int hkv, float scale, cudaStream_t stream) {
  static size_t configured = 0;
  const size_t bytes = smem_floats(hq / hkv, KB, HD) * sizeof(float);
  auto kernel = decode_kernel<T, HD>;
  cudaError_t e = ensure_smem(kernel, bytes, &configured);
  if (e != cudaSuccess) return e;
  const dim3 grid(B, hkv);
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(kc),
                                           static_cast<const T*>(vc), kv_len,
                                           static_cast<T*>(out), S, hq, hkv, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_hd(int hd, const void* q, const void* kc, const void* vc, const int* kv_len,
                  void* out, int B, int S, int hq, int hkv, float scale, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, kc, vc, kv_len, out, B, S, hq, hkv, scale, st);
    case 32:
      return launch<T, 32>(q, kc, vc, kv_len, out, B, S, hq, hkv, scale, st);
    case 64:
      return launch<T, 64>(q, kc, vc, kv_len, out, B, S, hq, hkv, scale, st);
    case 128:
      return launch<T, 128>(q, kc, vc, kv_len, out, B, S, hq, hkv, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// the tensor-core body, split over keys
// ---------------------------------------------------------------------------

// Split (b, h, s): key kpos is cache row b S + k0 + kpos.
struct ContigDecodeMap : dsplit::SplitRows {
  int S, k0, hkv;
  __device__ __forceinline__ int64_t key(int kpos) const {
    return (static_cast<int64_t>(b) * S + k0 + kpos) * hkv + h;
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(mma_attn::THREADS)
decode_mma_kernel(dsplit::Workspace ws, const T* __restrict__ q, const T* __restrict__ k_cache,
                  const T* __restrict__ v_cache, const int* __restrict__ kv_len, int S, int hq,
                  int hkv, int n_split, float scale) {
  extern __shared__ __align__(128) char smem_mma[];
  const int b = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int k0 = s * dsplit::KPS;
  const int len = min(min(max(kv_len[b], 0), S) - k0, dsplit::KPS);
  if (len <= 0) return;  // past the row's end: the combine reads no partial here
  const int G = hq / hkv;
  const ContigDecodeMap mp{{ws.o, ws.m, ws.l, b, h, s, hq, G, HD, n_split, len}, S, k0, hkv};
  dsplit::attend_split<T, T, false, HD>(mp, q, k_cache, v_cache, nullptr, G, len, scale,
                                        smem_mma);
}

template <typename T, int HD>
cudaError_t launch_mma(const void* q, const void* kc, const void* vc, const int* kv_len,
                       void* out, void* ws, int B, int S, int hq, int hkv, int n_split,
                       float scale, cudaStream_t stream) {
  static size_t configured = 0;
  return dsplit::launch<T, HD>(decode_mma_kernel<T, HD>, &configured,
                               dsplit::carve(ws, B, hq, n_split, HD), kv_len, out, B, hq, hkv,
                               n_split, S, stream, static_cast<const T*>(q),
                               static_cast<const T*>(kc), static_cast<const T*>(vc), kv_len, S,
                               hq, hkv, n_split, scale);
}

template <typename T>
cudaError_t mma_by_hd(int hd, const void* q, const void* kc, const void* vc, const int* kv_len,
                      void* out, void* ws, int B, int S, int hq, int hkv, int n_split,
                      float scale, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch_mma<T, 16>(q, kc, vc, kv_len, out, ws, B, S, hq, hkv, n_split, scale, st);
    case 32:
      return launch_mma<T, 32>(q, kc, vc, kv_len, out, ws, B, S, hq, hkv, n_split, scale, st);
    case 64:
      return launch_mma<T, 64>(q, kc, vc, kv_len, out, ws, B, S, hq, hkv, n_split, scale, st);
    case 128:
      return launch_mma<T, 128>(q, kc, vc, kv_len, out, ws, B, S, hq, hkv, n_split, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point bound with ctypes (kernels/decode_attention.py): q, the caches
// and out share one dtype. ws: the tensor-core body's f32 workspace of
// B x Hq x n_split x (hd + 2) floats, n_split = ceil(S / KPS)
// (decode_split.cuh); the CUDA-core body leaves it alone. *body is set to the
// body launched: 1 the tensor cores, 0 the CUDA cores. Returns the launch's
// cudaGetLastError() (0 = launched).
extern "C" int decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                const void* kv_len, void* out, void* ws, int B, int S, int hq,
                                int hkv, int hd, int n_split, float scale, int dtype,
                                void* stream, int* body) {
  const int* kl = static_cast<const int*>(kv_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool mma = (dtype == BF16 || dtype == F16) && hq / hkv <= mma_attn::ROWS;
  *body = mma ? 1 : 0;
  if (B == 0) return 0;
  if (mma) {
    if (n_split != dsplit::n_splits(S)) return cudaErrorInvalidValue;
    return dtype == BF16 ? mma_by_hd<__nv_bfloat16>(hd, q, k_cache, v_cache, kl, out, ws, B, S,
                                                    hq, hkv, n_split, scale, st)
                         : mma_by_hd<__half>(hd, q, k_cache, v_cache, kl, out, ws, B, S, hq, hkv,
                                             n_split, scale, st);
  }
  switch (dtype) {
    case F32:
      return by_hd<float>(hd, q, k_cache, v_cache, kl, out, B, S, hq, hkv, scale, st);
    case BF16:
      return by_hd<__nv_bfloat16>(hd, q, k_cache, v_cache, kl, out, B, S, hq, hkv, scale, st);
    case F16:
      return by_hd<__half>(hd, q, k_cache, v_cache, kl, out, B, S, hq, hkv, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
