// Decode attention over slot-contiguous caches for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention (body _kernel, sharing _softmax_step with the paged one).
//
// What it computes: one query token per sequence, q (B,1,Hq,hd), against the
// sequence's own cache strip, k/v caches (B,S,Hkv,hd), over the first
// kv_len[b] positions (clamped to [0, S]). A row with kv_len 0 is exactly 0.
//
// Design: one block per (sequence, kv head) with the G = Hq / Hkv query rows
// of that head's group. The TPU grid's kv axis, which walked all of S masked,
// is a loop inside the block over tiles of KB rows that stops at kv_len[b]:
// no cache row at or past kv_len is ever read, so a stale slot may hold
// anything. The tile load and online softmax are the paged kernels'
// (paged_attention_common.cuh), as the TPU kernels share _softmax_step.
//
// What bounds it: the bytes of K/V read, each row once per kv head. At
// granite-3-8b batch 4 the grid is only 4 x 8 = 32 blocks on the H100's 132
// SMs, so one block's serial walk sets the time, not the card's memory rate.
// Splitting the walk over several blocks with a combine pass
// (flash-decoding) is the later speed item, as for the paged kernel.

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

}  // namespace

// C entry point bound with ctypes (kernels/decode_attention.py): q, the caches
// and out share one dtype. Returns the launch's cudaGetLastError() (0 =
// launched).
extern "C" int decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                const void* kv_len, void* out, int B, int S, int hq, int hkv,
                                int hd, float scale, int dtype, void* stream) {
  const int* kl = static_cast<const int*>(kv_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
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
