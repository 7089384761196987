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
// paged kernel; at these sizes the walk's latency and launches cost more
// than its bytes. Two bodies, as there:
//
// - tensor cores (decode_split.cuh's decode_cluster_kernel), for bf16 and
//   fp16 caches with G = Hq / Hkv <= 64: the paged kernel's one launch, its
//   walk split over blocks of KPS positions, a cluster of C = min(8,
//   ceil(S / KPS)) blocks a (sequence, kv head) that combines the splits
//   before the launch ends; a split's K and V come by TMA from the strip,
//   boxes of 16 rows (rows past S zero-filled), and its products
//   run on mma.sync (mma_attention.cuh's fold), so its bits are the paged
//   kernel's on the same keys.
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
// the tensor-core body: one cluster launch (decode_split.cuh)
// ---------------------------------------------------------------------------

// Rows of a strip a TMA box: a stage is four boxes (tools/decode_probe.py:
// at granite's decode shapes 16-row boxes beat one 64-row box a stage).
constexpr int BOX_LOG2 = 4;

// Position p of sequence b: row p of its strip, in the caches' map (HD,
// Hkv, S, B).
struct ContigSrc {
  __device__ __forceinline__ int page(int b, int) const { return b; }
  __device__ __forceinline__ int row(int p) const { return p; }
};

template <typename T, int HD>
cudaError_t launch_mma(const void* q, const void* kc, const void* vc, const int* kv_len,
                       void* out, void* ws, int B, int S, int hq, int hkv, int n_split,
                       int cluster, float scale, cudaStream_t stream, int* launched) {
  dsplit::Args a{};
  a.q = q;
  a.out = out;
  a.kv_len = kv_len;
  a.ws = dsplit::carve(ws, B, hq, n_split, HD);
  a.hq = hq;
  a.hkv = hkv;
  a.n_split = n_split;
  a.cap = S;
  a.lh = BOX_LOG2;
  a.ls = BOX_LOG2;
  a.scale = scale;
  CUtensorMap km{}, vm{};
  if (n_split > 0 && (!dsplit::make_kv_map<T, HD>(&km, kc, hkv, S, B, 1 << a.lh) ||
                      !dsplit::make_kv_map<T, HD>(&vm, vc, hkv, S, B, 1 << a.lh))) {
    return cudaErrorInvalidValue;
  }
  return dsplit::launch_cluster<T, HD>(km, vm, ContigSrc{}, a, B, cluster, launched, stream);
}

template <typename T>
cudaError_t mma_by_hd(int hd, const void* q, const void* kc, const void* vc, const int* kv_len,
                      void* out, void* ws, int B, int S, int hq, int hkv, int n_split,
                      int cluster, float scale, cudaStream_t st, int* launched) {
  switch (hd) {
    case 16:
      return launch_mma<T, 16>(q, kc, vc, kv_len, out, ws, B, S, hq, hkv, n_split, cluster,
                               scale, st, launched);
    case 32:
      return launch_mma<T, 32>(q, kc, vc, kv_len, out, ws, B, S, hq, hkv, n_split, cluster,
                               scale, st, launched);
    case 64:
      return launch_mma<T, 64>(q, kc, vc, kv_len, out, ws, B, S, hq, hkv, n_split, cluster,
                               scale, st, launched);
    case 128:
      return launch_mma<T, 128>(q, kc, vc, kv_len, out, ws, B, S, hq, hkv, n_split, cluster,
                                scale, st, launched);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point bound with ctypes (kernels/decode_attention.py): q, the caches
// and out share one dtype. ws: the tensor-core body's f32 workspace of
// B x Hq x n_split x (hd + 2) floats, its partials, n_split = ceil(S / KPS)
// (decode_split.cuh); the CUDA-core body leaves it alone. cluster: the most
// blocks a (sequence, kv head) of the tensor-core launch, in [1, 16] (the
// wrapper's min(8, n_split), at least 1). *launched is set to the cluster
// size the tensor-core launch took (0 for the CUDA-core body), *body to the
// body launched: 1 the tensor cores, 0 the CUDA cores. Returns the
// launch's error, else its cudaGetLastError() (0 = launched).
extern "C" int decode_attention(const void* q, const void* k_cache, const void* v_cache,
                                const void* kv_len, void* out, void* ws, int B, int S, int hq,
                                int hkv, int hd, int n_split, float scale, int dtype,
                                int cluster, void* stream, int* launched, int* body) {
  const int* kl = static_cast<const int*>(kv_len);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool mma = (dtype == BF16 || dtype == F16) && hq / hkv <= mma_attn::ROWS;
  *body = mma ? 1 : 0;
  *launched = 0;
  if (B == 0) return 0;
  if (mma) {
    if (n_split != dsplit::n_splits(S)) return cudaErrorInvalidValue;
    return dtype == BF16
               ? mma_by_hd<__nv_bfloat16>(hd, q, k_cache, v_cache, kl, out, ws, B, S, hq, hkv,
                                          n_split, cluster, scale, st, launched)
               : mma_by_hd<__half>(hd, q, k_cache, v_cache, kl, out, ws, B, S, hq, hkv,
                                   n_split, cluster, scale, st, launched);
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
