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
// Design: one block per (tile of tile_q query positions, kv head, batch
// row). The tile's tile_q * G query rows (G = Hq / Hkv, tile_q = 32 / G:
// 8 * 4 = 32 rows at granite-3-8b) share every K/V tile load. The TPU grid's
// sequential kv axis is a loop inside the block over tiles of KB keys,
// bounded by the tile's longest row, min(q_offset + last position + 1, Sk)
// when causal: a causal tile never touches keys past its last query, and no
// tile walks Sk padded up to a block. Each row's valid length masks the
// ragged edge inside the last tile (paged_attention_common.cuh).
//
// What bounds it: at the main path's prefill (batch 1, Sq = Sk = a few hundred
// tokens, hd 128) the operations, not the bytes: each K/V tile is read once
// per query tile from L2, and every score and PV product runs in float32 on
// the CUDA cores, 32 rows against each key. Tensor-core (wgmma) products and
// TMA tile loads are the later speed items.

#include "paged_attention_common.cuh"

namespace {

using namespace pattn;

constexpr int KB = 32;  // keys per K/V tile

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

}  // namespace

// C entry point bound with ctypes (kernels/flash_attention.py): q, k, v and
// out share one dtype. Returns the launch's cudaGetLastError() (0 = launched).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                               int sq, int sk, int hq, int hkv, int hd, int tile_q, int causal,
                               int q_offset, float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || sq == 0) return 0;
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
