// The RWKV6 ('Finch') WKV recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wkv6.py: wkv6 (body _kernel).
//
// What it computes, per (batch row b, head h), sequentially in t, with a
// float32 (hd, hd) state S (row i: key channel, column j: value channel):
//
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- exp(-exp(w_t[i])) * S[i][j] + k_t[i] * v_t[j]
//
// S starts from the given state (or zero) and the final S is written back.
// r, k, v, w are (B, T, H, hd); u is (H, hd) float32; the states are
// (B, H, hd, hd) float32; y is (B, T, H, hd) in r's dtype. All arithmetic is
// float32, with expf (exact to float32 rounding; no fast-math exponentials).
//
// Design: one block per (b, h) and HD threads. Thread j holds column j of S,
// S[:, j], in registers for the whole loop over t, so a step needs no
// reduction across threads: each thread forms its own y[j] from the step's r,
// u*k and decay rows, which the block stages in shared memory, CT steps at a
// time between two synchronisations. The TPU kernel's sequential time-chunk
// grid axis, which carried S in VMEM scratch, is this loop inside the block;
// it stops at T, so nothing is padded (the plain version pads to its chunk
// with steps that leave S unchanged). The state is read once at the start and
// written once at the end, each thread its own column, so the final state may
// be written over the initial one in place.
//
// What bounds it: at rwkv6-1.6b prefill (B 1, T 412, H 32, hd 64) the bytes
// (r, k, v, y in bf16, w in float32, the state in and out: 11.2 MB) over the
// H100's 3.35 TB/s and the float32 operations (about 4 hd^2 a step a head)
// over its 67 TFLOP/s outside the tensor cores give about the same least
// time, 3.3 us; at decode (B 4, T 1) the state's read and write are the
// whole cost. This first version is far from both: only B*H blocks of HD
// threads run, and each step is a chain of HD shared-memory reads and FMAs
// per thread. A chunk-parallel form, or several heads a block, is the later
// speed item (PERF.md has its measured time).

#include "paged_attention_common.cuh"

namespace {

using pattn::BF16;
using pattn::F16;
using pattn::F32;
using pattn::from_f32;
using pattn::to_f32;

constexpr int CT = 16;  // time steps staged in shared memory between syncs

template <typename T, typename TW, int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const TW* __restrict__ w, const float* __restrict__ u, const float* s0,
            T* __restrict__ y, float* sT, int T_, int H) {
  __shared__ __align__(16) float rs[CT][HD];
  __shared__ __align__(16) float ks[CT][HD];
  __shared__ __align__(16) float uks[CT][HD];
  __shared__ __align__(16) float ds[CT][HD];
  __shared__ float vs[CT][HD];
  const int bh = blockIdx.x;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int j = threadIdx.x;
  const int64_t s_off = static_cast<int64_t>(bh) * HD * HD + j;

  float S[HD];
  if (s0 != nullptr) {
#pragma unroll
    for (int i = 0; i < HD; ++i) S[i] = s0[s_off + static_cast<int64_t>(i) * HD];
  } else {
#pragma unroll
    for (int i = 0; i < HD; ++i) S[i] = 0.f;
  }
  const float uj = u[h * HD + j];
  // element j of row (b, t, h) sits at ((b * T + t) * H + h) * HD + j
  const int64_t step = static_cast<int64_t>(H) * HD;
  const int64_t base = (static_cast<int64_t>(b) * T_ * H + h) * HD + j;

  for (int t0 = 0; t0 < T_; t0 += CT) {
    const int n = min(CT, T_ - t0);
    __syncthreads();  // every thread is done with the previous chunk's rows
    for (int c = 0; c < n; ++c) {
      const int64_t o = base + (t0 + c) * step;
      const float kj = to_f32<T>(k[o]);
      rs[c][j] = to_f32<T>(r[o]);
      ks[c][j] = kj;
      uks[c][j] = uj * kj;
      ds[c][j] = expf(-expf(to_f32<TW>(w[o])));
      vs[c][j] = to_f32<T>(v[o]);
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = vs[c][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < HD; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&rs[c][i]);
        const float4 uk4 = *reinterpret_cast<const float4*>(&uks[c][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[c][i]);
        const float4 d4 = *reinterpret_cast<const float4*>(&ds[c][i]);
        acc[0] = fmaf(r4.x, fmaf(uk4.x, vj, S[i]), acc[0]);
        acc[1] = fmaf(r4.y, fmaf(uk4.y, vj, S[i + 1]), acc[1]);
        acc[2] = fmaf(r4.z, fmaf(uk4.z, vj, S[i + 2]), acc[2]);
        acc[3] = fmaf(r4.w, fmaf(uk4.w, vj, S[i + 3]), acc[3]);
        S[i] = fmaf(d4.x, S[i], k4.x * vj);
        S[i + 1] = fmaf(d4.y, S[i + 1], k4.y * vj);
        S[i + 2] = fmaf(d4.z, S[i + 2], k4.z * vj);
        S[i + 3] = fmaf(d4.w, S[i + 3], k4.w * vj);
      }
      y[base + (t0 + c) * step] = from_f32<T>((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }

#pragma unroll
  for (int i = 0; i < HD; ++i) sT[s_off + static_cast<int64_t>(i) * HD] = S[i];
}

template <typename T, typename TW, int HD>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const float* u,
                   const float* s0, void* y, float* sT, int B, int T_, int H,
                   cudaStream_t stream) {
  wkv6_kernel<T, TW, HD><<<B * H, HD, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TW*>(w), u, s0, static_cast<T*>(y), sT, T_, H);
  return cudaGetLastError();
}

template <typename T, typename TW>
cudaError_t by_hd(int hd, const void* r, const void* k, const void* v, const void* w,
                  const float* u, const float* s0, void* y, float* sT, int B, int T_, int H,
                  cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch<T, TW, 16>(r, k, v, w, u, s0, y, sT, B, T_, H, st);
    case 32:
      return launch<T, TW, 32>(r, k, v, w, u, s0, y, sT, B, T_, H, st);
    case 64:
      return launch<T, TW, 64>(r, k, v, w, u, s0, y, sT, B, T_, H, st);
    case 128:
      return launch<T, TW, 128>(r, k, v, w, u, s0, y, sT, B, T_, H, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point bound with ctypes (kernels/wkv6.py). r, k, v and y share
// `dtype`; w is float32 or r's dtype (`w_dtype`). s0 may be null (a zero
// state) and may equal sT (the state updated in place). Returns the launch's
// cudaGetLastError() (0 = launched).
extern "C" int wkv6(const void* r, const void* k, const void* v, const void* w, const void* u,
                    const void* s0, void* y, void* sT, int B, int T, int H, int hd, int dtype,
                    int w_dtype, void* stream) {
  const float* uf = static_cast<const float*>(u);
  const float* s0f = static_cast<const float*>(s0);
  float* sTf = static_cast<float*>(sT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0) return 0;
  if (dtype == F32 && w_dtype == F32)
    return by_hd<float, float>(hd, r, k, v, w, uf, s0f, y, sTf, B, T, H, st);
  if (dtype == BF16 && w_dtype == F32)
    return by_hd<__nv_bfloat16, float>(hd, r, k, v, w, uf, s0f, y, sTf, B, T, H, st);
  if (dtype == BF16 && w_dtype == BF16)
    return by_hd<__nv_bfloat16, __nv_bfloat16>(hd, r, k, v, w, uf, s0f, y, sTf, B, T, H, st);
  if (dtype == F16 && w_dtype == F32)
    return by_hd<__half, float>(hd, r, k, v, w, uf, s0f, y, sTf, B, T, H, st);
  if (dtype == F16 && w_dtype == F16)
    return by_hd<__half, __half>(hd, r, k, v, w, uf, s0f, y, sTf, B, T, H, st);
  return cudaErrorInvalidValue;
}
