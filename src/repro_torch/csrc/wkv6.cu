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
// Design. Column j of S depends only on v_t[j] and on what every column
// shares (r_t, k_t, u and the decay), so a head's columns are split over
// blocks: one block per (b, h, group of JC = 16 value columns), hd / JC
// blocks a head (128 blocks at rwkv6-1.6b's B 1, H 32, hd 64, on 132 SMs).
// Inside a block, each column's hd key rows are split over G lanes of one
// warp (lane g holds rows g, g + G, ..., hd / G of them) and each thread
// holds J columns, so a row element loaded from shared memory serves J
// columns. A launch of at least one whole tile of steps (a prefill) takes
// G = IG = 16, J = NJ = 2: the shortest chain a step and half the shared-
// memory reads, which bound it. A shorter launch (a decode step) takes
// G = IG_SHORT = 8, J = 1: half the warps, whose fixed cost bounds it.
//
// A step forms, per column, the lane's partial y[j] over its rows in row
// order. The G partials are added in one fixed order, the xor-1, 2, 4 (, 8)
// shuffle tree ((p0 + p1) + (p2 + p3)) + ...: step by step in a partial
// tile, and once a whole tile as a reduce-scatter (each xor level halves the
// steps a lane keeps, and each kept sum is own + partner's, the tree's own
// two operands), so a whole tile's steps run without shuffles or branches.
// y depends on nothing but the row's own inputs and the launch's length
// class (T >= CT or not): not on the batch, the other rows or JC. Each state
// entry is updated by the first design's expression, fmaf(d_i, S_ij, k_i *
// v_j) with d_i = expf(-expf(w_i)), so the final state equals that design's
// to the bit; only the order of y's sum over i changed. The TPU kernel's
// sequential time-chunk grid axis, which carried S in VMEM scratch, is the
// loop over t inside the block; it stops at T, so nothing is padded (the
// plain version pads to its chunk with steps that leave S unchanged).
//
// Staging. The block walks T in tiles of CT = 16 steps. cp.async brings tile
// n + 1's raw r, k and w rows (all of hd) and v (the block's JC columns)
// into one slot of a two-slot ring while the block runs tile n's steps, so
// a tile's global latency runs under its predecessor's steps. A landed tile
// is converted once, by all the block's threads together: step c's row i
// becomes the float4 (r_i, u_i k_i, k_i, d_i), which a lane reads as one
// 16-byte shared-memory load per row it holds. The first tile comes in one
// cp.async group with u and the block's columns of the initial state, so a
// launch makes one trip to memory before its first step. Shared memory is
// sized by min(T, CT) steps.
//
// State I/O. A block reads its JC columns of the initial state once and
// writes them once at the end, 16 bytes a thread in turn, through shared
// memory. Blocks own disjoint columns, so the final state may be written
// over the initial one in place. A null initial state is zero.
//
// What bounds it: at rwkv6-1.6b prefill (B 1, T 412, H 32, hd 64) the bytes
// (r, k, v, y in bf16, w in float32, the state in and out: 11.2 MB) over the
// H100's 3.35 TB/s and the float32 operations (about 4 hd^2 a step a head)
// over its 67 TFLOP/s outside the tensor cores give about the same least
// time, 3.3 us; at decode (B 4, T 1) the state's read and write are the
// whole cost (1.3 us). This design stays serial in t: each step of a tile
// reads every row element once per column pair from shared memory, and a
// tile converts its rows between two barriers. Measured (chip_smoke.py
// --wkv6-shape, H100 80GB HBM3 at a 700 W power limit): 0.048 ms at that
// prefill, 0.008 ms at that decode step, against 0.188 and 0.008 for the
// first design (one block of hd threads a head); PERF.md has the runs. The
// chunk-parallel form on the tensor cores is the next step, once its
// rounding can meet the state's 1e-4 limit.

#include "mma_attention.cuh"
#include "paged_attention_common.cuh"

namespace {

using pattn::BF16;
using pattn::F16;
using pattn::F32;
using pattn::from_f32;
using pattn::to_f32;

constexpr int CT = 16;  // time steps a tile
constexpr int JC = 16;  // value columns a block (at most hd)
// lanes that split one column's key rows, and value columns a thread: for a
// launch of at least one whole tile (a prefill), and for a shorter one (a
// decode step); kernels/wkv6.py mirrors CT, JC and both lane counts
constexpr int IG = 16;
constexpr int NJ = 2;
constexpr int IG_SHORT = 8;
constexpr int NJ_SHORT = 1;

// A block's shared memory, in bytes, for tiles of ct = min(CT, T) steps (a
// decode step needs a sixteenth of a prefill's): the converted tile (a
// float4 a row element), the block's state columns (rows of SR = JB + 4
// floats), v of the block's columns as float, u, then the two raw slots of
// the ring (r, k, w, v as they are in memory). Every part is a multiple of
// 16 bytes; the state, u and the raw slots are cp.async destinations.
template <typename T, typename TW, int HD, int JB, int G, int J>
struct Smem {
  static constexpr int NT = JB / J * G;  // threads a block
  static constexpr int SR = JB + 4;      // floats a staged state row
  static constexpr size_t STATE = size_t(HD) * SR * 4;
  __host__ __device__ static constexpr size_t rows(int ct) { return size_t(ct) * HD * 16; }
  __host__ __device__ static constexpr size_t vf(int ct) { return size_t(ct) * JB * 4; }
  __host__ __device__ static constexpr size_t r(int ct) { return size_t(ct) * HD * sizeof(T); }
  __host__ __device__ static constexpr size_t w(int ct) { return size_t(ct) * HD * sizeof(TW); }
  __host__ __device__ static constexpr size_t v(int ct) { return size_t(ct) * JB * sizeof(T); }
  __host__ __device__ static constexpr size_t raw(int ct) { return 2 * r(ct) + w(ct) + v(ct); }
  __host__ __device__ static constexpr size_t ring_offset(int ct) {
    return rows(ct) + STATE + vf(ct) + HD * 4;
  }
  __host__ __device__ static constexpr size_t bytes(int ct) {
    return ring_offset(ct) + 2 * raw(ct);
  }
  static_assert(G >= 2 && (G & (G - 1)) == 0 && CT % G == 0 && HD % G == 0 && JB % J == 0,
                "xor levels; whole steps a lane; whole row groups and column groups");
  static_assert(JB * sizeof(T) % 16 == 0 && NT % 32 == 0 && HD / 4 <= NT,
                "16-byte rows of v; whole warps; u in one pass");
};

// cp.async rows [0, n) of N elements each (N * sizeof(E) bytes, a multiple
// of 16): row c from src + c * stride into dst + c * N, 16 bytes a thread in
// turn
template <typename E, int N, int NT>
__device__ __forceinline__ void stage_rows(E* dst, const E* src, int64_t stride, int n,
                                           int tid) {
  constexpr int PER = 16 / sizeof(E);  // elements a copy
  constexpr int CH = N / PER;          // copies a row
#pragma unroll
  for (int q0 = 0; q0 < CT * CH; q0 += NT) {
    const int q = q0 + tid;
    const int c = q / CH, e = (q - c * CH) * PER;
    if (c < n) mma_attn::cp16(dst + c * N + e, src + c * stride + e, true);
  }
}

// one level of a reduce-scatter over lane bit BIT, then the next up to G / 2:
// the LEN values P[0, LEN) pair up as (P[2i], P[2i + 1]); the lane with the
// bit set keeps the odd one and sends the even one, its partner the reverse,
// and each keeps own + received in P[i]
template <int G, int LEN, int BIT>
__device__ __forceinline__ void reduce_scatter(float (&P)[CT], int g) {
  const bool hi = g & BIT;
#pragma unroll
  for (int i = 0; i < LEN / 2; ++i) {
    const float send = hi ? P[2 * i] : P[2 * i + 1];
    const float keep = hi ? P[2 * i + 1] : P[2 * i];
    P[i] = keep + __shfl_xor_sync(0xffffffffu, send, BIT);
  }
  if constexpr (2 * BIT < G) reduce_scatter<G, LEN / 2, 2 * BIT>(P, g);
}

// G lanes split a column's key rows; each thread holds J columns
template <typename T, typename TW, int HD, int JB, int G, int J>
__global__ void __launch_bounds__(JB / J * G)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const TW* __restrict__ w, const float* __restrict__ u, const float* s0,
            T* __restrict__ y, float* sT, int T_, int H) {
  using L = Smem<T, TW, HD, JB, G, J>;
  constexpr int NT = L::NT;
  constexpr int NI = HD / G;       // key rows a thread
  constexpr int NB = HD / JB;      // blocks a head
  constexpr int SR = L::SR;
  constexpr int S4 = HD * JB / 4;  // float4s of the block's state columns
  const int ct = min(CT, T_);
  extern __shared__ __align__(16) unsigned char smem[];
  float4* rows = reinterpret_cast<float4*>(smem);                   // [ct][HD]
  float* sst = reinterpret_cast<float*>(smem + L::rows(ct));        // [HD][SR]
  float* vf = sst + HD * SR;                                        // [ct][JB]
  float* us = vf + ct * JB;                                         // [HD]
  unsigned char* ring = smem + L::ring_offset(ct);                  // 2 raw tiles
  const size_t raw = L::raw(ct);

  const int tid = threadIdx.x;
  const int jb = blockIdx.x % NB;
  const int bh = blockIdx.x / NB;  // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int j0 = jb * JB;
  const int g = tid % G;         // this lane's row group: rows g + G m
  const int jl = tid / G * J;    // this thread's first column, j0 + jl
  // element e of row (b, t, h) sits at ((b * T + t) * H + h) * HD + e
  const int64_t step = static_cast<int64_t>(H) * HD;
  const int64_t base = (static_cast<int64_t>(b) * T_ * H + h) * HD;
  const int64_t s_off = static_cast<int64_t>(bh) * HD * HD + j0;
  const int n_tiles = (T_ + CT - 1) / CT;

  auto slot_of = [&](int tile) { return ring + (tile & 1) * raw; };
  auto stage = [&](int tile) {
    unsigned char* slot = slot_of(tile);
    const int t0 = tile * CT;
    const int n = min(CT, T_ - t0);
    const int64_t o = base + t0 * step;
    stage_rows<T, HD, NT>(reinterpret_cast<T*>(slot), r + o, step, n, tid);
    stage_rows<T, HD, NT>(reinterpret_cast<T*>(slot + L::r(ct)), k + o, step, n, tid);
    stage_rows<TW, HD, NT>(reinterpret_cast<TW*>(slot + 2 * L::r(ct)), w + o, step, n, tid);
    stage_rows<T, JB, NT>(reinterpret_cast<T*>(slot + 2 * L::r(ct) + L::w(ct)), v + o + j0,
                          step, n, tid);
  };

  // one cp.async group brings the block's columns of the initial state
  // (zeros for a null one), u and the first tile: one trip to memory
#pragma unroll
  for (int q0 = 0; q0 < S4; q0 += NT) {
    const int q = q0 + tid, i = q / (JB / 4), c = (q % (JB / 4)) * 4;
    if (S4 % NT == 0 || q < S4)
      mma_attn::cp16(sst + i * SR + c, s0 + s_off + int64_t(i) * HD + c, s0 != nullptr);
  }
  if (tid < HD / 4) mma_attn::cp16(us + 4 * tid, u + h * HD + 4 * tid, true);
  if (n_tiles > 0) stage(0);
  mma_attn::cp_commit();

  float S[NI][J];
  T* yb = y + base + j0 + jl;
  for (int tile = 0; tile < n_tiles; ++tile) {
    // the next tile's slot was converted a tile ago, and every thread has
    // passed the barrier after that conversion
    if (tile + 1 < n_tiles) stage(tile + 1);
    mma_attn::cp_commit();
    mma_attn::cp_wait<1>();
    __syncthreads();  // this tile landed; every thread is done with the last
    if (tile == 0) {
#pragma unroll
      for (int m = 0; m < NI; ++m)
#pragma unroll
        for (int q = 0; q < J; ++q) S[m][q] = sst[(g + G * m) * SR + jl + q];
    }
    const unsigned char* slot = slot_of(tile);
    const T* rr = reinterpret_cast<const T*>(slot);
    const T* kr = reinterpret_cast<const T*>(slot + L::r(ct));
    const TW* wr = reinterpret_cast<const TW*>(slot + 2 * L::r(ct));
    const T* vr = reinterpret_cast<const T*>(slot + 2 * L::r(ct) + L::w(ct));
    const int t0 = tile * CT;
    const int n = min(CT, T_ - t0);
#pragma unroll
    for (int q0 = 0; q0 < CT * HD; q0 += NT) {
      const int q = q0 + tid;
      if (q < n * HD) {
        const float kq = to_f32<T>(kr[q]);
        rows[q] = make_float4(to_f32<T>(rr[q]), us[q % HD] * kq, kq,
                              expf(-expf(to_f32<TW>(wr[q]))));
      }
    }
#pragma unroll
    for (int q0 = 0; q0 < CT * JB; q0 += NT) {
      const int q = q0 + tid;
      if (q < n * JB) vf[q] = to_f32<T>(vr[q]);
    }
    __syncthreads();

    // this lane's partial y of step c over its rows, in row order, for each
    // of its columns, and its state entries' update: the state's chain is
    // one FMA a step
    auto partial = [&](int c, float (&p)[J]) {
      float vj[J];
#pragma unroll
      for (int q = 0; q < J; ++q) {
        vj[q] = vf[c * JB + jl + q];
        p[q] = 0.f;
      }
      const float4* row = rows + c * HD + g;
#pragma unroll
      for (int m = 0; m < NI; ++m) {
        const float4 e = row[G * m];  // (r_i, u_i k_i, k_i, d_i)
#pragma unroll
        for (int q = 0; q < J; ++q) {
          p[q] = fmaf(e.x, fmaf(e.y, vj[q], S[m][q]), p[q]);
          S[m][q] = fmaf(e.w, S[m][q], e.z * vj[q]);
        }
      }
    };
    if (n == CT) {
      // a whole tile runs without a branch, so later steps' loads issue
      // early; then a column's G partials of every step are added once, as
      // a reduce-scatter: each xor level halves the steps a lane keeps, and
      // each kept sum is own + partner's, the same two operands as the
      // per-step xor shuffle tree below, so every step's y is that tree's
      // ((p0 + p1) + (p2 + p3)) + ...; lane g ends with the steps g + G x
      float P[J][CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        float p[J];
        partial(c, p);
#pragma unroll
        for (int q = 0; q < J; ++q) P[q][c] = p[q];
      }
#pragma unroll
      for (int q = 0; q < J; ++q) {
        reduce_scatter<G, CT, 1>(P[q], g);
#pragma unroll
        for (int x = 0; x < CT / G; ++x)
          yb[(t0 + g + G * x) * step + q] = from_f32<T>(P[q][x]);
      }
    } else {
      // the last, partial tile (a decode step's only one): step by step
      for (int c = 0; c < n; ++c) {
        float p[J];
        partial(c, p);
#pragma unroll
        for (int q = 0; q < J; ++q) {
#pragma unroll
          for (int bit = 1; bit < G; bit *= 2) p[q] += __shfl_xor_sync(0xffffffffu, p[q], bit);
          if (g == 0) yb[(t0 + c) * step + q] = from_f32<T>(p[q]);
        }
      }
    }
  }

  // the final state out through the same staging (a thread writes back the
  // entries it read); with no step it is the initial one, as it landed
  if (n_tiles > 0) {
#pragma unroll
    for (int m = 0; m < NI; ++m)
#pragma unroll
      for (int q = 0; q < J; ++q) sst[(g + G * m) * SR + jl + q] = S[m][q];
  } else {
    mma_attn::cp_wait<0>();
  }
  __syncthreads();
#pragma unroll
  for (int q0 = 0; q0 < S4; q0 += NT) {
    const int q = q0 + tid, i = q / (JB / 4), c = (q % (JB / 4)) * 4;
    if (S4 % NT == 0 || q < S4)
      *reinterpret_cast<float4*>(sT + s_off + int64_t(i) * HD + c) =
          *reinterpret_cast<const float4*>(sst + i * SR + c);
  }
}

template <typename T, typename TW, int HD, int G, int J>
cudaError_t launch_as(const void* r, const void* k, const void* v, const void* w, const float* u,
                      const float* s0, void* y, float* sT, int B, int T_, int H,
                      cudaStream_t stream) {
  constexpr int JB = JC < HD ? JC : HD;
  using L = Smem<T, TW, HD, JB, G, J>;
  auto kernel = wkv6_kernel<T, TW, HD, JB, G, J>;
  const size_t bytes = L::bytes(T_ < CT ? T_ : CT);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  kernel<<<B * H * (HD / JB), L::NT, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const TW*>(w), u, s0, static_cast<T*>(y), sT, T_, H);
  return cudaGetLastError();
}

template <typename T, typename TW, int HD>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const float* u,
                   const float* s0, void* y, float* sT, int B, int T_, int H,
                   cudaStream_t stream) {
  if (T_ >= CT)
    return launch_as<T, TW, HD, IG, NJ>(r, k, v, w, u, s0, y, sT, B, T_, H, stream);
  return launch_as<T, TW, HD, IG_SHORT, NJ_SHORT>(r, k, v, w, u, s0, y, sT, B, T_, H, stream);
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
// `dtype`; w is float32 or r's dtype (`w_dtype`). Every tensor but u starts
// on a 16-byte boundary (cp.async, and the states' 16-byte accesses). s0 may be null (a zero state) and may
// equal sT (the state updated in place). Returns the launch's
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
