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
// tile's positions times the GQA group G are the block's rows (row
// position * G + g), so every group shares the block's K/V loads. The TPU
// grid's sequential kv axis is a loop inside the block, bounded by the
// tile's longest row, min(q_offset + last position + 1, Sk) when causal: a
// causal tile never touches keys past its last query. Two bodies:
//
// - tensor cores (flash_wgmma_kernel, hopper.cuh), for bf16 and fp16 with
//   G <= 64: a producer and one or two consumer warpgroups of 64 rows. One
//   producer thread issues TMA loads: Q once, then K/V in stages of KEYS
//   keys (128 with two consumer warpgroups, 64 with one) into a two-stage
//   ring guarded by full/empty mbarriers. The maps are 4-D (hd, heads, S,
//   B), so a box past Sk is zero-filled inside its own batch row, and
//   swizzled (128-byte lines at hd 64 and 128, 64 and 32 bytes at hd 32
//   and 16). Each consumer warpgroup computes S = Q K^T by wgmma from
//   shared memory (both K-major), masks kpos >= a row's limit by a select
//   to -inf on the stages that cross one, runs the online softmax in f32
//   registers (exp2f; a row's max and sum over the 4 lanes that hold it),
//   rounds P to q's type in registers, where the accumulator's layout is
//   already the A fragment of O += P V, and runs that by wgmma with V from
//   shared memory as an MN-major B. V rows of the stage on the causal edge
//   past every row's limit are zeroed before the product (0 * NaN is NaN
//   inside wgmma).
//   Tiles: 128 rows (two consumer warpgroups; the producer is a whole
//   warpgroup that gives its registers to them by setmaxnreg, 24 / 240)
//   unless that grid, ceil(Sq G / 128) Hkv B blocks, would leave SMs idle;
//   then 64 rows (one consumer warpgroup and a producer warp, two blocks
//   an SM). The two warpgroups of a 128-row tile take turns at the tensor
//   cores (named barriers): each issues a product on its turn and hands
//   the turn over, so one's softmax runs under the other's products; both
//   walk every stage of the block so their turns pair up. The longest
//   causal tiles are launched first.
// - CUDA cores (flash_kernel, paged_attention_common.cuh), for f32, which
//   the f32 tests hold to 1e-5 (TF32 wgmma cannot), and for G > 64: 32 rows
//   a block, K/V tiles of 32 keys widened to f32 in shared memory, every
//   score and PV term an f32 FMA.
// The C entry point picks the body by dtype and group and reports which.
//
// What bounds it: at the compute-bound shapes (prefills of thousands of
// tokens: 4 Hq hd Sq Sk / 2 operations against 2 (2 Sq Hq + 2 Sk Hkv) hd
// bytes) the tensor-core rate, which only wgmma reaches. The TMA ring keeps
// the loads off the consumers' instruction stream, and the turns keep the
// tensor cores fed while a warpgroup runs its softmax (exp2 of 64 x KEYS
// scores a stage, about half a stage's product time on the SM's special
// function units). Issuing stage i's S behind stage i - 1's PV within a
// warpgroup (FA3's intra-warpgroup overlap) keeps S, O and P live at once:
// at hd 128 that spilled even at 240 registers and was slower. At the
// serving prefill (batch 1, a few hundred tokens) neither bound is near
// (0.0025 ms of bytes at Sq 412): a block's stages follow one another, each
// a product's latency plus its softmax, so the walk's latency and the
// number of blocks in flight are what is left.

#include <type_traits>

#include "hopper.cuh"
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

constexpr int MAX_GROUP = 64;  // the largest GQA group of the tensor-core body
constexpr float LOG2E = 1.4426950408889634f;
// registers a thread of the two-warpgroup tile: 384 threads enter with 168
// (65,536 / 384); the producer gives back what the consumers take
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// The shapes of the tensor-core body with CWG consumer warpgroups at head
// dim HD: shared memory is Q (CB column blocks of ROWS lines), then the
// ring (each stage a K and a V tile of CB column blocks of KEYS lines),
// then the mbarriers.
template <int HD, int CWG>
struct Shape {
  static constexpr int ROWS = 64 * CWG;
  static constexpr int KEYS = CWG == 2 ? 128 : 64;
  static constexpr int STAGES = 2;  // K/V stages in the ring
  static constexpr int COLS = HD < 64 ? HD : 64;  // elements a swizzle line
  static constexpr int LINE = COLS * 2;           // its bytes
  static constexpr int CB = HD / COLS;            // column blocks a row
  // the producer: a warp (CWG 1), or a warpgroup whose registers go to the
  // consumers (CWG 2; ptxas budgets a lone warp as a whole warpgroup)
  static constexpr int THREADS = CWG == 2 ? 384 : CWG * 128 + 32;
  static constexpr int Q_BYTES = CB * ROWS * LINE;
  static constexpr int TILE_BYTES = CB * KEYS * LINE;  // one K or V tile
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr int BARS = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr size_t SMEM = BARS + (3 * STAGES + 1) * 8 + 1024;  // + alignment
};

// One consumer warpgroup's walk over the block's stages and its rows'
// output. Rows of this thread: r = 64 wg + 16 warp + lane / 4 and r + 8.
template <typename T, int HD, int CWG>
__device__ __forceinline__ void consume(char* qs, char* ring, uint64_t* full_k,
                                        uint64_t* full_v, uint64_t* empty,
                                        uint64_t* qbar, T* __restrict__ out, int b, int h,
                                        int t0, int G, int n_rows, int sq, int sk, int hq,
                                        int causal, int q_offset, int len, int n_st,
                                        float scale2) {
  using S = Shape<HD, CWG>;
  constexpr int KEYS = S::KEYS, LINE = S::LINE, COLS = S::COLS, CB = S::CB;
  constexpr uint32_t SWZ = hopper::swizzle_code<LINE>();
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid % 32, t2 = (lane & 3) * 2;
  const int r0 = wg * 64 + (tid / 32) * 16 + lane / 4;

  // each row's limit: keys kpos < vlen (rows past Sq and spare rows
  // past P G are never stored and take Sk)
  int vlen[2];
  bool real[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 8 * rr;
    const int t = t0 + r / G;
    real[rr] = r < n_rows && t < sq;
    vlen[rr] = causal && real[rr] ? min(q_offset + t + 1, sk) : sk;
  }
  // the warpgroup's least limit: stages past it need no mask
  const int r_lo = wg * 64;
  const int lo = causal ? min(q_offset + min(t0 + r_lo / G, sq - 1) + 1, sk) : sk;

  const uint32_t q_addr = hopper::saddr(qs) + r_lo * LINE;
  const uint32_t ring_addr = hopper::saddr(ring);
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // Two warpgroups take turns at the tensor cores (named barriers 3 and 4):
  // each issues a product on its turn and hands the turn over, so one's
  // softmax runs while the other's products do. Both walk every stage of
  // the block (a stage past all of a warpgroup's rows is masked whole), so
  // their turns pair up; warpgroup 0 goes first.
  constexpr bool PINGPONG = CWG == 2;
  if (PINGPONG && wg == 1) hopper::named_arrive(3, 256);
  hopper::mbar_wait(qbar, 0);
  for (int i = 0; i < n_st; ++i) {
    const int s = i % S::STAGES;
    const int kpos0 = i * KEYS;
    const uint32_t k_addr = ring_addr + s * S::STAGE_BYTES;
    const uint32_t v_addr = k_addr + S::TILE_BYTES;
    hopper::mbar_wait(full_k + s, (i / S::STAGES) & 1);

    // S = Q K^T
    float sc[KEYS / 2];
    if (PINGPONG) hopper::named_sync(3 + wg, 256);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t cb = kk * 16 / COLS, in = (kk * 16 % COLS) * 2;
      hopper::Wgmma<T, KEYS>::ss(
          sc, hopper::make_desc(q_addr + cb * S::ROWS * LINE + in, 16, 8 * LINE, SWZ),
          hopper::make_desc(k_addr + cb * KEYS * LINE + in, 16, 8 * LINE, SWZ), kk > 0);
    }
    hopper::wgmma_commit();
    if (PINGPONG) hopper::named_arrive(4 - wg, 256);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // keys past a row's limit: a select, so a NaN score there is gone
    if (kpos0 + KEYS > lo) {
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kpos0 + j * 8 + t2 + (e & 1) >= vlen[e >> 1]) sc[j * 4 + e] = -INFINITY;
        }
      }
    }

    // the online softmax in base 2: m is the row max of the raw scores (a
    // stage masked whole leaves it, and its probabilities are 0)
    float corr[2], ms[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = m[rr];
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j) {
        mx = fmaxf(mx, fmaxf(sc[j * 4 + 2 * rr], sc[j * 4 + 2 * rr + 1]));
      }
      mx = mma_attn::quad_max(mx);
      corr[rr] = hopper::ex2((m[rr] - mx) * scale2);
      m[rr] = mx;
      ms[rr] = mx * scale2;
    }
    // P rounded to T, l summed from the rounded P; pa[kk] is the A
    // fragment of keys 16 kk .. 16 kk + 15
    uint32_t pa[KEYS / 16][4];
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float p0 = hopper::ex2(fmaf(sc[j * 4 + 2 * rr], scale2, -ms[rr]));
        const float p1 = hopper::ex2(fmaf(sc[j * 4 + 2 * rr + 1], scale2, -ms[rr]));
        float q0, q1;
        pa[j / 2][(j % 2) * 2 + rr] = mma_attn::pack<T>(p0, p1, q0, q1);
        ls[rr] += q0 + q1;
      }
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * corr[rr] + ls[rr];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[j * 4] *= corr[0];
      o[j * 4 + 1] *= corr[0];
      o[j * 4 + 2] *= corr[1];
      o[j * 4 + 3] *= corr[1];
    }

    // O += P V
    hopper::mbar_wait(full_v + s, (i / S::STAGES) & 1);
    // the causal edge: V rows past every row's limit, up to Sk, may hold
    // anything, and a zero probability times NaN is NaN in the product
    const int z0 = len - kpos0, z1 = min(KEYS, sk - kpos0);
    if (z0 < z1) {
      constexpr int CPR = LINE / 16;
      char* vt = ring + s * S::STAGE_BYTES + S::TILE_BYTES;
      for (int e = tid; e < (z1 - z0) * CB * CPR; e += 128) {
        const int j = z0 + e / (CB * CPR), c = e % (CB * CPR);
        *reinterpret_cast<uint4*>(vt + (c / CPR) * KEYS * LINE + j * LINE + (c % CPR) * 16) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1 + wg, 128);
    }
    if (PINGPONG) hopper::named_sync(3 + wg, 256);
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) {
      hopper::Wgmma<T, HD>::rs(
          o, pa[kk], hopper::make_desc(v_addr + kk * 16 * LINE, KEYS * LINE, 8 * LINE, SWZ), 1);
    }
    hopper::wgmma_commit();
    // the last turn of warpgroup 1 hands nothing over
    if (PINGPONG && (wg == 0 || i + 1 < n_st)) hopper::named_arrive(4 - wg, 256);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::fence_regs(pa);
    // the stage is free once the warpgroup's products are done
    if (tid == 0) hopper::mbar_arrive(empty + s);
  }

  float lt[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) lt[rr] = fmaxf(mma_attn::quad_sum(l[rr]), 1e-30f);
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (!real[rr]) continue;
    const int r = r0 + 8 * rr;
    T* orow = out + ((static_cast<int64_t>(b) * sq + t0 + r / G) * hq + h * G + r % G) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + j * 8 + t2) =
          mma_attn::pack<T>(o[j * 4 + 2 * rr] / lt[rr], o[j * 4 + 2 * rr + 1] / lt[rr]);
    }
  }
}

// One block: tile blockIdx.y from the end (the longest causal tiles
// first), kv head and batch row blockIdx.x. Warps 0 .. 4 CWG - 1 are the
// consumers, the rest the producer (one warp, or a warpgroup at CWG 2).
template <typename T, int HD, int CWG>
__global__ void __launch_bounds__(Shape<HD, CWG>::THREADS, CWG == 1 ? 2 : 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, T* __restrict__ out, int sq, int sk,
                   int hq, int hkv, int causal, int q_offset, float scale2) {
  using S = Shape<HD, CWG>;
  extern __shared__ char smem_raw[];
  char* smem = smem_raw + ((1024 - (hopper::saddr(smem_raw) & 1023)) & 1023);
  const int G = hq / hkv;
  const int P = S::ROWS / G;  // positions a tile
  const int h = blockIdx.x % hkv, b = blockIdx.x / hkv;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * P;
  const int t_last = min(t0 + P, sq) - 1;
  const int len = causal ? min(q_offset + t_last + 1, sk) : sk;
  const int n_st = (len + S::KEYS - 1) / S::KEYS;
  char* qs = smem;
  char* ring = smem + S::Q_BYTES;
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full_v = full_k + S::STAGES;
  uint64_t* empty = full_v + S::STAGES;
  uint64_t* qbar = empty + S::STAGES;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S::STAGES; ++s) {
      hopper::mbar_init(full_k + s, 1);
      hopper::mbar_init(full_v + s, 1);
      hopper::mbar_init(empty + s, CWG);
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x / 128 == CWG) {
    // the producer: one thread issues every load
    if constexpr (CWG == 2) hopper::reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == CWG * 128) {
      hopper::tma_prefetch(&kmap);
      hopper::tma_prefetch(&vmap);
      hopper::mbar_expect_tx(qbar, P * G * HD * 2);
#pragma unroll
      for (int cb = 0; cb < S::CB; ++cb) {
        hopper::tma_load_4d(qs + cb * S::ROWS * S::LINE, &qmap, qbar, cb * S::COLS, h * G, t0, b);
      }
      for (int i = 0; i < n_st; ++i) {
        const int s = i % S::STAGES;
        if (i >= S::STAGES) hopper::mbar_wait(empty + s, ((i / S::STAGES) & 1) ^ 1);
        char* st = ring + s * S::STAGE_BYTES;
        hopper::mbar_expect_tx(full_k + s, S::TILE_BYTES);
#pragma unroll
        for (int cb = 0; cb < S::CB; ++cb) {
          hopper::tma_load_4d(st + cb * S::KEYS * S::LINE, &kmap, full_k + s, cb * S::COLS, h,
                              i * S::KEYS, b);
        }
        hopper::mbar_expect_tx(full_v + s, S::TILE_BYTES);
#pragma unroll
        for (int cb = 0; cb < S::CB; ++cb) {
          hopper::tma_load_4d(st + S::TILE_BYTES + cb * S::KEYS * S::LINE, &vmap, full_v + s,
                              cb * S::COLS, h, i * S::KEYS, b);
        }
      }
    }
  } else {
    if constexpr (CWG == 2) hopper::reg_alloc<CONSUMER_REGS>();
    consume<T, HD, CWG>(qs, ring, full_k, full_v, empty, qbar, out, b, h, t0, G, P * G, sq, sk,
                        hq, causal, q_offset, len, n_st, scale2);
  }
}

// The map of x (B, S, H, HD), 16-bit, as dims (HD, H, S, B) with a box of
// (one swizzle line, bh heads, bs positions, 1 batch row).
template <int HD>
bool make_map(CUtensorMap* map, const void* x, CUtensorMapDataType dt, int B, int S_, int H,
              int bh, int bs) {
  constexpr int COLS = HD < 64 ? HD : 64;
  const hopper::EncodeTiled enc = hopper::encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(S_),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {HD * 2ull, static_cast<cuuint64_t>(H) * HD * 2,
                                 static_cast<cuuint64_t>(S_) * H * HD * 2};
  const cuuint32_t box[4] = {COLS, static_cast<cuuint32_t>(bh), static_cast<cuuint32_t>(bs), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = COLS * 2 == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : COLS * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, dt, 4, const_cast<void*>(x), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int HD, int CWG>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int sq,
                         int sk, int hq, int hkv, int causal, int q_offset, float scale,
                         cudaStream_t stream) {
  using S = Shape<HD, CWG>;
  static size_t configured = 0;
  static int entry_regs = -1;
  auto kernel = flash_wgmma_kernel<T, HD, CWG>;
  cudaError_t e = ensure_smem(kernel, S::SMEM, &configured);
  if (e != cudaSuccess) return e;
  if (CWG == 2 && entry_regs < 0) {
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kernel);
    if (e != cudaSuccess) return e;
    entry_regs = attr.numRegs;
  }
  // setmaxnreg.inc waits for registers the producer gave back: with fewer
  // at entry than the two roles ask for, it would wait forever
  if (CWG == 2 && entry_regs * S::THREADS < 128 * PRODUCER_REGS + 256 * CONSUMER_REGS) {
    return cudaErrorInvalidConfiguration;
  }
  const CUtensorMapDataType dt = std::is_same<T, __nv_bfloat16>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  const int G = hq / hkv, P = S::ROWS / G;
  CUtensorMap qm, km, vm;
  if (!make_map<HD>(&qm, q, dt, B, sq, hq, G, P) ||
      !make_map<HD>(&km, k, dt, B, sk, hkv, 1, S::KEYS) ||
      !make_map<HD>(&vm, v, dt, B, sk, hkv, 1, S::KEYS)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(hkv * B, (sq + P - 1) / P);
  kernel<<<grid, S::THREADS, S::SMEM, stream>>>(qm, km, vm, static_cast<T*>(out), sq, sk, hq, hkv,
                                                causal, q_offset, scale * LOG2E);
  return cudaGetLastError();
}

// The rows of the tensor-core body's tile: 128 (two consumer warpgroups)
// unless that grid has fewer blocks than the card has SMs, then 64.
int tile_rows(int B, int sq, int hq, int hkv) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int P = 128 / (hq / hkv);
  const long long blocks = static_cast<long long>((sq + P - 1) / P) * hkv * B;
  return blocks >= sms ? 128 : 64;
}

template <typename T, int HD>
cudaError_t wgmma_tile(int rows, const void* q, const void* k, const void* v, void* out, int B,
                       int sq, int sk, int hq, int hkv, int causal, int q_offset, float scale,
                       cudaStream_t st) {
  return rows == 128
             ? launch_wgmma<T, HD, 2>(q, k, v, out, B, sq, sk, hq, hkv, causal, q_offset, scale, st)
             : launch_wgmma<T, HD, 1>(q, k, v, out, B, sq, sk, hq, hkv, causal, q_offset, scale,
                                      st);
}

template <typename T>
cudaError_t wgmma_by_hd(int hd, int rows, const void* q, const void* k, const void* v,
                        void* out, int B, int sq, int sk, int hq, int hkv, int causal,
                        int q_offset, float scale, cudaStream_t st) {
  switch (hd) {
    case 16:
      return wgmma_tile<T, 16>(rows, q, k, v, out, B, sq, sk, hq, hkv, causal, q_offset,
                               scale, st);
    case 32:
      return wgmma_tile<T, 32>(rows, q, k, v, out, B, sq, sk, hq, hkv, causal, q_offset,
                               scale, st);
    case 64:
      return wgmma_tile<T, 64>(rows, q, k, v, out, B, sq, sk, hq, hkv, causal, q_offset,
                               scale, st);
    case 128:
      return wgmma_tile<T, 128>(rows, q, k, v, out, B, sq, sk, hq, hkv, causal, q_offset,
                                scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point bound with ctypes (kernels/flash_attention.py): q, k, v and
// out share one dtype. *body is set to the body launched: 1 the tensor
// cores (bf16, fp16, G <= 64), 0 the CUDA cores; *tile to the query rows a
// block of the tensor-core body takes (64 or 128), 0 for the CUDA-core body
// or when nothing is launched. Returns the launch's cudaGetLastError()
// (0 = launched).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* out, int B,
                               int sq, int sk, int hq, int hkv, int hd, int causal,
                               int q_offset, float scale, int dtype, void* stream, int* body,
                               int* tile) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tc = (dtype == BF16 || dtype == F16) && hq / hkv <= MAX_GROUP;
  *body = tc ? 1 : 0;
  *tile = 0;
  if (B == 0 || sq == 0) return 0;
  if (tc) {
    *tile = tile_rows(B, sq, hq, hkv);
    return dtype == BF16 ? wgmma_by_hd<__nv_bfloat16>(hd, *tile, q, k, v, out, B, sq, sk, hq,
                                                      hkv, causal, q_offset, scale, st)
                         : wgmma_by_hd<__half>(hd, *tile, q, k, v, out, B, sq, sk, hq, hkv,
                                               causal, q_offset, scale, st);
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
      return by_hd<__half>(hd, q, k, v, out, B, sq, sk, hq, hkv, tile_q, causal, q_offset, scale,
                           st);
    default:
      return cudaErrorInvalidValue;
  }
}
