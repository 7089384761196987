// The split-over-keys attention body of the ragged kernel's decode runs
// (ragged_paged_attention.cu, through decode_split.cuh's attend_split):
// FlashAttention-2's shape on mma.sync tensor cores, with K/V tiles
// brought in by cp.async. Its per-stage step, fold, is also the product
// of the decode kernels (paged_decode_attention.cu, decode_attention.cu),
// whose stages come by TMA instead (decode_split.cuh's cluster launch);
// flash and the ragged kernel's prefill spans run on wgmma and TMA
// (hopper.cuh).
//
// A block of 4 warps owns up to 64 query rows that read one kv head (a tile
// of query positions times the GQA group G). Warp w owns 16 of them and
// holds their Q fragments in registers for the whole walk over keys. The
// keys come in stages of KEYS = 64 rows of K and V, 16-bit in shared
// memory, STAGES = 2 stages in a ring: stage i + 1 is in flight (cp.async,
// commit_group / wait_group) while stage i is computed, and the row indices
// of stage i + 2's keys (page ids from the table) are read meanwhile, so no
// load waits on a table read. Per stage a warp:
//   S = Q K^T        mma.m16n8k16, K's B fragments by ldmatrix, f32 sums;
//   online softmax   on S's accumulator fragments; row max and sum over the
//                    quad of lanes that share a row (__shfl_xor 1, 2);
//   O += P V         P rounded to 16 bits in registers is the A operand
//                    as it stands; V's B fragments by ldmatrix.trans.
// Tile rows are HD + 8 elements apart, so the 8 rows that one ldmatrix
// reads fall in 8 different groups of 4 banks (no bank conflicts).
//
// Where a block has fewer than 4 warps' worth of rows (a decode row's G
// query rows), NSPLIT warps share each row group and split every stage's
// keys between them; their partial (m, l, acc) are combined at the
// end in split order, so the sums are taken in the same order every run.
//
// Masking. A key at or past the tile's longest row (the rest of a last
// page, the trash page, rows at or past Sk, keys past every causal limit in
// the tile) is zero-filled on the way in (cp.async with a source size of
// 0), so a zero probability never meets a NaN in the product. Inside the
// tile each row's own limit vlen masks its scores to the finite -1e30 (so
// m_prev - m_new is never NaN) and its probabilities to exactly 0. A row
// with no valid key keeps l == 0 and acc == 0 and is written as exactly 0.
// A stage whose keys are all past every row of a warp is skipped by that
// warp; folding it would change no bit.
//
// Rounding: P is rounded to the PV operand type and l sums the rounded P,
// so numerator and denominator see the same probabilities.
//
// Partial rows (PARTIAL): the ragged kernel's decode runs take the body
// on one split of a row's keys, the map offsetting key positions by the
// split's first one, and write the unnormalised f32 state (base-2 row max
// m, sum l, acc o) to a workspace instead of acc / l; a second pass
// combines the splits.
// With Q8 the partial's o is acc + z: the zero term sum_j p_j vz_j is
// scaled by the same 2^(m - M) as acc in the combine, so it rides in o
// (16-bit pages write acc alone, bit for bit as before).
//
// int8 pages (Q8): scale and zero are per key row (token, kv head), so they
// factor out of both products and no dequantized tile is made:
//   score_j = ks_j (q . kq_j) + kz_j sum_d q_d
//   acc    += sum_j (p_j vs_j) vq_j + sum_j p_j vz_j
// The int8 codes are exact in bf16 and fp16. Each stage's codes are widened
// in shared memory (K to bf16, V to fp16): QK is a bf16 mma on q and the
// raw codes, PV an fp16 mma with A = p_j vs_j (fp16 keeps 3 more mantissa
// bits than bf16 there) and B the raw codes, and sum_j p_j vz_j is one f32
// scalar a row, added to every column at the end. l sums the f32 p.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mma_attn {

constexpr int THREADS = 128;         // 4 warps
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 16 * WARPS;     // query rows a block can own
constexpr int KEYS = 64;             // keys a stage
constexpr int STAGES = 2;            // stages in the ring
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Bytes of the shared-memory regions at head dim HD.
template <int HD>
struct Layout {
  static constexpr int LDS = HD + 8;                      // 16-bit tile row stride, elements
  static constexpr size_t TILE16 = size_t(KEYS) * LDS * 2;  // one 16-bit K or V tile
  static constexpr size_t RAW8 = size_t(KEYS) * HD;         // one int8 K or V tile
  static constexpr size_t SCALES = 4 * KEYS * sizeof(float);
  static constexpr size_t STAGE16 = 2 * TILE16;           // K and V, 16-bit pages
  static constexpr size_t STAGE8 = 2 * RAW8 + SCALES;     // K and V codes, their scales
  // the row indices of each stage's keys, one stage ahead of its loads
  static constexpr size_t ROWIDX = STAGES * KEYS * sizeof(int64_t);
  __host__ __device__ static constexpr size_t ring(bool q8) {
    return q8 ? STAGES * STAGE8 + 2 * TILE16 : STAGES * STAGE16;
  }
  // the split combine: (split - 1) x row warps x 16 rows of (acc, m, l, z)
  static constexpr size_t COMBINE = size_t(WARPS - 1) * 16 * (HD + 3) * sizeof(float);
  __host__ __device__ static constexpr size_t bytes(bool q8) {
    return ring(q8) + ROWIDX > COMBINE ? ring(q8) + ROWIDX : COMBINE;
  }
};

// ---------------------------------------------------------------------------
// PTX
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; !ok fills the 16 bytes with 0
// and reads nothing.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 16-bit matrices; lanes 8m .. 8m + 7 give the row addresses of
// matrix m, and each lane gets (row lane / 4, columns 2 (lane % 4) + {0, 1})
// of each, or with .trans (rows 2 (lane % 4) + {0, 1}, column lane / 4)
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p))
               : "memory");
}

// c += a b for a 16x16 A (row major), a 16x8 B (column major), f32 c.
// Fragments (g = lane / 4, t2 = 2 (lane % 4)): a = {(g, t2..), (g + 8, t2..),
// (g, t2 + 8..), (g + 8, t2 + 8..)}, b = {(t2.., g), (t2 + 8.., g)},
// c = {(g, t2), (g, t2 + 1), (g + 8, t2), (g + 8, t2 + 1)}.
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&c)[4], const uint32_t (&a)[4],
                                                   uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma<__half>(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two 16-bit values (lo in the low half),
// rounded to nearest; lo_r, hi_r are the rounded values back in f32
template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi, float& lo_r, float& hi_r) {
  uint32_t u;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    lo_r = __low2float(v);
    hi_r = __high2float(v);
    u = *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __half2 v = __floats2half2_rn(lo, hi);
    lo_r = __low2float(v);
    hi_r = __high2float(v);
    u = *reinterpret_cast<const uint32_t*>(&v);
  }
  return u;
}

template <typename T>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  float a, b;
  return pack<T>(lo, hi, a, b);
}

template <typename T>
__device__ __forceinline__ float2 unpack(uint32_t u) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&u);
    return make_float2(__low2float(v), __high2float(v));
  } else {
    const __half2 v = *reinterpret_cast<const __half2*>(&u);
    return make_float2(__low2float(v), __high2float(v));
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 16 int8 codes (raw, byte i the i-th) -> 16 values of T in o, two a
// register, exactly and without int-to-float conversions: byte b as
// u = b ^ 0x80 = code + 128, then
//   fp16: the half 0x64uu is 1024 + u, so (1024 + u) - 1152 = code;
//   bf16: the float 0x4B0000uu is 2^23 + u, so (2^23 + u) - (2^23 + 128)
//         = code, whose top 16 bits are its bf16 (|code| <= 128 fits).
template <typename T>
__device__ __forceinline__ void widen_codes(uint32_t (&o)[8], const uint4 raw) {
  const uint32_t w[4] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u, raw.z ^ 0x80808080u,
                         raw.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t u = w[i / 2];
    const int b0 = 2 * (i % 2), b1 = b0 + 1;  // the pair's bytes in u
    if constexpr (std::is_same<T, __half>::value) {
      const uint32_t h = __byte_perm(u, 0x64646464u, 0x5040 | b0 | (b1 << 8));
      const __half2 v = __hsub2(*reinterpret_cast<const __half2*>(&h),
                                __halves2half2(__ushort_as_half(0x6480u),
                                               __ushort_as_half(0x6480u)));
      o[i] = *reinterpret_cast<const uint32_t*>(&v);
    } else {
      const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | b0)) - 8388736.f;
      const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | b1)) - 8388736.f;
      o[i] = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
    }
  }
}

// 16 int8 codes -> 16 values of T, stored at dst (16-byte aligned)
template <typename T>
__device__ __forceinline__ void widen16(T* dst, const uint4 raw) {
  uint32_t o[8];
  widen_codes<T>(o, raw);
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(o[0], o[1], o[2], o[3]);
  d[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// ---------------------------------------------------------------------------
// the body
// ---------------------------------------------------------------------------

// What a kernel tells the body about its rows and keys (a "map"):
//   bool query(int r, int64_t& off, int& vlen): block row r (0 .. rows - 1)
//     exists; off is its element offset in q and out, vlen the number of
//     leading kv positions it attends;
//   int64_t key(int kpos): the row index of kv position kpos in the K/V
//     arrays seen as (rows, HD), which is also its index in the int8
//     pages' scale/zero pools;
// and, for PARTIAL only: int64_t part(int r), row r's index in the
// workspace arrays po (index x HD floats), pm and pl.

// The row indices of one stage's keys [kpos0, kpos0 + KEYS), -1 at or past
// len. Written a stage ahead of the loads that read them, so a page id's
// read from the table is off the loads' critical path.
template <class Map>
__device__ __forceinline__ void index_stage(const Map& mp, int64_t* rows, int kpos0, int len) {
  for (int j = threadIdx.x; j < KEYS; j += THREADS) {
    rows[j] = kpos0 + j < len ? mp.key(kpos0 + j) : int64_t(-1);
  }
}

// Issue the loads of one stage from its row indices; a key with none (at
// or past len) is zero-filled. KT: the page type (16-bit, or int8 with Q8).
template <typename KT, bool Q8, int HD>
__device__ __forceinline__ void load_stage(const int64_t* rows, const KT* kp, const KT* vp,
                                           const float* const* sc, char* dst) {
  using L = Layout<HD>;
  if constexpr (!Q8) {
    constexpr int CPR = HD / 8;  // 16-byte chunks a row
    KT* kd = reinterpret_cast<KT*>(dst);
    KT* vd = reinterpret_cast<KT*>(dst + L::TILE16);
    for (int e = threadIdx.x; e < KEYS * CPR; e += THREADS) {
      const int j = e / CPR, c = e % CPR;
      const int64_t r = rows[j];
      const bool ok = r >= 0;
      const int64_t off = ok ? r * HD + c * 8 : 0;
      cp16(kd + j * L::LDS + c * 8, kp + off, ok);
      cp16(vd + j * L::LDS + c * 8, vp + off, ok);
    }
  } else {
    constexpr int CPR = HD / 16;
    int8_t* kd = reinterpret_cast<int8_t*>(dst);
    int8_t* vd = kd + L::RAW8;
    float* sd = reinterpret_cast<float*>(dst + 2 * L::RAW8);
    for (int e = threadIdx.x; e < KEYS * CPR; e += THREADS) {
      const int j = e / CPR, c = e % CPR;
      const int64_t r = rows[j];
      const bool ok = r >= 0;
      const int64_t off = ok ? r * HD + c * 16 : 0;
      cp16(kd + j * HD + c * 16, kp + off, ok);
      cp16(vd + j * HD + c * 16, vp + off, ok);
    }
    for (int j = threadIdx.x; j < KEYS; j += THREADS) {
      const int64_t r = rows[j];
      const bool ok = r >= 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) cp4(sd + i * KEYS + j, sc[i] + (ok ? r : 0), ok);
    }
  }
}

// int8 stage -> K codes as bf16, V codes as fp16, in the 16-bit tiles
template <int HD>
__device__ __forceinline__ void widen_stage(const char* raw, __nv_bfloat16* kc, __half* vc) {
  using L = Layout<HD>;
  constexpr int CPR = HD / 16;
  for (int e = threadIdx.x; e < KEYS * CPR; e += THREADS) {
    const int j = e / CPR, c = e % CPR;
    const uint4 kr = *reinterpret_cast<const uint4*>(raw + j * HD + c * 16);
    const uint4 vr = *reinterpret_cast<const uint4*>(raw + L::RAW8 + j * HD + c * 16);
    widen16(kc + j * L::LDS + c * 16, kr);
    widen16(vc + j * L::LDS + c * 16, vr);
  }
}

// Where key row k, columns [c, c + 8) of a 16-bit K or V tile lie in
// shared memory: tiles of this body are KEYS rows LDS elements apart (the
// decode kernels' TMA stages use their own layout, decode_split.cuh).
template <int HD>
struct PaddedTile {
  template <typename T>
  __device__ __forceinline__ const T* at(const T* tile, int k, int c) const {
    return tile + k * Layout<HD>::LDS + c;
  }
};

// The running softmax state of a thread's two rows (g and g + 8 of its
// warp's 16): max m, sum l, the int8 zero term z, and the accumulator
// o[n] = columns 8 n + t2 + {0, 1} of row g (o[n][0..1]) and g + 8 (2..3).
template <int HD>
struct RowState {
  float o[HD / 8][4];
  float m[2], l[2], z[2];
};

// Fold keys [key0, key0 + KW) of a stage (kv positions kpos0 + key) into
// the warp's rows. QKT: the QK operand type (K tile); PVT: the PV operand
// type (V tile); tl: where a tile's rows lie (PaddedTile, or the decode
// kernels' TMA layout). sc: Q8's scale/zero arrays of the stage (KEYS
// each). Scores are kept in base 2 (scale2 = softmax scale * log2 e,
// exp2f), so m is the row max of score * log2 e.
template <typename QKT, typename PVT, bool Q8, int HD, int KW, class Tile>
__device__ __forceinline__ void fold(RowState<HD>& st, const uint32_t (&qf)[HD / 16][4],
                                     const float (&qsum)[2], const QKT* kt, const PVT* vt,
                                     const float* sc, int key0, int kpos0, const int (&vlen)[2],
                                     float scale2, const Tile& tl) {
  constexpr int NT = KW / 8;
  const int lane = threadIdx.x & 31;
  const int t2 = (lane & 3) * 2;

  float s[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < NT; n += 2) {
    const int kr = key0 + (n + (lane >> 4)) * 8 + (lane & 7);
#pragma unroll
    for (int kb = 0; kb < HD / 16; ++kb) {
      uint32_t b[4];
      ldsm4(b, tl.at(kt, kr, ((lane >> 3) & 1) * 8 + kb * 16));
      mma<QKT>(s[n], qf[kb], b[0], b[1]);
      mma<QKT>(s[n + 1], qf[kb], b[2], b[3]);
    }
  }

  // scaled, masked scores and the row max
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = e >> 1;
      const int j = key0 + n * 8 + t2 + (e & 1);
      float x = s[n][e];
      if constexpr (Q8) x = sc[j] * x + sc[KEYS + j] * qsum[rr];
      x = kpos0 + j < vlen[rr] ? x * scale2 : NEG;
      s[n][e] = x;
      mx[rr] = fmaxf(mx[rr], x);
    }
  }
  float corr[2], mnew[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mnew[rr] = fmaxf(st.m[rr], quad_max(mx[rr]));
    corr[rr] = exp2f(st.m[rr] - mnew[rr]);
    st.m[rr] = mnew[rr];
  }

  // probabilities, rounded to the PV operand type
  uint32_t p[NT][2];
  float ls[2] = {0.f, 0.f}, zs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int j = key0 + n * 8 + t2;
      const float p0 = kpos0 + j < vlen[rr] ? exp2f(s[n][2 * rr] - mnew[rr]) : 0.f;
      const float p1 = kpos0 + j + 1 < vlen[rr] ? exp2f(s[n][2 * rr + 1] - mnew[rr]) : 0.f;
      if constexpr (Q8) {
        p[n][rr] = pack<PVT>(p0 * sc[2 * KEYS + j], p1 * sc[2 * KEYS + j + 1]);
        ls[rr] += p0 + p1;
        zs[rr] += p0 * sc[3 * KEYS + j] + p1 * sc[3 * KEYS + j + 1];
      } else {
        float r0, r1;
        p[n][rr] = pack<PVT>(p0, p1, r0, r1);
        ls[rr] += r0 + r1;
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    st.l[rr] = st.l[rr] * corr[rr] + ls[rr];
    st.z[rr] = st.z[rr] * corr[rr] + zs[rr];
  }
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    st.o[d][0] *= corr[0];
    st.o[d][1] *= corr[0];
    st.o[d][2] *= corr[1];
    st.o[d][3] *= corr[1];
  }

  // O += P V, 16 keys at a time
#pragma unroll
  for (int kk = 0; kk < KW / 16; ++kk) {
    const uint32_t a[4] = {p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0], p[2 * kk + 1][1]};
    const int vr = key0 + kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b[4];
      ldsm4t(b, tl.at(vt, vr, (lane >> 4) * 8 + dp * 16));
      mma<PVT>(st.o[2 * dp], a, b[0], b[1]);
      mma<PVT>(st.o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// The whole body for one block: rows [0, n_rows) of the map, keys
// [0, len). NSPLIT warps share each row group, so the block attends its
// first 16 * WARPS / NSPLIT rows; rows from there to n_rows are the
// caller's promise of pad rows and are written as 0.
// QT: q and out; KT: the pages; QKT, PVT: the operand types of the two
// products (QT and QT, or bf16 and fp16 with Q8). PARTIAL: write each
// row's (m, l, o) through the map's part() instead of out, which is unused.
template <typename QT, typename KT, bool Q8, int HD, int NSPLIT, class Map,
          bool PARTIAL = false>
__device__ __forceinline__ void attend(const Map& mp, const QT* __restrict__ q,
                                       const KT* __restrict__ kp, const KT* __restrict__ vp,
                                       const float* const* sc, QT* __restrict__ out, int n_rows,
                                       int len, float scale, char* smem) {
  using QKT = typename std::conditional<Q8, __nv_bfloat16, QT>::type;
  using PVT = typename std::conditional<Q8, __half, QT>::type;
  using L = Layout<HD>;
  constexpr int NRW = WARPS / NSPLIT;  // row groups
  constexpr int KW = KEYS / NSPLIT;    // keys a warp takes of each stage
  static_assert(NRW * NSPLIT == WARPS && KW % 16 == 0, "split");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp % NRW, ks = warp / NRW;
  const int g = lane >> 2, t2 = (lane & 3) * 2;

  // this thread's two rows, their limits, and the warp's Q fragments
  int64_t qoff[2];
  int vlen[2];
  bool has[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = rw * 16 + g + 8 * rr;
    has[rr] = r < n_rows && mp.query(r, qoff[rr], vlen[rr]);
    if (!has[rr]) {
      qoff[rr] = 0;
      vlen[rr] = 0;
    }
    vlen[rr] = min(vlen[rr], len);
  }
  uint32_t qf[HD / 16][4];
  float qsum[2] = {0.f, 0.f};
#pragma unroll
  for (int kb = 0; kb < HD / 16; ++kb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = i & 1;
      qf[kb][i] = has[rr] ? __ldg(reinterpret_cast<const unsigned int*>(
                                q + qoff[rr] + kb * 16 + (i >> 1) * 8 + t2))
                          : 0u;
      if constexpr (Q8) {
        const float2 f = unpack<QKT>(qf[kb][i]);
        qsum[rr] += f.x + f.y;
      }
    }
  }
  if constexpr (Q8) {
    qsum[0] = quad_sum(qsum[0]);
    qsum[1] = quad_sum(qsum[1]);
  }
  int vmax = max(vlen[0], vlen[1]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) vmax = max(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));

  RowState<HD> st;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) st.o[d][0] = st.o[d][1] = st.o[d][2] = st.o[d][3] = 0.f;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    st.m[rr] = NEG;
    st.l[rr] = 0.f;
    st.z[rr] = 0.f;
  }

  // the walk over keys: STAGES stages in a ring, the next STAGES - 1 in
  // flight while one is computed, and their row indices one stage further
  constexpr size_t STAGE = Q8 ? L::STAGE8 : L::STAGE16;
  QKT* kc = reinterpret_cast<QKT*>(smem + STAGES * STAGE);  // Q8: the widened tiles
  PVT* vc = reinterpret_cast<PVT*>(smem + STAGES * STAGE + L::TILE16);
  int64_t* rid = reinterpret_cast<int64_t*>(smem + L::ring(Q8));
  const float scale2 = scale * LOG2E;
  const int n_st = (len + KEYS - 1) / KEYS;
#pragma unroll
  for (int i = 0; i < STAGES; ++i) index_stage(mp, rid + i * KEYS, i * KEYS, len);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_st) load_stage<KT, Q8, HD>(rid + i * KEYS, kp, vp, sc, smem + i * STAGE);
    cp_commit();
  }
  for (int i = 0; i < n_st; ++i) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage i landed for every thread; stage i - 1 is free
    const int nx = i + STAGES - 1;
    if (nx < n_st) {
      load_stage<KT, Q8, HD>(rid + (nx % STAGES) * KEYS, kp, vp, sc,
                             smem + (nx % STAGES) * STAGE);
    }
    cp_commit();
    // stage i's loads were issued a step ago: its indices give way to stage
    // i + STAGES's, read after the next barrier
    index_stage(mp, rid + (i % STAGES) * KEYS, (i + STAGES) * KEYS, len);
    char* cur = smem + (i % STAGES) * STAGE;
    const float* scs = nullptr;
    const QKT* kt;
    const PVT* vt;
    if constexpr (Q8) {
      widen_stage<HD>(cur, reinterpret_cast<__nv_bfloat16*>(kc), reinterpret_cast<__half*>(vc));
      __syncthreads();
      scs = reinterpret_cast<const float*>(cur + 2 * L::RAW8);
      kt = kc;
      vt = vc;
    } else {
      kt = reinterpret_cast<const QKT*>(cur);
      vt = reinterpret_cast<const PVT*>(cur + L::TILE16);
    }
    if (i * KEYS + ks * KW < vmax) {
      fold<QKT, PVT, Q8, HD, KW>(st, qf, qsum, kt, vt, scs, ks * KW, i * KEYS, vlen, scale2,
                                 PaddedTile<HD>{});
    }
  }
  cp_wait<0>();
  __syncthreads();  // every warp is done with the tiles: the combine may reuse them

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    st.l[rr] = quad_sum(st.l[rr]);
    st.z[rr] = quad_sum(st.z[rr]);
  }

  if constexpr (NSPLIT > 1) {
    // splits 1 .. NSPLIT - 1 hand their rows to split 0, which adds them in
    // split order
    float* cb = reinterpret_cast<float*>(smem);
    constexpr int SLOT = 16 * (HD + 3);
    if (ks > 0) {
      float* b = cb + ((ks - 1) * NRW + rw) * SLOT;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = g + 8 * rr;
#pragma unroll
        for (int d = 0; d < HD / 8; ++d) {
          b[row * HD + d * 8 + t2] = st.o[d][2 * rr];
          b[row * HD + d * 8 + t2 + 1] = st.o[d][2 * rr + 1];
        }
        if ((lane & 3) == 0) {
          b[16 * HD + row] = st.m[rr];
          b[16 * HD + 16 + row] = st.l[rr];
          b[16 * HD + 32 + row] = st.z[rr];
        }
      }
    }
    __syncthreads();
    if (ks == 0) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = g + 8 * rr;
        float mall = st.m[rr];
#pragma unroll
        for (int k = 1; k < NSPLIT; ++k) {
          mall = fmaxf(mall, cb[((k - 1) * NRW + rw) * SLOT + 16 * HD + row]);
        }
        const float c0 = exp2f(st.m[rr] - mall);
        st.l[rr] *= c0;
        st.z[rr] *= c0;
#pragma unroll
        for (int d = 0; d < HD / 8; ++d) {
          st.o[d][2 * rr] *= c0;
          st.o[d][2 * rr + 1] *= c0;
        }
#pragma unroll
        for (int k = 1; k < NSPLIT; ++k) {
          const float* b = cb + ((k - 1) * NRW + rw) * SLOT;
          const float ck = exp2f(b[16 * HD + row] - mall);
          st.l[rr] += b[16 * HD + 16 + row] * ck;
          st.z[rr] += b[16 * HD + 32 + row] * ck;
#pragma unroll
          for (int d = 0; d < HD / 8; ++d) {
            st.o[d][2 * rr] += b[row * HD + d * 8 + t2] * ck;
            st.o[d][2 * rr + 1] += b[row * HD + d * 8 + t2 + 1] * ck;
          }
        }
        st.m[rr] = mall;
      }
    }
  }

  if (ks == 0) {
    if constexpr (PARTIAL) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        if (!has[rr]) continue;
        const int64_t p = mp.part(rw * 16 + g + 8 * rr);
        float* orow = mp.po + p * HD;
#pragma unroll
        for (int d = 0; d < HD / 8; ++d) {
          if constexpr (Q8) {
            *reinterpret_cast<float2*>(orow + d * 8 + t2) =
                make_float2(st.o[d][2 * rr] + st.z[rr], st.o[d][2 * rr + 1] + st.z[rr]);
          } else {
            *reinterpret_cast<float2*>(orow + d * 8 + t2) =
                make_float2(st.o[d][2 * rr], st.o[d][2 * rr + 1]);
          }
        }
        if ((lane & 3) == 0) {
          mp.pm[p] = st.m[rr];
          mp.pl[p] = st.l[rr];
        }
      }
    } else {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        if (!has[rr]) continue;
        const float l = fmaxf(st.l[rr], 1e-30f);
        QT* orow = out + qoff[rr];
#pragma unroll
        for (int d = 0; d < HD / 8; ++d) {
          const float x0 = (st.o[d][2 * rr] + st.z[rr]) / l;
          const float x1 = (st.o[d][2 * rr + 1] + st.z[rr]) / l;
          *reinterpret_cast<uint32_t*>(orow + d * 8 + t2) = pack<QT>(x0, x1);
        }
      }
    }
  }
  if constexpr (!PARTIAL) {
    // rows past the block's row groups: pads, exactly 0
    for (int e = NRW * 16 * HD + threadIdx.x; e < n_rows * HD; e += THREADS) {
      int64_t off;
      int vl;
      if (mp.query(e / HD, off, vl)) out[off + e % HD] = QT(0.f);
    }
  }
}

}  // namespace mma_attn
