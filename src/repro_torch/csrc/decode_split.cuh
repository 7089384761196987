// The split of a decode row's keys over blocks (flash-decoding), and the
// one launch that computes and combines it: the tensor-core bodies of
// paged_decode_attention.cu and decode_attention.cu.
//
// One query token per sequence leaves B x Hkv (sequence, kv head) pairs for
// a decode step (32 at granite-3-8b batch 4, on 132 SMs), each a walk over
// up to a whole row of keys. The walk is split: split s of a row holds kv
// positions [s KPS, (s + 1) KPS), and its partial state for each of the G
// query rows of kv head h is, in f32,
//   o  sum_j p_j v_j, p_j = 2^(score_j - m)
//   m  the base-2 row max (score * scale * log2 e)
//   l  sum_j p_j, from the rounded p
// The row's output is (sum_s o_s 2^(m_s - M)) / max(sum_s l_s 2^(m_s - M),
// 1e-30), M the largest m_s, the sums taken in split order; a row with no
// key (n = 0 splits) is exactly 0.
//
// One launch (decode_cluster_kernel): the blocks of one (sequence, kv
// head) form a thread block cluster of C <= 8 blocks (grid (C, Hkv, B), C
// chosen on the host from shapes and the card's occupancy alone, never
// from kv_len: launch_nsplit). Block r walks splits r, r + C,
// r + 2C, ... of its row and stops at the row's length:
// - warp 0 reads the row's length and its first split's page ids together
//   at the block's start (one trip to memory), then issues that split's
//   K and V by TMA (hopper.cuh's tma_load_4d; pages: one box a page and
//   kv head, or a power-of-two part of one; slot-contiguous caches: boxes
//   of 16 rows) into a ring of two stages of 64 keys on mbarriers, so all
//   of a split's bytes are in flight before its first product. A later
//   stage's page ids are read while the stage before it is computed;
//   the stage is issued when its slot frees up;
// - the four warps fold each stage into their rows with
//   mma_attention.cuh's fold (QK and PV on mma.sync, its online softmax),
//   their ldmatrix addresses following the TMA layout (TmaTile); for
//   G <= 16 (<= 32) the warps split each stage's keys four (two) ways and
//   add their rows in split order, as mma_attention.cuh's attend does;
// - each split's partial goes to the f32 workspace, which the L2 still
//   holds when it is read (tools/decode_probe.py measured keeping them in
//   the cluster's shared memory instead, read across the cluster: never
//   faster, and a wave slower where their bytes cost a block an SM);
// - every block, with keys or without, arrives at the cluster barrier;
//   then the cluster's warps write the G rows with combine_row's
//   arithmetic.
//
// The bits. Which split a key lands in depends on its position alone (KPS
// is fixed, never derived from the table width, S or the batch); within a
// split the stages, the warps' key split and the order of every sum are
// those of mma_attention.cuh's attend on the same split, and the combine
// is combine_row's, in split order, with no atomics. So the outputs are
// those of the two-kernel split and combine that the ragged kernel still
// runs on its decode runs (ragged_paged_attention.cu), bit for bit, and
// do not move with the table's width or the cache's S.
//
// Masking. TMA brings whole boxes: the rest of a row's last page, or cache
// rows at or past its length, and stale slots of the ring may hold
// anything. Scores of keys at or past the row's length are replaced by a
// select in fold (never multiplied), and the V rows of those keys are
// zeroed before the product (0 * NaN is NaN inside mma). Boxes wholly
// past the row's length are never loaded; a box past the pool or the
// cache comes back zero-filled.

#pragma once

#include <cuda.h>

#include <type_traits>

#include "hopper.cuh"
#include "mma_attention.cuh"
#include "paged_attention_common.cuh"

namespace dsplit {

// kv positions a split: two stages of the body. kernels/decode_attention.py
// sizes the workspace with the same constant (SPLIT_KEYS) and the C entry
// points refuse a workspace of another split count.
constexpr int KPS = 128;
static_assert(KPS == 2 * mma_attn::KEYS, "a split is two stages");

constexpr int COMBINE_WARPS = 4;  // (slot, q head) rows a block of ragged's combine
constexpr int CLUSTER_CAP = 16;   // the largest cluster a launch may ask for

__host__ __device__ inline int n_splits(int n_keys) { return (n_keys + KPS - 1) / KPS; }

// The workspace, one f32 buffer: o, then m, then l.
struct Workspace {
  float* o;
  float* m;
  float* l;
};

inline Workspace carve(void* ws, int B, int hq, int n_split, int hd) {
  float* base = static_cast<float*>(ws);
  const size_t rows = size_t(B) * hq * n_split;
  return {base, base + rows * hd, base + rows * (hd + 1)};
}

// The query rows of split (b, h, s), for mma_attention.cuh's attend: row r
// is q head h G + r of sequence b, attending the split's first vlen keys.
// (The ragged kernel's decode runs.)
struct SplitRows {
  float* po;
  float* pm;
  float* pl;
  int b, h, s, hq, G, hd, n_split, vlen;
  __device__ __forceinline__ bool query(int r, int64_t& off, int& vl) const {
    off = (static_cast<int64_t>(b) * hq + h * G + r) * hd;
    vl = vlen;
    return true;
  }
  __device__ __forceinline__ int64_t part(int r) const {
    return (static_cast<int64_t>(b) * hq + h * G + r) * n_split + s;
  }
};

// The body on one split: len (>= 1) keys of the split, G rows, the row
// groups and key split of the body chosen by G. KT, Q8, sc: the pages, as
// mma_attention.cuh's attend takes them. (The ragged kernel's decode
// runs.)
template <typename T, typename KT, bool Q8, int HD, class Map>
__device__ __forceinline__ void attend_split(const Map& mp, const T* q, const KT* kp,
                                             const KT* vp, const float* const* sc, int G,
                                             int len, float scale, char* smem) {
  using mma_attn::attend;
  if (G <= 16) {
    attend<T, KT, Q8, HD, 4, Map, true>(mp, q, kp, vp, sc, nullptr, G, len, scale, smem);
  } else if (G <= 32) {
    attend<T, KT, Q8, HD, 2, Map, true>(mp, q, kp, vp, sc, nullptr, G, len, scale, smem);
  } else {
    attend<T, KT, Q8, HD, 1, Map, true>(mp, q, kp, vp, sc, nullptr, G, len, scale, smem);
  }
}

// The warps that share each row group's keys, by G (attend_split's rule).
__host__ __device__ inline int key_split(int G) { return G <= 16 ? 4 : G <= 32 ? 2 : 1; }

// One warp writes one output row orow (HD values of QT) from its n
// partials at po/pm/pl[p0 ..]: (sum_s o_s 2^(m_s - M)) / max(sum_s l_s
// 2^(m_s - M), 1e-30), the sums in split order; n = 0 gives exactly 0.
template <typename QT, int HD>
__device__ __forceinline__ void combine_row(const float* __restrict__ po,
                                            const float* __restrict__ pm,
                                            const float* __restrict__ pl, int64_t p0, int n,
                                            QT* __restrict__ orow, int lane) {
  float mx = mma_attn::NEG;
  for (int s = lane; s < n; s += 32) mx = fmaxf(mx, pm[p0 + s]);
  mx = pattn::warp_max(mx);
  constexpr int PER = (HD + 31) / 32;  // columns a lane; at HD 16 half the lanes idle
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  float l = 0.f;
#pragma unroll 4
  for (int s = 0; s < n; ++s) {
    const float c = exp2f(pm[p0 + s] - mx);
    l += pl[p0 + s] * c;
    const float* o = po + (p0 + s) * HD;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      if (lane + 32 * i < HD) acc[i] += o[lane + 32 * i] * c;
    }
  }
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (lane + 32 * i < HD) orow[lane + 32 * i] = pattn::from_f32<QT>(acc[i] / den);
  }
}

// ---------------------------------------------------------------------------
// the cluster launch
// ---------------------------------------------------------------------------

// combine_row's arithmetic, bit for bit, with every load of a row of at
// most NMAX splits issued at once (lane s brings split s's m and l, each
// lane its columns of every o), so the row waits on one trip to the L2
// instead of one for the max and more for the sums; past NMAX splits,
// combine_row itself.
template <typename QT, int HD, int NMAX>
__device__ __forceinline__ void combine_row_at_once(const float* __restrict__ po,
                                                    const float* __restrict__ pm,
                                                    const float* __restrict__ pl, int64_t p0,
                                                    int n, QT* __restrict__ orow, int lane) {
  static_assert(NMAX <= 32, "one split a lane");
  if (n > NMAX) {
    combine_row<QT, HD>(po, pm, pl, p0, n, orow, lane);
    return;
  }
  constexpr int PER = (HD + 31) / 32;
  const float m_lane = lane < n ? pm[p0 + lane] : mma_attn::NEG;
  const float l_lane = lane < n ? pl[p0 + lane] : 0.f;
  float ov[NMAX][PER];
#pragma unroll
  for (int s = 0; s < NMAX; ++s) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      ov[s][i] = s < n && lane + 32 * i < HD ? po[(p0 + s) * HD + lane + 32 * i] : 0.f;
    }
  }
  const float mx = pattn::warp_max(m_lane);
  float acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) acc[i] = 0.f;
  float l = 0.f;
#pragma unroll
  for (int s = 0; s < NMAX; ++s) {
    if (s < n) {
      const float c = exp2f(__shfl_sync(0xffffffffu, m_lane, s) - mx);
      l += __shfl_sync(0xffffffffu, l_lane, s) * c;
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[i] += ov[s][i] * c;
    }
  }
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (lane + 32 * i < HD) orow[lane + 32 * i] = pattn::from_f32<QT>(acc[i] / den);
  }
}

// A K or V stage of KEYS rows as TMA writes it: column blocks of COLS
// elements, each KEYS x MINROWS lines of LINE bytes swizzled as TMA's
// LINE-byte swizzle (hopper.cuh's swz; the 1,024-byte aligned ring keeps
// every pattern in phase). A box of 2^lh rows lands on 2^ls lines (ls >=
// lh), so every box starts on 128 bytes, as TMA requires, even where a
// row is 32 or 64 bytes and the box 1 or 2 rows.
template <int HD>
struct TmaTile {
  static constexpr int COLS = HD < 64 ? HD : 64;  // elements a swizzle line
  static constexpr int LINE = COLS * 2;           // its bytes
  static constexpr int CB = HD / COLS;            // column blocks a row
  static constexpr int MINROWS = 128 / LINE;      // rows of 128 bytes
  static constexpr int LINES = mma_attn::KEYS * MINROWS;  // lines a column block
  static constexpr int BYTES = CB * LINES * LINE;  // one K or V stage
  int lh, ls;
  __device__ __forceinline__ int line(int k) const {
    if constexpr (MINROWS == 1) {
      return k;
    } else {
      return ((k >> lh) << ls) | (k & ((1 << lh) - 1));
    }
  }
  // key row k, columns [c, c + 8) (16 bytes, one swizzle chunk)
  template <typename T>
  __device__ __forceinline__ const T* at(const T* tile, int k, int c) const {
    const int off = (c / COLS) * (LINES * LINE) + line(k) * LINE + (c % COLS) * 2;
    return reinterpret_cast<const T*>(reinterpret_cast<const char*>(tile) +
                                      hopper::swz<LINE>(off));
  }
};

// The launch's scalars.
struct Args {
  const void* q;
  void* out;
  const int* kv_len;
  Workspace ws;      // the partials
  int hq, hkv;
  int n_split;       // ceil(cap / KPS)
  int cap;           // a row's positions: the table's nb bs, or S
  int lh, ls;        // log2 of a box's rows and of the tile lines it takes
  float scale;
};

// Shared memory: the ring (two stages of K then V), two mbarriers, then
// the row groups' scratch for their key split.
template <int HD>
struct ClusterSmem {
  static constexpr int STAGE = 2 * TmaTile<HD>::BYTES;
  static constexpr int BARS = 2 * STAGE;
  static constexpr int SCRATCH = BARS + 16;
  // floats of the scratch: (key split - 1) x row groups slots of R rows
  // (R = min(G, 16)) of (o, m, l)
  __host__ __device__ static int scratch_floats(int G) {
    const int ns = key_split(G), rows = G < 16 ? G : 16;
    return (ns - 1) * (mma_attn::WARPS / ns) * rows * (HD + 2);
  }
  static size_t bytes(int G) { return 1024 + SCRATCH + 4 * size_t(scratch_floats(G)); }
};

// Src: where position p of row b lies in the 4-D map (HD, Hkv, D2, D3):
// coordinate row(p) along D2, page(b, p) along D3 (pages: slot p % bs of
// page tables[b][p / bs]; caches: row p of sequence b).
template <typename T, int HD, int NSPLIT, class Src>
__global__ void __launch_bounds__(mma_attn::THREADS)
decode_cluster_kernel(const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, const Src src, const Args a) {
  using TL = TmaTile<HD>;
  using SM = ClusterSmem<HD>;
  using mma_attn::KEYS;
  using mma_attn::THREADS;
  using mma_attn::WARPS;
  constexpr int NRW = WARPS / NSPLIT;  // row groups
  constexpr int KW = KEYS / NSPLIT;    // keys a warp takes of each stage
  constexpr int PG = KEYS * TL::CB / 32;  // boxes (page, column block) a lane at most
  static_assert(PG >= 1 && NRW * NSPLIT == WARPS && KW % 16 == 0, "shapes");
  extern __shared__ char smem_raw[];
  char* smem = smem_raw + ((1024 - (hopper::saddr(smem_raw) & 1023)) & 1023);
  const int C = gridDim.x, r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = a.hq / a.hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rw = warp % NRW, ks = warp / NRW;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int hrows = 1 << a.lh;  // a box's rows
  const TL tl{a.lh, a.ls};
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SM::BARS);
  float* scratch = reinterpret_cast<float*>(smem + SM::SCRATCH);
  const int R = G < 16 ? G : 16;  // rows a scratch slot holds

  // stage i of this block: split r + (i / 2) C, its keys [pos0, pos0 + nk)
  // below `lim`; none where nk <= 0
  auto stage_keys = [&](int i, int lim, int& pos0) {
    pos0 = (r + (i >> 1) * C) * KPS + (i & 1) * KEYS;
    return min(KEYS, lim - pos0);
  };
  // warp 0: the page ids of the boxes of stage i this lane issues (box j
  // of idx = lane + 32 u, column block idx % CB)
  auto page_ids = [&](int (&pg)[PG], int i, int lim) {
    int pos0;
    const int nk = stage_keys(i, lim, pos0);
#pragma unroll
    for (int u = 0; u < PG; ++u) {
      const int j = (lane + 32 * u) / TL::CB;
      pg[u] = j * hrows < nk ? src.page(b, pos0 + j * hrows) : 0;
    }
  };
  // warp 0: stage i's K and V boxes into its slot, on its mbarrier
  auto issue = [&](const int (&pg)[PG], int i, int lim) {
    int pos0;
    const int nk = stage_keys(i, lim, pos0);
    if (nk <= 0) return;
    const int nbox = (nk + hrows - 1) >> a.lh;
    uint64_t* bar = full + (i & 1);
    if (lane == 0) hopper::mbar_expect_tx(bar, 2 * nbox * TL::CB * hrows * TL::LINE);
    __syncwarp();
    char* st = smem + (i & 1) * SM::STAGE;
#pragma unroll
    for (int u = 0; u < PG; ++u) {
      const int idx = lane + 32 * u, j = idx / TL::CB, cb = idx % TL::CB;
      if (j < nbox) {
        const int p = pos0 + j * hrows;
        const int off = cb * (TL::LINES * TL::LINE) + tl.line(j << a.lh) * TL::LINE;
        hopper::tma_load_4d(st + off, &kmap, bar, cb * TL::COLS, h, src.row(p), pg[u]);
        hopper::tma_load_4d(st + TL::BYTES + off, &vmap, bar, cb * TL::COLS, h, src.row(p),
                            pg[u]);
      }
    }
  };

  if (tid == 0) {
    hopper::mbar_init(full, 1);
    hopper::mbar_init(full + 1, 1);
    hopper::mbar_init_fence();
  }
  // the row's length, (warp 0) the first split's page ids, and the Q
  // fragments, read together (the table's entries below cap exist,
  // whatever the row's length)
  const int raw_len = a.kv_len[b];
  int pg0[PG], pg1[PG];
  if (warp == 0) {
    page_ids(pg0, 0, a.cap);
    page_ids(pg1, 1, a.cap);
  }
  // this thread's two rows of its row group, and the warp's Q fragments
  bool has[2];
  uint32_t qf[HD / 16][4];
  const float qsum[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) has[rr] = rw * 16 + g + 8 * rr < G;
#pragma unroll
  for (int kb = 0; kb < HD / 16; ++kb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = e & 1;
      const int64_t off =
          (static_cast<int64_t>(b) * a.hq + h * G + rw * 16 + g + 8 * rr) * HD + kb * 16 +
          (e >> 1) * 8 + t2;
      qf[kb][e] = has[rr] ? __ldg(reinterpret_cast<const unsigned int*>(
                                static_cast<const T*>(a.q) + off))
                          : 0u;
    }
  }
  __syncthreads();  // the mbarriers are initialised
  const int len = min(max(raw_len, 0), a.cap);
  const int n = n_splits(len);
  if (warp == 0) {
    issue(pg0, 0, len);
    issue(pg1, 1, len);
  }

  const float scale2 = a.scale * mma_attn::LOG2E;

  int i = 0;  // the block's stage, over its splits
  for (int s = r, k = 0; s < n; s += C, ++k) {
    const int len_s = min(len - s * KPS, KPS);
    const int n_st = (len_s + KEYS - 1) / KEYS;
    int vlen[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) vlen[rr] = has[rr] ? len_s : 0;
    int vmax = max(vlen[0], vlen[1]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) vmax = max(vmax, __shfl_xor_sync(0xffffffffu, vmax, o));
    mma_attn::RowState<HD> st;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) st.o[d][0] = st.o[d][1] = st.o[d][2] = st.o[d][3] = 0.f;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      st.m[rr] = mma_attn::NEG;
      st.l[rr] = 0.f;
      st.z[rr] = 0.f;
    }

    for (int t = 0; t < n_st; ++t, ++i) {
      int nxt[PG];
      if (warp == 0) page_ids(nxt, i + 2, len);  // in flight while this stage is folded
      hopper::mbar_wait(full + (i & 1), (i >> 1) & 1);
      char* cur = smem + (i & 1) * SM::STAGE;
      const int nk = min(KEYS, len_s - t * KEYS);
      if (nk < KEYS) {
        // V rows past the row's keys (the rest of a box, boxes never
        // loaded): whatever they hold, 0 * it must be 0
        constexpr int CPL = TL::LINE / 16;
        for (int e = tid; e < (KEYS - nk) * TL::CB * CPL; e += THREADS) {
          const int kk = nk + e / (TL::CB * CPL), c = e % (TL::CB * CPL);
          *reinterpret_cast<uint4*>(cur + TL::BYTES + (c / CPL) * (TL::LINES * TL::LINE) +
                                    tl.line(kk) * TL::LINE + (c % CPL) * 16) =
              make_uint4(0u, 0u, 0u, 0u);
        }
        hopper::fence_proxy_async();
        __syncthreads();
      }
      if (t * KEYS + ks * KW < vmax) {
        mma_attn::fold<T, T, false, HD, KW>(st, qf, qsum, reinterpret_cast<const T*>(cur),
                                            reinterpret_cast<const T*>(cur + TL::BYTES),
                                            nullptr, ks * KW, t * KEYS, vlen, scale2, tl);
      }
      __syncthreads();  // every warp is done with this slot
      if (warp == 0) issue(nxt, i + 2, len);
    }

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) st.l[rr] = mma_attn::quad_sum(st.l[rr]);
    if constexpr (NSPLIT > 1) {
      // warps 1 .. NSPLIT - 1 of each row group hand their rows to warp 0,
      // which adds them in split order (attend's arithmetic)
      const int SLOT = R * (HD + 2);
      if (ks > 0) {
        float* sb = scratch + ((ks - 1) * NRW + rw) * SLOT;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int row = g + 8 * rr;
          if (row >= R) continue;
#pragma unroll
          for (int d = 0; d < HD / 8; ++d) {
            sb[row * HD + d * 8 + t2] = st.o[d][2 * rr];
            sb[row * HD + d * 8 + t2 + 1] = st.o[d][2 * rr + 1];
          }
          if ((lane & 3) == 0) {
            sb[R * HD + row] = st.m[rr];
            sb[R * HD + R + row] = st.l[rr];
          }
        }
      }
      __syncthreads();
      if (ks == 0) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int row = g + 8 * rr;
          if (row >= R) continue;
          float mall = st.m[rr];
#pragma unroll
          for (int kk = 1; kk < NSPLIT; ++kk) {
            mall = fmaxf(mall, scratch[((kk - 1) * NRW + rw) * SLOT + R * HD + row]);
          }
          const float c0 = exp2f(st.m[rr] - mall);
          st.l[rr] *= c0;
#pragma unroll
          for (int d = 0; d < HD / 8; ++d) {
            st.o[d][2 * rr] *= c0;
            st.o[d][2 * rr + 1] *= c0;
          }
#pragma unroll
          for (int kk = 1; kk < NSPLIT; ++kk) {
            const float* sb = scratch + ((kk - 1) * NRW + rw) * SLOT;
            const float ck = exp2f(sb[R * HD + row] - mall);
            st.l[rr] += sb[R * HD + R + row] * ck;
#pragma unroll
            for (int d = 0; d < HD / 8; ++d) {
              st.o[d][2 * rr] += sb[row * HD + d * 8 + t2] * ck;
              st.o[d][2 * rr + 1] += sb[row * HD + d * 8 + t2 + 1] * ck;
            }
          }
          st.m[rr] = mall;
        }
      }
    }
    if (ks == 0) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        if (!has[rr]) continue;
        const int row = rw * 16 + g + 8 * rr;
        const int64_t p = (static_cast<int64_t>(b) * a.hq + h * G + row) * a.n_split + s;
        float* po = a.ws.o + p * HD;
#pragma unroll
        for (int d = 0; d < HD / 8; ++d) {
          *reinterpret_cast<float2*>(po + d * 8 + t2) =
              make_float2(st.o[d][2 * rr], st.o[d][2 * rr + 1]);
        }
        if ((lane & 3) == 0) {
          a.ws.m[p] = st.m[rr];
          a.ws.l[p] = st.l[rr];
        }
      }
    }
  }

  // every block of the cluster, with keys or without, past its splits:
  // the barrier's release and acquire make the partials written before it
  // (to the workspace, in the L2) seen by every block of the cluster after
  hopper::cluster_sync();
  // the cluster's warps write the G rows, in split order
  for (int row = r + C * warp; row < G; row += C * WARPS) {
    const int64_t orow = static_cast<int64_t>(b) * a.hq + h * G + row;
    combine_row_at_once<T, HD, 8>(a.ws.o, a.ws.m, a.ws.l, orow * a.n_split, n,
                                  static_cast<T*>(a.out) + orow * HD, lane);
  }
}

// The tensor map of a K or V array seen as (HD, Hkv, d2, d3) of T (pages
// (N, bs, Hkv, HD): d2 = bs, d3 = N; caches (B, S, Hkv, HD): d2 = S, d3 =
// B), a box one swizzle line of `rows` rows of one kv head.
template <typename T, int HD>
bool make_kv_map(CUtensorMap* map, const void* base, int hkv, int d2, int d3, int rows) {
  using TL = TmaTile<HD>;
  const hopper::EncodeTiled enc = hopper::encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(hkv), static_cast<cuuint64_t>(d2),
                              static_cast<cuuint64_t>(d3)};
  const cuuint64_t strides[3] = {HD * 2ull, static_cast<cuuint64_t>(hkv) * HD * 2,
                                 static_cast<cuuint64_t>(d2) * hkv * HD * 2};
  const cuuint32_t box[4] = {TL::COLS, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = TL::LINE == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : TL::LINE == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                  : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUtensorMapDataType dt = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return enc(map, dt, 4, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// log2 of a box's rows over pages of bs rows: the largest power of two
// that divides bs, at most a stage (boxes then never cross a page, and
// every stage is whole boxes)
inline int box_log2(int bs) {
  int lh = 0;
  while (lh < 6 && bs % (2 << lh) == 0) ++lh;
  return lh;
}

// The cluster kernel with NSPLIT warps on each row group's keys, grid (C,
// Hkv, B) in clusters of C blocks: C the first of min(C0, n_split), then
// the powers of two below it, whose B x Hkv clusters the card holds at
// once (cudaOccupancyMaxActiveClusters; none: min(C0, n_split)), so that
// blocks with no keys do not push the grid into a second wave. A cluster
// the card cannot hold at all (the query 0 or refused) is an error:
// never a launch of another size. *cluster: the C launched.
template <typename T, int HD, int NSPLIT, class Src>
cudaError_t launch_nsplit(const CUtensorMap& km, const CUtensorMap& vm, const Src& src,
                          const Args& a, int B, int C0, int* cluster, cudaStream_t stream) {
  static size_t configured = 0;
  // clusters the card holds, by C, at the shared memory last asked
  static size_t asked[CLUSTER_CAP + 1] = {};
  static int held[CLUSTER_CAP + 1] = {};
  auto kernel = decode_cluster_kernel<T, HD, NSPLIT, Src>;
  const size_t bytes = ClusterSmem<HD>::bytes(a.hq / a.hkv);
  cudaError_t e = pattn::ensure_smem(kernel, bytes, &configured);
  if (e != cudaSuccess) return e;
  const int top = a.n_split < C0 ? (a.n_split > 0 ? a.n_split : 1) : C0;
  int cand[8], nc = 0;  // top, then the powers of two below it
  cand[nc++] = top;
  for (int c = 1 << (31 - __builtin_clz(top)); c >= 1; c >>= 1) {
    if (c < top) cand[nc++] = c;
  }
  int C = top;
  for (int i = 0; i < nc; ++i) {
    const int c = cand[i];
    if (asked[c] != bytes) {
      int n = 0;
      e = hopper::max_clusters(kernel, dim3(c, a.hkv, B), mma_attn::THREADS, bytes, c, &n);
      if (e != cudaSuccess) return e;
      if (n == 0) return cudaErrorInvalidConfiguration;
      asked[c] = bytes;
      held[c] = n;
    }
    if (held[c] >= a.hkv * B) {
      C = c;
      break;
    }
  }
  *cluster = C;
  return hopper::launch_ex(kernel, dim3(C, a.hkv, B), mma_attn::THREADS, bytes, stream, false, C,
                           km, vm, src, a);
}

// The launch of one call: kmap/vmap are make_kv_map's, boxes of 2^a.lh
// rows; C0 in [1, CLUSTER_CAP] (else refused): the most blocks a cluster.
template <typename T, int HD, class Src>
cudaError_t launch_cluster(const CUtensorMap& km, const CUtensorMap& vm, const Src& src,
                           const Args& a, int B, int C0, int* cluster, cudaStream_t stream) {
  if (C0 < 1 || C0 > CLUSTER_CAP) return cudaErrorInvalidValue;
  switch (key_split(a.hq / a.hkv)) {
    case 4:
      return launch_nsplit<T, HD, 4>(km, vm, src, a, B, C0, cluster, stream);
    case 2:
      return launch_nsplit<T, HD, 2>(km, vm, src, a, B, C0, cluster, stream);
    default:
      return launch_nsplit<T, HD, 1>(km, vm, src, a, B, C0, cluster, stream);
  }
}

}  // namespace dsplit
