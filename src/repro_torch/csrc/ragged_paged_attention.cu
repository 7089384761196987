// Ragged-batch paged attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ragged_attention.py:
// ragged_paged_attention (bodies _ragged_kernel and _ragged_kernel_q8).
//
// What it computes: one launch over a whole mixed serving step. q (T,Hq,hd)
// holds the step's query tokens flattened across requests (prefill chunks of
// any length and history, and decode rows); token t reads the pages of
// block-table row row[t] and attends causally over kv positions [0, pos[t]].
// Pad tokens (pos = -1) come back exactly 0. T is a multiple of tile_q and
// row is constant over each tile of tile_q tokens (the runner's layout);
// tile_q is the wrapper's one constant, ragged_attention.py::TILE_Q.
// With scale/zero pools the pages are int8 and no dequantized copy of a
// pool is ever written.
//
// A run is a maximal stretch of consecutive tiles with one row. A decode
// run holds one real token (a decode row, or a one-token chunk); its tile
// holding that token is a decode tile. Which tile is which is decided on
// the device, from row and pos; the C entry point launches from shapes
// alone and the wrapper reads no device data (a launch can be captured in
// a CUDA graph). Two bodies:
//
// - tensor cores, for a bf16 q over bf16 or int8 pages with G = Hq / Hkv
//   <= 8 and pages of a power of two >= 4 rows, in three kernels on the
//   stream: the spans (3. below), then the split (1.) as their
//   programmatic dependent launch, which runs beside them (neither reads
//   what the other writes; one split block waits for the spans' end),
//   then the combine (2.), launched early too and waiting on the device.
//   1. decode tiles, split over keys (ragged_split_kernel): block (tile,
//      h, s) takes kv positions [s KPS, (s + 1) KPS) of a decode tile's
//      token and runs the split body on them (decode_split.cuh's
//      attend_split over mma_attention.cuh: cp.async stages, mma.sync,
//      the four warps splitting each stage's keys) for the G rows of kv
//      head h, writing unnormalised partials to a workspace of T / tile_q
//      slots; a block whose tile is no decode tile, or whose split starts
//      past its row's length, exits at once.
//   2. their combine (ragged_combine_kernel): one warp a (slot, q head)
//      adds the partials in split order (decode_split.cuh's combine_row,
//      the arithmetic of the decode kernels' cluster combine); the split
//      records each tile's decode slot and key count for it. A key's
//      split depends on its position alone, so over bf16 pages a decode
//      row's bits are paged_decode_attention's on the same pages and
//      length, though that kernel brings its stages by TMA and combines
//      inside one cluster launch.
//   3. prefill spans (ragged_span_kernel): block (span, h) owns a span of
//      consecutive tiles worth 64 query rows per consumer warpgroup (8 / G
//      tiles a warpgroup; rows past (8 / G) 8 G, at G 3 and 7, are spare
//      and never stored), one or two consumer warpgroups picked from the
//      shape (two unless that grid would leave SMs idle; the entry point
//      reports the rows it launched) and a producer warp. Q's TMA load is
//      issued at once; meanwhile the span's tiles are sorted (decode tiles
//      are skipped but for their pad rows, which are zeroed here), and the
//      block walks its prefill pieces (maximal
//      stretches of non-decode tiles of one row) in turn: for each, the
//      keys [0, the piece's largest pos + 1) of its row in stages of 64.
//      The producer reads a stage's page ids from the table (pages past
//      the piece's keys are never read) before its slot frees up, then
//      brings each page's bs rows of head h by TMA from a 4-D map (hd,
//      Hkv, bs, N) into a two-stage mbarrier ring, swizzled as wgmma reads
//      it (flash_attention.cu's lines); a slot's K is free again once S is
//      computed, its V once O is. Each consumer warpgroup computes S = Q
//      K^T and O += P V on wgmma, the online softmax in f32 registers;
//      rows of other pieces, pad and spare rows, and keys past a row's pos
//      are masked by a select on the stages that reach them, and a row
//      with no key yet keeps m = -inf with a factor of 1. TMA brings whole
//      pages, so the V rows past the piece's keys (the rest of the last
//      page, pages never loaded) are zeroed before the product: 0 * NaN is
//      NaN inside wgmma.
//   int8 pages: the codes come by TMA unswizzled, and each consumer
//   warpgroup widens them (exactly, by byte permutes: mma_attention.cuh's
//   widen_codes) into its own 16-bit tiles in the swizzled layout (K to
//   bf16, V to fp16; keys past the piece's keys 0) with the stage's four
//   f32 scale/zero columns, which the producer warp brings with plain
//   loads; the slot is then free. Scale and zero stay factored out of both
//   products, as in mma_attention.cuh: QK a bf16 wgmma on the raw codes,
//   then ks_j s + kz_j sum_d q_d; PV an fp16 wgmma with A = p_j vs_j, plus
//   sum_j p_j vz_j per row; l sums the f32 p. No dequantized page is
//   written anywhere.
// - CUDA cores (ragged_kernel, paged_attention_common.cuh), for f32 q or
//   pages, fp16 pages under a bf16 q (no one 16-bit mma type takes that
//   pair), and G > 8: one block per (tile, kv head); each page is widened
//   to f32 in shared memory and every score and PV term is an f32 FMA, the
//   int8 pages dequantized in the load. It serves the f32 tests, which
//   hold it to 1e-5.
// The C entry point picks the body by dtype and G, and reports which.
//
// What bounds it: the bytes of K/V it reads, each needed row once per kv
// head (3.35 TB/s). A decode row alone in a block would leave the walk's
// latency to set the time (a fused decode-only step is 32 blocks on 132
// SMs): the split puts up to nb bs / KPS blocks on each row, as paged
// decode does. A prefill chunk of n tokens rereads its history once per
// span of its tiles, from L2 after the first; the spans cut that by the
// tiles a block holds (8 / G or 16 / G), and TMA keeps the gather off the
// consumers' instruction stream. At the serving shapes the products are
// far from the tensor-core rate: what is left is each span's serial walk
// over its stages, the three launches (two grid ends before the last one
// returns, where paged decode has none), and the split's grid of
// T / tile_q x Hkv x n_split blocks, most of which only find that their
// tile is no decode tile (tools/ragged_probe.py times each kernel).

#include <cuda.h>

#include "decode_split.cuh"
#include "hopper.cuh"
#include "mma_attention.cuh"
#include "paged_attention_common.cuh"

namespace {

using namespace pattn;

template <typename QT, typename KT, int HD>
__global__ void __launch_bounds__(THREADS)
ragged_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pages,
              const KT* __restrict__ v_pages, const float* __restrict__ k_scale,
              const float* __restrict__ k_zero, const float* __restrict__ v_scale,
              const float* __restrict__ v_zero, const int* __restrict__ tables,
              const int* __restrict__ row, const int* __restrict__ pos,
              QT* __restrict__ out, int hq, int hkv, int nb, int bs, int tile_q,
              float scale) {
  extern __shared__ float smem[];
  const int it = blockIdx.x;
  const int h = blockIdx.y;
  const int G = hq / hkv;
  const int R = tile_q * G;
  const Smem s = carve(smem, R, bs, HD);
  const int64_t t0 = static_cast<int64_t>(it) * tile_q;

  // query rows r = token * G + g of kv head h: q[t0 + token, h * G + g, :]
  for (int e = threadIdx.x; e < R * HD; e += blockDim.x) {
    const int r = e / HD;
    const int d = e % HD;
    const int64_t t = t0 + r / G;
    s.q[e] = to_f32<QT>(q[(t * hq + h * G + r % G) * HD + d]);
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) s.vlen[r] = pos[t0 + r / G] + 1;
  softmax_init(s, R, HD);
  int max_len = 0;
  for (int i = 0; i < tile_q; ++i) max_len = max(max_len, pos[t0 + i] + 1);
  const int n_pages = min((max_len + bs - 1) / bs, nb);
  const int* trow = tables + static_cast<int64_t>(row[t0]) * nb;
  __syncthreads();

  PageLoader<KT, HD> ld{k_pages, v_pages, k_scale, k_zero, v_scale, v_zero, bs, hkv, h};
  if (n_pages > 0) ld.fetch(trow[0], min(bs, max_len));
  for (int ib = 0; ib < n_pages; ++ib) {
    ld.store(s);
    __syncthreads();
    // the next page's loads fly while this one is scored
    if (ib + 1 < n_pages) ld.fetch(trow[ib + 1], min(bs, max_len - (ib + 1) * bs));
    softmax_page<HD>(s, R, bs, ib * bs, scale);
  }

  for (int e = threadIdx.x; e < R * HD; e += blockDim.x) {
    const int r = e / HD;
    const int d = e % HD;
    const int64_t t = t0 + r / G;
    out[(t * hq + h * G + r % G) * HD + d] = from_f32<QT>(s.acc[e] / fmaxf(s.l[r], 1e-30f));
  }
}

template <typename QT, typename KT, int HD>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const float* k_scale, const float* k_zero, const float* v_scale,
                   const float* v_zero, const int* tables, const int* row, const int* pos,
                   void* out, int T, int hq, int hkv, int nb, int bs, int tile_q,
                   float scale, cudaStream_t stream) {
  static size_t configured = 0;
  const int R = tile_q * (hq / hkv);
  const size_t bytes = smem_floats(R, bs, HD) * sizeof(float);
  auto kernel = ragged_kernel<QT, KT, HD>;
  cudaError_t e = ensure_smem(kernel, bytes, &configured);
  if (e != cudaSuccess) return e;
  const dim3 grid(T / tile_q, hkv);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), k_scale, k_zero, v_scale, v_zero, tables, row,
      pos, static_cast<QT*>(out), hq, hkv, nb, bs, tile_q, scale);
  return cudaGetLastError();
}

template <typename QT, typename KT>
cudaError_t by_hd(int hd, const void* q, const void* kp, const void* vp, const float* ks,
                  const float* kz, const float* vs, const float* vz, const int* tables,
                  const int* row, const int* pos, void* out, int T, int hq, int hkv,
                  int nb, int bs, int tile_q, float scale, cudaStream_t st) {
  switch (hd) {
    case 16:
      return launch<QT, KT, 16>(q, kp, vp, ks, kz, vs, vz, tables, row, pos, out, T, hq,
                                hkv, nb, bs, tile_q, scale, st);
    case 32:
      return launch<QT, KT, 32>(q, kp, vp, ks, kz, vs, vz, tables, row, pos, out, T, hq,
                                hkv, nb, bs, tile_q, scale, st);
    case 64:
      return launch<QT, KT, 64>(q, kp, vp, ks, kz, vs, vz, tables, row, pos, out, T, hq,
                                hkv, nb, bs, tile_q, scale, st);
    case 128:
      return launch<QT, KT, 128>(q, kp, vp, ks, kz, vs, vz, tables, row, pos, out, T, hq,
                                 hkv, nb, bs, tile_q, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename QT>
cudaError_t by_kv(int kv_dtype, int hd, const void* q, const void* kp, const void* vp,
                  const float* ks, const float* kz, const float* vs, const float* vz,
                  const int* tables, const int* row, const int* pos, void* out, int T,
                  int hq, int hkv, int nb, int bs, int tile_q, float scale,
                  cudaStream_t st) {
  switch (kv_dtype) {
    case F32:
      return by_hd<QT, float>(hd, q, kp, vp, ks, kz, vs, vz, tables, row, pos, out, T, hq,
                              hkv, nb, bs, tile_q, scale, st);
    case BF16:
      return by_hd<QT, __nv_bfloat16>(hd, q, kp, vp, ks, kz, vs, vz, tables, row, pos, out,
                                       T, hq, hkv, nb, bs, tile_q, scale, st);
    case F16:
      return by_hd<QT, __half>(hd, q, kp, vp, ks, kz, vs, vz, tables, row, pos, out, T, hq,
                               hkv, nb, bs, tile_q, scale, st);
    case I8:
      return by_hd<QT, int8_t>(hd, q, kp, vp, ks, kz, vs, vz, tables, row, pos, out, T,
                               hq, hkv, nb, bs, tile_q, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// the tensor-core body: runs and decode tiles
// ---------------------------------------------------------------------------

constexpr int TILE = 8;       // tokens a tile: the wrapper's TILE_Q, checked at entry
constexpr int MAX_GROUP = 8;  // the largest GQA group of the tensor-core body
constexpr float LOG2E = 1.4426950408889634f;

// What a span's tile is: a prefill tile (its real tokens walk their keys
// in the span kernel), a decode tile (split kernel, then the span
// kernel's combine), or past T.
enum TileKind { PREFILL = 0, DECODE = 1, PAST = 2 };

// The slot (0 .. TILE - 1) of a decode tile's one real token, else -1: the
// tile's run holds exactly one real token, and this tile holds it. The
// tile's positions and both neighbours' rows come in one round of loads;
// the run is walked further only where a neighbour shares the tile's row.
__device__ __forceinline__ int decode_slot(const int* __restrict__ row,
                                           const int* __restrict__ pos, int n_tiles, int tile) {
  const int64_t t0 = static_cast<int64_t>(tile) * TILE;
  int p[TILE];
#pragma unroll
  for (int i = 0; i < TILE; ++i) p[i] = pos[t0 + i];
  const int r = row[t0];
  const int r_prev = row[tile > 0 ? t0 - TILE : t0];
  const int r_next = row[tile + 1 < n_tiles ? t0 + TILE : t0];
  int j = -1, n = 0;
#pragma unroll
  for (int i = 0; i < TILE; ++i) {
    if (p[i] >= 0) {
      j = i;
      ++n;
    }
  }
  if (n != 1) return -1;
  if (tile > 0 && r_prev == r) {
    for (int u = tile - 1; u >= 0 && row[static_cast<int64_t>(u) * TILE] == r; --u) {
      for (int i = 0; i < TILE; ++i) {
        if (pos[static_cast<int64_t>(u) * TILE + i] >= 0) return -1;
      }
    }
  }
  if (tile + 1 < n_tiles && r_next == r) {
    for (int u = tile + 1; u < n_tiles && row[static_cast<int64_t>(u) * TILE] == r; ++u) {
      for (int i = 0; i < TILE; ++i) {
        if (pos[static_cast<int64_t>(u) * TILE + i] >= 0) return -1;
      }
    }
  }
  return j;
}

// ---------------------------------------------------------------------------
// decode tiles, split over keys
// ---------------------------------------------------------------------------

// Split (tile, h, s) of a decode tile: the G query rows of its token t and
// kv head h; key kpos is position k0 + kpos of table row trow. Partials
// go to workspace slot `tile` (SplitRows::part with b = tile).
struct RaggedSplitMap : dsplit::SplitRows {
  const int* trow;
  int64_t t;
  int k0, bs, hkv;
  __device__ __forceinline__ bool query(int r, int64_t& off, int& vl) const {
    off = (t * hq + h * G + r) * hd;
    vl = vlen;
    return true;
  }
  __device__ __forceinline__ int64_t key(int kpos) const {
    const int p = k0 + kpos;
    return (static_cast<int64_t>(trow[p / bs]) * bs + p % bs) * hkv + h;
  }
};

template <typename KT, bool Q8, int HD>
__global__ void __launch_bounds__(mma_attn::THREADS)
ragged_split_kernel(dsplit::Workspace ws, int* __restrict__ slots,
                    const __nv_bfloat16* __restrict__ q,
                    const KT* __restrict__ k_pages, const KT* __restrict__ v_pages,
                    const float* __restrict__ k_scale, const float* __restrict__ k_zero,
                    const float* __restrict__ v_scale, const float* __restrict__ v_zero,
                    const int* __restrict__ tables, const int* __restrict__ row,
                    const int* __restrict__ pos, int n_tiles, int hq, int hkv, int nb, int bs,
                    int n_split, float scale) {
  extern __shared__ __align__(128) char smem_mma[];
  // the combine, launched after this grid, may start at once (it waits)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tile = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int j = decode_slot(row, pos, n_tiles, tile);
  const int64_t t = static_cast<int64_t>(tile) * TILE + max(j, 0);
  const int n_keys = j < 0 ? 0 : min(pos[t] + 1, nb * bs);
  if (h == 0 && s == 0 && threadIdx.x == 0) {  // for the combine
    slots[2 * tile] = j;
    slots[2 * tile + 1] = n_keys;
  }
  const int k0 = s * dsplit::KPS;
  const int len = min(n_keys - k0, dsplit::KPS);
  // no decode tile (the span kernel walks it), or past the row's end: no
  // partial here
  if (len > 0) {
    const int G = hq / hkv;
    const RaggedSplitMap mp{{ws.o, ws.m, ws.l, tile, h, s, hq, G, HD, n_split, len},
                            tables + static_cast<int64_t>(row[t]) * nb,
                            t,
                            k0,
                            bs,
                            hkv};
    const float* sc[4] = {k_scale, k_zero, v_scale, v_zero};
    dsplit::attend_split<__nv_bfloat16, KT, Q8, HD>(mp, q, k_pages, v_pages, sc, G, len, scale,
                                                    smem_mma);
  }
  // this grid runs beside the spans' (it is their programmatic dependent):
  // neither reads what the other writes, and one block waits for their
  // grid's end before it ends, so the combine after this grid finds both
  // done
  if (blockIdx.x + blockIdx.y + blockIdx.z == 0 && threadIdx.x == 0) {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
  }
}

// The decode tiles' rows from the split's partials: one warp a (workspace
// slot, q head), with the decode kernels' combine arithmetic
// (decode_split.cuh's combine_row, in split order); a warp whose tile is
// no decode tile (slots: the split's decode_slot and key count a tile)
// returns at once.
// The span kernel zeroes the decode tiles' pad rows.
template <int HD>
__global__ void __launch_bounds__(32 * dsplit::COMBINE_WARPS)
ragged_combine_kernel(dsplit::Workspace ws, const int* __restrict__ slots,
                      __nv_bfloat16* __restrict__ out, int n_tiles, int hq, int n_split) {
  // launched early, as the programmatic dependent of the kernel before
  // it: the split and the spans are done past this wait
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int rid = blockIdx.x * dsplit::COMBINE_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (rid >= n_tiles * hq) return;
  const int tile = rid / hq, head = rid % hq;
  const int j = slots[2 * tile];
  if (j < 0) return;
  const int64_t t = static_cast<int64_t>(tile) * TILE + j;
  dsplit::combine_row<__nv_bfloat16, HD>(ws.o, ws.m, ws.l, static_cast<int64_t>(rid) * n_split,
                                         dsplit::n_splits(slots[2 * tile + 1]),
                                         out + (t * hq + head) * HD, lane);
}

// ---------------------------------------------------------------------------
// prefill spans: wgmma, K/V pages by TMA
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int round_1k(int x) { return (x + 1023) / 1024 * 1024; }

// The shapes of the span kernel with CWG consumer warpgroups at head dim
// HD over pages of KT. Shared memory: Q (CB column blocks of ROWS lines),
// the ring (a stage: K and V tiles of CB blocks of KEYS lines, or int8:
// the K and V codes and the stage's scale/zero columns), int8's widened
// K and V tiles and scale/zero columns of each consumer warpgroup, the
// span's tile table, the mbarriers.
template <typename KT, int HD, int CWG>
struct Span {
  static constexpr bool Q8 = sizeof(KT) == 1;
  static constexpr int ROWS = 64 * CWG;
  static constexpr int KEYS = 64;  // keys a stage
  static constexpr int STAGES = 2;
  static constexpr int COLS = HD < 64 ? HD : 64;  // elements a swizzle line
  static constexpr int LINE = COLS * 2;           // its bytes
  static constexpr int CB = HD / COLS;            // column blocks a row
  static constexpr int THREADS = CWG * 128 + 32;  // consumers, then the producer warp
  static constexpr int MAX_TILES = ROWS / TILE;   // tiles a span at G 1
  static constexpr int Q_BYTES = CB * ROWS * LINE;
  static constexpr int TILE16 = CB * KEYS * LINE;  // one 16-bit K or V tile
  // int8 codes of one K or V stage: each page's box starts on 128 bytes,
  // and a page holds at least 4 rows
  static constexpr int RAW = KEYS * HD > 128 * (KEYS / 4) ? KEYS * HD : 128 * (KEYS / 4);
  static constexpr int SCALES = 4 * KEYS * 4;
  static constexpr int STAGE = round_1k(Q8 ? 2 * RAW + SCALES : 2 * TILE16);
  static constexpr int RING = Q_BYTES;
  static constexpr int WIDE = RING + STAGES * STAGE;
  static constexpr int WIDE_WG = 2 * TILE16 + SCALES;  // int8: a warpgroup's own copy
  static constexpr int META = WIDE + (Q8 ? CWG * WIDE_WG : 0);
  static constexpr int BARS = META + MAX_TILES * 4 * 4;
  static constexpr size_t SMEM = BARS + (4 * STAGES + 1) * 8 + 1024;  // + alignment
  static_assert(KEYS / 4 * CB <= 32, "a stage's boxes: one a producer lane");
};

// A piece: tiles [lo, hi) of a span, consecutive prefill tiles of one table
// row, whose keys [0, len) the block walks in turn; lo == span past the
// last. meta holds (row, len, kind, slot) a tile.
struct Piece {
  int lo, hi, row, len;
};

__device__ __forceinline__ Piece piece_from(const int* meta, int span, int from) {
  Piece p{span, span, -1, 0};
  int i = from;
  while (i < span && meta[4 * i + 2] != PREFILL) ++i;
  if (i == span) return p;
  p.lo = i;
  p.row = meta[4 * i];
  while (i < span && meta[4 * i + 2] == PREFILL && meta[4 * i] == p.row) {
    p.len = max(p.len, meta[4 * i + 1]);
    ++i;
  }
  p.hi = i;
  return p;
}

// 16 int8 codes -> 16 values of T (32 bytes) at byte off of a swizzled
// tile of LINE-byte lines: two 16-byte chunks, each at its swizzled place
// (mma_attn::widen_codes: exact, without int-to-float conversions).
template <typename T, int LINE>
__device__ __forceinline__ void store_widened(char* tile, int off, const uint4 raw) {
  uint32_t o[8];
  mma_attn::widen_codes<T>(o, raw);
  *reinterpret_cast<uint4*>(tile + hopper::swz<LINE>(off)) = make_uint4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<uint4*>(tile + hopper::swz<LINE>(off + 16)) =
      make_uint4(o[4], o[5], o[6], o[7]);
}

// int8: one stage's codes (page boxes pstride apart, bsb rows of HD bytes
// each) widened into a warpgroup's K (bf16) and V (fp16) tiles, keys at or
// past nk 0, and its scale/zero columns copied after them: the stage's
// slot is then free.
template <typename S>
__device__ __forceinline__ void widen_stage(const char* raw, char* wide, int nk, int bsb,
                                            int pstride, int tid) {
  constexpr int HD = S::CB * S::COLS;
  constexpr int CPR = HD / 16;  // 16-code chunks a row
  for (int e = tid; e < 4 * S::KEYS; e += 128) {
    reinterpret_cast<float*>(wide + 2 * S::TILE16)[e] =
        reinterpret_cast<const float*>(raw + 2 * S::RAW)[e];
  }
  for (int e = tid; e < S::KEYS * CPR; e += 128) {
    const int j = e / CPR, c = e % CPR;
    uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = kr;
    if (j < nk) {
      const int src = (j / bsb) * pstride + (j % bsb) * HD + c * 16;
      kr = *reinterpret_cast<const uint4*>(raw + src);
      vr = *reinterpret_cast<const uint4*>(raw + S::RAW + src);
    }
    const int col = c * 16;
    const int off = (col / S::COLS) * S::KEYS * S::LINE + j * S::LINE + (col % S::COLS) * 2;
    store_widened<__nv_bfloat16, S::LINE>(wide, off, kr);
    store_widened<__half, S::LINE>(wide + S::TILE16, off, vr);
  }
}

// One block: span blockIdx.x of CWG (8 / G) tiles, kv head blockIdx.y.
// Warps 0 .. 4 CWG - 1 are the consumers, the last the producer.
template <typename KT, int HD, int CWG>
__global__ void __launch_bounds__(Span<KT, HD, CWG>::THREADS, CWG == 1 ? 2 : 1)
ragged_span_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ k_zero, const float* __restrict__ v_scale,
                   const float* __restrict__ v_zero, const int* __restrict__ tables,
                   const int* __restrict__ row, const int* __restrict__ pos, int n_tiles, int hq,
                   int hkv, int nb, int bs, int n_split, float scale2) {
  using S = Span<KT, HD, CWG>;
  using PVT = typename std::conditional<S::Q8, __half, __nv_bfloat16>::type;
  // the split kernel, launched after this grid, may start at once
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  constexpr int KEYS = S::KEYS, LINE = S::LINE, COLS = S::COLS, CB = S::CB;
  constexpr uint32_t SWZ = hopper::swizzle_code<LINE>();
  extern __shared__ char smem_raw[];
  char* smem = smem_raw + ((1024 - (hopper::saddr(smem_raw) & 1023)) & 1023);
  const int G = hq / hkv;
  const int tpw = MAX_GROUP / G;  // tiles a warpgroup: 64 rows / (TILE G)
  const int span = CWG * tpw;
  const int h = blockIdx.y;
  const int tile0 = blockIdx.x * span;
  const int cap = nb * bs;
  const int bsb = min(bs, KEYS);  // rows of a page's box
  int* meta = reinterpret_cast<int*>(smem + S::META);
  // a stage's K and V: loaded (full) and free again (empty) apart, so the
  // next K load starts once S is done; int8's codes and scales all go on
  // full_k and empty_k, free once widened
  uint64_t* full_k = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full_v = full_k + S::STAGES;
  uint64_t* empty_k = full_v + S::STAGES;
  uint64_t* empty_v = empty_k + S::STAGES;
  uint64_t* qbar = empty_v + S::STAGES;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S::STAGES; ++s) {
      // int8: the producer's expect_tx, then each producer lane's arrival
      // once its scale/zero loads are in shared memory
      hopper::mbar_init(full_k + s, S::Q8 ? 33 : 1);
      hopper::mbar_init(full_v + s, 1);
      hopper::mbar_init(empty_k + s, CWG);
      hopper::mbar_init(empty_v + s, CWG);
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_init_fence();
    // Q's loads fly while the span's tiles are sorted out below
    hopper::mbar_expect_tx(qbar, CWG * tpw * TILE * G * HD * 2);
#pragma unroll
    for (int w = 0; w < CWG; ++w) {
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
        hopper::tma_load_4d(smem + cb * S::ROWS * LINE + w * 64 * LINE, &qmap, qbar, cb * COLS,
                            h * G, (tile0 + w * tpw) * TILE, 0);
      }
    }
  }
  if (threadIdx.x < span) {
    const int tile = tile0 + threadIdx.x;
    int r = -1, len = 0, kind = PAST, slot = -1;
    if (tile < n_tiles) {
      const int64_t t0 = static_cast<int64_t>(tile) * TILE;
      r = row[t0];
      slot = n_split > 0 ? decode_slot(row, pos, n_tiles, tile) : -1;
      kind = slot >= 0 ? DECODE : PREFILL;
      for (int i = 0; i < TILE; ++i) len = max(len, pos[t0 + i] + 1);
      len = min(len, cap);
    }
    int* mt = meta + 4 * threadIdx.x;
    mt[0] = r;
    mt[1] = len;
    mt[2] = kind;
    mt[3] = slot;
  }
  __syncthreads();
  int total = 0;  // stages over the span's pieces
  for (Piece p = piece_from(meta, span, 0); p.lo < span; p = piece_from(meta, span, p.hi)) {
    total += (p.len + KEYS - 1) / KEYS;
  }
  char* ring = smem + S::RING;

  if (threadIdx.x / 128 == CWG) {
    // the producer warp: lane 0 arms the barriers, every lane issues loads
    if (total == 0) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      hopper::tma_prefetch(&kmap);
      hopper::tma_prefetch(&vmap);
    }
    const int pstride = (bsb * HD + 127) / 128 * 128;  // int8: a page's box
    int i = 0;
    for (Piece p = piece_from(meta, span, 0); p.lo < span; p = piece_from(meta, span, p.hi)) {
      const int* trow = tables + static_cast<int64_t>(p.row) * nb;
      for (int kpos0 = 0; kpos0 < p.len; kpos0 += KEYS, ++i) {
        const int s = i % S::STAGES;
        const int nk = min(KEYS, p.len - kpos0);
        const int npg = (nk + bsb - 1) / bsb;  // boxes: never a page past the keys
        // what the stage's loads need from device memory (its page ids;
        // int8: its scale/zero columns), read before the slot frees up:
        // at most KEYS / 4 pages of CB boxes, one box of K and V a lane
        const int box = S::Q8 ? lane : lane / CB;  // the lane's page of the stage
        const int key0 = kpos0 + box * bsb;
        const int page = box < npg ? trow[key0 / bs] : 0;
        float sv[2][4];
        if constexpr (S::Q8) {
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int j = lane + 32 * u, kp = kpos0 + j;
            const bool ok = j < nk;
            const int64_t x =
                ok ? (static_cast<int64_t>(trow[kp / bs]) * bs + kp % bs) * hkv + h : 0;
            sv[u][0] = ok ? k_scale[x] : 0.f;
            sv[u][1] = ok ? k_zero[x] : 0.f;
            sv[u][2] = ok ? v_scale[x] : 0.f;
            sv[u][3] = ok ? v_zero[x] : 0.f;
          }
        }
        const uint32_t freed = ((i / S::STAGES) & 1) ^ 1;
        if (i >= S::STAGES) hopper::mbar_wait(empty_k + s, freed);
        char* st = ring + s * S::STAGE;
        if constexpr (S::Q8) {
          if (lane == 0) hopper::mbar_expect_tx(full_k + s, 2 * npg * bsb * HD);
          __syncwarp();
          if (box < npg) {
            hopper::tma_load_4d(st + box * pstride, &kmap, full_k + s, 0, h, key0 % bs, page);
            hopper::tma_load_4d(st + S::RAW + box * pstride, &vmap, full_k + s, 0, h, key0 % bs,
                                page);
          }
          float* sc = reinterpret_cast<float*>(st + 2 * S::RAW);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
#pragma unroll
            for (int c = 0; c < 4; ++c) sc[c * KEYS + lane + 32 * u] = sv[u][c];
          }
          hopper::mbar_arrive(full_k + s);
        } else {
          const int cb = lane % CB;
          const int off = cb * KEYS * LINE + box * bsb * LINE;
          if (lane == 0) hopper::mbar_expect_tx(full_k + s, npg * bsb * HD * 2);
          __syncwarp();
          if (box < npg) {
            hopper::tma_load_4d(st + off, &kmap, full_k + s, cb * COLS, h, key0 % bs, page);
          }
          if (i >= S::STAGES) hopper::mbar_wait(empty_v + s, freed);
          if (lane == 0) hopper::mbar_expect_tx(full_v + s, npg * bsb * HD * 2);
          __syncwarp();
          if (box < npg) {
            hopper::tma_load_4d(st + S::TILE16 + off, &vmap, full_v + s, cb * COLS, h, key0 % bs,
                                page);
          }
        }
      }
    }
    return;
  }

  // the consumers
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, t2 = (lane & 3) * 2;

  // the span's decode tiles: their pad rows of this kv head's G q heads
  // are 0 (the combine writes the real token's)
  for (int e = threadIdx.x; e < span * TILE * G * (HD / 8); e += CWG * 128) {
    const int i = e / (TILE * G * (HD / 8)), x = e % (TILE * G * (HD / 8));
    const int* mt = meta + 4 * i;
    const int tok = x / (G * (HD / 8));
    if (mt[2] != DECODE || tok == mt[3]) continue;
    const int64_t t = static_cast<int64_t>(tile0 + i) * TILE + tok;
    *reinterpret_cast<uint4*>(out + (t * hq + h * G + x / (HD / 8) % G) * HD + x % (HD / 8) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }

  // this thread's rows: rl and rl + 8 of its warpgroup's 64; their span
  // tile (-1: spare), limit (keys kpos < lim_row; 0 for pads) and place
  const int rmax = tpw * TILE * G;
  int my_tile[2], lim_row[2];
  int64_t ooff[2];
  bool store[2];
  float qsum[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int rl = warp * 16 + lane / 4 + 8 * rr;
    const int ti = wg * tpw + rl / (TILE * G);
    my_tile[rr] = -1;
    lim_row[rr] = 0;
    ooff[rr] = 0;
    store[rr] = rl < rmax && meta[4 * ti + 2] == PREFILL;
    if (store[rr]) {
      const int64_t t = static_cast<int64_t>(tile0 + ti) * TILE + (rl % (TILE * G)) / G;
      my_tile[rr] = ti;
      lim_row[rr] = min(max(pos[t] + 1, 0), cap);
      ooff[rr] = (t * hq + h * G + rl % G) * HD;
    }
    if constexpr (S::Q8) {
      // int8: sum_d q_d of the row, a quarter of it a lane
      if (lim_row[rr] > 0) {
        for (int d = t2; d < HD; d += 8) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(q + ooff[rr] + d));
          qsum[rr] += f.x + f.y;
        }
      }
      qsum[rr] = mma_attn::quad_sum(qsum[rr]);
    }
  }

  float o[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) o[x] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, z[2] = {0.f, 0.f};
  hopper::mbar_wait(qbar, 0);  // (so no load is in flight when the block ends)
  const uint32_t q_addr = hopper::saddr(smem) + wg * 64 * LINE;
  char* wide = smem + S::WIDE + wg * S::WIDE_WG;
  const int pstride = (bsb * HD + 127) / 128 * 128;
  int i = 0;
  for (Piece p = piece_from(meta, span, 0); p.lo < span; p = piece_from(meta, span, p.hi)) {
    int lim[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      lim[rr] = my_tile[rr] >= p.lo && my_tile[rr] < p.hi ? lim_row[rr] : 0;
    }
    // the warp's least limit: stages below it need no mask
    const int wlo = __reduce_min_sync(0xffffffffu, min(lim[0], lim[1]));
    // a piece with none of the warpgroup's tiles: its stages are only
    // waited for and handed back, so the ring's phases stay in step
    const bool active = wg * tpw < p.hi && (wg + 1) * tpw > p.lo;
    for (int kpos0 = 0; kpos0 < p.len; kpos0 += KEYS, ++i) {
      const int s = i % S::STAGES;
      const uint32_t par = (i / S::STAGES) & 1;
      hopper::mbar_wait(full_k + s, par);
      if (!active) {
        if constexpr (!S::Q8) hopper::mbar_wait(full_v + s, par);
        if (tid == 0) {
          hopper::mbar_arrive(empty_k + s);
          if constexpr (!S::Q8) hopper::mbar_arrive(empty_v + s);
        }
        continue;
      }
      const int nk = min(KEYS, p.len - kpos0);
      char* st = ring + s * S::STAGE;
      uint32_t k_addr, v_addr;
      const float* scs = nullptr;
      if constexpr (S::Q8) {
        widen_stage<S>(st, wide, nk, bsb, pstride, tid);
        hopper::fence_proxy_async();
        hopper::named_sync(1 + wg, 128);
        if (tid == 0) hopper::mbar_arrive(empty_k + s);  // the codes are widened
        k_addr = hopper::saddr(wide);
        v_addr = k_addr + S::TILE16;
        scs = reinterpret_cast<const float*>(wide + 2 * S::TILE16);
      } else {
        k_addr = hopper::saddr(st);
        v_addr = k_addr + S::TILE16;
      }

      // S = Q K^T
      float sc[KEYS / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t cb = kk * 16 / COLS, in = (kk * 16 % COLS) * 2;
        hopper::Wgmma<__nv_bfloat16, KEYS>::ss(
            sc, hopper::make_desc(q_addr + cb * S::ROWS * LINE + in, 16, 8 * LINE, SWZ),
            hopper::make_desc(k_addr + cb * KEYS * LINE + in, 16, 8 * LINE, SWZ), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      if (!S::Q8 && tid == 0) hopper::mbar_arrive(empty_k + s);  // K is read

      // raw scores (int8: ks_j s + kz_j sum q), keys past a row's limit
      // (and every key of a row outside the piece) masked by a select on
      // the stages that reach past one of the warp's limits
      if constexpr (S::Q8) {
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j * 8 + t2 + (e & 1);
            sc[j * 4 + e] = fmaf(scs[key], sc[j * 4 + e], scs[KEYS + key] * qsum[e >> 1]);
          }
        }
      }
      if (kpos0 + KEYS > wlo) {
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (kpos0 + j * 8 + t2 + (e & 1) >= lim[e >> 1]) sc[j * 4 + e] = -INFINITY;
          }
        }
      }

      // the online softmax in base 2 (m: the raw scores' row max); a row
      // with no key yet keeps m = -inf, its factor 1 and its p 0
      float corr[2], ms[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = m[rr];
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j) {
          mx = fmaxf(mx, fmaxf(sc[j * 4 + 2 * rr], sc[j * 4 + 2 * rr + 1]));
        }
        mx = mma_attn::quad_max(mx);
        const bool none = mx == -INFINITY;
        corr[rr] = none ? 1.f : hopper::ex2((m[rr] - mx) * scale2);
        m[rr] = mx;
        ms[rr] = none ? 0.f : mx * scale2;
      }
      // P in the PV operand type (int8: p_j vs_j in fp16, l and the zero
      // term from the f32 p; else p in bf16, l from the rounded p); pa[kk]
      // is the A fragment of keys 16 kk .. 16 kk + 15
      uint32_t pa[KEYS / 16][4];
      float ls[2] = {0.f, 0.f}, zs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j) {
        const int key = j * 8 + t2;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float p0 = hopper::ex2(fmaf(sc[j * 4 + 2 * rr], scale2, -ms[rr]));
          const float p1 = hopper::ex2(fmaf(sc[j * 4 + 2 * rr + 1], scale2, -ms[rr]));
          if constexpr (S::Q8) {
            pa[j / 2][(j % 2) * 2 + rr] =
                mma_attn::pack<__half>(p0 * scs[2 * KEYS + key], p1 * scs[2 * KEYS + key + 1]);
            ls[rr] += p0 + p1;
            zs[rr] += p0 * scs[3 * KEYS + key] + p1 * scs[3 * KEYS + key + 1];
          } else {
            float q0, q1;
            pa[j / 2][(j % 2) * 2 + rr] = mma_attn::pack<__nv_bfloat16>(p0, p1, q0, q1);
            ls[rr] += q0 + q1;
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        l[rr] = l[rr] * corr[rr] + ls[rr];
        z[rr] = z[rr] * corr[rr] + zs[rr];
      }
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[j * 4] *= corr[0];
        o[j * 4 + 1] *= corr[0];
        o[j * 4 + 2] *= corr[1];
        o[j * 4 + 3] *= corr[1];
      }

      // O += P V
      if constexpr (!S::Q8) {
        hopper::mbar_wait(full_v + s, par);
        // V rows past the piece's keys (the rest of the last page, pages
        // never loaded) may hold anything: 0 * NaN is NaN in the product
        if (nk < KEYS) {
          constexpr int CPR = LINE / 16;
          char* vt = st + S::TILE16;
          for (int e = tid; e < (KEYS - nk) * CB * CPR; e += 128) {
            const int j = nk + e / (CB * CPR), c = e % (CB * CPR);
            *reinterpret_cast<uint4*>(vt + (c / CPR) * KEYS * LINE + j * LINE + (c % CPR) * 16) =
                make_uint4(0u, 0u, 0u, 0u);
          }
          hopper::fence_proxy_async();
          hopper::named_sync(1 + wg, 128);
        }
      }
      hopper::fence_regs(o);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk) {
        hopper::Wgmma<PVT, HD>::rs(
            o, pa[kk], hopper::make_desc(v_addr + kk * 16 * LINE, KEYS * LINE, 8 * LINE, SWZ), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::fence_regs(pa);
      // int8: every warp is done with the widened tiles before the next
      // stage's widening
      if constexpr (S::Q8) {
        hopper::named_sync(1 + wg, 128);
      } else if (tid == 0) {
        hopper::mbar_arrive(empty_v + s);  // V is read
      }
    }
  }

  float lt[2], zt[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    lt[rr] = fmaxf(mma_attn::quad_sum(l[rr]), 1e-30f);
    zt[rr] = S::Q8 ? mma_attn::quad_sum(z[rr]) : 0.f;
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (!store[rr]) continue;
    __nv_bfloat16* orow = out + ooff[rr];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + j * 8 + t2) = mma_attn::pack<__nv_bfloat16>(
          (o[j * 4 + 2 * rr] + zt[rr]) / lt[rr], (o[j * 4 + 2 * rr + 1] + zt[rr]) / lt[rr]);
    }
  }
}

// ---------------------------------------------------------------------------
// tensor maps and launches
// ---------------------------------------------------------------------------

inline CUtensorMapSwizzle map_swizzle(int line) {
  return line == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                     : line == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
}

// The pool (N, bs, Hkv, HD) of KT as dims (HD, Hkv, bs, N), a box one
// page's bsb rows of one head: 16-bit pages a swizzle line wide (flash's
// lines), int8 codes a whole row wide and unswizzled.
template <typename KT, int HD>
bool make_page_map(CUtensorMap* map, const void* pages, int n_pages, int bs, int hkv, int bsb) {
  constexpr bool Q8 = sizeof(KT) == 1;
  constexpr int COLS = HD < 64 ? HD : 64;
  const hopper::EncodeTiled enc = hopper::encoder();
  if (enc == nullptr) return false;
  const cuuint64_t e = sizeof(KT);
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(hkv), static_cast<cuuint64_t>(bs),
                              static_cast<cuuint64_t>(n_pages)};
  const cuuint64_t strides[3] = {HD * e, hkv * HD * e, static_cast<cuuint64_t>(bs) * hkv * HD * e};
  const cuuint32_t box[4] = {Q8 ? HD : COLS, 1, static_cast<cuuint32_t>(bsb), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, Q8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(pages), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             Q8 ? CU_TENSOR_MAP_SWIZZLE_NONE : map_swizzle(COLS * 2),
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// q (T, Hq, HD) bf16 as dims (HD, Hq, T, 1), a box one line of G heads of
// a warpgroup's P tokens (swizzled)
template <int HD>
bool make_q_map(CUtensorMap* map, const void* q, int T, int hq, int G, int P) {
  constexpr int COLS = HD < 64 ? HD : 64;
  const hopper::EncodeTiled enc = hopper::encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(hq), static_cast<cuuint64_t>(T), 1};
  const cuuint64_t strides[3] = {HD * 2ull, static_cast<cuuint64_t>(hq) * HD * 2,
                                 static_cast<cuuint64_t>(T) * hq * HD * 2};
  const cuuint32_t box[4] = {COLS, static_cast<cuuint32_t>(G), static_cast<cuuint32_t>(P), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(q), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, map_swizzle(COLS * 2),
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tensor-core path's operands.
struct TcArgs {
  const void *q, *kp, *vp;
  const float *ks, *kz, *vs, *vz;
  const int *tables, *row, *pos;
  void* out;
  void* ws;
  int T, hq, hkv, nb, bs, n_pages, n_split;
  float scale;
  cudaStream_t st;
};

// The split, as the spans' programmatic dependent: it starts while they
// run.
template <typename KT, int HD>
cudaError_t launch_split(const TcArgs& a, const dsplit::Workspace& ws, int* slots) {
  constexpr bool Q8 = sizeof(KT) == 1;
  static size_t configured = 0;
  const size_t bytes = mma_attn::Layout<HD>::bytes(Q8);
  auto kernel = ragged_split_kernel<KT, Q8, HD>;
  const cudaError_t e = ensure_smem(kernel, bytes, &configured);
  if (e != cudaSuccess) return e;
  return hopper::launch_ex(kernel, dim3(a.T / TILE, a.hkv, a.n_split), mma_attn::THREADS, bytes,
                           a.st, true, 0, ws, slots, static_cast<const __nv_bfloat16*>(a.q),
                           static_cast<const KT*>(a.kp), static_cast<const KT*>(a.vp), a.ks,
                           a.kz, a.vs, a.vz, a.tables, a.row, a.pos, a.T / TILE, a.hq, a.hkv,
                           a.nb, a.bs, a.n_split, a.scale);
}

template <typename KT, int HD, int CWG>
cudaError_t launch_span(const TcArgs& a) {
  using S = Span<KT, HD, CWG>;
  static size_t configured = 0;
  auto kernel = ragged_span_kernel<KT, HD, CWG>;
  cudaError_t e = ensure_smem(kernel, S::SMEM, &configured);
  if (e != cudaSuccess) return e;
  const int G = a.hq / a.hkv, tpw = MAX_GROUP / G, bsb = min(a.bs, S::KEYS);
  CUtensorMap qm, km, vm;
  if (!make_q_map<HD>(&qm, a.q, a.T, a.hq, G, tpw * TILE) ||
      !make_page_map<KT, HD>(&km, a.kp, a.n_pages, a.bs, a.hkv, bsb) ||
      !make_page_map<KT, HD>(&vm, a.vp, a.n_pages, a.bs, a.hkv, bsb)) {
    return cudaErrorInvalidValue;
  }
  const int n_tiles = a.T / TILE;
  return hopper::launch_ex(kernel, dim3((n_tiles + CWG * tpw - 1) / (CWG * tpw), a.hkv),
                           S::THREADS, S::SMEM, a.st, false, 0, qm, km, vm,
                           static_cast<const __nv_bfloat16*>(a.q),
                           static_cast<__nv_bfloat16*>(a.out), a.ks, a.kz, a.vs, a.vz, a.tables,
                           a.row, a.pos, n_tiles, a.hq, a.hkv, a.nb, a.bs, a.n_split,
                           a.scale * LOG2E);
}

// The spans of `rows` rows, then (when the workspace is given) the split
// and its combine, each launched as the programmatic dependent of the
// kernel before it.
template <typename KT, int HD>
cudaError_t launch_tc(int rows, const TcArgs& a) {
  cudaError_t e = rows == 128 ? launch_span<KT, HD, 2>(a) : launch_span<KT, HD, 1>(a);
  if (e != cudaSuccess || a.n_split == 0) return e;
  const int n_tiles = a.T / TILE;
  const dsplit::Workspace ws = dsplit::carve(a.ws, n_tiles, a.hq, a.n_split, HD);
  int* slots = reinterpret_cast<int*>(ws.l + static_cast<size_t>(n_tiles) * a.hq * a.n_split);
  e = launch_split<KT, HD>(a, ws, slots);
  if (e != cudaSuccess) return e;
  const int n_rows = n_tiles * a.hq;
  return hopper::launch_ex(ragged_combine_kernel<HD>,
                           dim3((n_rows + dsplit::COMBINE_WARPS - 1) / dsplit::COMBINE_WARPS),
                           32 * dsplit::COMBINE_WARPS, 0, a.st, true, 0, ws,
                           static_cast<const int*>(slots), static_cast<__nv_bfloat16*>(a.out),
                           n_tiles, a.hq, a.n_split);
}

template <typename KT>
cudaError_t tc_by_hd(int hd, int rows, const TcArgs& a) {
  switch (hd) {
    case 16:
      return launch_tc<KT, 16>(rows, a);
    case 32:
      return launch_tc<KT, 32>(rows, a);
    case 64:
      return launch_tc<KT, 64>(rows, a);
    case 128:
      return launch_tc<KT, 128>(rows, a);
    default:
      return cudaErrorInvalidValue;
  }
}

// The span kernel's rows a block: 128 (two consumer warpgroups) unless that
// grid has fewer blocks than the card has SMs, then 64.
int span_rows(int n_tiles, int G, int hkv) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int span2 = 2 * (MAX_GROUP / G);
  const long long blocks = static_cast<long long>((n_tiles + span2 - 1) / span2) * hkv;
  return blocks >= sms ? 128 : 64;
}

}  // namespace

// C entry point bound with ctypes (kernels/ragged_attention.py). The scale/
// zero pointers are null for float pages and all four set for int8 pages.
// ws: the tensor-core body's f32 workspace of (T / tile_q) x Hq x n_split x
// (hd + 2) floats, then 2 T / tile_q ints (each tile's decode slot and key
// count, for the combine), n_split = ceil(nb bs / KPS) (decode_split.cuh), or
// n_split = 0 and no workspace: then no split runs and the spans walk the
// decode runs too; the CUDA-core body leaves it alone. *body is set to the
// body launched: 1 the tensor cores, 0 the CUDA cores; *tile to the span
// kernel's rows a block (64 or 128), 0 for the CUDA-core body or when
// nothing is launched. Returns the launches' cudaGetLastError() (0 =
// launched).
extern "C" int ragged_paged_attention(const void* q, const void* k_pages,
                                      const void* v_pages, const void* k_scale,
                                      const void* k_zero, const void* v_scale,
                                      const void* v_zero, const void* tables,
                                      const void* row, const void* pos, void* out, void* ws,
                                      int T, int hq, int hkv, int hd, int nb, int bs,
                                      int n_pages, int tile_q, int n_split, float scale,
                                      int q_dtype, int kv_dtype, void* stream, int* body,
                                      int* tile) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* kz = static_cast<const float*>(k_zero);
  const float* vs = static_cast<const float*>(v_scale);
  const float* vz = static_cast<const float*>(v_zero);
  const int* tb = static_cast<const int*>(tables);
  const int* rw = static_cast<const int*>(row);
  const int* ps = static_cast<const int*>(pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool tc = q_dtype == BF16 && (kv_dtype == BF16 || kv_dtype == I8) &&
                  hq / hkv <= MAX_GROUP;
  *body = tc ? 1 : 0;
  *tile = 0;
  if (T == 0) return 0;
  if (tc) {
    // pages of a power of two >= 4 rows: a stage is whole boxes, each on
    // 128 bytes
    if (tile_q != TILE || bs < 4 || (bs & (bs - 1)) != 0) return cudaErrorInvalidValue;
    if (n_split != 0 && n_split != dsplit::n_splits(nb * bs)) return cudaErrorInvalidValue;
    *tile = span_rows(T / TILE, hq / hkv, hkv);
    const TcArgs a{q,  k_pages, v_pages, ks, kz, vs, vz, tb,      rw,      ps,   out,
                   ws, T,       hq,      hkv, nb, bs, n_pages, n_split, scale, st};
    return kv_dtype == I8 ? tc_by_hd<int8_t>(hd, *tile, a) : tc_by_hd<__nv_bfloat16>(hd, *tile, a);
  }
  switch (q_dtype) {
    case F32:
      return by_kv<float>(kv_dtype, hd, q, k_pages, v_pages, ks, kz, vs, vz, tb, rw, ps,
                          out, T, hq, hkv, nb, bs, tile_q, scale, st);
    case BF16:
      return by_kv<__nv_bfloat16>(kv_dtype, hd, q, k_pages, v_pages, ks, kz, vs, vz, tb,
                                  rw, ps, out, T, hq, hkv, nb, bs, tile_q, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}
