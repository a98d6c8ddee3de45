// Split-KV decode attention for Hopper (sm_90a): the counterpart of the
// Pallas _decode_kernel (ffpa_attn_tpu/ops/decode.py). ops/decode.py calls the
// C entry point ffpa_decode_fwd through ctypes.
//
// Bound on an H100: bytes. A step reads the whole K and V cache once (34.6 MB
// a layer at B1 Hkv4 Nkv4224 D512, 10.3 us at 3.35 TB/s) and does 2 multiply-
// adds per K element per packed row. The TPU kernel is one pass over the KV
// axis per KV head, because a TPU v5e has one TensorCore; at B=1 and Hkv=4
// that grid would fill 4 of an H100's 132 SMs, so the KV range is split:
//   launch 1, grid (splits, Hkv * row_blocks, B): each block holds a tile of
//     PackGQA rows (row r is query head hkv*group + r / Nq at position
//     r % Nq, so K/V stream once per KV head, not once per query head) and
//     walks its KV slice with an fp32 online softmax, writing fp32 partials
//     (o_s normalised by its own l, lse_s = m + log l);
//   launch 2, grid (ceil(Dv / 128), R, B * Hkv): merges the splits by LSE,
//     lse = log sum exp(lse_s), o = sum exp(lse_s - lse) * o_s (split_merge.cuh,
//     shared with the paged decode kernel).
// A row whose split attends only masked columns (every score at or below
// MASK_VALUE, so lse_s = MASK_VALUE whatever l is) is normalised by the
// band's width instead of its l: the merge weighs such splits alike, and
// their sum is then the band's mean of V, what one pass over a row masked
// everywhere gives.
//
// Launch 1 is one TMA + wgmma block (namespace tma) for every D, Dv <= 1024
// in 64-column multiples. make_plan sizes it (ffpa_decode_plan hands the
// plan out, ops/config.py decode_plan mirrors it).
//
// * The split. Split s of S walks tiles [s * T / S, (s + 1) * T / S) of the
//   band's T 64-row tiles (ops/decode.py decode_split_ranges is the same
//   rule), and the wrapper takes as many splits as keep every block of the
//   launch resident at once (ops/decode.py _tma_splits: one block for every
//   SM, at most one split a tile).
// * The stream. One producer thread keeps a ring of 8 KiB stages full (up to
//   12, about 90 KiB in flight a block), each stage one 64 x 64 box (128 B
//   rows, 128 B swizzle) of K or V from a 3-D map (D, Nkv, B * Hkv) at the
//   cache's true extents, so TMA zero-fills past Nkv; per tile the K boxes
//   come first, then the V boxes.
// * The math. One consumer warpgroup (D, Dv <= 512) does it with wgmma, roles
//   swapped so the 64 cache rows are M and the 16 packed rows N: S^T = K Q^T
//   (Q resident in 16-row boxes) and O^T += V^T P^T (V read M-major, P^T
//   through one swizzled 16 x 64 box); S and the fp32 O^T (64 registers a
//   thread at Dv 512) stay in registers, the row maxima cross the four warps
//   through shared memory. Scores stay in natural units until
//   ex2((s - m) * log2 e): in log2 units the validity bias (MASK_VALUE)
//   overflows to -inf and a masked split's max with it. Two blocks fit an SM.
// * Above 512 (SPLIT): O^T at Dv 1024 would take 128 registers a thread, so
//   two consumer warpgroups split Dv's boxes (col_block), each holding the
//   D512 block's 64 registers of O^T. Both form the same S^T from every K
//   stage (bit-identical, so the same softmax, with no barrier between them)
//   and keep their own P^T box and exchange; each waits on and frees every
//   stage of the stream, its partner's V stages unread, so a stage's phases
//   stay in step. Warpgroup 0 alone writes the score residual and lse_s.
//   One block an SM, 288 threads (the paged decode block's SPLIT instance,
//   paged_decode.cu, over a dense cache).
//
// Score residual (return_scores, the decode backward's input): launch 1 also
// writes each valid row's masked post-softcap / bias scores in fp32 to
// [B, Hkv, R, s_ld], each split its own tiles' columns, masked and padding
// entries as MASK_VALUE.
#include <limits.h>
#include <string.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"
#include "split_merge.cuh"

namespace {

using namespace ffpa;

constexpr int KV_TILE = 64;   // K/V rows per tile (ops/config.py KV_TILE)
constexpr int D_CHUNK = 64;   // head-dim columns per box (ops/config.py D_CHUNK)
constexpr int MAX_D = 1024;   // head dims the block takes

namespace tma {

using namespace ffpa::sm90;

constexpr int ROWS = 16;                       // packed rows of a block: wgmma's N
constexpr int TILE = KV_TILE;                  // cache rows of a tile: wgmma's M
constexpr int STAGE_BYTES = BOX_BYTES;         // one 64 x 64 box of K or V
constexpr int MAX_BOXES = 8;                   // 64-column boxes of O^T a warpgroup holds
constexpr int MAX_STAGES = 12;
constexpr int CONSUMERS = 128;                 // a warpgroup: the math
constexpr int CONSUMER_WARPS = CONSUMERS / 32; // a warpgroup's arrivals that free a stage
constexpr int Q_BOX_BYTES = ROWS * 128;        // 16 rows x 64 columns of Q, or of P^T
constexpr int XCH_FLOATS = 2 * CONSUMER_WARPS * ROWS;  // per-warp row maxima, two tiles
// D, Dv <= 512: two blocks an SM, 228 KiB of shared memory, 1 KiB of it
// reserved a block. Above: one block an SM, all a block may opt into.
constexpr size_t BLOCK_SMEM = 115712;
constexpr size_t SPLIT_BLOCK_SMEM = 232448;
static_assert(TILE * 128 == STAGE_BYTES, "a stage is one tile's box");

// Consumer warpgroups of the instance, and its threads (and one producer
// warp).
__host__ __device__ constexpr int warpgroups(bool split) { return split ? 2 : 1; }
__host__ __device__ constexpr int threads(bool split) {
  return warpgroups(split) * CONSUMERS + 32;
}

// Shared memory of a block besides its ring (a stage is STAGE_COST with its
// two barriers): the 1024 B alignment, Q's boxes and, per warpgroup, the P^T
// box and the exchange.
constexpr size_t fixed_bytes(int nd, bool split) {
  return 1024 + (size_t)nd * Q_BOX_BYTES +
         warpgroups(split) * (Q_BOX_BYTES + XCH_FLOATS * sizeof(float));
}
constexpr size_t STAGE_COST = STAGE_BYTES + 2 * sizeof(uint64_t);
static_assert(fixed_bytes(MAX_D / 64, true) + MAX_STAGES * STAGE_COST <= SPLIT_BLOCK_SMEM,
              "D1024 keeps the full ring");

// Shared memory of a block, from a 1024 B boundary.
struct Smem {
  unsigned char* ring;  // stages x 8 KiB
  unsigned char* q;     // nd boxes of 16 x 64
  unsigned char* p;     // per warpgroup P^T: 16 packed rows x 64 cache rows
  float* xch;           // per warpgroup [2][CONSUMER_WARPS][ROWS]
  uint64_t* full;
  uint64_t* empty;
};
__device__ __forceinline__ Smem carve(unsigned char* base, int nd, int stages, int wgs) {
  Smem sm;
  sm.ring = base;
  sm.q = sm.ring + (size_t)stages * STAGE_BYTES;
  sm.p = sm.q + nd * Q_BOX_BYTES;
  sm.xch = reinterpret_cast<float*>(sm.p + wgs * Q_BOX_BYTES);
  sm.full = reinterpret_cast<uint64_t*>(sm.xch + wgs * XCH_FLOATS);
  sm.empty = sm.full + stages;
  return sm;
}

// The kernel's tensor maps, a __grid_constant__ parameter of their own (TMA
// reads them by address); the scalars stay an ordinary parameter.
struct Maps {
  CUtensorMap k_map;  // (D, Nkv, B * Hkv); box (64, 64, 1)
  CUtensorMap v_map;  // (Dv, Nkv, B * Hkv)
};

struct Params {
  const void* q;        // packed [B, Hkv, R, D]
  float* o_part;        // [B, Hkv, splits, R, Dv]
  float* lse_part;      // [B, Hkv, splits, R]
  const float* bias;    // additive fp32 bias packed like q, or null
  long long sb, sh, sr, sc;  // its strides, 0 on broadcast dims
  float* s_out;         // fp32 score residual [B, Hkv, R, s_ld], or null
  int s_ld;
  int Hkv, nrows, nq, D, Dv, stages, num_splits, row_blocks;
  float scale, softcap;
  int causal_offset, window_left, window_right;  // window_right: 0 when causal, -1 open
  int kv_start, kv_end;
};

// A map of one cache: 3-D (columns, row, b * Hkv + kv head), 64 x 64 boxes,
// 128 B swizzle, at the cache's true extents.
inline cudaError_t encode_cache(CUtensorMap* map, bool f16, const void* base, int cols, int nkv,
                                uint64_t slabs) {
  const uint64_t row_bytes = (uint64_t)cols * 2;
  return encode_3d(map, f16, base, cols, nkv, slabs, row_bytes, row_bytes * nkv, 64, TILE);
}

// A block's packed rows and cache rows: split blockIdx.x of num_splits near-
// equal runs of whole tiles of the band [kv_start, kv_end), the last cut at
// kv_end (ops/decode.py decode_split_ranges is the same rule). The same in
// every thread.
struct Range {
  int b, kvh, row0, kv_lo, kv_hi, ntiles;
};
__device__ __forceinline__ Range range_of(const Params& p) {
  Range r;
  r.b = blockIdx.z;
  r.kvh = blockIdx.y / p.row_blocks;
  r.row0 = (blockIdx.y % p.row_blocks) * ROWS;
  const int tiles = p.kv_end > p.kv_start ? (p.kv_end - p.kv_start + TILE - 1) / TILE : 0;
  const int t0 = (int)((long long)blockIdx.x * tiles / p.num_splits);
  const int t1 = (int)((long long)(blockIdx.x + 1) * tiles / p.num_splits);
  r.kv_lo = p.kv_start + t0 * TILE;
  r.kv_hi = min(p.kv_start + t1 * TILE, p.kv_end);
  r.ntiles = t1 - t0;
  return r;
}

// x, opaque to the compiler: what is formed from it is formed where it is
// used, not hoisted out of the tile loop and held.
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// The producer's thread: per tile, the D / 64 K boxes, then the Dv / 64 V
// boxes, one a stage.
__device__ __forceinline__ void produce(const Maps& maps, const Params& p, const Smem& sm,
                                        const Range& r, int nd, int nv) {
  prefetch_map(&maps.k_map);
  prefetch_map(&maps.v_map);
  const int slab = r.b * p.Hkv + r.kvh;
  int it = 0;
  for (int t = 0; t < r.ntiles; ++t) {
    const int kv0 = r.kv_lo + t * TILE;
#pragma unroll 1
    for (int kv = 0; kv < 2; ++kv) {
      const CUtensorMap* map = kv ? &maps.v_map : &maps.k_map;
      const int ns = kv ? nv : nd;
      for (int j = 0; j < ns; ++j, ++it) {
        const int st = it % p.stages;
        if (it >= p.stages) mbar_wait(&sm.empty[st], ((it / p.stages) - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[st], STAGE_BYTES);
        tma_load_3d(sm.ring + (size_t)st * STAGE_BYTES, map, &sm.full[st], j * 64, kv0, slab);
      }
    }
  }
}

// O^T (64 rows of Dv x 16 packed rows) += V^T P^T for one 64-column V box: A
// is the box read M-major (a k16 step is 16 rows, 2048 B), B the P^T box
// (K-major, 32 B a step).
template <typename T>
__device__ __forceinline__ void pv_mma(float (&acc)[8], const unsigned char* vbox,
                                       const unsigned char* pbox) {
  const uint64_t da = desc_b128(vbox, BOX_BYTES, 1024), db = desc_b128(pbox, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<T, ROWS, 1, 0>(acc, da + kk * (2048 >> 4), db + kk * (32 >> 4), 1);
}

// A consumer warpgroup. Accumulator element 4 j + 2 hh + e of thread (warp,
// g = lane / 4, t4 = lane % 4) is M row 16 warp + g + 8 hh and packed row
// (N column) 8 j + 2 t4 + e: for S^T the cache row kv0 + 16 warp + g + 8 hh,
// for O^T box i's column 64 (vb0 + i) + 16 warp + g + 8 hh. Element
// 4 j + 2 hh + e belongs to this thread's packed-row slot jj = 2 j + e. With
// SPLIT, warpgroup wg owns Dv boxes [vb0, vb0 + vbn) (col_block over nv).
template <typename T, bool SPLIT>
__device__ __forceinline__ void consume(const Params& p, const Smem& sm, const Range& r, int nd,
                                        int nv) {
  constexpr int WGS = warpgroups(SPLIT);
  constexpr float LOG2E = 1.4426950408889634f;
  const int tid = threadIdx.x & (CONSUMERS - 1), warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = r.b * p.Hkv + r.kvh;
  // The warpgroup's index through a shuffle, so the compiler sees it uniform
  // across the warp and the branches on it around wgmma as not divergent.
  const int wg = SPLIT ? __shfl_sync(0xffffffffu, (int)(threadIdx.x / CONSUMERS), 0) : 0;
  const int bar = SPLIT ? 2 + wg : 1;  // this warpgroup's named barrier
  int vb0 = 0, vbn = nv;
  if constexpr (SPLIT) {
    const Cols c = col_block(nv, WGS, wg);
    vb0 = c.c0 / 64;
    vbn = c.nc;
  }
  unsigned char* const pbox = sm.p + wg * Q_BOX_BYTES;
  float* const xch0 = sm.xch + wg * XCH_FLOATS;

  // Q: the block's 16 packed rows (zeros past R) into nd swizzled boxes, by
  // every consumer thread.
  const T* qb = static_cast<const T*>(p.q) + (long long)bh * p.nrows * p.D;
  for (int i = threadIdx.x; i < ROWS * nd * 8; i += WGS * CONSUMERS) {
    const int row = i / (nd * 8), c = i - row * (nd * 8);  // 8-column chunk c of the row
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r.row0 + row < p.nrows)
      x = *reinterpret_cast<const uint4*>(qb + (long long)(r.row0 + row) * p.D + 8 * c);
    *reinterpret_cast<uint4*>(sm.q + (c >> 3) * Q_BOX_BYTES + swz(row, 8 * (c & 7))) = x;
  }

  // Per packed-row slot: its column of the tile, whether it is a row below R,
  // and the band the window (or causal) leaves it: lo <= col <= hi.
  int col[4], lo[4], hi[4];
  bool live[4];
  float m[4], l[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    col[jj] = 8 * (jj >> 1) + 2 * t4 + (jj & 1);
    const int row = r.row0 + col[jj], qpos = row % p.nq + p.causal_offset;
    live[jj] = row < p.nrows;
    hi[jj] = p.window_right >= 0 ? qpos + p.window_right : INT_MAX;
    lo[jj] = p.window_left >= 0 ? qpos - p.window_left : INT_MIN;
    m[jj] = -INFINITY;
    l[jj] = 0.f;
  }
  float o[MAX_BOXES * 8];
#pragma unroll
  for (int i = 0; i < MAX_BOXES * 8; ++i) o[i] = 0.f;
  fence_operands(o);
  fence_proxy_async();
  named_barrier_sync(1, WGS * CONSUMERS);  // Q is in

  // it: the stream's stage index; held: a stage whose products may still
  // run (one group stays in flight).
  int it = 0, held = -1;
  auto release = [&](int st, bool pred) { mbar_arrive_if(&sm.empty[st], pred && lane == 0); };
  auto done_with = [&](int st) {
    wgmma_commit();
    wgmma_wait<1>();
    release(held >= 0 ? held : 0, held >= 0);
    held = st;
  };
  auto drain = [&]() {
    wgmma_wait<0>();
    release(held >= 0 ? held : 0, held >= 0);
    held = -1;
  };
  // SPLIT: the partner's V stages, waited on and freed unread, so this
  // warpgroup sees every phase of every stage.
  auto pass_over = [&](int count) {
    for (int j = 0; j < count; ++j, ++it) {
      const int st = it % p.stages;
      mbar_wait(&sm.full[st], (it / p.stages) & 1);
      release(st, true);
    }
  };

  for (int t = 0; t < r.ntiles; ++t) {
    const int kv0 = r.kv_lo + opaque(t) * TILE;
    int pos[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) pos[hh] = kv0 + 16 * warp + g + 8 * hh;

    // The bias, read before the stream's wait: a row-broadcast bias (the
    // main path's [1|B, 1, 1, Nkv]) is one load a cache row, else one an
    // element. Both warpgroups of SPLIT read it.
    float bv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) bv[i] = 0.f;
    if (p.bias != nullptr) {
      const float* bb = p.bias + ((long long)opaque(r.b) * p.sb + (long long)r.kvh * p.sh);
      if (p.sr == 0) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float x = pos[hh] < r.kv_hi ? __ldg(bb + (long long)pos[hh] * p.sc) : 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (((i >> 1) & 1) == hh) bv[i] = x;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int hh = (i >> 1) & 1, jj = 2 * (i >> 2) + (i & 1);
          bv[i] = live[jj] && pos[hh] < r.kv_hi
                      ? __ldg(bb + (long long)(r.row0 + col[jj]) * p.sr +
                              (long long)pos[hh] * p.sc)
                      : 0.f;
        }
      }
    }

    // S^T = K Q^T over D: stage j holds the 64 columns of box j.
    float s[8];
    for (int j = 0; j < nd; ++j, ++it) {
      const int st = it % p.stages;
      mbar_wait(&sm.full[st], (it / p.stages) & 1);
      wgmma_fence();
      box_mma<T, ROWS, 0>(s, sm.ring + (size_t)st * STAGE_BYTES, sm.q + j * Q_BOX_BYTES, j == 0);
      done_with(st);
    }
    drain();  // also completes the tile before's P V products
    fence_operands(s);
    fence_operands(o);  // no rescale of O moves above the wait

    // Scores in natural units: scale, softcap, bias, then MASK_VALUE outside
    // the band and -inf past the split's end.
    float sv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int hh = (i >> 1) & 1, jj = 2 * (i >> 2) + (i & 1);
      const int ps = pos[hh];
      float x = s[i] * p.scale;
      if (p.softcap > 0.f) x = p.softcap * tanhf(__fdividef(x, p.softcap));
      x += bv[i];
      x = ps >= lo[jj] && ps <= hi[jj] ? x : MASK_VALUE;
      sv[i] = ps < r.kv_hi ? x : -INFINITY;
    }
    if (p.s_out != nullptr && wg == 0) {
      // Score residual: each split writes its own tiles' columns.
      const int row0 = opaque(bh * p.nrows + r.row0);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int hh = (i >> 1) & 1, jj = 2 * (i >> 2) + (i & 1);
        if (live[jj])
          p.s_out[(long long)(row0 + col[jj]) * p.s_ld + pos[hh]] =
              sv[i] == -INFINITY ? MASK_VALUE : sv[i];
      }
    }

    // Column (packed-row) maxima: this thread's two cache rows, the warp's
    // 16 (lanes of one t4), then the four warps through the exchange.
    float* xch = xch0 + (t & 1) * (CONSUMER_WARPS * ROWS);
    float mx[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int i0 = 4 * (jj >> 1) + (jj & 1);
      mx[jj] = fmaxf(sv[i0], sv[i0 + 2]);
      mx[jj] = fmaxf(mx[jj], __shfl_xor_sync(0xffffffffu, mx[jj], 4));
      mx[jj] = fmaxf(mx[jj], __shfl_xor_sync(0xffffffffu, mx[jj], 8));
      mx[jj] = fmaxf(mx[jj], __shfl_xor_sync(0xffffffffu, mx[jj], 16));
      if (g == 0) xch[warp * ROWS + col[jj]] = mx[jj];
    }
    named_barrier_sync(bar, CONSUMERS);
    // alpha = e^(m_old - m_new), 0 on the first tile (m_old = -inf); the
    // exponent's reference ms is 0 where the max is still -inf, so no
    // -inf - -inf.
    float alpha[4], ms[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float mt = xch[col[jj]];
#pragma unroll
      for (int w = 1; w < CONSUMER_WARPS; ++w) mt = fmaxf(mt, xch[w * ROWS + col[jj]]);
      const float mn = fmaxf(m[jj], mt);
      alpha[jj] = m[jj] == mn ? 1.f : ex2((m[jj] - mn) * LOG2E);
      m[jj] = mn;
      ms[jj] = mn == -INFINITY ? 0.f : mn;
    }

    // P = e^(s - m) (a masked score against a masked max gives 1, as in one
    // pass); l sums it; P^T into its box.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int hh = (i >> 1) & 1, jj = 2 * (i >> 2) + (i & 1);
      const float pv = ex2((sv[i] - ms[jj]) * LOG2E);
      if (hh == 0) l[jj] *= alpha[jj];
      l[jj] += pv;
      *reinterpret_cast<T*>(pbox + swz(col[jj], 16 * warp + g + 8 * hh)) = from_float<T>(pv);
    }
#pragma unroll
    for (int i = 0; i < MAX_BOXES * 8; ++i) o[i] *= alpha[2 * ((i & 7) >> 2) + (i & 1)];
    fence_operands(o);
    fence_proxy_async();
    named_barrier_sync(bar, CONSUMERS);  // P^T is in; every warp has read the maxima

    // O^T += V^T P^T: V stage vb0 + j is Dv box vb0 + j.
    if constexpr (SPLIT) pass_over(vb0);
#pragma unroll
    for (int j = 0; j < MAX_BOXES; ++j) {
      if (j < vbn) {
        const int st = it % p.stages;
        mbar_wait(&sm.full[st], (it / p.stages) & 1);
        wgmma_fence();
        pv_mma<T>(*reinterpret_cast<float(*)[8]>(o + 8 * j), sm.ring + (size_t)st * STAGE_BYTES,
                  pbox);
        done_with(st);
        ++it;
      }
    }
    if constexpr (SPLIT) pass_over(nv - vb0 - vbn);
  }
  drain();
  fence_operands(o);

  // Epilogue: l over the warp's lanes and the four warps; o_s = O / l and
  // lse_s = m + log l on rows below R (l == 0: o_s = 0, lse_s = -inf; a max
  // at or below MASK_VALUE: O over the band's width, see the top of the
  // file). A warpgroup writes its own Dv boxes; warpgroup 0 writes lse_s.
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    l[jj] += __shfl_xor_sync(0xffffffffu, l[jj], 4);
    l[jj] += __shfl_xor_sync(0xffffffffu, l[jj], 8);
    l[jj] += __shfl_xor_sync(0xffffffffu, l[jj], 16);
    if (g == 0) xch0[warp * ROWS + col[jj]] = l[jj];  // read by all before the last barrier
  }
  named_barrier_sync(bar, CONSUMERS);
  const long long base = ((long long)bh * p.num_splits + blockIdx.x) * p.nrows;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    if (!live[jj]) continue;
    float lt = 0.f;
#pragma unroll
    for (int w = 0; w < CONSUMER_WARPS; ++w) lt += xch0[w * ROWS + col[jj]];
    const float norm = m[jj] <= MASK_VALUE ? (float)(p.kv_end - p.kv_start) : lt;
    const float inv = lt == 0.f ? 0.f : __fdividef(1.f, norm);
    const long long row = base + r.row0 + col[jj];
    float* dst = p.o_part + row * p.Dv + 64 * vb0 + 16 * warp + g;
#pragma unroll
    for (int i = 0; i < MAX_BOXES; ++i) {
      if (i < vbn) {
        dst[64 * i] = o[8 * i + 4 * (jj >> 1) + (jj & 1)] * inv;
        dst[64 * i + 8] = o[8 * i + 4 * (jj >> 1) + 2 + (jj & 1)] * inv;
      }
    }
    if (wg == 0 && warp == 0 && g == 0)
      p.lse_part[row] = lt == 0.f ? -INFINITY : m[jj] + logf(lt);
  }
}

template <typename T, bool SPLIT>
__global__ void __launch_bounds__(threads(SPLIT), SPLIT ? 1 : 2)
    decode_tma_kernel(const __grid_constant__ Maps maps, const Params p) {
  constexpr int WGS = warpgroups(SPLIT);
  extern __shared__ unsigned char smem_raw[];
  // Boxes on 1024 B boundaries (the 128 B swizzle's atom), by an offset
  // added to smem_raw itself, so every pointer below stays a 32-bit shared
  // one.
  unsigned char* base = smem_raw + ((1024u - (cvta_smem(smem_raw) & 1023u)) & 1023u);
  const int nd = p.D / 64, nv = p.Dv / 64;
  const Range r = range_of(p);
  if (r.ntiles == 0) {
    // A split with no tile: o_s = 0, lse_s = -inf, which the merge weighs 0.
    const long long base_row =
        ((long long)(r.b * p.Hkv + r.kvh) * p.num_splits + blockIdx.x) * p.nrows + r.row0;
    const int rows = min(ROWS, p.nrows - r.row0);
    for (int i = threadIdx.x; i < rows * p.Dv; i += threads(SPLIT))
      p.o_part[base_row * p.Dv + i] = 0.f;
    if (threadIdx.x < rows) p.lse_part[base_row + threadIdx.x] = -INFINITY;
    return;
  }
  const Smem sm = carve(base, nd, p.stages, WGS);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], WGS * CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x < WGS * CONSUMERS)
    consume<T, SPLIT>(p, sm, r, nd, nv);
  else if (threadIdx.x == WGS * CONSUMERS)
    produce(maps, p, sm, r, nd, nv);
}

template <typename T, bool SPLIT>
cudaError_t launch(const Params& p, size_t smem, const void* k, const void* v, int nkv, int B,
                   cudaStream_t st) {
  const bool f16 = std::is_same<T, __half>::value;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const uint64_t slabs = (uint64_t)B * p.Hkv;
  cudaError_t e = encode_cache(&maps.k_map, f16, k, p.D, nkv, slabs);
  if (e == cudaSuccess) e = encode_cache(&maps.v_map, f16, v, p.Dv, nkv, slabs);
  if (e != cudaSuccess) return e;
  auto kern = decode_tma_kernel<T, SPLIT>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.num_splits, p.Hkv * p.row_blocks, B);
  kern<<<grid, threads(SPLIT), smem, st>>>(maps, p);
  return cudaGetLastError();
}

// The launch's registers a thread and local (spill) bytes a thread.
template <typename T>
cudaError_t attributes(bool split, cudaFuncAttributes* a) {
  return split ? cudaFuncGetAttributes(a, decode_tma_kernel<T, true>)
               : cudaFuncGetAttributes(a, decode_tma_kernel<T, false>);
}

}  // namespace tma

// The tiling of a launch at head dims (D, Dv), multiples of 64 up to 1024:
// 16 packed rows a block (a taller packing takes row blocks); D, Dv <= 512
// one consumer warpgroup in a block's share of two an SM, wider heads two
// (SPLIT) in one block an SM; as many 8 KiB stages, at most 12, as fit beside
// the fixed bytes. ffpa_decode_plan hands it out; ops/config.py decode_plan
// mirrors it and the card test holds the two equal.
struct Plan {
  int rows, stages, consumers, blocks_per_sm;
  size_t smem;
};
inline Plan make_plan(int D, int Dv) {
  Plan pl = {};
  const bool split = D > 512 || Dv > 512;
  pl.rows = tma::ROWS;
  pl.consumers = tma::warpgroups(split);
  pl.blocks_per_sm = split ? 1 : 2;
  const size_t fixed = tma::fixed_bytes(D / 64, split);
  const size_t budget = split ? tma::SPLIT_BLOCK_SMEM : tma::BLOCK_SMEM;
  pl.stages = (int)std::min((size_t)tma::MAX_STAGES, (budget - fixed) / tma::STAGE_COST);
  pl.smem = fixed + pl.stages * tma::STAGE_COST;
  return pl;
}

inline bool valid_dims(int D, int Dv) {
  return D > 0 && Dv > 0 && D <= MAX_D && Dv <= MAX_D && D % D_CHUNK == 0 && Dv % D_CHUNK == 0;
}

template <typename T>
cudaError_t launch_decode(const tma::Params& p, const Plan& pl, const void* k, const void* v,
                          int nkv, void* o, float* lse, int B, cudaStream_t st) {
  const cudaError_t e = pl.consumers == 2 ? tma::launch<T, true>(p, pl.smem, k, v, nkv, B, st)
                                          : tma::launch<T, false>(p, pl.smem, k, v, nkv, B, st);
  if (e != cudaSuccess) return e;
  return launch_split_merge<T>(p.o_part, p.lse_part, o, lse, p.nrows, p.num_splits, p.Dv,
                               B * p.Hkv, st);
}

}  // namespace

// Launch 1, then the merge. block_rows must be the plan's rows; the band
// [kv_start, kv_end) is cut into num_splits near-equal runs of whole tiles.
// kv_per_split is not read.
extern "C" int ffpa_decode_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                               float* o_part, float* lse_part, const float* bias, long long sb,
                               long long sh, long long sr, long long sc, int is_fp16,
                               int block_rows, int B, int Hkv, int R, int nq, int nkv, int D,
                               int Dv, float scale, float softcap, int causal_offset,
                               int window_left, int window_right, int kv_start, int kv_end,
                               int kv_per_split, int num_splits, float* s_out, int s_ld,
                               void* stream) {
  (void)kv_per_split;
  if (!valid_dims(D, Dv) || R < 1 || nq < 1 || num_splits < 1 ||
      (s_out != nullptr && s_ld < ((nkv + KV_TILE - 1) / KV_TILE) * KV_TILE))
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(D, Dv);
  if (block_rows != pl.rows) return (int)cudaErrorInvalidValue;  // the wrapper follows the plan
  tma::Params p = {};
  p.q = q;
  p.o_part = o_part;
  p.lse_part = lse_part;
  p.bias = bias;
  p.sb = sb;
  p.sh = sh;
  p.sr = sr;
  p.sc = sc;
  p.s_out = s_out;
  p.s_ld = s_ld;
  p.Hkv = Hkv;
  p.nrows = R;
  p.nq = nq;
  p.D = D;
  p.Dv = Dv;
  p.stages = pl.stages;
  p.num_splits = num_splits;
  p.row_blocks = (R + pl.rows - 1) / pl.rows;
  p.scale = scale;
  p.softcap = softcap;
  p.causal_offset = causal_offset;
  p.window_left = window_left;
  p.window_right = window_right;
  p.kv_start = kv_start;
  p.kv_end = kv_end;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_fp16 ? launch_decode<__half>(p, pl, k, v, nkv, o, lse, B, st)
                       : launch_decode<__nv_bfloat16>(p, pl, k, v, nkv, o, lse, B, st));
}

// The tiling ffpa_decode_fwd takes at head dims (D, Dv), multiples of 64 up
// to 1024, and R packed rows (the plan does not depend on R): out[0..5] are
// the route (1, TMA: the only one), the packed rows of a block, the ring's
// stages, the dynamic shared-memory bytes of a block, its consumer
// warpgroups and the blocks an SM holds; cap is out's length.
extern "C" int ffpa_decode_plan(int D, int Dv, int R, int* out, int cap) {
  if (!valid_dims(D, Dv) || R < 1 || cap < 6) return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(D, Dv);
  out[0] = 1;
  out[1] = pl.rows;
  out[2] = pl.stages;
  out[3] = (int)pl.smem;
  out[4] = pl.consumers;
  out[5] = pl.blocks_per_sm;
  return 0;
}

// Registers a thread and local (spill) bytes a thread of the launch-1
// kernel with `consumers` warpgroups (1: D, Dv <= 512; 2: wider), in f16 or
// bf16.
extern "C" int ffpa_decode_attrs(int consumers, int is_fp16, int* regs, int* local_bytes) {
  if (consumers != 1 && consumers != 2) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t e = is_fp16 ? tma::attributes<__half>(consumers == 2, &a)
                                : tma::attributes<__nv_bfloat16>(consumers == 2, &a);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}
