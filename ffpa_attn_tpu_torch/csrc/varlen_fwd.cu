// Packed (THD) varlen forward attention for Hopper (sm_90a): the counterpart
// of the Pallas _varlen_fwd_kernel (ffpa_attn_tpu/ops/varlen.py).
// ops/varlen.py calls the C entry point ffpa_varlen_fwd through ctypes.
//
// The TPU kernel walks a (Hq, Tq / bq, Tk / bkv) grid over head-major
// [H, T, D] copies of the inputs, clamping the KV axis into each Q tile's
// [jmin, jmax] interval. Here one block (or a cluster of two) owns the
// packed query rows of one 64-row Q tile of one query head and loops over
// the KV tiles its Q tile needs, reading the list from device memory (one 64
// x 64 walk a call, computed on the device in ops/varlen.py and saved for
// the backward). q [Tq, Hq, D], k [Tk, Hkv, D] and v [Tk, Hkv, Dv] are read
// through their row and head strides (no head-major copy, no padding of T);
// o [Tq, Hq, Dv] and lse [Hq, Tq] are written directly, rows past Tq not.
// The keep-mask is the segment / rank test on the per-token metadata
//   (q_seg == k_seg) & (k_pos <= q_rank [+ wr]) [& k_pos >= q_rank - wl].
// Masked scores are MASK_VALUE and their P is exactly 0, so a row whose
// keep-mask is empty (padding, a Q tile that needs no KV tile) gives o = 0
// and lse = MASK_VALUE + log(1e-38), as on the TPU.
//
// One TMA + wgmma block (namespace tma, details beside it) on two routes,
// chosen by head dims alone (tma::make_plan, the dense forward's plan): D,
// Dv <= 512 one block per 64 Q rows; wider heads, up to 1024, a cluster of
// two such blocks that split D and Dv between them.
//
// Bound on an H100: bytes, barely (q, k, v and o once each against 4 * Hq *
// D flop per attended pair; ops/varlen.py).
#include "common.cuh"
#include "sm90.cuh"

#include <string.h>

namespace {

using namespace ffpa;

constexpr int KV_TILE = 64;        // K/V rows per tile (ops/config.py KV_TILE)
constexpr int CH = 64;             // head-dim columns of a box

struct VarlenParams {
  const void* q;
  const void* k;
  const void* v;
  long long q_rs, q_hs, k_rs, k_hs, v_rs, v_hs;  // row and head strides, elements
  void* o;      // [Tq, Hq, Dv] in the input type
  float* lse;   // [Hq, Tq]
  const int* q_seg;   // [num_q_tiles * 64]
  const int* q_rank;
  const int* k_seg;   // [ceil(Tk / 64) * 64]
  const int* k_pos;
  const int* tiles;   // [num_q_tiles, tiles_ld] the needed KV tiles of each Q tile
  const int* ntile;   // [num_q_tiles] how many of them
  const int* order;   // [num_q_tiles] the Q tiles, most needed tiles first
  int tiles_ld;
  const float* alibi; // [Hq] slopes, or null
  int Hq, Hkv, tq, tk, D, Dv, group;
  float scale, softcap;
  int window_left, window_right;  // window_right: 0 when causal, -1 open
};

// ---------------------------------------------------------------------------
// TMA + mbarrier + wgmma, one block (D, Dv <= 512) or a cluster of two (D or
// Dv in (512, 1024])
// ---------------------------------------------------------------------------

// The kernel of ffpa_varlen_fwd: the dense forward's block (flash_fwd.cu
// namespace fwd, sm90.cuh) over the packed layout. The mma.sync block it
// replaced put a block barrier after every 64 x 64 chunk of its cp.async
// ring, sent S through shared memory for a softmax on 512 threads and P back
// the same way, and walked every KV tile of its interval (0.56 ms at the
// serving packing on an H100, 26x its bound; above D512, at 32-row tiles,
// 4.49 ms at 8 documents in 8192 tokens H8/4 D1024, 25x). Here a block of
// 384 threads owns 64 packed Q rows of one query head:
//  - warpgroup 0 is the producer (setmaxnreg 24): one thread loads Q once by
//    TMA into resident 64 x 64 boxes (128 B swizzle), then, per KV tile of
//    the Q tile's list, streams the K boxes and the V boxes through a ring
//    of two-box stages. The tensor maps span the packed layout: dims (D, T,
//    H) with the row and head strides, extents at the true Tq and Tk, so
//    TMA zero-fills the ragged tail (varlen_bwd.cu's maps);
//  - the list holds only the KV tiles that _tile_needed (the JAX package's
//    conservative test) marks needed inside the Q tile's [jmin, jmax]
//    interval: a tile it leaves out is fully masked and changes neither m's
//    final value, l nor O of a row that keeps a key. A Q tile that needs
//    none (padding, an empty pseudo-segment) loads nothing, and its rows
//    keep m = MASK_VALUE, l = 0;
//  - warpgroups 1 and 2 are the consumers (setmaxnreg 240), as in the dense
//    block: consumer c computes S for KV columns 32c..32c+31 (m64n32k16 over
//    D), the halves of a row meet through a shared buffer of row maxima, P
//    goes through one swizzled box and O is split by columns (consumer 0
//    owns the first ceil(nv / 2) of the block's nv Dv boxes);
//  - a consumer's 64 x 32 block that lies in one segment and inside the band
//    on every pair, with no softcap, ALiBi or left window, is full: the first
//    and last rows' and columns' segment ids equal and the last key's k_pos
//    at most the first row's q_rank + wr (packing keeps a segment contiguous
//    with rising positions; varlen._full_blocks at 64 x 32 is the rule in Python),
//    and it skips the per-element mask. Any other block applies the mask
//    and the features element by element, its metadata read from device
//    memory (L1) per tile through addresses formed from an index hidden
//    behind an empty asm, so none is hoisted and held beside O;
//  - m starts at MASK_VALUE, not -inf, and scores stay in natural units
//    until ex2((s - m) * log2 e): MASK_VALUE * log2 e is -inf.
// The grid is (Hq, Q tiles): the query heads of a Q tile side by side, so a
// GQA group reads its K and V from L2 once, and the Q tiles in the
// schedule's order, most needed tiles first (the tail of the last wave is
// short). ptxas keeps the wgmma pipeline because products start with
// scale-d 0, roles are template arguments, stage releases are predicated
// arrivals and every ordinary write of an accumulator (the zeros, the
// rescale of O, the sum of partial scores) is fenced off from the products.
//
// D, Dv <= 512 (SPLIT false): the block holds all of D and Dv, 8 Q boxes, a
// P box and a ring of 8 stages (a D512 tile's K and V) at most.
//
// Wider heads (SPLIT true, D or Dv in (512, 1024]): a 64 x 1024 Q tile
// (128 KB) leaves no room for the ring and a 64 x 1024 fp32 O tile is the
// whole register file, so a cluster of two blocks (grid x = 2 Hq, the pair
// adjacent in x: the same block order) owns the 64 rows and splits both
// head dims, as the dense forward's cluster does: rank r owns the D boxes
// and the Dv boxes of its half (rank 0 the larger; sm90.cuh col_block),
// loads only its Q boxes and, per listed KV tile, only its K and V boxes, so
// every byte of Q, K and V is read once per cluster. Consumer c of each rank
// computes a partial S over its rank's D boxes and stores it (64 x 32 fp32,
// 8 KB) into the shared memory of the partner's consumer c (st.async,
// completing its bytes on the partner's barrier), then adds the partner's
// partial to its own. fp32 addition of two values is commutative, so both
// ranks hold bit-identical S, and so the same keep-mask, full-block test (the
// same metadata words), m, l and P with no further exchange; each rank
// accumulates P V into its own Dv boxes (at most 4 a consumer). A rank with
// no D box (D64 / Dv1024) sends zeros; one with no Dv box (D1024 / Dv64)
// writes no O. The exchange is double-buffered: a rank stores into slot t %
// 2 at tile t only after it received the partner's tile t - 1, which the
// partner stored after reading its slot of tile t - 2, so no slot is
// overwritten unread. Both ranks walk the same list (the same Q tile's row
// of the schedule); a Q tile with no listed tile loads and exchanges nothing.
// Each rank writes its own O columns; rank 0 writes lse. The ring is 7
// stages deep beside a rank's 8 Q boxes and the 32 KB exchange, which leads
// the boxes so that its addresses are constant offsets from their base; the
// barriers and the row exchange sit before the alignment. The cluster
// barrier at the start publishes the barriers' initialisation (every block
// reaches it, a Q tile with nothing to walk too), the one at the end keeps a
// block alive while its partner may still store into it.
namespace tma {

using namespace ffpa::sm90;

constexpr int ROWS = 64;                     // Q rows of a block
constexpr int COLS = 64;                     // columns of a box (128 B of 16-bit)
static_assert(ROWS * COLS * 2 == BOX_BYTES && KV_TILE == 64 && CH == COLS,
              "Q, K and V boxes are 64 x 64");
constexpr int MAX_BOXES = 8;                 // D, Dv boxes of a block: D512, a rank's half of D1024
constexpr int MAX_HEAD_DIM = 2 * MAX_BOXES * COLS;  // D, Dv of either route
constexpr int O_BOXES = MAX_BOXES / 2;       // Dv boxes of one consumer: 64 x 256 fp32
constexpr int STAGE_BOXES = 2;               // boxes a stage (one barrier handshake)
constexpr int STAGE_BYTES = STAGE_BOXES * BOX_BYTES;
constexpr int THREADS = 384;                 // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMER_WARPS = 8;            // arrivals that free a stage
constexpr int XCH_BYTES = 2 * ROWS * 4;      // row maxima, then row sums, of both consumers
constexpr int PART_BYTES = ROWS * 32 * 4;    // one consumer's partial S (64 x 32 fp32)
constexpr int PART_SLOTS = 2;                // the partial exchange's double buffer
constexpr int PART_BUF_BYTES = PART_SLOTS * 2 * PART_BYTES;
constexpr int SMEM_LIMIT = 232448;
constexpr int WGMMA = 1, CLUSTER = 2;        // routes

// Ring depth of the plan: a D512 tile's K and V alone; the deepest ring
// that fits beside a rank's 8 Q boxes and the exchange in a cluster
// (flash_fwd.cu fwd::stages_of). The kernel takes its depth at run time (a
// launch may cap it, the autotune's knob), never below MIN_STAGES, the
// stages the consumers' walk holds at once: a consumer waits on stage it
// while stage it - 1 may still be read, and where a block's Dv boxes are
// odd consumer 1 carries the stage of its last product, two before the
// next tile's first K stage, into that tile's S walk (flash_fwd.cu
// fwd::MIN_STAGES).
__host__ __device__ constexpr int stages_of(bool split) { return split ? 7 : 8; }
constexpr int MIN_STAGES = 3;

// The head of a block's dynamic shared memory, ahead of the 1024 B
// alignment: the full / empty barriers of the plan's deepest ring, Q's
// barrier, the partial exchange's barriers (split) and the row exchange,
// sized for the plan's depth whatever a launch's cap, so every barrier sits
// at a constant offset from the array (flash_fwd.cu fwd::head_bytes).
__host__ __device__ constexpr int head_bytes(bool split) {
  return (2 * stages_of(split) + 1 + (split ? PART_SLOTS * 2 : 0)) * (int)sizeof(uint64_t) +
         XCH_BYTES;
}

// Shared memory of a block laid out for nd Q boxes and a ring of stages:
// the head, the 1024 B alignment, the exchange (split), Q, the P box and
// the ring: the dense forward's formula (flash_fwd.cu fwd::smem_bytes), so
// the plans are equal.
constexpr size_t smem_bytes(int nd, bool split, int stages) {
  return (size_t)head_bytes(split) + 1024 + (size_t)(nd + 1) * BOX_BYTES +
         (split ? (size_t)PART_BUF_BYTES : 0) + (size_t)stages * STAGE_BYTES;
}
static_assert(smem_bytes(MAX_BOXES, false, stages_of(false)) <= SMEM_LIMIT,
              "D512's block fits the card");
static_assert(smem_bytes(MAX_BOXES, true, stages_of(true)) <= SMEM_LIMIT,
              "a D1024 rank fits the card");

// Whether a ring cap is one the entry points take: 0 (the plan's depth) or
// MIN_STAGES..the plan's depth.
inline bool ring_cap_ok(int ring_cap, bool split) {
  return ring_cap == 0 || (ring_cap >= MIN_STAGES && ring_cap <= stages_of(split));
}

// A block's share of the head dims: its first D box and D boxes, its first
// Dv box and Dv boxes, and consumer 0's Dv boxes (the first ceil(nv / 2);
// consumer 1 owns the rest). Alone a block holds everything; split, rank r
// holds half of each, rank 0 the larger half (flash_fwd.cu fwd::part_of).
struct Part {
  int d0, nd, v0, nv, nv0;
};
__host__ __device__ inline Part part_of(int nd, int nv, bool split, int rank) {
  Part pt = {0, nd, 0, nv, 0};
  if (split) {
    const Cols d = col_block(nd, 2, rank), v = col_block(nv, 2, rank);
    pt = {d.c0 / COLS, d.nc, v.c0 / COLS, v.nc, 0};
  }
  pt.nv0 = (pt.nv + 1) / 2;
  return pt;
}

// The route and tiling of a launch at head dims (D, Dv), multiples of 64
// up to 1024: the dense forward's (flash_fwd.cu fwd::make_plan). D, Dv <=
// 512 take one block per 64 Q rows, wider heads the cluster. The segment
// metadata and the tile lists are read from device memory and cost no
// shared memory. ffpa_varlen_fwd_plan hands it out; ops/config.py
// varlen_fwd_plan mirrors it (it is fwd_plan) and the card test holds the
// two equal. ring_cap > 0 caps the ring at that many stages (ring_cap_ok:
// at least MIN_STAGES).
struct Plan {
  int route, rows, stages;
  Part part[2];  // each rank's share (the lone block's is part[0])
  size_t smem;
};
inline Plan make_plan(int D, int Dv, int ring_cap = 0) {
  const int nd = D / COLS, nv = Dv / COLS;
  const bool split = nd > MAX_BOXES || nv > MAX_BOXES;
  Plan pl;
  pl.route = split ? CLUSTER : WGMMA;
  pl.rows = ROWS;
  pl.stages = stages_of(split);
  if (ring_cap > 0 && ring_cap < pl.stages) pl.stages = ring_cap;
  pl.part[0] = part_of(nd, nv, split, 0);
  pl.part[1] = part_of(nd, nv, split, 1);
  pl.smem = smem_bytes(pl.part[0].nd, split, pl.stages);
  return pl;
}

// The kernel's tensor maps, a __grid_constant__ parameter of their own (TMA
// reads them by address); the scalars stay an ordinary parameter, read from
// the constant bank.
struct Maps {
  CUtensorMap q_map;  // (D, Tq, Hq): row and head strides; box 64 x 64
  CUtensorMap k_map;  // (D, Tk, Hkv)
  CUtensorMap v_map;  // (Dv, Tk, Hkv)
};

// Shared memory of a block: the head (head_bytes: the barriers and the row
// exchange) at the start of the dynamic shared memory, then from a 1024 B
// boundary the partial exchange (split), the Q boxes, the P box and the
// ring. Both ranks of a cluster lay it out alike (for rank 0's Q boxes), so
// an offset here is the same offset in the partner.
struct Smem {
  unsigned char* part;  // [PART_SLOTS][2][PART_BYTES]: partial S the partner stored here
  unsigned char* q;
  unsigned char* p;
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* q_full;
  uint64_t* part_full;  // [PART_SLOTS][2]: the partner's partial for consumer c has landed
  float* xch;           // [2][ROWS]: row maxima of consumers 0 and 1, then their row sums
};
template <bool SPLIT>
__device__ __forceinline__ Smem carve(unsigned char* smem_raw, int nd) {
  constexpr int HEAD = head_bytes(SPLIT);
  Smem sm;
  sm.full = reinterpret_cast<uint64_t*>(smem_raw);
  sm.empty = sm.full + stages_of(SPLIT);
  sm.q_full = sm.empty + stages_of(SPLIT);
  sm.part_full = sm.q_full + 1;
  sm.xch = reinterpret_cast<float*>(sm.part_full + (SPLIT ? PART_SLOTS * 2 : 0));
  // Boxes on 1024 B boundaries: the 128 B swizzle's atom. The offset is
  // added to smem_raw itself, so the compiler keeps every pointer below in
  // the shared space (32-bit) rather than generic (64-bit, two registers).
  unsigned char* base =
      smem_raw + HEAD + ((1024u - ((cvta_smem(smem_raw) + HEAD) & 1023u)) & 1023u);
  sm.part = base;
  sm.q = base + (SPLIT ? PART_BUF_BYTES : 0);
  sm.p = sm.q + nd * BOX_BYTES;
  sm.ring = sm.p + BOX_BYTES;
  return sm;
}

// A block's query head, its Q tile's first row, and its walk: entries
// [first, first + n) of p.tiles. The same in every thread and in both ranks
// of a cluster.
struct Block {
  int head, row0, first, n;
};

// The producer's thread: the block's Q boxes once, then per listed KV tile
// its K stages (two boxes each, an odd last box alone) and its V stages (box
// j of consumer 0's half beside box j of consumer 1's, alone where that half
// is shorter).
__device__ __forceinline__ void produce(const Maps& maps, const VarlenParams& p, const Smem& sm,
                                        const Block& k, const Part& pt, int stages) {
  prefetch_map(&maps.q_map);
  prefetch_map(&maps.k_map);
  prefetch_map(&maps.v_map);
  const int kvh = k.head / p.group;
  mbar_arrive_expect_tx(sm.q_full, pt.nd * BOX_BYTES);
  for (int j = 0; j < pt.nd; ++j)
    tma_load_3d(sm.q + j * BOX_BYTES, &maps.q_map, sm.q_full, (pt.d0 + j) * COLS, k.row0,
                k.head);
  // pos: the stage to fill next; once the ring has wrapped (reuse) a stage
  // is free again only when both consumers released its previous round.
  RingPos pos;
  bool reuse = false;
  auto claim = [&](int nb) -> unsigned char* {
    if (reuse) mbar_wait(&sm.empty[pos.st], pos.ph ^ 1u);
    mbar_arrive_expect_tx(&sm.full[pos.st], nb * BOX_BYTES);
    return sm.ring + pos.st * STAGE_BYTES;
  };
  auto advance = [&]() {
    pos.next(stages);
    reuse = reuse || pos.st == 0;
  };
  for (int t = 0; t < k.n; ++t) {
    const int kv0 = __ldg(p.tiles + k.first + t) * KV_TILE;
    for (int c = 0; c < pt.nd; c += STAGE_BOXES, advance()) {
      const int nb = min(STAGE_BOXES, pt.nd - c);
      unsigned char* dst = claim(nb);
      for (int g = 0; g < nb; ++g)
        tma_load_3d(dst + g * BOX_BYTES, &maps.k_map, &sm.full[pos.st],
                    (pt.d0 + c + g) * COLS, kv0, kvh);
    }
    for (int j = 0; j < pt.nv0; ++j, advance()) {
      const bool both = pt.nv0 + j < pt.nv;
      unsigned char* dst = claim(both ? 2 : 1);
      tma_load_3d(dst, &maps.v_map, &sm.full[pos.st], (pt.v0 + j) * COLS, kv0, kvh);
      if (both)
        tma_load_3d(dst + BOX_BYTES, &maps.v_map, &sm.full[pos.st],
                    (pt.v0 + pt.nv0 + j) * COLS, kv0, kvh);
    }
  }
}

// Consumer C of a block; C and SPLIT are template arguments so that no
// branch around a wgmma depends on the thread (ptxas serializes wgmma on a
// path it cannot prove uniform). Accumulator element 4 j + 2 hh + e of
// thread (warp, g = lane / 4, t4 = lane % 4) is row 16 warp + g + 8 hh and,
// in its 8-column block j, column 8 j + 2 t4 + e. pt is the block's share
// of the head dims, rank the block's rank (0 alone).
template <typename T, int C, bool SPLIT>
__device__ __forceinline__ void consume(const VarlenParams& p, const Smem& sm, const Block& k,
                                        const Part& pt, int rank, int stages) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // The block's box counts (D, Dv, consumer 0's Dv) and its rank. One block
  // reads them as they are; a rank of the cluster from one register
  // unpacked behind an empty asm where they are used, so the rank's values
  // are not held apart beside O (varlen_bwd.cu's dQ cluster spilled so).
  const uint32_t counts = pt.nd | pt.nv << 8 | pt.nv0 << 16 | rank << 24;
  auto count = [&](int field) -> int {
    if constexpr (SPLIT) {
      uint32_t x = counts;
      asm volatile("" : "+r"(x));
      return (int)((x >> (8 * field)) & 255u);
    }
    return field == 0 ? pt.nd : field == 1 ? pt.nv : field == 2 ? pt.nv0 : 0;
  };
  const int r0 = 16 * warp + g;             // this thread's rows: r0, r0 + 8
  constexpr float LOG2E = 1.4426950408889634f;
  // No feature that changes a kept element's score: a full block skips the mask.
  const bool plain = p.alibi == nullptr && p.softcap <= 0.f && p.window_left < 0;

  // Every ordinary write of an accumulator is fenced off from the wgmma
  // that follows, or ptxas serializes the pipeline.
  float o[O_BOXES * 32];
#pragma unroll
  for (int i = 0; i < O_BOXES * 32; ++i) o[i] = 0.f;
  fence_operands(o);
  float m[2] = {MASK_VALUE, MASK_VALUE}, l[2] = {0.f, 0.f};

  // pos: the stream's next stage and its round's parity; held: a stage
  // whose products may still run. done_with frees the stage before once
  // this one's products are issued and the older ones completed (one group
  // stays in flight).
  RingPos pos;
  int held = -1;
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
  auto wait_full = [&]() { mbar_wait(&sm.full[pos.st], pos.ph); };

  if (k.n > 0) mbar_wait(sm.q_full, 0);
  for (int t = 0; t < k.n; ++t) {
    // This consumer's first KV column, from the list entry of the tile.
    int idx = k.first + t;
    asm volatile("" : "+r"(idx));
    const int kc = __ldg(p.tiles + idx) * KV_TILE + 32 * C;

    // S for this consumer's 32 KV columns: rows 32 C.. of each K box.
    float s[16];
    const int nd = count(0);
    int c = 0;
    for (; c + 2 <= nd; c += 2, pos.next(stages)) {
      const int st = pos.st;
      const unsigned char* kb = sm.ring + st * STAGE_BYTES + C * 4096;
      wait_full();
      wgmma_fence();
      box_mma<T, 32, 0>(s, sm.q + c * BOX_BYTES, kb, c == 0);
      box_mma<T, 32, 0>(s, sm.q + (c + 1) * BOX_BYTES, kb + BOX_BYTES);
      done_with(st);
    }
    if (c < nd) {
      const int st = pos.st;
      wait_full();
      wgmma_fence();
      box_mma<T, 32, 0>(s, sm.q + c * BOX_BYTES, sm.ring + st * STAGE_BYTES + C * 4096, c == 0);
      done_with(st);
      pos.next(stages);
    }
    drain();  // also completes this consumer's P V products of the tile before
    fence_operands(s);
    fence_operands(o);  // no rescale of O moves above the wait

    if constexpr (SPLIT) {
      // S = this rank's partial + the partner's, the same bits in both. A
      // rank without D boxes contributes 0. Element 4 i + e of thread tid
      // sits at (i * 128 + tid) * 16 + 4 e bytes of its slot, at a constant
      // offset from the exchange's base.
      const int slot = t & 1;
      const uint32_t mine = cvta_smem(sm.part) + (slot * 2 + C) * PART_BYTES + tid * 16;
      uint64_t* landed = &sm.part_full[slot * 2 + C];
      const uint32_t partner = (uint32_t)count(3) ^ 1u;
      const uint32_t there = mapa(mine, partner), there_bar = mapa(cvta_smem(landed), partner);
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = nd > 0 ? s[i] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) st_async_v4(there + i * 2048, s + 4 * i, there_bar);
      mbar_arrive_expect_tx_if(landed, PART_BYTES, tid == 0);
      mbar_wait_cluster(landed, (t >> 1) & 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x[4];
        lds_v4(mine + i * 2048, x);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[4 * i + e] += x[e];
      }
      fence_operands(s);
    }

    // Scores in natural units; keep holds the keep-mask, bit i for s[i].
    // The full-block test reads the same six words in every thread (and in
    // both ranks), the rows' from an index the empty asm hides (else their
    // loads are hoisted out of the walk and held beside O).
    int q_first = k.row0;
    asm volatile("" : "+r"(q_first));
    const int ks = __ldg(p.k_seg + kc);
    const bool full =
        plain && ks >= 0 && __ldg(p.k_seg + kc + 31) == ks && __ldg(p.q_seg + q_first) == ks &&
        __ldg(p.q_seg + q_first + ROWS - 1) == ks &&
        (p.window_right < 0 ||
         __ldg(p.k_pos + kc + 31) <= __ldg(p.q_rank + q_first) + p.window_right);
    float sv[16];
    uint32_t keep = 0xffffu;
    if (full) {
#pragma unroll
      for (int i = 0; i < 16; ++i) sv[i] = s[i] * p.scale;
    } else {
      const float slope = p.alibi != nullptr ? __ldg(p.alibi + k.head) : 0.f;
      keep = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          // One pair at a time: the empty asm ties the pair's scores, its
          // first column and its row, so nothing of a pair (the metadata
          // loads and their addresses) is computed ahead of the pairs
          // before, and the mask's registers are needed once, not 8 times
          // beside the 128 of O.
          const int i0 = 4 * j + 2 * hh;
          int col = kc + 8 * j + 2 * t4, row = k.row0 + r0 + 8 * hh;
          asm volatile("" : "+f"(s[i0]), "+f"(s[i0 + 1]), "+r"(col), "+r"(row));
          const int qs = __ldg(p.q_seg + row), qr = __ldg(p.q_rank + row);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kseg = __ldg(p.k_seg + col + e), kpos = __ldg(p.k_pos + col + e);
            const bool kp = qs == kseg && (p.window_right < 0 || kpos <= qr + p.window_right) &&
                            (p.window_left < 0 || kpos >= qr - p.window_left);
            float x = s[i0 + e] * p.scale;
            if (p.softcap > 0.f) x = p.softcap * tanhf(__fdividef(x, p.softcap));
            if (p.alibi != nullptr) x -= slope * fabsf((float)(qr - kpos));
            sv[i0 + e] = kp ? x : MASK_VALUE;
            keep |= (uint32_t)kp << (i0 + e);
          }
          asm volatile("" : "+f"(sv[i0]), "+f"(sv[i0 + 1]));
        }
    }

    // Row maxima: over this thread's 8 columns, its quad, then the other
    // consumer's half through the exchange buffer.
    float mx[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = MASK_VALUE;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mx[hh] = fmaxf(mx[hh], fmaxf(sv[4 * j + 2 * hh], sv[4 * j + 2 * hh + 1]));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      if (t4 == 0) sm.xch[C * ROWS + r0 + 8 * hh] = mx[hh];
    }
    // Both consumers' maxima are in, and both have completed the tile
    // before's products: the P box is free.
    named_barrier_sync(1, 2 * 128);
    float alpha[2], mn[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mn[hh] = fmaxf(m[hh], fmaxf(mx[hh], sm.xch[(1 - C) * ROWS + r0 + 8 * hh]));
      alpha[hh] = ex2((m[hh] - mn[hh]) * LOG2E);  // m >= MASK_VALUE: finite, or 0 from -inf
      m[hh] = mn[hh];
    }

    // P = exp(s - m), exactly 0 where the mask drops the pair (a row that
    // keeps nothing has s = m = MASK_VALUE), into the box; the row sums.
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float pv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hh + e;
          pv[e] = (keep >> i) & 1u ? ex2((sv[i] - mn[hh]) * LOG2E) : 0.f;
          rs[hh] += pv[e];
        }
        *reinterpret_cast<uint32_t*>(sm.p + swz(r0 + 8 * hh, 32 * C + 8 * j + 2 * t4)) =
            pack2<T>(pv[0], pv[1]);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = alpha[hh] * l[hh] + rs[hh];
#pragma unroll
    for (int i = 0; i < O_BOXES * 32; ++i) o[i] *= alpha[(i >> 1) & 1];
    fence_operands(o);
    fence_proxy_async();
    named_barrier_sync(1, 2 * 128);  // both halves of P are in the box

    // O[:, own boxes] += P V: V stage j holds this consumer's box j at
    // C * BOX_BYTES; a consumer with fewer boxes frees the stage unread.
    const int nv0 = count(2), own = C == 0 ? nv0 : count(1) - nv0;
#pragma unroll
    for (int j = 0; j < O_BOXES; ++j) {
      if (j < nv0) {
        const int st = pos.st;
        wait_full();
        if (j < own) {
          wgmma_fence();
          box_mma<T, 64, 1>(*reinterpret_cast<float(*)[32]>(o + 32 * j), sm.p,
                            sm.ring + st * STAGE_BYTES + C * BOX_BYTES);
          done_with(st);
        } else {
          release(st, true);
        }
        pos.next(stages);
      }
    }
  }
  drain();
  fence_operands(o);

  // Epilogue: l over the quad and both consumers (in the maxima's slots,
  // read by the other consumer before the last tile's second barrier); O /
  // l on rows below Tq, packed [Tq, Hq, Dv], this block's columns; lse = m +
  // log(max(l, 1e-38)) (rank 0 alone on the cluster); rows with l == 0 give
  // O = 0 and lse = MASK_VALUE + log(1e-38).
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    if (t4 == 0) sm.xch[C * ROWS + r0 + 8 * hh] = l[hh];
  }
  named_barrier_sync(1, 2 * 128);
  const int v0 = SPLIT ? col_block(p.Dv / COLS, 2, count(3)).c0 : 0;
  const int nv0_e = count(2), own = C == 0 ? nv0_e : count(1) - nv0_e;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh, row = k.row0 + r;
    if (row >= p.tq) continue;
    const float lt = l[hh] + sm.xch[(1 - C) * ROWS + r];  // the same sum in both
    const float inv = lt == 0.f ? 1.f : __fdividef(1.f, lt);
    T* dst = static_cast<T*>(p.o) + ((long long)row * p.Hq + k.head) * p.Dv + v0 +
             (C == 0 ? 0 : nv0_e * COLS) + 2 * t4;
#pragma unroll
    for (int j = 0; j < O_BOXES; ++j) {
      if (j >= own) break;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8)
        *reinterpret_cast<uint32_t*>(dst + COLS * j + 8 * j8) =
            pack2<T>(o[32 * j + 4 * j8 + 2 * hh] * inv, o[32 * j + 4 * j8 + 2 * hh + 1] * inv);
    }
    if (C == 0 && t4 == 0 && (!SPLIT || count(3) == 0))
      p.lse[(long long)k.head * p.tq + row] = m[hh] + logf(fmaxf(lt, 1e-38f));
  }
}

template <typename T, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
    varlen_fwd_wgmma_kernel(const __grid_constant__ Maps maps, const VarlenParams p,
                            const int stages) {
  extern __shared__ unsigned char smem_raw[];
  const int rank = SPLIT ? (int)cluster_rank() : 0;
  const int nd = p.D / COLS;
  const Part pt = part_of(nd, p.Dv / COLS, SPLIT, rank);
  const Smem sm = carve<SPLIT>(smem_raw, SPLIT ? (nd + 1) / 2 : nd);  // both ranks alike
  // Block order: the query heads of a Q tile side by side (on the cluster
  // route each head's two ranks adjacent), the Q tiles in the schedule's
  // order (most needed KV tiles first).
  const int tile = p.order[blockIdx.y];
  const Block k = {SPLIT ? (int)(blockIdx.x >> 1) : (int)blockIdx.x, tile * ROWS,
                   tile * p.tiles_ld, p.ntile[tile]};
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMER_WARPS);
    }
    mbar_init(sm.q_full, 1);
    if constexpr (SPLIT)
      for (int s = 0; s < PART_SLOTS * 2; ++s) mbar_init(&sm.part_full[s], 1);
    fence_barrier_init();
  }
  // The partner's barriers are initialised before this block's first store
  // into its shared memory. Every block of a cluster reaches both cluster
  // barriers, a Q tile with no listed KV tile too.
  if constexpr (SPLIT)
    cluster_sync();
  else
    __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    // A Q tile that needs no KV tile loads nothing (not even Q).
    if (threadIdx.x == 0 && k.n > 0) produce(maps, p, sm, k, pt, stages);
  } else {
    setmaxnreg_inc<240>();
    if (threadIdx.x < 256)
      consume<T, 0, SPLIT>(p, sm, k, pt, rank, stages);
    else
      consume<T, 1, SPLIT>(p, sm, k, pt, rank, stages);
  }
  if constexpr (SPLIT) cluster_sync();  // the partner may still store into this block
}

// The host side of one launch: tensor maps over the packed layout (dims (D,
// T, H), strides in bytes), shared memory, the grid (query heads, on the
// cluster route the pair of each head adjacent along x; Q tiles).
template <typename T, bool SPLIT>
cudaError_t launch(const VarlenParams& p, const Plan& pl, int num_q_tiles, cudaStream_t stream) {
  const dim3 grid((SPLIT ? 2 : 1) * p.Hq, num_q_tiles);
  if (grid.x * grid.y == 0) return cudaSuccess;
  const bool f16 = std::is_same<T, __half>::value;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const uint64_t mq = p.tq > 0 ? p.tq : 1, mkv = p.tk > 0 ? p.tk : 1;
  cudaError_t e = encode_3d(&maps.q_map, f16, p.q, p.D, mq, p.Hq, (uint64_t)p.q_rs * 2,
                            (uint64_t)p.q_hs * 2, COLS, ROWS);
  if (e == cudaSuccess)
    e = encode_3d(&maps.k_map, f16, p.k, p.D, mkv, p.Hkv, (uint64_t)p.k_rs * 2,
                  (uint64_t)p.k_hs * 2, COLS, KV_TILE);
  if (e == cudaSuccess)
    e = encode_3d(&maps.v_map, f16, p.v, p.Dv, mkv, p.Hkv, (uint64_t)p.v_rs * 2,
                  (uint64_t)p.v_hs * 2, COLS, KV_TILE);
  if (e != cudaSuccess) return e;
  auto kern = varlen_fwd_wgmma_kernel<T, SPLIT>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (e != cudaSuccess) return e;
  if constexpr (SPLIT) {
    return launch_cluster(kern, grid, THREADS, pl.smem, stream, 2, maps, p, pl.stages);
  } else {
    kern<<<grid, THREADS, pl.smem, stream>>>(maps, p, pl.stages);
    return cudaGetLastError();
  }
}

template <bool SPLIT>
cudaError_t launch_typed(bool f16, const VarlenParams& p, const Plan& pl, int num_q_tiles,
                         cudaStream_t stream) {
  return f16 ? launch<__half, SPLIT>(p, pl, num_q_tiles, stream)
             : launch<__nv_bfloat16, SPLIT>(p, pl, num_q_tiles, stream);
}

}  // namespace tma

}  // namespace

// o [Tq, Hq, Dv] in the input type and lse [Hq, Tq] fp32; the route is
// tma::make_plan's, by head dims alone (one block at D, Dv <= 512, the
// cluster of two up to 1024). A block (a cluster) owns 64 Q rows
// (num_q_tiles = ceil(Tq / 64)) and walks tiles[tile * num_kv_tiles ..][0,
// ntile[tile]) of its Q tile, the Q tiles in order's order. jmin, jmax and
// block_q are not read (the argument list of the entry point that walked
// block_q-row intervals above D512).
extern "C" int ffpa_varlen_fwd(const void* q, const void* k, const void* v, long long q_rs,
                               long long q_hs, long long k_rs, long long k_hs, long long v_rs,
                               long long v_hs, void* o, float* lse, const int* q_seg,
                               const int* q_rank, const int* k_seg, const int* k_pos,
                               const int* jmin, const int* jmax, const int* tiles,
                               const int* ntile, const int* order, const float* alibi,
                               int is_fp16, int block_q, int Hq, int Hkv, int tq, int tk,
                               int num_q_tiles, int num_kv_tiles, int D, int Dv, float scale,
                               float softcap, int window_left, int window_right, int ring_cap,
                               void* stream) {
  (void)jmin;
  (void)jmax;
  (void)block_q;
  VarlenParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_rs = q_rs;
  p.q_hs = q_hs;
  p.k_rs = k_rs;
  p.k_hs = k_hs;
  p.v_rs = v_rs;
  p.v_hs = v_hs;
  p.o = o;
  p.lse = lse;
  p.q_seg = q_seg;
  p.q_rank = q_rank;
  p.k_seg = k_seg;
  p.k_pos = k_pos;
  p.tiles = tiles;
  p.ntile = ntile;
  p.order = order;
  p.tiles_ld = num_kv_tiles;
  p.alibi = alibi;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.tq = tq;
  p.tk = tk;
  p.D = D;
  p.Dv = Dv;
  p.group = Hkv > 0 ? Hq / Hkv : 0;
  p.scale = scale;
  p.softcap = softcap;
  p.window_left = window_left;
  p.window_right = window_right;
  if (D <= 0 || Dv <= 0 || D % CH != 0 || Dv % CH != 0 || D > tma::MAX_HEAD_DIM ||
      Dv > tma::MAX_HEAD_DIM || Hkv < 1 || Hq % Hkv != 0 || tiles == nullptr ||
      ntile == nullptr || order == nullptr || num_q_tiles < 1 ||
      (long long)num_q_tiles * tma::ROWS < tq || (long long)num_kv_tiles * KV_TILE < tk)
    return (int)cudaErrorInvalidValue;
  if (!tma::ring_cap_ok(ring_cap, tma::make_plan(D, Dv).route == tma::CLUSTER))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const tma::Plan pl = tma::make_plan(D, Dv, ring_cap);
  return (int)(pl.route == tma::CLUSTER
                   ? tma::launch_typed<true>(is_fp16, p, pl, num_q_tiles, st)
                   : tma::launch_typed<false>(is_fp16, p, pl, num_q_tiles, st));
}

// The route and tiling ffpa_varlen_fwd takes at head dims (D, Dv),
// multiples of 64 up to 1024, in ffpa_flash_fwd_plan's layout: out[0..4]
// are the route (1 one block, 2 the cluster of two), the Q rows of a block,
// the KV rows of a tile, the ring's stages and the dynamic shared-memory
// bytes of a block; out[5] the number of O column blocks (each consumer's,
// rank by rank), then (first column, width) of each; then the number of
// ranks that split the head dims (0 for one block) and for each its (first
// D column, D width, first Dv column, Dv width). cap is out's length;
// ring_cap the launch's (0: the plan's depth), as ffpa_varlen_fwd takes it.
extern "C" int ffpa_varlen_fwd_plan(int D, int Dv, int* out, int cap, int ring_cap) {
  if (D <= 0 || Dv <= 0 || D % CH != 0 || Dv % CH != 0 || D > tma::MAX_HEAD_DIM ||
      Dv > tma::MAX_HEAD_DIM || cap < 6 + 8 + 1 + 8 ||
      !tma::ring_cap_ok(ring_cap, tma::make_plan(D, Dv).route == tma::CLUSTER))
    return (int)cudaErrorInvalidValue;
  const tma::Plan pl = tma::make_plan(D, Dv, ring_cap);
  const int ranks = pl.route == tma::CLUSTER ? 2 : 1;
  int n = 0;
  out[n++] = pl.route;
  out[n++] = pl.rows;
  out[n++] = KV_TILE;
  out[n++] = pl.stages;
  out[n++] = (int)pl.smem;
  out[n++] = 2 * ranks;
  for (int r = 0; r < ranks; ++r) {
    const tma::Part& pt = pl.part[r];
    out[n++] = pt.v0 * CH;
    out[n++] = pt.nv0 * CH;
    out[n++] = (pt.v0 + pt.nv0) * CH;
    out[n++] = (pt.nv - pt.nv0) * CH;
  }
  out[n++] = ranks == 2 ? 2 : 0;
  for (int r = 0; r < (ranks == 2 ? 2 : 0); ++r) {
    const tma::Part& pt = pl.part[r];
    out[n++] = pt.d0 * CH;
    out[n++] = pt.nd * CH;
    out[n++] = pt.v0 * CH;
    out[n++] = pt.nv * CH;
  }
  return 0;
}

// Registers a thread (at launch, before setmaxnreg moves them between the
// warpgroups) and local (spill) bytes a thread of the varlen forward kernel
// of route 1 (one block) or 2 (the cluster), in f16 or bf16.
extern "C" int ffpa_varlen_fwd_attrs(int route, int is_fp16, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e;
  if (route == tma::CLUSTER)
    e = is_fp16 ? cudaFuncGetAttributes(&a, tma::varlen_fwd_wgmma_kernel<__half, true>)
                : cudaFuncGetAttributes(&a, tma::varlen_fwd_wgmma_kernel<__nv_bfloat16, true>);
  else if (route == tma::WGMMA)
    e = is_fp16 ? cudaFuncGetAttributes(&a, tma::varlen_fwd_wgmma_kernel<__half, false>)
                : cudaFuncGetAttributes(&a, tma::varlen_fwd_wgmma_kernel<__nv_bfloat16, false>);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}
