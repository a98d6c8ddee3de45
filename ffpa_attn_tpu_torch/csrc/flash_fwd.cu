// Forward attention kernel for Hopper (sm_90a): the counterpart of the
// Pallas _fwd_kernel (ffpa_attn_tpu/ops/flash_fwd.py). ops/flash_fwd.py calls
// the C entry point ffpa_flash_fwd through ctypes.
//
// One TMA + mbarrier + wgmma block (namespace fwd, details beside it) on two
// routes, chosen by head dims alone (fwd::make_plan, handed out by
// ffpa_flash_fwd_plan and mirrored by ops/config.py fwd_plan): D and Dv up
// to 512 take one block per 64 Q rows; wider heads, up to 1024, a cluster
// of two such blocks that split D and Dv between them. Both compute the
// same function:
//
// Queries are tail-aligned (causal_offset = Nkv - Nq); tail-aligned causal
// and sliding-window tiles outside the band are never loaded; the bias is
// read with strides of 0 on its broadcast dims. A window masks to
// MASK_VALUE, columns past the block's KV range are -inf; a row whose max
// is -inf keeps alpha = 1 and p = 0, and a row with l = 0 gives O = 0.
// lse = m + log(max(l, 1e-38)) in fp32. Dropout drops P after the row sum
// l (which keeps every element) from the hash of rng.cuh on global (row,
// col) ids, the bits the backward kernels replay.
//
// S residual (return_scores, the S-resident backward's input): each visited
// tile's post-scale / softcap / ALiBi / bias / mask scores go straight from
// the softmax's registers to the bf16 slab [B, Hq, s_rows, s_ld], masked and
// padding entries as MASK_VALUE (never +-inf: the backward's softcap factor
// 1 - (s/cap)^2 reads them). Tiles the band skips are never written; the
// from-S kernel re-masks the band and never reads them. Storing it changes
// no arithmetic of (o, lse).
//
// Bound on an H100: operations (2 * pairs * (D + Dv) flop, 989 TFLOP/s
// dense bf16 / f16; utils/profiling.py).
#include <string.h>

#include <type_traits>

#include "common.cuh"
#include "rng.cuh"
#include "sm90.cuh"

namespace {

using namespace ffpa;

constexpr int KV_TILE = 64;        // K/V rows per tile (ops/config.py KV_TILE)
constexpr int CH = 64;             // head-dim columns of a box
constexpr int MAX_HEAD_DIM = 1024;  // D, Dv of either route

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;     // [B, Hq, Nq, Dv] in the input type
  float* lse;  // [B, Hq, Nq]
  const float* bias;
  long long sb, sh, sr, sc;  // bias strides, 0 on broadcast dims
  const float* alibi;        // [B, Hq] slopes, or null
  int Hq, Hkv, nq, nkv, D, Dv, group;
  float scale, softcap;
  int causal_offset, window_left, window_right;  // window_right: 0 when causal, -1 open
  float dropout_p, dropout_inv;
  uint32_t seed;
  __nv_bfloat16* s_out;  // S residual [B, Hq, s_rows, s_ld], or null
  int s_rows, s_ld;
};

// The score of element (row, col) from its product acc = q.k, on both
// routes: scale, softcap, ALiBi, bias, then the window's masks; padding rows
// (row >= Nq) give 0 (computed, never stored) and columns at or past kv_hi
// (the block's KV range) -inf. The softcap's division is the fast one: the
// IEEE division's slow-path call costs a wgmma consumer its registers.
__device__ __forceinline__ float score(const FwdParams& p, float acc, int b, int head, int row,
                                       int col, int kv_hi, float slope) {
  if (row >= p.nq) return 0.f;
  if (col >= kv_hi) return -INFINITY;
  float s = acc * p.scale;
  if (p.softcap > 0.f) s = p.softcap * tanhf(__fdividef(s, p.softcap));
  if (p.alibi != nullptr) s -= slope * fabsf((float)(row + p.causal_offset - col));
  if (p.bias != nullptr)
    s += p.bias[(long long)b * p.sb + (long long)head * p.sh + (long long)row * p.sr +
                (long long)col * p.sc];
  if (p.window_right >= 0 && col > row + p.causal_offset + p.window_right) s = MASK_VALUE;
  if (p.window_left >= 0 && col < row + p.causal_offset - p.window_left) s = MASK_VALUE;
  return s;
}

// ---------------------------------------------------------------------------
// The TMA + mbarrier + wgmma block, alone (D, Dv <= 512) or as a cluster of
// two (D or Dv in (512, 1024])
// ---------------------------------------------------------------------------

// The Hopper forward (the reference's SM90 split-D forward block,
// FFPAAttnFwdSm90SplitD). A block of 384 threads owns 64 Q rows of one
// query head; blocks go out heads fastest, the longest causal rows first:
//  - warpgroup 0 is the producer (setmaxnreg 24): one thread loads the
//    block's Q boxes once by TMA into resident 64 x 64 boxes (128 B
//    swizzle), then per KV tile of the band streams the block's K boxes and
//    V boxes through a ring of two-box stages (one mbarrier handshake per
//    two boxes); tensor maps at the true extents zero-fill rows past Nq and
//    Nkv;
//  - warpgroups 1 and 2 are the consumers (setmaxnreg 240). The fp32 O
//    tile (64 x 512 at Dv 512) does not fit one warpgroup, so O is split by
//    columns: consumer c owns the Dv boxes of its half (128 registers a
//    thread at 4 boxes) for the whole walk, and a V stage holds one box of
//    each half;
//  - per KV tile, consumer c computes S for KV columns 32c..32c+31 (wgmma
//    m64n32k16 over the block's D boxes, Q and the K box both K-major), so
//    both do the same tensor work. The scores stay in the accumulator's
//    layout: a row lives in the 4 threads of a quad (two shuffles a
//    reduction); the two halves of a row meet through a shared buffer of
//    row maxima (a named barrier). Each consumer writes its half of P into
//    the shared P box (swizzled, K-major); after a second named barrier,
//    O[:, own columns] += P V (m64n64k16 a box, V N-major with the
//    transpose bit). The row sum l stays per thread and is combined in the
//    epilogue;
//  - a tile with no bias, ALiBi, softcap or dropout, inside the band and
//    the Nkv edge on every element, skips the per-element feature code.
// The two named barriers a tile also order the reuse of the P box and the
// row exchange. ptxas keeps the wgmma pipeline (no C7515 / C7520 note)
// because products start with scale-d 0, roles are template arguments,
// stage releases are predicated arrivals and every ordinary write of an
// accumulator (the zeros, the rescale of O, the sum of partial scores) is
// fenced off from the products around it. A block reads its band's K and V
// from L2 once per 64 Q rows: 64 flop a byte.
//
// D, Dv <= 512 (SPLIT false): the block holds all of D and Dv, 8 Q boxes,
// a P box and a ring of 8 stages (a D512 tile's K and V) at most.
//
// Wider heads (SPLIT true, D or Dv in (512, 1024]): a 64 x 1024 Q tile
// (128 KB) leaves no room for the ring and a 64 x 1024 fp32 O tile is the
// whole register file, so a cluster of two blocks (grid x = 2 Hq, the pair
// adjacent in x: the same block order) owns the 64 rows and splits both
// head dims: rank r owns the D boxes and the Dv boxes of its half (rank 0
// the larger; sm90.cuh col_block), loads only its Q boxes and, per KV tile,
// only its K and V boxes, so every byte of Q, K and V is read once per
// cluster, as one D512 block reads it. Consumer c of each rank computes a
// partial S over its rank's D boxes and stores it (64 x 32 fp32, 8 KB)
// into the shared memory of the partner's consumer c (st.async, completing
// its bytes on the partner's barrier), then adds the partner's partial to
// its own. fp32 addition of two values is commutative, so both ranks hold
// bit-identical S, and so the same m, l, P and dropout mask; from there
// each rank runs the softmax above and accumulates P V into its own Dv
// boxes (at most 4 a consumer). The exchange is double-buffered: a rank
// stores into slot t % 2 at tile t only after it received the partner's
// tile t - 1, which the partner stored after reading its slot of tile t - 2,
// so no slot is overwritten unread. Both ranks walk the same band (it
// depends on rows alone); a block that visits no tile exchanges nothing.
// Each rank writes its own O columns; rank 0 writes lse; the S residual's
// rows are split (rank hh stores rows r0 + 8 hh of each thread), so each
// stores half. The ring is 7 stages deep beside a rank's 8 Q boxes and the
// 32 KB exchange; the cluster barrier at the start publishes the barriers'
// initialisation, the one at the end keeps a block alive while its partner
// may still store into it.
namespace fwd {

using namespace ffpa::sm90;

constexpr int ROWS = 64;                       // Q rows of a block
constexpr int COLS = 64;                       // columns of a box (128 B of 16-bit)
static_assert(ROWS * COLS * 2 == BOX_BYTES && KV_TILE == 64 && CH == COLS,
              "Q, K and V boxes are 64 x 64");
constexpr int MAX_BOXES = 8;                   // D, Dv boxes of a block: D512, a rank's half of D1024
static_assert(2 * MAX_BOXES * COLS == MAX_HEAD_DIM, "two blocks hold the widest head");
constexpr int O_BOXES = MAX_BOXES / 2;         // Dv boxes of one consumer: 64 x 256 fp32
constexpr int STAGE_BOXES = 2;                 // boxes a stage (one barrier handshake)
constexpr int STAGE_BYTES = STAGE_BOXES * BOX_BYTES;
constexpr int THREADS = 384;                   // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMER_WARPS = 8;              // arrivals that free a stage
constexpr int XCH_BYTES = 2 * ROWS * 4;        // row maxima, then row sums, of both consumers
constexpr int PART_BYTES = ROWS * 32 * 4;      // one consumer's partial S (64 x 32 fp32)
constexpr int PART_SLOTS = 2;                  // the partial exchange's double buffer
constexpr int PART_BUF_BYTES = PART_SLOTS * 2 * PART_BYTES;
constexpr int SMEM_LIMIT = 232448;
constexpr int WGMMA = 1, CLUSTER = 2;          // routes

// Ring depth of the plan: a D512 tile's K and V alone; the deepest ring
// that fits beside a rank's 8 Q boxes and the exchange in a cluster. The
// kernel takes its depth at run time (a launch may cap it, the autotune's
// knob: only the shared memory a block asks for changes), never below
// MIN_STAGES, the stages the consumers' walk holds at once: done_with frees
// the stage before only after it issued the products of the next, so a
// consumer waits on stage it while stage it - 1 may still be read; and
// where a block's Dv boxes are odd (D320, a D640 rank) consumer 1's V run
// is one box shorter, so it carries the stage of its last product, two
// before the next tile's first K stage, into that tile's S walk. A
// two-stage ring would put that K stage in the slot consumer 1 still
// holds.
__host__ __device__ constexpr int stages_of(bool split) { return split ? 7 : 8; }
constexpr int MIN_STAGES = 3;

// The head of a block's dynamic shared memory, ahead of the 1024 B
// alignment: the full / empty barriers of the plan's deepest ring, Q's
// barrier, the partial exchange's barriers (split) and the row exchange.
// Sized for the plan's depth whatever a launch's cap, so every barrier sits
// at a constant offset from the array and no consumer register holds its
// address (with the barriers behind a ring of run-time depth the forward
// ran 3 % slower).
__host__ __device__ constexpr int head_bytes(bool split) {
  return (2 * stages_of(split) + 1 + (split ? PART_SLOTS * 2 : 0)) * (int)sizeof(uint64_t) +
         XCH_BYTES;
}

// Shared memory of a block laid out for nd Q boxes and a ring of stages:
// the head, the 1024 B alignment, Q, the P box, the exchange (split) and
// the ring.
constexpr size_t smem_bytes(int nd, bool split, int stages) {
  return (size_t)head_bytes(split) + 1024 + (size_t)(nd + 1) * BOX_BYTES +
         (split ? (size_t)PART_BUF_BYTES : 0) + (size_t)stages * STAGE_BYTES;
}
static_assert(smem_bytes(MAX_BOXES, false, stages_of(false)) <= SMEM_LIMIT,
              "D512's block fits the card");
static_assert(smem_bytes(MAX_BOXES, true, stages_of(true)) <= SMEM_LIMIT &&
                  smem_bytes(MAX_BOXES, true, stages_of(true) + 1) > SMEM_LIMIT,
              "a D1024 rank fits the card with the deepest ring that does");

// Whether a ring cap is one the entry points take: 0 (the plan's depth) or
// MIN_STAGES..the plan's depth.
inline bool ring_cap_ok(int ring_cap, bool split) {
  return ring_cap == 0 || (ring_cap >= MIN_STAGES && ring_cap <= stages_of(split));
}

// A block's share of the head dims: its first D box and D boxes, its first
// Dv box and Dv boxes, and consumer 0's Dv boxes (the first ceil(nv / 2);
// consumer 1 owns the rest). Alone a block holds everything; split, rank r
// holds half of each, rank 0 the larger half.
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
// up to 1024: D, Dv <= 512 take one block per 64 Q rows, wider heads the
// cluster. ffpa_flash_fwd_plan hands it out; ops/config.py fwd_plan
// mirrors it and the card test holds the two equal. ring_cap > 0 caps the
// ring at that many stages (ring_cap_ok: at least MIN_STAGES).
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
// reads them by address); the scalars stay an ordinary parameter, read
// from the constant bank.
struct Maps {
  CUtensorMap q_map;  // (D, nq, B * Hq); box 64 x 64
  CUtensorMap k_map;  // (D, nkv, B * Hkv); box 64 x 64
  CUtensorMap v_map;  // (Dv, nkv, B * Hkv); box 64 x 64
};

// Shared memory of a block: the head (head_bytes: the barriers and the row
// exchange), then from a 1024 B boundary the Q boxes, the P box, the
// partial-score exchange (split) and the ring's stages. Both ranks of a
// cluster lay it out alike (for rank 0's Q boxes), so an offset here is the
// same offset in the partner. The boundary is found by adding an offset to
// the shared array itself, so every pointer into it stays a 32-bit shared
// one: the consumers have no registers for 64-bit generic ones (through
// uintptr_t the row exchange's address spilled).
struct Smem {
  unsigned char* q;
  unsigned char* p;
  unsigned char* ring;
  unsigned char* part;  // [PART_SLOTS][2][PART_BYTES]: partial S the partner stored here
  uint64_t* full;
  uint64_t* empty;
  uint64_t* q_full;
  float* xch;           // [2][ROWS]: row maxima of consumers 0 and 1, then their row sums
  uint64_t* part_full;  // [PART_SLOTS][2]: the partner's partial for consumer c has landed
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
  unsigned char* base =
      smem_raw + HEAD + ((1024u - ((cvta_smem(smem_raw) + HEAD) & 1023u)) & 1023u);
  sm.q = base;
  sm.p = base + nd * BOX_BYTES;
  sm.part = sm.p + BOX_BYTES;
  sm.ring = sm.part + (SPLIT ? PART_BUF_BYTES : 0);
  return sm;
}

// A block's rows and the KV tiles of its band, [kv_lo, kv_hi) in ntiles
// tiles: the same in every thread, and in both ranks of a cluster.
struct Block {
  int b, head, kvh, row0, kv_lo, kv_hi, ntiles;
};
template <bool SPLIT>
__device__ __forceinline__ Block block_of(const FwdParams& p) {
  Block k;
  k.head = SPLIT ? blockIdx.x >> 1 : blockIdx.x;
  k.b = blockIdx.y;
  k.kvh = k.head / p.group;
  k.row0 = (gridDim.z - 1 - blockIdx.z) * ROWS;  // the longest causal rows start first
  const int row_last = min(k.row0 + ROWS, p.nq) - 1;
  k.kv_lo = 0;
  k.kv_hi = p.nkv;
  if (p.window_right >= 0)
    k.kv_hi = min(p.nkv, row_last + p.causal_offset + p.window_right + 1);
  if (p.window_left >= 0) k.kv_lo = max(0, k.row0 + p.causal_offset - p.window_left);
  k.kv_lo = (k.kv_lo / KV_TILE) * KV_TILE;
  k.ntiles = k.kv_hi > k.kv_lo ? (k.kv_hi - k.kv_lo + KV_TILE - 1) / KV_TILE : 0;
  return k;
}

// The producer's thread: the block's Q boxes once, then per KV tile its K
// stages (two boxes each, an odd last box alone) and its V stages (box j of
// consumer 0's half beside box j of consumer 1's, alone where that half is
// shorter).
__device__ __forceinline__ void produce(const Maps& maps, const FwdParams& p, const Smem& sm,
                                        const Block& k, const Part& pt, int stages) {
  prefetch_map(&maps.q_map);
  prefetch_map(&maps.k_map);
  prefetch_map(&maps.v_map);
  const int bq = k.b * p.Hq + k.head, bkv = k.b * p.Hkv + k.kvh;
  mbar_arrive_expect_tx(sm.q_full, pt.nd * BOX_BYTES);
  for (int j = 0; j < pt.nd; ++j)
    tma_load_3d(sm.q + j * BOX_BYTES, &maps.q_map, sm.q_full, (pt.d0 + j) * COLS, k.row0, bq);
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
  for (int t = 0; t < k.ntiles; ++t) {
    const int kv0 = k.kv_lo + t * KV_TILE;
    for (int c = 0; c < pt.nd; c += STAGE_BOXES, advance()) {
      const int nb = min(STAGE_BOXES, pt.nd - c);
      unsigned char* dst = claim(nb);
      for (int g = 0; g < nb; ++g)
        tma_load_3d(dst + g * BOX_BYTES, &maps.k_map, &sm.full[pos.st],
                    (pt.d0 + c + g) * COLS, kv0, bkv);
    }
    for (int j = 0; j < pt.nv0; ++j, advance()) {
      const bool both = pt.nv0 + j < pt.nv;
      unsigned char* dst = claim(both ? 2 : 1);
      tma_load_3d(dst, &maps.v_map, &sm.full[pos.st], (pt.v0 + j) * COLS, kv0, bkv);
      if (both)
        tma_load_3d(dst + BOX_BYTES, &maps.v_map, &sm.full[pos.st],
                    (pt.v0 + pt.nv0 + j) * COLS, kv0, bkv);
    }
  }
}

// Consumer C of a block; C is a template argument so that no branch around
// a wgmma depends on the thread (ptxas serializes wgmma on a path it cannot
// prove uniform). Accumulator element 4 j + 2 hh + e of thread (warp, g =
// lane / 4, t4 = lane % 4) is row 16 warp + g + 8 hh and, in its 8-column
// block j, column 8 j + 2 t4 + e.
template <typename T, int C, bool SPLIT>
__device__ __forceinline__ void consume(const FwdParams& p, const Smem& sm, const Block& k,
                                        const Part& pt, int rank, int stages) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nd = pt.nd, nv = pt.nv, nv0 = pt.nv0;
  const int own = C == 0 ? nv0 : nv - nv0;  // Dv boxes of this consumer
  const int r0 = 16 * warp + g;             // this thread's rows: r0, r0 + 8
  constexpr float LOG2E = 1.4426950408889634f;
  const long long bh = (long long)k.b * p.Hq + k.head;
  const bool plain =
      p.bias == nullptr && p.alibi == nullptr && p.softcap <= 0.f && p.dropout_p <= 0.f;
  const float slope = p.alibi != nullptr ? p.alibi[bh] : 0.f;

  // Every ordinary write of an accumulator is fenced off from the wgmma
  // that follows, or ptxas serializes the pipeline.
  float o[O_BOXES * 32];
#pragma unroll
  for (int i = 0; i < O_BOXES * 32; ++i) o[i] = 0.f;
  fence_operands(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

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

  mbar_wait(sm.q_full, 0);
  for (int t = 0; t < k.ntiles; ++t) {
    const int kc = k.kv_lo + t * KV_TILE + 32 * C;  // this consumer's first KV column

    // S for this consumer's 32 KV columns: rows 32 C.. of each K box.
    float s[16];
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
      // sits at (i * 128 + tid) * 16 + 4 e bytes of its slot.
      const int slot = t & 1;
      const uint32_t mine = cvta_smem(sm.part) + (slot * 2 + C) * PART_BYTES + tid * 16;
      uint64_t* landed = &sm.part_full[slot * 2 + C];
      const uint32_t partner = rank ^ 1;
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

    // Scores: the interior fast path, or score() element by element.
    const bool interior =
        plain && kc + 31 < k.kv_hi &&
        (p.window_right < 0 || kc + 31 <= k.row0 + p.causal_offset + p.window_right) &&
        (p.window_left < 0 || kc >= k.row0 + ROWS - 1 + p.causal_offset - p.window_left);
    float sv[16];
    if (interior) {
#pragma unroll
      for (int i = 0; i < 16; ++i) sv[i] = s[i] * p.scale;
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        // One element at a time (the empty asm orders each score after the
        // one before): the feature code's registers are needed once, not
        // 16 times beside the 128 of O.
        asm volatile("" : "+f"(s[i]));
        sv[i] = score(p, s[i], k.b, k.head, k.row0 + r0 + 8 * ((i >> 1) & 1),
                      kc + 8 * (i >> 2) + 2 * t4 + (i & 1), k.kv_hi, slope);
        asm volatile("" : "+f"(sv[i]));
      }
    }
    if (p.s_out != nullptr) {
      // The block's first slab row, then offsets within a head's slab.
      __nv_bfloat16* s_blk = p.s_out + (bh * p.s_rows + k.row0) * p.s_ld;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = k.row0 + r0 + 8 * hh;
        if (row >= p.s_rows || (SPLIT && hh != rank)) continue;
        __nv_bfloat16* dst = s_blk + ((r0 + 8 * hh) * p.s_ld + kc + 2 * t4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = sv[4 * j + 2 * hh], z = sv[4 * j + 2 * hh + 1];
          if (row >= p.nq || a == -INFINITY) a = MASK_VALUE;
          if (row >= p.nq || z == -INFINITY) z = MASK_VALUE;
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(a, z);
        }
      }
    }

    // Row maxima: over this thread's 8 columns, its quad, then the other
    // consumer's half through the exchange buffer.
    float mx[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = -INFINITY;
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
      alpha[hh] = mn[hh] == -INFINITY ? 1.f : ex2((m[hh] - mn[hh]) * LOG2E);
      m[hh] = mn[hh];
    }

    // P = exp(s - m), the row sums before dropout, P dropped into the box.
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float pv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          pv[e] = mn[hh] == -INFINITY ? 0.f : ex2((sv[4 * j + 2 * hh + e] - mn[hh]) * LOG2E);
          rs[hh] += pv[e];
          if (!interior && p.dropout_p > 0.f) {
            const int row = k.row0 + r0 + 8 * hh, col = kc + 8 * j + 2 * t4 + e;
            if (dropout_uniform(p.seed, k.b, k.head, row, col) < p.dropout_p) pv[e] = 0.f;
            pv[e] *= p.dropout_inv;
          }
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
  // l on rows below Nq; lse = m + log(max(l, 1e-38)); rows with l == 0
  // give O = 0.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    if (t4 == 0) sm.xch[C * ROWS + r0 + 8 * hh] = l[hh];
  }
  named_barrier_sync(1, 2 * 128);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh, row = k.row0 + r;
    if (row >= p.nq) continue;
    const float lt = l[hh] + sm.xch[(1 - C) * ROWS + r];  // the same sum in both
    const float inv = lt == 0.f ? 1.f : __fdividef(1.f, lt);
    T* dst = static_cast<T*>(p.o) + (bh * p.nq + row) * p.Dv +
             (pt.v0 + (C == 0 ? 0 : nv0)) * COLS + 2 * t4;
#pragma unroll
    for (int j = 0; j < O_BOXES; ++j) {
      if (j >= own) break;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8)
        *reinterpret_cast<uint32_t*>(dst + COLS * j + 8 * j8) =
            pack2<T>(o[32 * j + 4 * j8 + 2 * hh] * inv, o[32 * j + 4 * j8 + 2 * hh + 1] * inv);
    }
    if (C == 0 && t4 == 0 && (!SPLIT || rank == 0))
      p.lse[bh * p.nq + row] = m[hh] + logf(fmaxf(lt, 1e-38f));
  }
}

template <typename T, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1) wgmma_fwd_kernel(const __grid_constant__ Maps maps,
                                                               const FwdParams p,
                                                               const int stages) {
  // Boxes on 1024 B boundaries: the 128 B swizzle's atom (carve).
  extern __shared__ unsigned char smem_raw[];
  const int rank = SPLIT ? (int)cluster_rank() : 0;
  const int nd = p.D / COLS;
  const Part pt = part_of(nd, p.Dv / COLS, SPLIT, rank);
  const Smem sm = carve<SPLIT>(smem_raw, SPLIT ? (nd + 1) / 2 : nd);  // both ranks alike
  const Block k = block_of<SPLIT>(p);
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
  // The partner's barriers are initialised before this block's first
  // store into its shared memory.
  if constexpr (SPLIT)
    cluster_sync();
  else
    __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) produce(maps, p, sm, k, pt, stages);
  } else {
    setmaxnreg_inc<240>();
    if (threadIdx.x < 256)
      consume<T, 0, SPLIT>(p, sm, k, pt, rank, stages);
    else
      consume<T, 1, SPLIT>(p, sm, k, pt, rank, stages);
  }
  if constexpr (SPLIT) cluster_sync();  // the partner may still store into this block
}

// The host side of one launch: tensor maps, shared memory, the grid (and
// for the split, the cluster of two along x).
template <typename T, bool SPLIT>
cudaError_t launch(const FwdParams& p, const Plan& pl, int B, cudaStream_t stream) {
  const dim3 grid((SPLIT ? 2 : 1) * p.Hq, B, (p.nq + ROWS - 1) / ROWS);
  if (grid.x * grid.y * grid.z == 0) return cudaSuccess;
  const bool f16 = std::is_same<T, __half>::value;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const uint64_t mkv = p.nkv > 0 ? p.nkv : 1;
  cudaError_t e = encode_3d(&maps.q_map, f16, p.q, p.D, p.nq, (uint64_t)B * p.Hq,
                            (uint64_t)p.D * 2, (uint64_t)p.nq * p.D * 2, COLS, ROWS);
  if (e == cudaSuccess)
    e = encode_3d(&maps.k_map, f16, p.k, p.D, mkv, (uint64_t)B * p.Hkv, (uint64_t)p.D * 2,
                  mkv * p.D * 2, COLS, KV_TILE);
  if (e == cudaSuccess)
    e = encode_3d(&maps.v_map, f16, p.v, p.Dv, mkv, (uint64_t)B * p.Hkv, (uint64_t)p.Dv * 2,
                  mkv * p.Dv * 2, COLS, KV_TILE);
  if (e != cudaSuccess) return e;
  auto kern = wgmma_fwd_kernel<T, SPLIT>;
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
cudaError_t launch_typed(bool f16, const FwdParams& p, const Plan& pl, int B,
                         cudaStream_t stream) {
  return f16 ? launch<__half, SPLIT>(p, pl, B, stream)
             : launch<__nv_bfloat16, SPLIT>(p, pl, B, stream);
}

}  // namespace fwd

}  // namespace

extern "C" int ffpa_flash_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                              const float* bias, long long sb, long long sh, long long sr,
                              long long sc, const float* alibi, int is_fp16, int block_q, int B,
                              int Hq, int Hkv, int nq, int nkv, int D, int Dv, float scale,
                              float softcap, int causal_offset, int window_left,
                              int window_right, float dropout_p, float dropout_inv,
                              unsigned seed, void* s_out, int s_rows, int s_ld,
                              int ring_cap, void* stream) {
  FwdParams p = {};
  p.s_out = static_cast<__nv_bfloat16*>(s_out);
  p.s_rows = s_rows;
  p.s_ld = s_ld;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.bias = bias;
  p.sb = sb;
  p.sh = sh;
  p.sr = sr;
  p.sc = sc;
  p.alibi = alibi;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.nq = nq;
  p.nkv = nkv;
  p.D = D;
  p.Dv = Dv;
  p.group = Hq / Hkv;
  p.scale = scale;
  p.softcap = softcap;
  p.causal_offset = causal_offset;
  p.window_left = window_left;
  p.window_right = window_right;
  p.dropout_p = dropout_p;
  p.dropout_inv = dropout_inv;
  p.seed = seed;
  // D and Dv are 64-multiples up to 1024. The kernel picks its own 64-row
  // tile; block_q (64, or 32 at Dv > 512: block_q * Dv <= 32768) is the
  // config's row tile, which sets the S residual's row padding: the slab's
  // rows cover every row tile, its columns every KV tile.
  if (D <= 0 || Dv <= 0 || D % CH != 0 || Dv % CH != 0 || D > MAX_HEAD_DIM ||
      Dv > MAX_HEAD_DIM || (long long)block_q * Dv > 32 * 1024 ||
      (block_q != 64 && block_q != 32) ||
      (s_out != nullptr && (s_rows < ((nq + block_q - 1) / block_q) * block_q ||
                            s_ld < ((nkv + KV_TILE - 1) / KV_TILE) * KV_TILE)))
    return (int)cudaErrorInvalidValue;
  if (!fwd::ring_cap_ok(ring_cap, fwd::make_plan(D, Dv).route == fwd::CLUSTER))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const fwd::Plan pl = fwd::make_plan(D, Dv, ring_cap);
  return (int)(pl.route == fwd::CLUSTER ? fwd::launch_typed<true>(is_fp16, p, pl, B, st)
                                        : fwd::launch_typed<false>(is_fp16, p, pl, B, st));
}

// The route and tiling ffpa_flash_fwd takes at head dims (D, Dv), multiples
// of 64 up to 1024: out[0..4] are the route (1 one block, 2 the cluster of
// two), the Q rows of a block, the KV rows of a tile, the ring's stages and
// the dynamic shared-memory bytes of a block; out[5] the number of O column
// blocks (each consumer's, rank by rank), then (first column, width) of
// each; then the number of ranks that split the head dims (0 for one
// block) and for each its (first D column, D width, first Dv column, Dv
// width). cap is out's length; ring_cap the launch's (0: the plan's depth),
// as ffpa_flash_fwd takes it.
extern "C" int ffpa_flash_fwd_plan(int D, int Dv, int* out, int cap, int ring_cap) {
  if (D <= 0 || Dv <= 0 || D % CH != 0 || Dv % CH != 0 || D > MAX_HEAD_DIM ||
      Dv > MAX_HEAD_DIM || cap < 6 + 8 + 1 + 8 ||
      !fwd::ring_cap_ok(ring_cap, fwd::make_plan(D, Dv).route == fwd::CLUSTER))
    return (int)cudaErrorInvalidValue;
  const fwd::Plan pl = fwd::make_plan(D, Dv, ring_cap);
  const int ranks = pl.route == fwd::CLUSTER ? 2 : 1;
  int n = 0;
  out[n++] = pl.route;
  out[n++] = pl.rows;
  out[n++] = KV_TILE;
  out[n++] = pl.stages;
  out[n++] = (int)pl.smem;
  out[n++] = 2 * ranks;
  for (int r = 0; r < ranks; ++r) {
    const fwd::Part& pt = pl.part[r];
    out[n++] = pt.v0 * CH;
    out[n++] = pt.nv0 * CH;
    out[n++] = (pt.v0 + pt.nv0) * CH;
    out[n++] = (pt.nv - pt.nv0) * CH;
  }
  out[n++] = ranks == 2 ? 2 : 0;
  for (int r = 0; r < (ranks == 2 ? 2 : 0); ++r) {
    const fwd::Part& pt = pl.part[r];
    out[n++] = pt.d0 * CH;
    out[n++] = pt.nd * CH;
    out[n++] = pt.v0 * CH;
    out[n++] = pt.nv * CH;
  }
  return 0;
}

// Registers a thread (at launch, before setmaxnreg moves them between the
// warpgroups) and local (spill) bytes a thread of the forward kernel of
// route 1 (one block) or 2 (the cluster), in f16 or bf16.
extern "C" int ffpa_flash_fwd_attrs(int route, int is_fp16, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e;
  if (route == fwd::CLUSTER)
    e = is_fp16 ? cudaFuncGetAttributes(&a, fwd::wgmma_fwd_kernel<__half, true>)
                : cudaFuncGetAttributes(&a, fwd::wgmma_fwd_kernel<__nv_bfloat16, true>);
  else if (route == fwd::WGMMA)
    e = is_fp16 ? cudaFuncGetAttributes(&a, fwd::wgmma_fwd_kernel<__half, false>)
                : cudaFuncGetAttributes(&a, fwd::wgmma_fwd_kernel<__nv_bfloat16, false>);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}
