// Packed (THD) varlen backward attention for Hopper (sm_90a): the
// counterparts of the Pallas _varlen_dkdv_kernel and _varlen_dq_kernel
// (ffpa_attn_tpu/ops/varlen.py). ops/varlen.py calls the C entry points
// ffpa_varlen_bwd_dkdv and ffpa_varlen_bwd_dq through ctypes.
//
// Every block below is the dense backward's (flash_bwd.cu) with two
// changes:
//   * the causal / window band test becomes the segment / rank keep-mask of
//     the forward (varlen_fwd.cu),
//       (q_seg == k_seg) & (k_pos <= q_rank [+ wr]) [& k_pos >= q_rank - wl],
//     read from the per-token metadata in device memory; masked elements
//     get P = 0 and dS = 0 exactly, so rows with no key (padding, rows past
//     Tq, an empty interval's [0, 0] tile) add nothing;
//   * the tiles each block walks are read from device memory, computed on
//     the device from one 64 x 64 walk of the call (ops/varlen.py
//     _backward_schedules: the forward's own at D, Dv <= 512, computed by
//     the backward above): for dK/dV a 64-row KV tile's [imin, imax] of
//     64-row Q tiles, for dQ a 64-row Q tile's list of needed 64-row KV
//     tiles.
// q, dO [T, Hq, D|Dv] and k, v [T, Hkv, D|Dv] are read through their row
// and head strides (no head-major copy, no padding of T); dq, dk and dv are
// written packed, the ragged tails bounds-checked. lse and delta are [Hq, Tq]
// fp32 (delta = rowsum(dO * O), the sink-inclusive O where there are sinks).
//
// dK/dV is the TMA + wgmma block of namespace tma (the dense dkdv::kernel's
// design, details beside it) on two routes, by head dims alone
// (tma::make_plan): 64 KV rows of one KV head with K and V resident, the
// GQA group's 64-row Q and dO tiles streamed as TMA boxes, column passes of
// at most 256 columns; one block at D, Dv <= 512, a cluster of two blocks up
// to 1024 (each rank holding half of D's and of Dv's boxes, the partial
// S^T and dP^T exchanged through distributed shared memory). The group is
// reduced in fp32 in the block's registers and dK, dV are stored once each
// (the TPU kernel writes a per-q-head dK/dV in the input type and sums the
// group afterwards).
//
// dQ is the TMA + wgmma block of namespace tma (the dense dq::wgmma_dq_kernel's
// design, details beside it) on two routes, by head dims alone
// (tma::make_dq_plan): 64 Q rows of one query head with Q and dO resident,
// the listed KV tiles' K and V boxes streamed, the fp32 dQ tile split over
// two consumer warpgroups; one block at D, Dv <= 512, a cluster of two
// blocks up to 1024 (each rank holding half of D's and of Dv's boxes, the
// partial S and dP exchanged through distributed shared memory).
//
// Bound on an H100: operations (4 matmul units of 2 * pairs * D flop for
// dK/dV, 3 for dQ, over the segments' bands; utils/profiling.py
// varlen_backward_counts). The design against it is the dense backward's,
// walking only the needed tiles (dQ) or the intervals' tiles (dK/dV).
#include <string.h>

#include <algorithm>
#include <type_traits>

#include "bwd_tiles.cuh"
#include "sm90.cuh"

namespace {

using namespace ffpa;

struct VarlenBwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  long long q_rs, q_hs, k_rs, k_hs, v_rs, v_hs, do_rs, do_hs;  // row and head strides
  const float* lse;    // [Hq, Tq]
  const float* delta;  // [Hq, Tq]
  void* dq;            // [Tq, Hq, D]
  void* dk;            // [Tk, Hkv, D]
  void* dv;            // [Tk, Hkv, Dv]
  const int* q_seg;    // [ceil(Tq / 128) * 128]
  const int* q_rank;
  const int* k_seg;    // [ceil(Tk / 64) * 64]
  const int* k_pos;
  const int* lo;       // [KV tiles] first Q tile of each dK/dV block's interval
  const int* hi;       // last Q tile
  const int* order;    // [tiles] the blocks' tiles in launch order
  const int* tiles;    // [Q tiles, tiles_ld] each Q tile's needed KV tiles (dQ)
  const int* ntile;    // [Q tiles] how many it lists
  const float* alibi;  // [Hq] slopes, or null
  int Hq, Hkv, group, tq, tk, D, Dv, col_passes, tiles_ld;
  float scale, softcap;
  int window_left, window_right;  // window_right: 0 when causal, -1 open
};

// Whether a (query, key) pair is attended: the forward's keep-mask.
__device__ __forceinline__ bool keeps(const VarlenBwdParams& p, int qs, int qr, int ks, int kp) {
  bool keep = qs == ks;
  if (p.window_right >= 0) keep = keep && kp <= qr + p.window_right;
  if (p.window_left >= 0) keep = keep && kp >= qr - p.window_left;
  return keep;
}

// p = exp(s - lse) of one kept score element from its raw q.k, and
// softcap's chain factor 1 - (s/cap)^2; a masked element gives p = 0.
struct Prob {
  float p, cap;
};

__device__ __forceinline__ Prob score_prob(const VarlenBwdParams& p, bool keep, float qk,
                                           float lse, float slope, int dist) {
  Prob r = {0.f, 1.f};
  if (!keep) return r;
  float s = qk * p.scale;
  if (p.softcap > 0.f) {
    s = p.softcap * tanhf(s / p.softcap);
    const float u = s / p.softcap;
    r.cap = 1.f - u * u;
  }
  if (p.alibi != nullptr) s -= slope * fabsf((float)dist);
  r.p = __expf(s - lse);
  return r;
}

VarlenBwdParams make_params(const void* q, const void* k, const void* v, const void* dout,
                            long long q_rs, long long q_hs, long long k_rs, long long k_hs,
                            long long v_rs, long long v_hs, long long do_rs, long long do_hs,
                            const float* lse, const float* delta, const int* q_seg,
                            const int* q_rank, const int* k_seg, const int* k_pos, const int* lo,
                            const int* hi, const float* alibi, int Hq, int Hkv, int tq, int tk,
                            int D, int Dv, float scale, float softcap, int window_left,
                            int window_right) {
  VarlenBwdParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.q_rs = q_rs;
  p.q_hs = q_hs;
  p.k_rs = k_rs;
  p.k_hs = k_hs;
  p.v_rs = v_rs;
  p.v_hs = v_hs;
  p.do_rs = do_rs;
  p.do_hs = do_hs;
  p.lse = lse;
  p.delta = delta;
  p.q_seg = q_seg;
  p.q_rank = q_rank;
  p.k_seg = k_seg;
  p.k_pos = k_pos;
  p.lo = lo;
  p.hi = hi;
  p.alibi = alibi;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.group = Hkv > 0 ? Hq / Hkv : 1;
  p.tq = tq;
  p.tk = tk;
  p.D = D;
  p.Dv = Dv;
  p.col_passes = 1;
  p.scale = scale;
  p.softcap = softcap;
  p.window_left = window_left;
  p.window_right = window_right;
  return p;
}

// ---------------------------------------------------------------------------
// dK / dV: TMA + mbarrier + wgmma, one block (D, Dv <= 512) or a cluster of
// two (D or Dv in (512, 1024])
// ---------------------------------------------------------------------------

// ffpa_varlen_bwd_dkdv's kernel, built on the dense dK/dV block
// (flash_bwd.cu namespace dkdv; sm90.cuh). The mma.sync block it replaced
// owned 32 KV rows, ran m16n8k16 products from ldmatrix fragments and put a
// block barrier after every 64-column chunk of its cp.async ring, so nothing
// overlapped (3.19 ms at the packed-training shape on an H100, 18x its
// bound; above D512 9.57 ms, 27x, at 8 documents in 8192 tokens H8/4 D1024).
// Here a block of 384 threads owns 64 KV rows of one KV head and one column
// pass (at most 256 columns of dK and of dV, 128 fp32 registers of each
// consumer thread). K and V are loaded by TMA once and stay resident in 64 x
// 64 boxes with 128 B swizzle; warpgroup 0 is the producer: one thread
// streams, for every q-head of the GQA group and every 64-row Q tile of the
// KV tile's interval, the Q and dO boxes through a ring of two-box stages
// (tensor maps over the packed layout: dims (D, T, H) with the row and head
// strides, extents at the true Tq and Tk, so TMA zero-fills the ragged
// tail). Warpgroups 1 and 2 are the consumers; per Q tile:
//  - S^T = K Q^T and dP^T = V dO^T over all of the block's D and Dv boxes:
//    consumer c takes Q columns 32c..32c+31 (wgmma.m64n32k16), so each
//    thread holds its own S, dP, lse and delta;
//  - P and dS = P (dP - delta) (softcap's factor included): a block of 64
//    KV rows x 32 Q columns that lies in one segment and inside the band,
//    with no feature on (no softcap, no ALiBi, no left window), is full:
//    p = 2^(s * scale * log2 e - lse * log2 e) alone. Packing keeps a
//    segment's tokens contiguous with rising positions, so that is the
//    first and last rows' and columns' segments equal and k_pos(last row)
//    <= q_rank(first column) + wr: six loads, the same for every thread.
//    Any other block takes keeps + score_prob element by element, with the
//    metadata of the thread's 8 columns and 2 rows read from device memory
//    (L1) for the tile;
//  - each consumer writes its 32 columns of P^T and dS^T into two swizzled
//    [kv][q] boxes; consumer 0 runs dK += dS^T Q over the pass's Q boxes,
//    consumer 1 dV += P^T dO over its dO boxes (wgmma.m64n64k16), which the
//    ring holds after the S^T / dP^T boxes, so both work at once.
// The blocks of the longest intervals start first (the schedule's order:
// under causal packing a segment's first KV tiles walk the most Q tiles),
// with a KV tile's passes and KV heads side by side. S and dP are
// recomputed in every pass. dK and dV are stored packed, rows past Tk not.
//
// D, Dv <= 512 (SPLIT false): one block holds all of D and Dv, 6 stages at
// most (5 at D512).
//
// Wider heads (SPLIT true, D or Dv in (512, 1024]): K and V of 64 rows at
// D1024 (256 KB) fit no block, so a cluster of two blocks (grid x = 2 x
// passes x KV heads, the pair adjacent in x: the same block order) owns the
// 64 KV rows and one pass and splits both head dims, as the dense dK/dV
// cluster does: rank r holds the K boxes of its half of D and the V boxes
// of its half of Dv, resident (rank 0 the larger half; sm90.cuh col_block),
// and per Q tile streams only its own Q and dO boxes, so every byte of Q,
// K, V and dO is read once per cluster. Consumer c of each rank computes a
// partial S^T over its rank's D boxes and a partial dP^T over its Dv boxes
// (64 x 32 fp32, 8 KB each), stores both into the shared memory of the
// partner's consumer c (st.async, completing their bytes on the partner's
// barrier; S^T as soon as its products complete, so its bytes travel under
// the dP^T products) and adds the partner's partials to its own. fp32
// addition of two values is commutative, so both ranks hold bit-identical
// S^T and dP^T, and so the same P, dS and full-block test from the same
// metadata, with no further exchange. Each rank then runs dK += dS^T Q over
// the pass's share of its D boxes and dV += P^T dO over its share of its Dv
// boxes (passes of at most 256 columns of a rank's half: 2 at D1024) and
// stores its own columns. The exchange has one slot (3 stages at D = Dv =
// 1024; the arithmetic is beside make_plan), so a rank stores tile t's
// partials only after the partner has read tile t - 1's: each thread that
// read its share of the slot arrives on the partner's "free" barrier (a
// remote arrive, release at cluster scope), which the storing consumer waits
// on with acquire. Both ranks walk the same Q tiles (the interval of the KV
// tile). A rank may hold no D box (D64 / Dv1024) or no Dv box (D1024 /
// Dv64): it sends zero partials of that product and owns no columns of that
// gradient. The cluster barrier at the start publishes the barriers'
// initialisation, the one at the end keeps a block alive while its partner
// may still store or arrive into it.
namespace tma {

using namespace ffpa::sm90;

constexpr int ROWS = 64;                     // KV rows of a block
constexpr int QROWS = 64;                    // Q rows of a streamed tile
constexpr int COLS = 64;                     // columns of a box (128 B of 16-bit)
constexpr int MAX_BOXES = 8;                 // D, Dv boxes of a block: D512, a rank's half of D1024
constexpr int MAX_HEAD_DIM = 2 * MAX_BOXES * COLS;  // D, Dv of either dK/dV route
constexpr int PASS_BOXES = 4;                // dK / dV columns of a pass: 256
constexpr int STAGE_BOXES = 2;               // boxes a stage (one barrier handshake)
static_assert(STAGE_BOXES == 2, "the consumers' stage loops take pairs of boxes");
constexpr int STAGE_BYTES = STAGE_BOXES * BOX_BYTES;
constexpr int MAX_STAGES = 6;
constexpr int THREADS = 384;                 // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMER_WARPS = 8;            // arrivals that free a stage
constexpr int CONSUMER_THREADS = 128;        // arrivals that free a consumer's exchange slot
constexpr int PART_BYTES = ROWS * 32 * 4;    // one consumer's partial S^T or dP^T (64 x 32 fp32)
constexpr int PART_BUF_BYTES = 2 * 2 * PART_BYTES;  // both consumers' S^T and dP^T: one slot
constexpr int PART_BARRIERS = 4;             // landed and free, per consumer
constexpr int SMEM_LIMIT = 232448;
constexpr int WGMMA = 1, CLUSTER = 2;       // routes

// A block's share of the head dims: its first D box and D boxes, its first
// Dv box and Dv boxes. Alone a block holds everything; split, rank r holds
// half of each, rank 0 the larger half.
struct Part {
  int d0, nd, v0, nv;
};
__host__ __device__ inline Part part_of(int nd, int nv, bool split, int rank) {
  if (!split) return {0, nd, 0, nv};
  const Cols d = col_block(nd, 2, rank), v = col_block(nv, 2, rank);
  return {d.c0 / COLS, d.nc, v.c0 / COLS, v.nc};
}

// Shared memory of a block laid out for nd K boxes and nv V boxes, apart
// from the ring: K, V, the P and dS boxes, the 1024 B alignment, the K/V
// barrier and, split, the exchange's slot and its barriers. A ring stage is
// STAGE_BOXES boxes and its two barriers.
inline size_t fixed_bytes(int nd, int nv, bool split) {
  return (size_t)(nd + nv + 2) * BOX_BYTES + 1024 + sizeof(uint64_t) +
         (split ? (size_t)PART_BUF_BYTES + PART_BARRIERS * sizeof(uint64_t) : 0);
}
constexpr size_t STAGE_SMEM = STAGE_BYTES + 2 * sizeof(uint64_t);

// The route and tiling of a launch at head dims (D, Dv), multiples of 64
// up to 1024: the dense dK/dV block's (flash_bwd.cu dkdv::make_plan). D, Dv
// <= 512 take one block, wider heads the cluster; ceil((a block's boxes of D
// or of Dv) / 4) passes whose column blocks split a block's D boxes and its
// Dv boxes as evenly as possible (sm90.cuh col_block), and as many ring
// stages (at most 6) as shared memory holds beside the rest. Both ranks of a
// cluster lay out rank 0's share. At D = Dv = 1024 a rank's K and V take 16
// boxes (128 KB), the P and dS boxes 16 KB and the exchange's slot 32 KB:
// with the alignment and the barriers 181,288 B, and 3 stages of 16,400 B
// make 230,488 of the 232,448 a block may ask for. The segment metadata and
// the schedule are read from device memory and cost no shared memory.
// ffpa_varlen_bwd_dkdv_plan hands the plan out; ops/config.py
// varlen_dkdv_plan mirrors it (it is dkdv_plan) and the card test holds the
// two equal.
struct Plan {
  int route, passes, stages;
  Part part[2];  // each rank's share (the lone block's is part[0])
  size_t smem;
};
inline Plan make_plan(int D, int Dv) {
  const int nd = D / COLS, nv = Dv / COLS;
  const bool split = nd > MAX_BOXES || nv > MAX_BOXES;
  Plan pl;
  pl.route = split ? CLUSTER : WGMMA;
  pl.part[0] = part_of(nd, nv, split, 0);
  pl.part[1] = part_of(nd, nv, split, 1);
  const Part& lay = pl.part[0];
  pl.passes = std::max((lay.nd + PASS_BOXES - 1) / PASS_BOXES,
                       (lay.nv + PASS_BOXES - 1) / PASS_BOXES);
  const size_t fixed = fixed_bytes(lay.nd, lay.nv, split);
  pl.stages = (int)std::min((size_t)MAX_STAGES, (SMEM_LIMIT - fixed) / STAGE_SMEM);
  pl.smem = fixed + pl.stages * STAGE_SMEM;
  return pl;
}

// The kernels' tensor maps, a __grid_constant__ parameter of their own (TMA
// reads them by address); the scalars stay an ordinary parameter, read from
// the constant bank (p.col_passes is the plan's passes).
struct Maps {
  CUtensorMap q_map, do_map;  // (D | Dv, Tq, Hq): row and head strides; box 64 x 64
  CUtensorMap k_map, v_map;   // (D | Dv, Tk, Hkv)
};

// Shared memory of a block, from a 1024 B boundary: the K boxes, the V
// boxes, the P and dS boxes, the ring's stages, the exchange's slot
// (split), the stages' full / empty barriers, K/V's barrier and the
// exchange's barriers (split). Both ranks of a cluster lay it out alike
// (for rank 0's share), so an offset here is the same offset in the
// partner.
struct Smem {
  unsigned char* k;
  unsigned char* v;
  unsigned char* p;     // P^T, swizzled [kv][q]
  unsigned char* ds;    // dS^T (softcap's factor included), swizzled [kv][q]
  unsigned char* ring;
  unsigned char* part;  // [2][2][PART_BYTES]: consumer c's partial S^T, dP^T from the partner
  uint64_t* full;
  uint64_t* empty;
  uint64_t* kv_full;
  uint64_t* part_full;  // [2]: the partner's partials for consumer c have landed
  uint64_t* part_free;  // [2]: the partner's consumer c has read the partials sent to it
};
template <bool SPLIT>
__device__ __forceinline__ Smem carve(unsigned char* base, int nd, int nv, int stages) {
  Smem sm;
  sm.k = base;
  sm.v = base + nd * BOX_BYTES;
  sm.p = base + (nd + nv) * BOX_BYTES;
  sm.ds = sm.p + BOX_BYTES;
  sm.ring = sm.ds + BOX_BYTES;
  sm.part = sm.ring + stages * STAGE_BYTES;
  sm.full = reinterpret_cast<uint64_t*>(sm.part + (SPLIT ? PART_BUF_BYTES : 0));
  sm.empty = sm.full + stages;
  sm.kv_full = sm.empty + stages;
  sm.part_full = sm.kv_full + 1;
  sm.part_free = sm.part_full + 2;
  return sm;
}

// A block's work: its KV tile's first row and KV head, the tile's Q tiles
// [i_lo, i_lo + ni) of every group member (an empty interval is [0, 0]: one
// fully masked tile, which both ranks of a cluster walk and exchange), its
// rank's share of the head dims and its pass's dK and dV columns
// (absolute). Block order: the passes of a (KV tile, KV head) side by side
// (they read the same Q and dO tiles; on the cluster route each pass's two
// ranks adjacent), the KV heads of a tile next, the KV tiles in the
// schedule's order (longest interval first). Each warpgroup forms it after
// setmaxnreg (formed before and held across, a value spilled).
struct Work {
  int kv0, kvh, i_lo, ni;
  Part pt;
  Cols dc, vc;
};
template <bool SPLIT>
__device__ __forceinline__ Work work_of(const VarlenBwdParams& p) {
  Work w;
  const int passes = p.col_passes;
  const int blk = SPLIT ? (int)(blockIdx.x >> 1) : (int)blockIdx.x;
  const int pass = blk % passes, tile = p.order[blockIdx.y];
  w.kv0 = tile * ROWS;
  w.kvh = blk / passes;
  w.i_lo = p.lo[tile];
  w.ni = p.hi[tile] - w.i_lo + 1;
  w.pt = part_of(p.D / COLS, p.Dv / COLS, SPLIT, SPLIT ? (int)cluster_rank() : 0);
  w.dc = col_block(w.pt.nd, passes, pass);
  w.vc = col_block(w.pt.nv, passes, pass);
  w.dc.c0 += w.pt.d0 * COLS;
  w.vc.c0 += w.pt.v0 * COLS;
  return w;
}

// The pass's dK (dim 0) or dV (dim 1) columns of a rank of the cluster,
// absolute (Work's dc and vc), from its block index and rank.
__device__ __forceinline__ Cols split_pass_cols(const VarlenBwdParams& p, int dim) {
  const Cols r = col_block((dim ? p.Dv : p.D) / COLS, 2, (int)cluster_rank());
  Cols c = col_block(r.nc, p.col_passes, (int)(blockIdx.x >> 1) % p.col_passes);
  c.c0 += r.c0;
  return c;
}

// The producer's thread: the block's K and V boxes once, then per Q tile
// four runs of boxes: its nd Q boxes, its nv dO boxes, the pass's dO boxes,
// the pass's Q boxes; a stage takes up to STAGE_BOXES boxes of one run.
__device__ __forceinline__ void produce(const Maps& maps, const VarlenBwdParams& p,
                                        const Smem& sm, int stages, const Work& w) {
  const Part& pt = w.pt;
  prefetch_map(&maps.q_map);
  prefetch_map(&maps.do_map);
  prefetch_map(&maps.k_map);
  prefetch_map(&maps.v_map);
  mbar_arrive_expect_tx(sm.kv_full, (pt.nd + pt.nv) * BOX_BYTES);
  for (int j = 0; j < pt.nd; ++j)
    tma_load_3d(sm.k + j * BOX_BYTES, &maps.k_map, sm.kv_full, (pt.d0 + j) * COLS, w.kv0, w.kvh);
  for (int j = 0; j < pt.nv; ++j)
    tma_load_3d(sm.v + j * BOX_BYTES, &maps.v_map, sm.kv_full, (pt.v0 + j) * COLS, w.kv0, w.kvh);
  // A Q tile's four runs, (first box, boxes) in 4 bits each (at most 15),
  // in one register unpacked behind an empty asm at each tile: the producer
  // has 24 registers, and held apart they spilled.
  const uint32_t runs = pt.d0 | pt.nd << 4 | pt.v0 << 8 | pt.nv << 12 | (w.vc.c0 / COLS) << 16 |
                        w.vc.nc << 20 | (w.dc.c0 / COLS) << 24 | (uint32_t)w.dc.nc << 28;
  const int h0 = w.kvh * p.group, i_lo = w.i_lo, ni = w.ni;
  int it = 0;
  auto run = [&](const CUtensorMap* map, int first, int n, int q0, int h) {
    for (int c = 0; c < n; c += STAGE_BOXES, ++it) {
      const int st = it % stages, nb = min(STAGE_BOXES, n - c);
      if (it >= stages) mbar_wait(&sm.empty[st], ((it / stages) - 1) & 1);
      mbar_arrive_expect_tx(&sm.full[st], nb * BOX_BYTES);
      for (int b = 0; b < nb; ++b)
        tma_load_3d(sm.ring + st * STAGE_BYTES + b * BOX_BYTES, map, &sm.full[st],
                    (first + c + b) * COLS, q0, h);
    }
  };
  for (int t = 0; t < p.group * ni; ++t) {
    const int h = h0 + t / ni, q0 = (i_lo + t % ni) * QROWS;
    uint32_t r = runs;
    asm volatile("" : "+r"(r));
    run(&maps.q_map, r & 15, (r >> 4) & 15, q0, h);
    run(&maps.do_map, (r >> 8) & 15, (r >> 12) & 15, q0, h);
    run(&maps.do_map, (r >> 16) & 15, (r >> 20) & 15, q0, h);
    run(&maps.q_map, (r >> 24) & 15, r >> 28, q0, h);
  }
}

// Consumer CW (0: dK, 1: dV) of a block; CW and SPLIT are template
// arguments so that no branch around a wgmma depends on the thread (ptxas
// serializes wgmma on a path it cannot prove uniform).
template <typename T, int CW, bool SPLIT>
__device__ __forceinline__ void consume(const VarlenBwdParams& p, int stages, const Smem& sm,
                                        const Work& w) {
  const int ni = w.ni, i_lo = w.i_lo, kvh = w.kvh, kv0 = w.kv0;
  constexpr int cw = CW;  // 0: dK, Q columns 0..31; 1: dV, 32..63
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // The pass's dK (dim 0) or dV (dim 1) columns: one block holds them from
  // w; a rank of the cluster forms them where they are used (held across
  // the walk beside the exchange's values, they spilled).
  auto cols = [&](int dim) -> Cols {
    if constexpr (SPLIT) return split_pass_cols(p, dim);
    return dim ? w.vc : w.dc;
  };
  constexpr float LOG2E = 1.4426950408889634f;
  const float scale_log2 = p.scale * LOG2E;
  // No feature that changes a kept element's p: a full block skips the mask.
  const bool plain = p.alibi == nullptr && p.softcap <= 0.f && p.window_left < 0;
  // The block's D or Dv boxes: all of them alone; split, its rank's half,
  // formed where it is used from the rank the hardware reports (a rank's
  // values held across the walk cost registers beside the accumulator).
  auto boxes = [&](int dim) -> int {
    if constexpr (SPLIT) return col_block(dim / COLS, 2, (int)cluster_rank()).nc;
    return dim / COLS;
  };

  float acc[PASS_BOXES * 32];
#pragma unroll
  for (int i = 0; i < PASS_BOXES * 32; ++i) acc[i] = 0.f;

  // it: the stream's stage index; held: a stage whose products may still
  // run. done_with frees the stage before once this one's products are
  // issued and the older ones completed (one group stays in flight).
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
  // S^T or dP^T: this warpgroup's 32 Q columns of each of n resident boxes,
  // a stage's boxes in one wgmma group. The stages of two boxes, then an
  // odd last box alone: a conditional wgmma inside a stage makes ptxas
  // serialize.
  auto stream = [&](float(&a)[16], const unsigned char* res, int n) {
    int c = 0;
    for (; c + 2 <= n; c += 2, ++it) {
      const int st = it % stages;
      const unsigned char* sb = sm.ring + st * STAGE_BYTES + cw * 4096;
      mbar_wait(&sm.full[st], (it / stages) & 1);
      wgmma_fence();
      box_mma<T, 32, 0>(a, res + c * BOX_BYTES, sb, c == 0);
      box_mma<T, 32, 0>(a, res + (c + 1) * BOX_BYTES, sb + BOX_BYTES);
      done_with(st);
    }
    if (c < n) {
      const int st = it % stages;
      mbar_wait(&sm.full[st], (it / stages) & 1);
      wgmma_fence();
      box_mma<T, 32, 0>(a, res + c * BOX_BYTES, sm.ring + st * STAGE_BYTES + cw * 4096, c == 0);
      done_with(st);
      ++it;
    }
  };
  // Split: element 4 i + e of thread tid's partial sits at (i * 128 + tid)
  // * 16 + 4 e bytes of its consumer's S^T slot, and as far into the dP^T
  // slot PART_BYTES on; a thread reads back what the partner's thread tid
  // stored. The addresses are formed where they are used.
  auto slot = [&]() { return cvta_smem(sm.part) + CW * 2 * PART_BYTES + tid * 16; };
  // This rank's partial a (zeros where the rank holds no box of the
  // product) into the partner's slot at off.
  auto send = [&](float(&a)[16], int n, uint32_t off) {
    const uint32_t partner = cluster_rank() ^ 1u;
    const uint32_t there = mapa(slot() + off, partner);
    const uint32_t there_bar = mapa(cvta_smem(&sm.part_full[CW]), partner);
#pragma unroll
    for (int i = 0; i < 16; ++i) a[i] = n > 0 ? a[i] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) st_async_v4(there + i * 2048, a + 4 * i, there_bar);
  };

  mbar_wait(sm.kv_full, 0);
  // The walk, group member outer, Q tiles inner: q-head h, Q rows q0; the
  // interval's rows are [q_end - span, q_end). (A tile count divided by ni
  // kept i_lo live across the products, and it spilled.) Split, the parity
  // of the exchange's barriers flips each tile.
  const int span = ni * QROWS;
  const int h_end = (kvh + 1) * p.group;
  int h = kvh * p.group, q0 = i_lo * QROWS;
  const int q_end = q0 + span;
  uint32_t phase = 0;
  for (; h < h_end;) {
    const int qc = q0 + 32 * cw;  // this consumer's first Q column
    // lse and delta of this thread's 8 Q columns: qc + 8 jj + 2 t4 + e.
    // One block loads them once a tile, before the products; a rank of the
    // cluster a column group's where the group uses them (group_rows: held
    // across the products and the exchange, they spilled).
    float lse_r[8], dl_r[8];
    auto load_rows = [&](int jj, int col) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = col + e < p.tq;
        lse_r[2 * jj + e] = ok ? p.lse[(long long)h * p.tq + col + e] : 0.f;
        dl_r[2 * jj + e] = ok ? p.delta[(long long)h * p.tq + col + e] : 0.f;
      }
    };
    if constexpr (!SPLIT) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) load_rows(jj, qc + 8 * jj + 2 * t4);
    }
    float s[16], dp[16];
    stream(s, sm.k, boxes(p.D));
    if constexpr (SPLIT) {
      drain();
      fence_operands(s);
      // The partner has read the tile before's partials (at the first tile
      // the wait for parity 1 of a fresh barrier returns at once). S^T goes
      // out before the dP^T products, so its bytes travel under them.
      mbar_wait_cluster(&sm.part_free[CW], phase ^ 1u);
      send(s, boxes(p.D), 0);
    }
    stream(dp, sm.v, boxes(p.Dv));
    drain();
    fence_operands(s);
    fence_operands(dp);

    if constexpr (SPLIT) {
      // S^T and dP^T = this rank's partials + the partner's, the same bits
      // in both ranks.
      send(dp, boxes(p.Dv), PART_BYTES);
      mbar_arrive_expect_tx_if(&sm.part_full[CW], 2 * PART_BYTES, tid == 0);
      mbar_wait_cluster(&sm.part_full[CW], phase);
      const uint32_t mine = slot();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x[4], y[4];
        lds_v4(mine + i * 2048, x);
        lds_v4(mine + PART_BYTES + i * 2048, y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * i + e] += x[e];
          dp[4 * i + e] += y[e];
        }
      }
      mbar_arrive_cluster(mapa(cvta_smem(&sm.part_free[CW]), cluster_rank() ^ 1u));
      fence_operands(s);
      fence_operands(dp);
      phase ^= 1u;
    }

    // The other consumer is done with the previous tile's P and dS boxes
    // (its products completed), so each pair of P and dS goes there as it
    // is computed: no register holds them.
    named_barrier_sync(1, 2 * 128);
    // P and dS at the accumulator's (kv, q) coordinates: element 4 jj + 2 hh
    // + e is KV row 16 warp + g + 8 hh, Q column qc + 8 jj + 2 t4 + e. The
    // full-block test reads the same words in every thread of the
    // warpgroup. The metadata is read per tile (from L1), its addresses
    // formed from a KV row the empty asm hides, so that none is hoisted out
    // of the walk and held (or spilled) beside the accumulator.
    int kv_first = kv0;
    asm volatile("" : "+r"(kv_first));
    const int ks = __ldg(p.k_seg + kv_first);
    const bool full_block =
        plain && ks >= 0 && __ldg(p.k_seg + kv_first + ROWS - 1) == ks &&
        __ldg(p.q_seg + qc) == ks && __ldg(p.q_seg + qc + 31) == ks &&
        (p.window_right < 0 ||
         __ldg(p.k_pos + kv_first + ROWS - 1) <= __ldg(p.q_rank + qc) + p.window_right);
    // Split: column group jj's rows, loaded after the empty asm ties the
    // group's scores, so no load is hoisted ahead of the groups before.
    auto group_rows = [&](int jj) {
      if constexpr (SPLIT) {
        int col = qc + 8 * jj + 2 * t4;
        asm volatile("" : "+f"(s[4 * jj]), "+f"(s[4 * jj + 1]), "+f"(s[4 * jj + 2]),
                     "+f"(s[4 * jj + 3]), "+r"(col));
        load_rows(jj, col);
      }
    };
    if (full_block) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        group_rows(jj);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float pv[2], dsv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * jj + 2 * hh + e;
            pv[e] = exp2f(fmaf(s[idx], scale_log2, -lse_r[2 * jj + e] * LOG2E));
            dsv[e] = pv[e] * (dp[idx] - dl_r[2 * jj + e]);
          }
          const uint32_t off = swz(16 * warp + g + 8 * hh, 32 * cw + 8 * jj + 2 * t4);
          *reinterpret_cast<uint32_t*>(sm.p + off) = pack2<T>(pv[0], pv[1]);
          *reinterpret_cast<uint32_t*>(sm.ds + off) = pack2<T>(dsv[0], dsv[1]);
        }
      }
    } else {
      const float slope = p.alibi != nullptr ? p.alibi[h] : 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        group_rows(jj);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          // One pair at a time: the empty asm ties the pair's scores and
          // its first column and KV row, so nothing of a pair (the
          // metadata loads and their addresses) is computed ahead of the
          // pairs before, and the mask's registers are needed once, not 16
          // times beside the 128 of the accumulator.
          const int i0 = 4 * jj + 2 * hh;
          int col = qc + 8 * jj + 2 * t4, row = kv0 + 16 * warp + g + 8 * hh;
          asm volatile("" : "+f"(s[i0]), "+f"(s[i0 + 1]), "+f"(dp[i0]), "+f"(dp[i0 + 1]),
                       "+r"(col), "+r"(row));
          const int ks = __ldg(p.k_seg + row), kp = __ldg(p.k_pos + row);
          float pv[2], dsv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qr = __ldg(p.q_rank + col + e);
            const Prob pr = score_prob(p, keeps(p, __ldg(p.q_seg + col + e), qr, ks, kp),
                                       s[i0 + e], lse_r[2 * jj + e], slope, qr - kp);
            pv[e] = pr.p;
            dsv[e] = pr.p * pr.cap * (dp[i0 + e] - dl_r[2 * jj + e]);
          }
          const uint32_t off = swz(16 * warp + g + 8 * hh, 32 * cw + 8 * jj + 2 * t4);
          *reinterpret_cast<uint32_t*>(sm.p + off) = pack2<T>(pv[0], pv[1]);
          *reinterpret_cast<uint32_t*>(sm.ds + off) = pack2<T>(dsv[0], dsv[1]);
        }
      }
    }
    fence_proxy_async();
    named_barrier_sync(1, 2 * 128);

    // dV += P^T dO (consumer 1) over the pass's dO boxes, which come first,
    // and dK += dS^T Q (consumer 0) over its Q boxes; each frees the other's
    // boxes as they arrive. The accumulator box of each product is fixed at
    // compile time.
    auto skip = [&](int n) {  // the stages of n boxes
      for (int c = 0; c < n; c += STAGE_BOXES, ++it) {
        const int st = it % stages;
        mbar_wait(&sm.full[st], (it / stages) & 1);
        release(st, true);
      }
    };
    if constexpr (CW == 0) skip(cols(1).nc);
    const unsigned char* a_box = CW == 0 ? sm.ds : sm.p;
    const int own = cols(CW).nc;  // boxes of this consumer's product
#pragma unroll
    for (int jj = 0; jj < PASS_BOXES; jj += 2) {
      if (jj + 2 <= own) {
        const int st = it % stages;
        mbar_wait(&sm.full[st], (it / stages) & 1);
        wgmma_fence();
        box_mma<T, 64, 1>(*reinterpret_cast<float(*)[32]>(acc + 32 * jj), a_box,
                          sm.ring + st * STAGE_BYTES);
        box_mma<T, 64, 1>(*reinterpret_cast<float(*)[32]>(acc + 32 * (jj + 1)), a_box,
                          sm.ring + st * STAGE_BYTES + BOX_BYTES);
        done_with(st);
        ++it;
      } else if (jj < own) {
        const int st = it % stages;
        mbar_wait(&sm.full[st], (it / stages) & 1);
        wgmma_fence();
        box_mma<T, 64, 1>(*reinterpret_cast<float(*)[32]>(acc + 32 * jj), a_box,
                          sm.ring + st * STAGE_BYTES);
        done_with(st);
        ++it;
      }
    }
    if constexpr (CW == 1) skip(cols(0).nc);
    drain();
    q0 += QROWS;
    if (q0 == q_end) {
      q0 -= span;
      ++h;
    }
  }
  fence_operands(acc);

  // Epilogue: dK = scale * sum (consumer 0) or dV (consumer 1), packed
  // [Tk, Hkv, D|Dv], this block's columns; rows past Tk are not stored.
  const Cols out_cols = cols(CW);
  const int ld = cw == 0 ? p.D : p.Dv;
  const float mul = cw == 0 ? p.scale : 1.f;
  void* out = cw == 0 ? p.dk : p.dv;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kv = kv0 + 16 * warp + g + 8 * hh;
    if (kv >= p.tk) continue;
    const long long base = ((long long)kv * p.Hkv + kvh) * ld + out_cols.c0 + 2 * t4;
#pragma unroll
    for (int jj = 0; jj < PASS_BOXES; ++jj) {
      if (jj >= out_cols.nc) break;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8)
        store2<T>(out, base + 64 * jj + 8 * j8, acc[32 * jj + 4 * j8 + 2 * hh] * mul,
                  acc[32 * jj + 4 * j8 + 2 * hh + 1] * mul, 0);
    }
  }
}

template <typename T, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
    varlen_dkdv_wgmma_kernel(const __grid_constant__ Maps maps, const VarlenBwdParams p,
                             const int stages) {
  extern __shared__ unsigned char smem_raw[];
  // Boxes on 1024 B boundaries: the 128 B swizzle's atom. The offset is
  // added to smem_raw itself, so the compiler keeps every pointer below in
  // the shared space (32-bit) rather than generic (64-bit, two registers).
  unsigned char* base = smem_raw + ((1024u - (cvta_smem(smem_raw) & 1023u)) & 1023u);
  const Part lay = part_of(p.D / COLS, p.Dv / COLS, SPLIT, 0);  // both ranks alike
  const Smem sm = carve<SPLIT>(base, lay.nd, lay.nv, stages);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMER_WARPS);
    }
    mbar_init(sm.kv_full, 1);
    if constexpr (SPLIT)
      for (int c = 0; c < 2; ++c) {
        mbar_init(&sm.part_full[c], 1);
        mbar_init(&sm.part_free[c], CONSUMER_THREADS);
      }
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
    if (threadIdx.x == 0) produce(maps, p, sm, stages, work_of<SPLIT>(p));
  } else {
    setmaxnreg_inc<240>();
    const Work w = work_of<SPLIT>(p);
    if (threadIdx.x < 256)
      consume<T, 0, SPLIT>(p, stages, sm, w);
    else
      consume<T, 1, SPLIT>(p, stages, sm, w);
  }
  if constexpr (SPLIT) cluster_sync();  // the partner may still store or arrive into this block
}

// The tensor maps of a launch over the packed layout: dims (D, T, H),
// strides in bytes, extents at the true Tq and Tk, 64 x 64 boxes.
inline cudaError_t encode_maps(const VarlenBwdParams& bp, bool f16, Maps* maps) {
  memset(maps, 0, sizeof(*maps));
  const uint64_t mq = bp.tq > 0 ? bp.tq : 1, mkv = bp.tk > 0 ? bp.tk : 1;
  cudaError_t e = encode_3d(&maps->q_map, f16, bp.q, bp.D, mq, bp.Hq, (uint64_t)bp.q_rs * 2,
                            (uint64_t)bp.q_hs * 2, COLS, QROWS);
  if (e == cudaSuccess)
    e = encode_3d(&maps->do_map, f16, bp.dout, bp.Dv, mq, bp.Hq, (uint64_t)bp.do_rs * 2,
                  (uint64_t)bp.do_hs * 2, COLS, QROWS);
  if (e == cudaSuccess)
    e = encode_3d(&maps->k_map, f16, bp.k, bp.D, mkv, bp.Hkv, (uint64_t)bp.k_rs * 2,
                  (uint64_t)bp.k_hs * 2, COLS, ROWS);
  if (e == cudaSuccess)
    e = encode_3d(&maps->v_map, f16, bp.v, bp.Dv, mkv, bp.Hkv, (uint64_t)bp.v_rs * 2,
                  (uint64_t)bp.v_hs * 2, COLS, ROWS);
  return e;
}

// The host side of one dK/dV launch: tensor maps, shared memory, the grid
// (passes x KV heads, for the split the cluster of two along x; KV tiles).
template <typename T, bool SPLIT>
cudaError_t launch(const VarlenBwdParams& bp, const Plan& pl, int num_kv_tiles,
                   cudaStream_t stream) {
  Maps maps;
  VarlenBwdParams p = bp;
  p.col_passes = pl.passes;
  cudaError_t e = encode_maps(bp, std::is_same<T, __half>::value, &maps);
  if (e != cudaSuccess) return e;
  const dim3 grid((SPLIT ? 2 : 1) * pl.passes * bp.Hkv, num_kv_tiles);
  auto kern = varlen_dkdv_wgmma_kernel<T, SPLIT>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (e != cudaSuccess) return e;
  if (grid.x * grid.y == 0) return cudaSuccess;
  if constexpr (SPLIT) {
    return launch_cluster(kern, grid, THREADS, pl.smem, stream, 2, maps, p, pl.stages);
  } else {
    kern<<<grid, THREADS, pl.smem, stream>>>(maps, p, pl.stages);
    return cudaGetLastError();
  }
}

template <bool SPLIT>
cudaError_t launch_typed(bool f16, const VarlenBwdParams& p, const Plan& pl, int num_kv_tiles,
                         cudaStream_t stream) {
  return f16 ? launch<__half, SPLIT>(p, pl, num_kv_tiles, stream)
             : launch<__nv_bfloat16, SPLIT>(p, pl, num_kv_tiles, stream);
}

// ---------------------------------------------------------------------------
// dQ: TMA + mbarrier + wgmma, one block (D, Dv <= 512) or a cluster of two
// (D or Dv in (512, 1024])
// ---------------------------------------------------------------------------

// ffpa_varlen_bwd_dq's kernel: the dense recompute dQ block (flash_bwd.cu
// namespace dq) over the packed layout, on a 64 x 64 walk (varlen_fwd.cu
// namespace tma; the forward saves it at D, Dv <= 512, the backward
// computes it above). The mma.sync block it replaced owned block_q rows,
// ran m16n8k16 products from ldmatrix fragments with a block barrier after
// every 64-column chunk of its cp.async ring (no product in flight during
// a barrier), and walked every KV tile of its Q tile's interval: at D512
// 2.13 ms at the packed-training packing on an H100, 16x its bound, where
// one block of this design reads 0.65 ms, 4.9x; above D512 (32-row tiles)
// 6.63 ms, 25x, at 8 documents in 8192 tokens H8/4 D1024 (PERF.md). Here
// 384 threads own 64 Q rows of one query head:
//  - warpgroup 0 is the producer (setmaxnreg 24). One thread loads Q and dO
//    once by TMA into 64 x 64 resident boxes (128 B swizzle; 3-D maps (D,
//    T, H) with the row and head strides at the true Tq and Tk, so the
//    ragged tail reads as zero), then per listed KV tile streams the K
//    boxes (for S) and the V boxes (for dP) in two-box stages, then the K
//    boxes again (for dQ), box j of consumer 0's share of D beside box j of
//    consumer 1's: one stage feeds both dQ products;
//  - warpgroups 1 and 2 are the consumers (setmaxnreg 240). Consumer c
//    computes S = Q K^T and dP = dO V^T for KV columns 32c..32c+31
//    (wgmma m64n32k16), forms dS = P (dP - delta) in registers (softcap's
//    factor included), rounds it to the input type into its 32 columns of
//    one swizzled [q][kv] exchange box and, after a named barrier, runs
//    dQ[:, own share of D] += dS K (m64n64k16 a box; 128 fp32 registers a
//    thread at a share of 256 columns);
//  - the walk: a Q tile visits only the KV tiles its row of
//    _needed_tiles(_tile_needed(..., 64, 64)) lists. The grid is (Hq, Q
//    tiles): the heads of a Q tile side by side, so a GQA group's K and V
//    stay in L2, and the Q tiles most needed first. A Q tile with no listed
//    tile loads nothing (not even Q) and stores dQ = 0;
//  - a consumer's 64 x 32 block inside one segment's band with no softcap,
//    ALiBi or left window is full (the forward's test: varlen._full_blocks
//    at 64 x 32) and takes p = exp(s scale - lse) alone. Any other block
//    masks element by element: P is selected to 0 where the mask drops the
//    pair (a row with no key has lse = MASK_VALUE + log(1e-38), where
//    exp(s scale - lse) overflows), its metadata read from L1 through
//    addresses formed from an index hidden behind an empty asm, so none is
//    hoisted and held beside dQ. Scores stay in natural units until the
//    exponent (MASK_VALUE * log2 e is -inf).
// Two named barriers a tile order the exchange box, as in the dense block.
// ptxas keeps the wgmma pipeline because products start with scale-d 0,
// roles are template arguments, each stage's products are committed in
// their own block, stage releases are predicated arrivals and the zeros of
// dQ are fenced off from its products.
//
// D, Dv <= 512 (SPLIT false): one block holds all of D and Dv, 5 stages at
// D = Dv = 512.
//
// Wider heads (SPLIT true, D or Dv in (512, 1024]): Q and dO of 64 rows at
// D1024 (256 KB) fit no block, and a 64 x 512 fp32 dQ half is all a
// consumer's registers hold, so a cluster of two blocks (grid x = 2 Hq, the
// pair adjacent in x: the same block order) owns the 64 Q rows and splits
// both head dims, as the dense dQ cluster does: rank r holds the Q boxes of
// its half of D and the dO boxes of its half of Dv, resident (rank 0 the
// larger half; sm90.cuh col_block), and per listed KV tile streams only its
// K boxes (for S), its V boxes (for dP) and its K boxes again (for dQ), so
// every byte of Q, dO, K and V is read once per cluster. Consumer c of each
// rank computes a partial S over its rank's D boxes and a partial dP over
// its Dv boxes (64 x 32 fp32, 8 KB each), stores both into the shared
// memory of the partner's consumer c (st.async, completing their bytes on
// the partner's barrier; S as soon as its products complete, so its bytes
// travel under the dP products) and adds the partner's partials to its
// own. fp32 addition of two values is commutative, so both ranks hold
// bit-identical S and dP, and so the same P, full-block test (the same
// metadata words) and dS, with no further exchange. Each rank writes the
// whole dS box, runs dQ[:, its half of D] += dS K over its own K boxes
// (consumer c owning ceil or floor of the rank's boxes, at most 4) and
// stores its own dQ columns. The exchange has one slot (3 stages at D = Dv
// = 1024; the arithmetic is beside make_dq_plan), so a rank stores tile t's
// partials only after the partner has read tile t - 1's: each thread that
// read its share of the slot arrives on the partner's "free" barrier (a
// remote arrive, release at cluster scope), which the storing consumer
// waits on with acquire. Both ranks walk the same list (the same Q tile's
// row of the schedule). A rank may hold no D box (D64 / Dv1024) or no Dv
// box (D1024 / Dv64): it sends zero partials of that product and, without
// D boxes, owns no dQ columns. A Q tile with no listed KV tile exchanges
// nothing; both ranks store zeros. The cluster barrier at the start
// publishes the barriers' initialisation, the one at the end keeps a block
// alive while its partner may still store or arrive into it.
constexpr int DQ_MAX_STAGES = 8;
constexpr int DQ_BOXES = MAX_BOXES / 2;  // D boxes of one consumer's dQ: 64 x 256 fp32
// The exchange's slot (2 consumers x (S + dP) x PART_BYTES: a 64 x 32 fp32
// partial is as large as dK/dV's) and its 4 barriers (landed and free, per
// consumer), padded to a 1024 B atom: on the cluster route they lead the
// layout, at offsets the compiler knows.
constexpr int DQ_XCH_BYTES = PART_BUF_BYTES + 1024;

// Shared memory of a dQ block laid out for nd Q boxes and nv dO boxes,
// apart from the ring: Q, dO, the dS box, the 1024 B alignment, Q's
// barrier and, split, the exchange's slot and barriers.
inline size_t dq_fixed_bytes(int nd, int nv, bool split) {
  return (size_t)(nd + nv + 1) * BOX_BYTES + 1024 + sizeof(uint64_t) +
         (split ? DQ_XCH_BYTES : 0);
}

// The route and tiling of a dQ launch at head dims (D, Dv), multiples of
// 64 up to 1024: the dense dQ plan (flash_bwd.cu dq::make_plan). D, Dv <=
// 512 take one block, wider heads the cluster; within a block (a rank)
// consumer 0 owns the first ceil(nd / 2) of its nd D boxes of dQ and
// consumer 1 the rest, with as many ring stages (at most 8) as shared
// memory holds beside the rest: 5 at D = Dv = 512. Both ranks of a cluster
// lay out rank 0's share. At D = Dv = 1024 a rank's Q and dO take 16 boxes
// (128 KB), the dS box 8 KB and the exchange's slot 32 KB with its
// barriers in a 1 KB atom: with the alignment and Q's barrier 174,088 B,
// and 3 stages of 16,400 B make 223,288 of the 232,448 a block may ask
// for. The segment metadata and the tile lists are read from device memory
// and cost no shared memory. ffpa_varlen_bwd_dq_plan hands the plan out;
// ops/config.py varlen_dq_plan mirrors it (it is dq_plan) and the card
// test holds the two equal.
struct DqPlan {
  int route, stages;
  Part part[2];  // each rank's share (the lone block's is part[0])
  size_t smem;
};
inline DqPlan make_dq_plan(int D, int Dv) {
  const int nd = D / COLS, nv = Dv / COLS;
  const bool split = nd > MAX_BOXES || nv > MAX_BOXES;
  DqPlan pl;
  pl.route = split ? CLUSTER : WGMMA;
  pl.part[0] = part_of(nd, nv, split, 0);
  pl.part[1] = part_of(nd, nv, split, 1);
  const size_t fixed = dq_fixed_bytes(pl.part[0].nd, pl.part[0].nv, split);
  pl.stages = (int)std::min((size_t)DQ_MAX_STAGES, (SMEM_LIMIT - fixed) / STAGE_SMEM);
  pl.smem = fixed + pl.stages * STAGE_SMEM;
  return pl;
}

// Shared memory of a dQ block, from a 1024 B boundary: split, the
// exchange's slot and its barriers (an atom); the Q boxes, the dO boxes,
// the dS box, the ring's stages, their full / empty barriers and the
// barrier of Q and dO. The exchange leads so that its addresses are
// constant offsets from the base (as in the dense dQ cluster). Both ranks
// of a cluster lay it out alike (for rank 0's share), so an offset here is
// the same offset in the partner.
struct DqSmem {
  unsigned char* q;
  unsigned char* dout;
  unsigned char* ds;    // dS (softcap's factor included): [q][kv]
  unsigned char* ring;
  unsigned char* part;  // [2][2][PART_BYTES]: consumer c's partial S, dP from the partner
  uint64_t* full;
  uint64_t* empty;
  uint64_t* q_full;
  uint64_t* part_full;  // [2]: the partner's partials for consumer c have landed
  uint64_t* part_free;  // [2]: the partner's consumer c has read the partials sent to it
};
template <bool SPLIT>
__device__ __forceinline__ DqSmem dq_carve(unsigned char* base, int nd, int nv, int stages) {
  DqSmem sm;
  sm.part = base;
  sm.part_full = reinterpret_cast<uint64_t*>(base + PART_BUF_BYTES);
  sm.part_free = sm.part_full + 2;
  sm.q = base + (SPLIT ? DQ_XCH_BYTES : 0);
  sm.dout = sm.q + nd * BOX_BYTES;
  sm.ds = sm.dout + nv * BOX_BYTES;
  sm.ring = sm.ds + BOX_BYTES;
  sm.full = reinterpret_cast<uint64_t*>(sm.ring + stages * STAGE_BYTES);
  sm.empty = sm.full + stages;
  sm.q_full = sm.empty + stages;
  return sm;
}

// A dQ block's query head, its Q tile's first row, and its walk: entries
// [first, first + n) of p.tiles. The same in every thread and in both
// ranks of a cluster.
struct DqBlock {
  int head, row0, first, n;
};

// The producer's thread: its Q and dO boxes once, then per listed KV tile
// the stages of its K boxes and of its V boxes (two boxes each, an odd last
// box alone), then the dQ stages (K box j of consumer 0's share beside box
// nd0 + j of consumer 1's, alone where that share is shorter).
__device__ __forceinline__ void dq_produce(const Maps& maps, const VarlenBwdParams& p,
                                           const DqSmem& sm, const DqBlock& k, int stages,
                                           const Part& pt, int nd0) {
  prefetch_map(&maps.q_map);
  prefetch_map(&maps.do_map);
  prefetch_map(&maps.k_map);
  prefetch_map(&maps.v_map);
  const int kvh = k.head / p.group;
  mbar_arrive_expect_tx(sm.q_full, (pt.nd + pt.nv) * BOX_BYTES);
  for (int j = 0; j < pt.nd; ++j)
    tma_load_3d(sm.q + j * BOX_BYTES, &maps.q_map, sm.q_full, (pt.d0 + j) * COLS, k.row0,
                k.head);
  for (int j = 0; j < pt.nv; ++j)
    tma_load_3d(sm.dout + j * BOX_BYTES, &maps.do_map, sm.q_full, (pt.v0 + j) * COLS, k.row0,
                k.head);
  int it = 0;
  // Stage it % stages, free again, expecting nb boxes.
  auto claim = [&](int nb) -> unsigned char* {
    const int st = it % stages;
    if (it >= stages) mbar_wait(&sm.empty[st], ((it / stages) - 1) & 1);
    mbar_arrive_expect_tx(&sm.full[st], nb * BOX_BYTES);
    return sm.ring + st * STAGE_BYTES;
  };
  auto run = [&](const CUtensorMap* map, int first, int n, int kv0) {
    for (int c = 0; c < n; c += STAGE_BOXES, ++it) {
      const int nb = min(STAGE_BOXES, n - c);
      unsigned char* dst = claim(nb);
      for (int b = 0; b < nb; ++b)
        tma_load_3d(dst + b * BOX_BYTES, map, &sm.full[it % stages], (first + c + b) * COLS, kv0,
                    kvh);
    }
  };
  for (int t = 0; t < k.n; ++t) {
    const int kv0 = __ldg(p.tiles + k.first + t) * ROWS;
    run(&maps.k_map, pt.d0, pt.nd, kv0);
    run(&maps.v_map, pt.v0, pt.nv, kv0);
    for (int j = 0; j < nd0; ++j, ++it) {
      const bool both = nd0 + j < pt.nd;
      unsigned char* dst = claim(both ? 2 : 1);
      tma_load_3d(dst, &maps.k_map, &sm.full[it % stages], (pt.d0 + j) * COLS, kv0, kvh);
      if (both)
        tma_load_3d(dst + BOX_BYTES, &maps.k_map, &sm.full[it % stages],
                    (pt.d0 + nd0 + j) * COLS, kv0, kvh);
    }
  }
}

// Consumer C of a dQ block; C and SPLIT are template arguments so that no
// branch around a wgmma depends on the thread. Accumulator element 4 j + 2
// hh + e of thread (warp, g = lane / 4, t4 = lane % 4) of S and dP is Q
// row 16 warp + g + 8 hh, KV column 32 C + 8 j + 2 t4 + e of the tile; of
// dQ's box jj, Q row 16 warp + g + 8 hh, column 8 j + 2 t4 + e of the box.
// pt is the block's share of the head dims, nd0 consumer 0's D boxes of
// it, rank the block's rank (0 alone).
template <typename T, int C, bool SPLIT>
__device__ __forceinline__ void dq_consume(const VarlenBwdParams& p, const DqSmem& sm,
                                           const DqBlock& k, int stages, const Part& pt, int nd0,
                                           int rank) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // The block's box counts (D, Dv, consumer 0's D boxes) and its rank. One
  // block reads them as they are; a rank of the cluster from one register
  // unpacked behind an empty asm where they are used, so the rank's values
  // are not held apart beside the dQ accumulators (the dense dQ cluster
  // spilled so).
  const uint32_t counts = pt.nd | pt.nv << 8 | nd0 << 16 | rank << 24;
  auto count = [&](int field) -> int {
    if constexpr (SPLIT) {
      uint32_t x = counts;
      asm volatile("" : "+r"(x));
      return (int)((x >> (8 * field)) & 255u);
    }
    return field == 0 ? pt.nd : field == 1 ? pt.nv : field == 2 ? nd0 : 0;
  };
  const int r0 = 16 * warp + g;  // this thread's rows: r0, r0 + 8
  constexpr float LOG2E = 1.4426950408889634f;
  // No feature that changes a kept element's p: a full block skips the mask.
  const bool plain = p.alibi == nullptr && p.softcap <= 0.f && p.window_left < 0;
  // Split: element 4 i + e of thread tid's partial S sits at (i * 128 +
  // tid) * 16 + 4 e bytes of its consumer's S slot, and its partial dP as
  // far into the dP slot PART_BYTES on; a thread reads back what the
  // partner's thread tid stored. The addresses are formed where they are
  // used, at constant offsets from the base.
  auto slot = [&]() { return cvta_smem(sm.part) + C * 2 * PART_BYTES + tid * 16; };

  // lse and delta of this thread's two rows; rows past Tq keep no key. One
  // block loads them once for its walk; a rank of the cluster at each tile,
  // after the exchange (held across the walk, the dense cluster's spilled).
  float lse[2], dl[2];
  auto load_rows = [&]() {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = k.row0 + r0 + 8 * hh;
      const bool ok = row < p.tq;
      lse[hh] = ok ? p.lse[(long long)k.head * p.tq + row] : 0.f;
      dl[hh] = ok ? p.delta[(long long)k.head * p.tq + row] : 0.f;
    }
  };
  if constexpr (!SPLIT) load_rows();

  // Every ordinary write of an accumulator is fenced off from the wgmma
  // that follows, or ptxas serializes the pipeline.
  float acc[DQ_BOXES * 32];
#pragma unroll
  for (int i = 0; i < DQ_BOXES * 32; ++i) acc[i] = 0.f;
  fence_operands(acc);

  // it: the stream's stage index; held: a stage whose products may still
  // run. done_with frees the stage before once this one's products are
  // issued and the older ones completed (one group stays in flight).
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
  auto wait_full = [&](int st) { mbar_wait(&sm.full[st], (it / stages) & 1); };
  // S or dP for this consumer's 32 KV columns over n resident boxes: the
  // stages of two boxes, then an odd last box alone (a conditional wgmma
  // inside a stage would make ptxas serialize), each committed beside its
  // products.
  auto stream = [&](float(&a)[16], const unsigned char* res, int n) {
    int c = 0;
    for (; c + 2 <= n; c += 2, ++it) {
      const int st = it % stages;
      const unsigned char* sb = sm.ring + st * STAGE_BYTES + C * 4096;
      wait_full(st);
      wgmma_fence();
      box_mma<T, 32, 0>(a, res + c * BOX_BYTES, sb, c == 0);
      box_mma<T, 32, 0>(a, res + (c + 1) * BOX_BYTES, sb + BOX_BYTES);
      done_with(st);
    }
    if (c < n) {
      const int st = it % stages;
      wait_full(st);
      wgmma_fence();
      box_mma<T, 32, 0>(a, res + c * BOX_BYTES, sm.ring + st * STAGE_BYTES + C * 4096, c == 0);
      done_with(st);
      ++it;
    }
  };
  // Split: this rank's partial a (zeros where the rank holds no box of the
  // product) into the partner's slot at off.
  auto send = [&](float(&a)[16], int n, uint32_t off) {
    const uint32_t there = mapa(slot() + off, count(3) ^ 1);
    const uint32_t there_bar = mapa(cvta_smem(&sm.part_full[C]), count(3) ^ 1);
#pragma unroll
    for (int i = 0; i < 16; ++i) a[i] = n > 0 ? a[i] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) st_async_v4(there + i * 2048, a + 4 * i, there_bar);
  };

  if (k.n > 0) mbar_wait(sm.q_full, 0);
  for (int t = 0; t < k.n; ++t) {
    // This consumer's first KV column, from the list entry of the tile.
    int idx = k.first + t;
    asm volatile("" : "+r"(idx));
    const int kc = __ldg(p.tiles + idx) * ROWS + 32 * C;
    float s[16], dp[16];
    stream(s, sm.q, count(0));
    if constexpr (SPLIT) {
      drain();  // also completes this consumer's dQ products of the tile before
      fence_operands(s);
      // The partner has read tile t - 1's partials (at t = 0 the wait for
      // parity 1 of a fresh barrier returns at once). S goes out before
      // the dP products, so its bytes travel under them.
      mbar_wait_cluster(&sm.part_free[C], (t + 1) & 1);
      send(s, count(0), 0);
    }
    stream(dp, sm.dout, count(1));
    drain();  // also completes this consumer's dQ products of the tile before
    fence_operands(s);
    fence_operands(dp);

    if constexpr (SPLIT) {
      // S and dP = this rank's partials + the partner's, the same bits in
      // both ranks.
      send(dp, count(1), PART_BYTES);
      mbar_arrive_expect_tx_if(&sm.part_full[C], 2 * PART_BYTES, tid == 0);
      mbar_wait_cluster(&sm.part_full[C], t & 1);
      const uint32_t mine = slot();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x[4], y[4];
        lds_v4(mine + i * 2048, x);
        lds_v4(mine + PART_BYTES + i * 2048, y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * i + e] += x[e];
          dp[4 * i + e] += y[e];
        }
      }
      mbar_arrive_cluster(mapa(cvta_smem(&sm.part_free[C]), count(3) ^ 1));
      fence_operands(s);
      fence_operands(dp);
      load_rows();
    }

    // The full-block test reads the same six words in every thread (and in
    // both ranks), the rows' from an index the empty asm hides (else their
    // loads are hoisted out of the walk and held beside dQ).
    int q_first = k.row0;
    asm volatile("" : "+r"(q_first));
    const int ks = __ldg(p.k_seg + kc);
    const bool full =
        plain && ks >= 0 && __ldg(p.k_seg + kc + 31) == ks && __ldg(p.q_seg + q_first) == ks &&
        __ldg(p.q_seg + q_first + QROWS - 1) == ks &&
        (p.window_right < 0 ||
         __ldg(p.k_pos + kc + 31) <= __ldg(p.q_rank + q_first) + p.window_right);
    uint32_t dw[8];
    if (full) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float dsv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hh + e;
            dsv[e] = ex2((s[i] * p.scale - lse[hh]) * LOG2E) * (dp[i] - dl[hh]);
          }
          dw[2 * j + hh] = pack2<T>(dsv[0], dsv[1]);
        }
    } else {
      const float slope = p.alibi != nullptr ? __ldg(p.alibi + k.head) : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          // One pair at a time: the empty asm ties the pair's scores, its
          // first column and its row, so nothing of a pair (the metadata
          // loads and their addresses) is computed ahead of the pairs
          // before, and the mask's registers are needed once, not 8 times
          // beside the 128 of dQ.
          const int i0 = 4 * j + 2 * hh;
          int col = kc + 8 * j + 2 * t4, row = k.row0 + r0 + 8 * hh;
          asm volatile("" : "+f"(s[i0]), "+f"(s[i0 + 1]), "+f"(dp[i0]), "+f"(dp[i0 + 1]),
                       "+r"(col), "+r"(row));
          const int qs = __ldg(p.q_seg + row), qr = __ldg(p.q_rank + row);
          float dsv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = __ldg(p.k_pos + col + e);
            const Prob pr = score_prob(p, keeps(p, qs, qr, __ldg(p.k_seg + col + e), kp),
                                       s[i0 + e], lse[hh], slope, qr - kp);
            dsv[e] = pr.p * pr.cap * (dp[i0 + e] - dl[hh]);
          }
          dw[2 * j + hh] = pack2<T>(dsv[0], dsv[1]);
        }
    }
    // Both consumers have completed the tile before's dQ products: the dS
    // box is free.
    named_barrier_sync(1, 2 * 128);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(sm.ds + swz(r0 + 8 * hh, 32 * C + 8 * j + 2 * t4)) =
            dw[2 * j + hh];
    fence_proxy_async();
    named_barrier_sync(1, 2 * 128);  // both halves of dS are in the box

    // dQ[:, own boxes] += dS K: dQ stage j holds this consumer's K box j at
    // C * BOX_BYTES; a consumer with fewer boxes frees the stage unread.
    const int nd0_t = count(2), own = C == 0 ? nd0_t : count(0) - nd0_t;
#pragma unroll
    for (int j = 0; j < DQ_BOXES; ++j) {
      if (j < nd0_t) {
        const int st = it % stages;
        wait_full(st);
        if (j < own) {
          wgmma_fence();
          box_mma<T, 64, 1>(*reinterpret_cast<float(*)[32]>(acc + 32 * j), sm.ds,
                            sm.ring + st * STAGE_BYTES + C * BOX_BYTES);
          done_with(st);
        } else {
          release(st, true);
        }
        ++it;
      }
    }
  }
  drain();
  fence_operands(acc);

  // Epilogue: dQ = scale * sum, packed [Tq, Hq, D], this block's columns;
  // rows past Tq are not stored. A Q tile that walked nothing stores zeros.
  const int d0 = SPLIT ? col_block(p.D / COLS, 2, count(3)).c0 : 0;
  const int nd0_e = count(2), own = C == 0 ? nd0_e : count(0) - nd0_e;
  const int col0 = d0 + (C == 0 ? 0 : nd0_e * COLS);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = k.row0 + r0 + 8 * hh;
    if (row >= p.tq) continue;
    const long long base = ((long long)row * p.Hq + k.head) * p.D + col0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < DQ_BOXES; ++j) {
      if (j >= own) break;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8)
        store2<T>(p.dq, base + COLS * j + 8 * j8, acc[32 * j + 4 * j8 + 2 * hh] * p.scale,
                  acc[32 * j + 4 * j8 + 2 * hh + 1] * p.scale, 0);
    }
  }
}

template <typename T, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
    varlen_dq_wgmma_kernel(const __grid_constant__ Maps maps, const VarlenBwdParams p,
                           const int stages) {
  extern __shared__ unsigned char smem_raw[];
  // Boxes on 1024 B boundaries, the offset added to smem_raw itself (see
  // varlen_dkdv_wgmma_kernel).
  unsigned char* base = smem_raw + ((1024u - (cvta_smem(smem_raw) & 1023u)) & 1023u);
  const int rank = SPLIT ? (int)cluster_rank() : 0;
  const int nd = p.D / COLS, nv = p.Dv / COLS;
  const Part pt = part_of(nd, nv, SPLIT, rank);
  const Part lay = part_of(nd, nv, SPLIT, 0);  // both ranks alike
  const int nd0 = col_block(pt.nd, 2, 0).nc;
  const DqSmem sm = dq_carve<SPLIT>(base, lay.nd, lay.nv, stages);
  // Block order: the query heads of a Q tile side by side (on the cluster
  // route each head's two ranks adjacent), the Q tiles in the schedule's
  // order (most needed KV tiles first).
  const int tile = p.order[blockIdx.y];
  const DqBlock k = {SPLIT ? (int)(blockIdx.x >> 1) : (int)blockIdx.x, tile * QROWS,
                     tile * p.tiles_ld, p.ntile[tile]};
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMER_WARPS);
    }
    mbar_init(sm.q_full, 1);
    if constexpr (SPLIT)
      for (int c = 0; c < 2; ++c) {
        mbar_init(&sm.part_full[c], 1);
        mbar_init(&sm.part_free[c], CONSUMER_THREADS);
      }
    fence_barrier_init();
  }
  // The partner's barriers are initialised before this block's first
  // store into its shared memory. Every block of a cluster reaches both
  // cluster barriers, a Q tile with no listed KV tile too.
  if constexpr (SPLIT)
    cluster_sync();
  else
    __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    // A Q tile that needs no KV tile loads nothing (not even Q).
    if (threadIdx.x == 0 && k.n > 0) dq_produce(maps, p, sm, k, stages, pt, nd0);
  } else {
    setmaxnreg_inc<240>();
    if (threadIdx.x < 256)
      dq_consume<T, 0, SPLIT>(p, sm, k, stages, pt, nd0, rank);
    else
      dq_consume<T, 1, SPLIT>(p, sm, k, stages, pt, nd0, rank);
  }
  if constexpr (SPLIT) cluster_sync();  // the partner may still store or arrive into this block
}

// The host side of one dQ launch: tensor maps, shared memory, the grid
// (query heads, on the cluster route the pair of each head adjacent along
// x; Q tiles).
template <typename T, bool SPLIT>
cudaError_t dq_launch(const VarlenBwdParams& p, const DqPlan& pl, int num_q_tiles,
                      cudaStream_t stream) {
  const dim3 grid((SPLIT ? 2 : 1) * p.Hq, num_q_tiles);
  if (grid.x * grid.y == 0) return cudaSuccess;
  Maps maps;
  cudaError_t e = encode_maps(p, std::is_same<T, __half>::value, &maps);
  if (e != cudaSuccess) return e;
  auto kern = varlen_dq_wgmma_kernel<T, SPLIT>;
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
cudaError_t dq_launch_typed(bool f16, const VarlenBwdParams& p, const DqPlan& pl,
                            int num_q_tiles, cudaStream_t stream) {
  return f16 ? dq_launch<__half, SPLIT>(p, pl, num_q_tiles, stream)
             : dq_launch<__nv_bfloat16, SPLIT>(p, pl, num_q_tiles, stream);
}

}  // namespace tma

}  // namespace

// dK, dV [Tk, Hkv, D|Dv] in the input type, the GQA group reduced; the
// route is tma::make_plan's, by head dims alone (one block at D, Dv <= 512,
// the cluster of two up to 1024). imin / imax hold each KV tile's interval
// of Q tiles at the plan's 64 x 64 tiles (num_kv_tiles = ceil(Tk / 64)),
// order lists the KV tiles, longest interval first; col_passes must be the
// plan's.
extern "C" int ffpa_varlen_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                                    long long q_rs, long long q_hs, long long k_rs,
                                    long long k_hs, long long v_rs, long long v_hs,
                                    long long do_rs, long long do_hs, const float* lse,
                                    const float* delta, void* dk, void* dv, const int* q_seg,
                                    const int* q_rank, const int* k_seg, const int* k_pos,
                                    const int* imin, const int* imax, const int* order,
                                    const float* alibi, int is_fp16, int Hq, int Hkv, int tq,
                                    int tk, int num_kv_tiles, int D, int Dv, int col_passes,
                                    float scale, float softcap, int window_left,
                                    int window_right, void* stream) {
  VarlenBwdParams p = make_params(q, k, v, dout, q_rs, q_hs, k_rs, k_hs, v_rs, v_hs, do_rs,
                                  do_hs, lse, delta, q_seg, q_rank, k_seg, k_pos, imin, imax,
                                  alibi, Hq, Hkv, tq, tk, D, Dv, scale, softcap, window_left,
                                  window_right);
  p.dk = dk;
  p.dv = dv;
  p.order = order;
  p.col_passes = col_passes;
  if (D <= 0 || Dv <= 0 || D % CH != 0 || Dv % CH != 0 || D > tma::MAX_HEAD_DIM ||
      Dv > tma::MAX_HEAD_DIM || Hkv < 1 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  const tma::Plan pl = tma::make_plan(D, Dv);
  if (col_passes != pl.passes || order == nullptr || (long long)num_kv_tiles * tma::ROWS < tk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(pl.route == tma::CLUSTER
                   ? tma::launch_typed<true>(is_fp16, p, pl, num_kv_tiles, st)
                   : tma::launch_typed<false>(is_fp16, p, pl, num_kv_tiles, st));
}

// The route and tiling ffpa_varlen_bwd_dkdv takes at head dims (D, Dv),
// multiples of 64 up to 1024, in ffpa_bwd_dkdv_plan's layout: out[0..6] are
// the route (1 one block, 2 the cluster of two), the passes, a block's KV
// rows, the streamed Q rows, the ring's stages, the dynamic shared-memory
// bytes of a block and the ranks that split the head dims (1 or 2); then for
// each block of a KV tile, rank by rank and pass by pass, the (first column,
// width) of dK and of dV it owns; then for each rank of the cluster (none
// for one block) its (first D column, D width, first Dv column, Dv width).
// cap is out's length.
extern "C" int ffpa_varlen_bwd_dkdv_plan(int D, int Dv, int* out, int cap) {
  if (D <= 0 || Dv <= 0 || D % CH != 0 || Dv % CH != 0 || D > tma::MAX_HEAD_DIM ||
      Dv > tma::MAX_HEAD_DIM)
    return (int)cudaErrorInvalidValue;
  const tma::Plan pl = tma::make_plan(D, Dv);
  const int ranks = pl.route == tma::CLUSTER ? 2 : 1;
  if (cap < 7 + 4 * ranks * pl.passes + (ranks == 2 ? 8 : 0)) return (int)cudaErrorInvalidValue;
  int n = 0;
  out[n++] = pl.route;
  out[n++] = pl.passes;
  out[n++] = tma::ROWS;
  out[n++] = tma::QROWS;
  out[n++] = pl.stages;
  out[n++] = (int)pl.smem;
  out[n++] = ranks;
  for (int r = 0; r < ranks; ++r) {
    const tma::Part& pt = pl.part[r];
    for (int ps = 0; ps < pl.passes; ++ps) {
      const sm90::Cols dc = sm90::col_block(pt.nd, pl.passes, ps);
      const sm90::Cols vc = sm90::col_block(pt.nv, pl.passes, ps);
      out[n++] = pt.d0 * CH + dc.c0;
      out[n++] = dc.nc * CH;
      out[n++] = pt.v0 * CH + vc.c0;
      out[n++] = vc.nc * CH;
    }
  }
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
// warpgroups) and local (spill) bytes a thread of the varlen dK/dV kernel of
// route 1 (one block) or 2 (the cluster), in f16 or bf16.
extern "C" int ffpa_varlen_bwd_dkdv_attrs(int route, int is_fp16, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e;
  if (route == tma::CLUSTER)
    e = is_fp16 ? cudaFuncGetAttributes(&a, tma::varlen_dkdv_wgmma_kernel<__half, true>)
                : cudaFuncGetAttributes(&a, tma::varlen_dkdv_wgmma_kernel<__nv_bfloat16, true>);
  else if (route == tma::WGMMA)
    e = is_fp16 ? cudaFuncGetAttributes(&a, tma::varlen_dkdv_wgmma_kernel<__half, false>)
                : cudaFuncGetAttributes(&a, tma::varlen_dkdv_wgmma_kernel<__nv_bfloat16, false>);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// dQ [Tq, Hq, D] in the input type; the route is tma::make_dq_plan's, by
// head dims alone (one block at D, Dv <= 512, the cluster of two up to
// 1024). A block (a cluster) owns 64 Q rows (num_q_tiles = ceil(Tq / 64))
// and walks tiles[tile * num_kv_tiles ..][0, ntile[tile]) of its Q tile,
// the Q tiles in order's order.
extern "C" int ffpa_varlen_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                  long long q_rs, long long q_hs, long long k_rs, long long k_hs,
                                  long long v_rs, long long v_hs, long long do_rs,
                                  long long do_hs, const float* lse, const float* delta, void* dq,
                                  const int* q_seg, const int* q_rank, const int* k_seg,
                                  const int* k_pos, const int* tiles, const int* ntile,
                                  const int* order, const float* alibi, int is_fp16, int Hq,
                                  int Hkv, int tq, int tk, int num_q_tiles, int num_kv_tiles,
                                  int D, int Dv, float scale, float softcap, int window_left,
                                  int window_right, void* stream) {
  VarlenBwdParams p = make_params(q, k, v, dout, q_rs, q_hs, k_rs, k_hs, v_rs, v_hs, do_rs,
                                  do_hs, lse, delta, q_seg, q_rank, k_seg, k_pos, nullptr,
                                  nullptr, alibi, Hq, Hkv, tq, tk, D, Dv, scale, softcap,
                                  window_left, window_right);
  p.dq = dq;
  p.tiles = tiles;
  p.ntile = ntile;
  p.order = order;
  p.tiles_ld = num_kv_tiles;
  if (D <= 0 || Dv <= 0 || D % CH != 0 || Dv % CH != 0 || D > tma::MAX_HEAD_DIM ||
      Dv > tma::MAX_HEAD_DIM || Hkv < 1 || Hq % Hkv != 0 || tiles == nullptr ||
      ntile == nullptr || order == nullptr || (long long)num_q_tiles * tma::QROWS < tq ||
      (long long)num_kv_tiles * tma::ROWS < tk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const tma::DqPlan pl = tma::make_dq_plan(D, Dv);
  return (int)(pl.route == tma::CLUSTER
                   ? tma::dq_launch_typed<true>(is_fp16, p, pl, num_q_tiles, st)
                   : tma::dq_launch_typed<false>(is_fp16, p, pl, num_q_tiles, st));
}

// The route and tiling ffpa_varlen_bwd_dq takes at head dims (D, Dv),
// multiples of 64 up to 1024, in ffpa_bwd_dq_plan's layout: out[0..4] are
// the route (1 one block, 2 the cluster of two), the Q rows of a block, the
// KV rows of a tile, the ring's stages and the dynamic shared-memory bytes
// of a block; out[5] the number n of dQ column blocks (each rank's
// consumers' shares, rank by rank), then (first column, width) of each;
// out[6 + 2n] the number of ranks of a cluster (0 for one block), then each
// rank's (first D column, D width, first Dv column, Dv width). cap is out's
// length.
extern "C" int ffpa_varlen_bwd_dq_plan(int D, int Dv, int* out, int cap) {
  if (D <= 0 || Dv <= 0 || D % CH != 0 || Dv % CH != 0 || D > tma::MAX_HEAD_DIM ||
      Dv > tma::MAX_HEAD_DIM || cap < 23)
    return (int)cudaErrorInvalidValue;
  const tma::DqPlan pl = tma::make_dq_plan(D, Dv);
  const int ranks = pl.route == tma::CLUSTER ? 2 : 1;
  out[0] = pl.route;
  out[1] = tma::QROWS;
  out[2] = tma::ROWS;
  out[3] = pl.stages;
  out[4] = (int)pl.smem;
  int n = 6;
  out[5] = 2 * ranks;
  for (int r = 0; r < ranks; ++r)
    for (int c = 0; c < 2; ++c) {
      const sm90::Cols cb = sm90::col_block(pl.part[r].nd, 2, c);
      out[n++] = pl.part[r].d0 * CH + cb.c0;
      out[n++] = cb.nc * CH;
    }
  out[n++] = ranks == 2 ? 2 : 0;
  for (int r = 0; r < (ranks == 2 ? 2 : 0); ++r) {
    out[n++] = pl.part[r].d0 * CH;
    out[n++] = pl.part[r].nd * CH;
    out[n++] = pl.part[r].v0 * CH;
    out[n++] = pl.part[r].nv * CH;
  }
  return 0;
}

// Registers a thread (at launch, before setmaxnreg moves them between the
// warpgroups) and local (spill) bytes a thread of the varlen dQ kernel of
// route 1 (one block) or 2 (the cluster), in f16 or bf16.
extern "C" int ffpa_varlen_bwd_dq_attrs(int route, int is_fp16, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e;
  if (route == tma::CLUSTER)
    e = is_fp16 ? cudaFuncGetAttributes(&a, tma::varlen_dq_wgmma_kernel<__half, true>)
                : cudaFuncGetAttributes(&a, tma::varlen_dq_wgmma_kernel<__nv_bfloat16, true>);
  else if (route == tma::WGMMA)
    e = is_fp16 ? cudaFuncGetAttributes(&a, tma::varlen_dq_wgmma_kernel<__half, false>)
                : cudaFuncGetAttributes(&a, tma::varlen_dq_wgmma_kernel<__nv_bfloat16, false>);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}
