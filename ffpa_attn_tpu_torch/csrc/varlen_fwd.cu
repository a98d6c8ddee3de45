// Packed (THD) varlen forward attention for Hopper (sm_90a): the counterpart
// of the Pallas _varlen_fwd_kernel (ffpa_attn_tpu/ops/varlen.py).
// ops/varlen.py calls the C entry point ffpa_varlen_fwd through ctypes.
//
// The TPU kernel walks a (Hq, Tq / bq, Tk / bkv) grid over head-major
// [H, T, D] copies of the inputs, clamping the KV axis into each Q tile's
// [jmin, jmax] interval. Here one block owns the packed query rows of one Q
// tile of one query head and loops over KV tiles itself, reading its
// schedule from device memory (computed on the device at the route's tiles,
// ops/varlen.py). q [Tq, Hq, D], k [Tk, Hkv, D] and v [Tk, Hkv, Dv] are read
// through their row and head strides (no head-major copy, no padding of T);
// o [Tq, Hq, Dv] and lse [Hq, Tq] are written directly, rows past Tq not.
// The keep-mask is the segment / rank test on the per-token metadata
//   (q_seg == k_seg) & (k_pos <= q_rank [+ wr]) [& k_pos >= q_rank - wl].
// Masked scores are MASK_VALUE and their P is exactly 0, so a row whose
// keep-mask is empty (padding, a Q tile that needs no KV tile) gives o = 0
// and lse = MASK_VALUE + log(1e-38), as on the TPU.
//
// Two routes, by head dims alone (tma::make_plan). D, Dv <= 512 take the
// TMA + wgmma block of namespace tma (details beside it): 64 Q rows, and
// only the KV tiles the JAX package's _tile_needed marks needed, listed per
// Q tile. Wider heads take varlen_fwd_kernel below, the dense forward's
// mma.sync block (Split-D with the fp32 O tile over the registers of 16 warps,
// mma.sync m16n8k16 fed by ldmatrix, Q resident in shared memory, K and V
// streaming through a cp.async ring in 64 x 64 chunks) over every KV tile of
// a BQ-row Q tile's [jmin, jmax] interval, the row tile's metadata in
// shared memory and each key tile's in registers.
//
// Bound on an H100: bytes, barely (q, k, v and o once each against 4 * Hq *
// D flop per attended pair; ops/varlen.py).
#include "common.cuh"
#include "sm90.cuh"

#include <string.h>

namespace {

using namespace ffpa;

constexpr int NW = 16;             // warps per block
constexpr int NTHR = NW * 32;
constexpr int KV_TILE = 64;        // K/V rows per tile (ops/config.py KV_TILE)
constexpr int CH = 64;             // head-dim columns per streamed chunk
constexpr int NST = 4;             // stream ring slots (ops/config.py FWD_STREAM_STAGES)
constexpr int LDC = CH + 8;        // chunk / P row stride (elements)
constexpr int LDS = KV_TILE + 4;   // S row stride (floats)
constexpr int O_PER_THREAD = 64;   // fp32 accumulator registers per thread

struct VarlenParams {
  const void* q;
  const void* k;
  const void* v;
  long long q_rs, q_hs, k_rs, k_hs, v_rs, v_hs;  // row and head strides, elements
  void* o;      // [Tq, Hq, Dv] in the input type
  float* lse;   // [Hq, Tq]
  const int* q_seg;   // [num_q_tiles * BQ]
  const int* q_rank;
  const int* k_seg;   // [ceil(Tk / 64) * 64]
  const int* k_pos;
  const int* jmin;    // mma.sync: [num_q_tiles] first KV tile of each Q tile's interval
  const int* jmax;    // last KV tile
  const int* tiles;   // wgmma: [num_q_tiles, tiles_ld] the needed KV tiles of each Q tile
  const int* ntile;   // [num_q_tiles] how many of them
  const int* order;   // [num_q_tiles] the Q tiles, most needed tiles first
  int tiles_ld;
  const float* alibi; // [Hq] slopes, or null
  int Hq, Hkv, tq, tk, D, Dv, group;
  float scale, softcap;
  int window_left, window_right;  // window_right: 0 when causal, -1 open
};

// Dynamic shared memory of one block; ops/config.py varlen_smem_bytes is the
// same formula.
template <typename T>
size_t varlen_smem_bytes(int bq, int d) {
  return (size_t)bq * (d + 8) * sizeof(T)             // resident Q
         + (size_t)NST * KV_TILE * LDC * sizeof(T)     // K / V ring
         + (size_t)bq * LDS * sizeof(float)            // S
         + (size_t)bq * LDC * sizeof(T)                // P
         + 3 * (size_t)bq * sizeof(float)              // m, l, alpha
         + 2 * (size_t)bq * sizeof(int);               // q_seg, q_rank
}

template <typename T, int BQ>
__global__ void __launch_bounds__(NTHR, 1) varlen_fwd_kernel(const VarlenParams p) {
  constexpr int RT = BQ / 16;             // 16-row tiles
  constexpr int WC = NW / RT;             // warps per row tile
  constexpr int CW = CH / WC;             // columns per warp per chunk (16 or 8)
  constexpr int N8 = CW / 8;              // n8 mma tiles per warp per chunk
  constexpr int NVMAX = O_PER_THREAD / (4 * N8);  // Dv chunks the registers hold
  constexpr int RPW = BQ / NW;            // softmax rows per warp
  static_assert(N8 == 1 || N8 == 2, "BQ must be 32 or 64");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int LDQ = p.D + 8;
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* ring = Qs + BQ * LDQ;
  float* S = reinterpret_cast<float*>(ring + NST * KV_TILE * LDC);
  T* P = reinterpret_cast<T*>(S + BQ * LDS);
  float* m_s = reinterpret_cast<float*>(P + BQ * LDC);
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;
  int* qseg_s = reinterpret_cast<int*>(a_s + BQ);
  int* qrank_s = qseg_s + BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rt = warp / WC, wc = warp % WC;
  const int head = blockIdx.x, tile = blockIdx.y, kvh = head / p.group;
  const int row0 = tile * BQ;
  const int j_lo = p.jmin[tile], j_hi = p.jmax[tile];
  const int kv_lo = j_lo * KV_TILE;
  const int ntiles = j_hi - j_lo + 1;  // an empty interval is [0, 0]: one masked tile

  const T* qb = static_cast<const T*>(p.q) + (long long)head * p.q_hs;
  const T* kb = static_cast<const T*>(p.k) + (long long)kvh * p.k_hs;
  const T* vb = static_cast<const T*>(p.v) + (long long)kvh * p.v_hs;
  const float slope = p.alibi != nullptr ? p.alibi[head] : 0.f;

  // Resident Q: rows past Tq are zero-filled.
  for (int i = tid; i < BQ * (p.D / 8); i += NTHR) {
    const int r = i / (p.D / 8), c = (i % (p.D / 8)) * 8;
    const bool ok = row0 + r < p.tq;
    cp_async16(Qs + r * LDQ + c, ok ? qb + (long long)(row0 + r) * p.q_rs + c : qb, ok);
  }
  cp_async_commit();
  for (int i = tid; i < BQ; i += NTHR) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
    qseg_s[i] = p.q_seg[row0 + i];
    qrank_s[i] = p.q_rank[row0 + i];
  }

  const int nD = p.D / CH, nV = p.Dv / CH, per_tile = nD + nV;
  const int total = ntiles * per_tile;

  // Chunk gi of the stream: per KV tile, the nD K chunks then the nV V
  // chunks, 64 rows x 64 columns each, rows past Tk zero-filled.
  auto issue = [&](int gi) {
    if (gi < total) {
      const int t = gi / per_tile, c = gi - t * per_tile;
      const int kv0 = kv_lo + t * KV_TILE;
      const T* src = c < nD ? kb : vb;
      const long long rs = c < nD ? p.k_rs : p.v_rs;
      const int c0 = (c < nD ? c : c - nD) * CH;
      T* dst = ring + (gi % NST) * (KV_TILE * LDC);
      const int r = tid >> 3, cv = (tid & 7) * 8;  // one 16-byte vector per thread
      const bool ok = kv0 + r < p.tk;
      cp_async16(dst + r * LDC + cv, ok ? src + (long long)(kv0 + r) * rs + c0 + cv : src, ok);
    }
    cp_async_commit();
  };
  // Wait for chunk gi (and everything before it), with the ring refilled ahead.
  auto begin = [&](int gi) -> const T* {
    issue(gi + NST - 1);
    cp_async_wait<NST - 1>();
    __syncthreads();
    return ring + (gi % NST) * (KV_TILE * LDC);
  };

  float o[NVMAX][N8][4];
#pragma unroll
  for (int vc = 0; vc < NVMAX; ++vc)
#pragma unroll
    for (int n = 0; n < N8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[vc][n][e] = 0.f;

  // ldmatrix lane addressing (see common.cuh and flash_fwd.cu).
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int bn_row = (lane & 7) + ((lane >> 4) << 3), bn_col = ((lane >> 3) & 1) * 8;
  const int bt_row = (lane & 7) + (((lane >> 3) & 1) << 3), bt_col = (lane >> 4) * 8;

#pragma unroll
  for (int gi = 0; gi < NST - 1; ++gi) issue(gi);
  for (int t = 0; t < ntiles; ++t) {
    const int kv0 = kv_lo + t * KV_TILE;
    const int gt = t * per_tile;

    // S = Q K^T: this warp's 16 x CW piece, over the D chunks.
    float s_acc[N8][4];
#pragma unroll
    for (int n = 0; n < N8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[n][e] = 0.f;
    for (int c = 0; c < nD; ++c) {
      const T* kc = begin(gt + c);
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, Qs + (rt * 16 + a_row) * LDQ + c * CH + kk * 16 + a_col);
        if (N8 == 2) {
          uint32_t bf[4];
          ldsm_x4(bf, kc + (wc * CW + bn_row) * LDC + kk * 16 + bn_col);
          mma16816<T>(s_acc[0], a, bf[0], bf[1]);
          mma16816<T>(s_acc[N8 - 1], a, bf[2], bf[3]);
        } else {
          uint32_t bf[2];
          ldsm_x2(bf, kc + (wc * CW + (lane & 7)) * LDC + kk * 16 + bn_col);
          mma16816<T>(s_acc[0], a, bf[0], bf[1]);
        }
      }
      __syncthreads();  // the slot read here is refilled by a later issue
    }
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      const int col = wc * CW + n * 8 + 2 * t4;
      *reinterpret_cast<float2*>(S + (rt * 16 + g) * LDS + col) =
          make_float2(s_acc[n][0], s_acc[n][1]);
      *reinterpret_cast<float2*>(S + (rt * 16 + g + 8) * LDS + col) =
          make_float2(s_acc[n][2], s_acc[n][3]);
    }
    __syncthreads();

    // Online softmax: each warp owns RPW rows, two columns per lane. Every
    // column of a tile lies below ceil(Tk / 64) * 64, the key metadata's length.
    {
      int kseg[2], kpos[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        kseg[j] = p.k_seg[kv0 + lane + 32 * j];
        kpos[j] = p.k_pos[kv0 + lane + 32 * j];
      }
      float sv[RPW][2], red[RPW];
      bool keep[RPW][2];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp + i * NW;
        const int qs = qseg_s[r], qr = qrank_s[r];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          bool kp = qs == kseg[j];
          if (p.window_right >= 0) kp = kp && kpos[j] <= qr + p.window_right;
          if (p.window_left >= 0) kp = kp && kpos[j] >= qr - p.window_left;
          float s = MASK_VALUE;
          if (kp) {
            s = S[r * LDS + lane + 32 * j] * p.scale;
            if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
            if (p.alibi != nullptr) s -= slope * fabsf((float)(qr - kpos[j]));
          }
          sv[i][j] = s;
          keep[i][j] = kp;
        }
        red[i] = fmaxf(sv[i][0], sv[i][1]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < RPW; ++i)
          red[i] = fmaxf(red[i], __shfl_xor_sync(0xffffffffu, red[i], off));
      float m_new[RPW], alpha[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp + i * NW;
        const float m_old = m_s[r];
        m_new[i] = fmaxf(m_old, red[i]);  // >= MASK_VALUE: finite from the first tile on
        alpha[i] = __expf(m_old - m_new[i]);
        const float p0 = keep[i][0] ? __expf(sv[i][0] - m_new[i]) : 0.f;
        const float p1 = keep[i][1] ? __expf(sv[i][1] - m_new[i]) : 0.f;
        red[i] = p0 + p1;
        P[r * LDC + lane] = from_float<T>(p0);
        P[r * LDC + lane + 32] = from_float<T>(p1);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < RPW; ++i) red[i] += __shfl_xor_sync(0xffffffffu, red[i], off);
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const int r = warp + i * NW;
          m_s[r] = m_new[i];
          l_s[r] = alpha[i] * l_s[r] + red[i];
          a_s[r] = alpha[i];
        }
      }
    }
    __syncthreads();

    // O = alpha * O + P V, chunk by chunk of Dv; each warp its own columns.
    const float al0 = a_s[rt * 16 + g], al1 = a_s[rt * 16 + g + 8];
#pragma unroll
    for (int vc = 0; vc < NVMAX; ++vc) {
      if (vc < nV) {
#pragma unroll
        for (int n = 0; n < N8; ++n) {
          o[vc][n][0] *= al0;
          o[vc][n][1] *= al0;
          o[vc][n][2] *= al1;
          o[vc][n][3] *= al1;
        }
        const T* vch = begin(gt + nD + vc);
#pragma unroll
        for (int kk = 0; kk < KV_TILE / 16; ++kk) {
          uint32_t a[4];
          ldsm_x4(a, P + (rt * 16 + a_row) * LDC + kk * 16 + a_col);
          if (N8 == 2) {
            uint32_t bf[4];
            ldsm_x4_trans(bf, vch + (kk * 16 + bt_row) * LDC + wc * CW + bt_col);
            mma16816<T>(o[vc][0], a, bf[0], bf[1]);
            mma16816<T>(o[vc][N8 - 1], a, bf[2], bf[3]);
          } else {
            uint32_t bf[2];
            ldsm_x2_trans(bf, vch + (kk * 16 + bt_row) * LDC + wc * CW);
            mma16816<T>(o[vc][0], a, bf[0], bf[1]);
          }
        }
        __syncthreads();  // the slot read here is refilled by a later issue
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: O / l and lse = m + log(max(l, 1e-38)); l == 0 rows give 0.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rt * 16 + g + 8 * h, row = row0 + r;
    if (row >= p.tq) continue;
    const float l = l_s[r];
    const float l_safe = (l == 0.f) ? 1.f : l;
    T* dst = static_cast<T*>(p.o) + ((long long)row * p.Hq + head) * p.Dv;
#pragma unroll
    for (int vc = 0; vc < NVMAX; ++vc) {
      if (vc < nV) {
#pragma unroll
        for (int n = 0; n < N8; ++n) {
          const int col = vc * CH + wc * CW + n * 8 + 2 * t4;
          const float x0 = o[vc][n][2 * h] / l_safe, x1 = o[vc][n][2 * h + 1] / l_safe;
          *reinterpret_cast<uint32_t*>(dst + col) = pack2<T>(x0, x1);
        }
      }
    }
    if (wc == 0 && t4 == 0) p.lse[(long long)head * p.tq + row] = m_s[r] + logf(fmaxf(l, 1e-38f));
  }
}

template <typename T, int BQ>
cudaError_t launch(const VarlenParams& p, int num_q_tiles, cudaStream_t stream) {
  auto kern = varlen_fwd_kernel<T, BQ>;
  const size_t smem = varlen_smem_bytes<T>(BQ, p.D);
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.Hq, num_q_tiles);
  kern<<<grid, NTHR, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// D, Dv <= 512: TMA + mbarrier + wgmma
// ---------------------------------------------------------------------------

// The Hopper route of ffpa_varlen_fwd: the dense forward's block
// (flash_fwd.cu namespace fwd, sm90.cuh) over the packed layout. The
// mma.sync block above put a block barrier after every 64 x 64 chunk of its
// cp.async ring, sent S through shared memory for a softmax on 512 threads
// and P back the same way, and walked every KV tile of its interval (0.56 ms
// at the serving packing on an H100, 26x its bound). Here a block of 384
// threads owns 64 packed Q rows of one query head:
//  - warpgroup 0 is the producer (setmaxnreg 24): one thread loads Q once by
//    TMA into D / 64 resident 64 x 64 boxes (128 B swizzle), then, per KV
//    tile of the Q tile's list, streams the D / 64 K boxes and the Dv / 64 V
//    boxes through a ring of two-box stages. The tensor maps span the packed
//    layout: dims (D, T, H) with the row and head strides, extents at the
//    true Tq and Tk, so TMA zero-fills the ragged tail (varlen_bwd.cu's
//    maps);
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
//    owns the first ceil(nv / 2) Dv boxes);
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
// arrivals and every ordinary write of O is fenced off from the products.
namespace tma {

using namespace ffpa::sm90;

constexpr int ROWS = 64;                     // Q rows of a block
constexpr int COLS = 64;                     // columns of a box (128 B of 16-bit)
static_assert(ROWS * COLS * 2 == BOX_BYTES && KV_TILE == 64, "Q, K and V boxes are 64 x 64");
constexpr int MAX_BOXES = 8;                 // D, Dv <= 512 on this route
constexpr int O_BOXES = MAX_BOXES / 2;       // Dv boxes of one consumer: 64 x 256 fp32
constexpr int STAGE_BOXES = 2;               // boxes a stage (one barrier handshake)
constexpr int STAGE_BYTES = STAGE_BOXES * BOX_BYTES;
constexpr int STAGES = 8;                    // ring depth: a D512 tile's K and V
constexpr int THREADS = 384;                 // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMER_WARPS = 8;            // arrivals that free a stage
constexpr int XCH_BYTES = 2 * ROWS * 4;      // row maxima, then row sums, of both consumers
constexpr int SMEM_LIMIT = 232448;
constexpr int WGMMA = 1, MMA_SYNC = 0;       // routes

// Shared memory of this block: Q, the P box, the 1024 B alignment, Q's
// barrier and the exchange, then the stages and their two barriers each.
constexpr size_t smem_bytes(int nd) {
  return (size_t)(nd + 1) * BOX_BYTES + 1024 + sizeof(uint64_t) + XCH_BYTES +
         (size_t)STAGES * (STAGE_BYTES + 2 * sizeof(uint64_t));
}
static_assert(smem_bytes(MAX_BOXES) <= SMEM_LIMIT, "D512's block fits the card");

// The route and tiling of a launch at head dims (D, Dv), multiples of 64:
// D, Dv <= 512 take this block (64 Q rows, consumer 0 owning the first
// ceil(nv / 2) Dv boxes); wider heads take varlen_fwd_kernel at the largest
// row tile the registers hold (block_q * Dv <= 64 * 512). The dense
// forward's plan (flash_fwd.cu fwd::make_plan) with the varlen mma.sync
// block's shared memory. ffpa_varlen_fwd_plan hands it out; ops/config.py
// varlen_fwd_plan mirrors it and the card test holds the two equal.
struct Plan {
  int route, rows, stages, nd, nv, nv0;
  size_t smem;
};
inline Plan make_plan(int D, int Dv) {
  Plan pl;
  pl.nd = D / COLS;
  pl.nv = Dv / COLS;
  pl.nv0 = (pl.nv + 1) / 2;
  if (pl.nd <= MAX_BOXES && pl.nv <= MAX_BOXES) {
    pl.route = WGMMA;
    pl.rows = ROWS;
    pl.stages = STAGES;
    pl.smem = smem_bytes(pl.nd);
  } else {
    pl.route = MMA_SYNC;
    pl.rows = 64 * Dv <= 32 * 1024 ? 64 : 32;
    pl.stages = NST;
    pl.smem = varlen_smem_bytes<__nv_bfloat16>(pl.rows, D);
  }
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

// Shared memory of a block, from a 1024 B boundary: the Q boxes, the P box,
// the ring's stages, their full / empty barriers, Q's barrier and the
// exchange buffer.
struct Smem {
  unsigned char* q;
  unsigned char* p;
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* q_full;
  float* xch;  // [2][ROWS]: row maxima of consumers 0 and 1, then their row sums
};
__device__ __forceinline__ Smem carve(unsigned char* base, int nd) {
  Smem sm;
  sm.q = base;
  sm.p = base + nd * BOX_BYTES;
  sm.ring = sm.p + BOX_BYTES;
  sm.full = reinterpret_cast<uint64_t*>(sm.ring + STAGES * STAGE_BYTES);
  sm.empty = sm.full + STAGES;
  sm.q_full = sm.empty + STAGES;
  sm.xch = reinterpret_cast<float*>(sm.q_full + 1);
  return sm;
}

// A block's query head, its Q tile's first row, and its walk: entries
// [first, first + n) of p.tiles. The same in every thread.
struct Block {
  int head, row0, first, n;
};

// The producer's thread: Q once, then per listed KV tile the K stages (two
// boxes each, an odd last box alone) and the V stages (box j of consumer
// 0's half beside box j of consumer 1's, alone where that half is shorter).
__device__ __forceinline__ void produce(const Maps& maps, const VarlenParams& p, const Smem& sm,
                                        const Block& k, int nd, int nv, int nv0) {
  prefetch_map(&maps.q_map);
  prefetch_map(&maps.k_map);
  prefetch_map(&maps.v_map);
  const int kvh = k.head / p.group;
  mbar_arrive_expect_tx(sm.q_full, nd * BOX_BYTES);
  for (int j = 0; j < nd; ++j)
    tma_load_3d(sm.q + j * BOX_BYTES, &maps.q_map, sm.q_full, j * COLS, k.row0, k.head);
  int it = 0;
  // Stage it % STAGES, free again, expecting nb boxes.
  auto claim = [&](int nb) -> unsigned char* {
    const int st = it % STAGES;
    if (it >= STAGES) mbar_wait(&sm.empty[st], ((it / STAGES) - 1) & 1);
    mbar_arrive_expect_tx(&sm.full[st], nb * BOX_BYTES);
    return sm.ring + st * STAGE_BYTES;
  };
  for (int t = 0; t < k.n; ++t) {
    const int kv0 = __ldg(p.tiles + k.first + t) * KV_TILE;
    for (int c = 0; c < nd; c += STAGE_BOXES, ++it) {
      const int nb = min(STAGE_BOXES, nd - c);
      unsigned char* dst = claim(nb);
      for (int g = 0; g < nb; ++g)
        tma_load_3d(dst + g * BOX_BYTES, &maps.k_map, &sm.full[it % STAGES], (c + g) * COLS,
                    kv0, kvh);
    }
    for (int j = 0; j < nv0; ++j, ++it) {
      const bool both = nv0 + j < nv;
      unsigned char* dst = claim(both ? 2 : 1);
      tma_load_3d(dst, &maps.v_map, &sm.full[it % STAGES], j * COLS, kv0, kvh);
      if (both)
        tma_load_3d(dst + BOX_BYTES, &maps.v_map, &sm.full[it % STAGES], (nv0 + j) * COLS, kv0,
                    kvh);
    }
  }
}

// Consumer C of a block; C is a template argument so that no branch around
// a wgmma depends on the thread (ptxas serializes wgmma on a path it cannot
// prove uniform). Accumulator element 4 j + 2 hh + e of thread (warp, g =
// lane / 4, t4 = lane % 4) is row 16 warp + g + 8 hh and, in its 8-column
// block j, column 8 j + 2 t4 + e.
template <typename T, int C>
__device__ __forceinline__ void consume(const VarlenParams& p, const Smem& sm, const Block& k,
                                        int nd, int nv, int nv0) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int own = C == 0 ? nv0 : nv - nv0;  // Dv boxes of this consumer
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
  auto wait_full = [&](int st) { mbar_wait(&sm.full[st], (it / STAGES) & 1); };

  if (k.n > 0) mbar_wait(sm.q_full, 0);
  for (int t = 0; t < k.n; ++t) {
    // This consumer's first KV column, from the list entry of the tile.
    int idx = k.first + t;
    asm volatile("" : "+r"(idx));
    const int kc = __ldg(p.tiles + idx) * KV_TILE + 32 * C;

    // S for this consumer's 32 KV columns: rows 32 C.. of each K box.
    float s[16];
    int c = 0;
    for (; c + 2 <= nd; c += 2, ++it) {
      const int st = it % STAGES;
      const unsigned char* kb = sm.ring + st * STAGE_BYTES + C * 4096;
      wait_full(st);
      wgmma_fence();
      box_mma<T, 32, 0>(s, sm.q + c * BOX_BYTES, kb, c == 0);
      box_mma<T, 32, 0>(s, sm.q + (c + 1) * BOX_BYTES, kb + BOX_BYTES);
      done_with(st);
    }
    if (c < nd) {
      const int st = it % STAGES;
      wait_full(st);
      wgmma_fence();
      box_mma<T, 32, 0>(s, sm.q + c * BOX_BYTES, sm.ring + st * STAGE_BYTES + C * 4096, c == 0);
      done_with(st);
      ++it;
    }
    drain();  // also completes this consumer's P V products of the tile before
    fence_operands(s);
    fence_operands(o);  // no rescale of O moves above the wait

    // Scores in natural units; keep holds the keep-mask, bit i for s[i].
    // The full-block test reads the same six words in every thread, the
    // rows' from an index the empty asm hides (else their loads are hoisted
    // out of the walk and held beside O).
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
#pragma unroll
    for (int j = 0; j < O_BOXES; ++j) {
      if (j < nv0) {
        const int st = it % STAGES;
        wait_full(st);
        if (j < own) {
          wgmma_fence();
          box_mma<T, 64, 1>(*reinterpret_cast<float(*)[32]>(o + 32 * j), sm.p,
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
  fence_operands(o);

  // Epilogue: l over the quad and both consumers (in the maxima's slots,
  // read by the other consumer before the last tile's second barrier); O /
  // l on rows below Tq, packed [Tq, Hq, Dv]; lse = m + log(max(l, 1e-38));
  // rows with l == 0 give O = 0 and lse = MASK_VALUE + log(1e-38).
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
    if (row >= p.tq) continue;
    const float lt = l[hh] + sm.xch[(1 - C) * ROWS + r];  // the same sum in both
    const float inv = lt == 0.f ? 1.f : __fdividef(1.f, lt);
    T* dst = static_cast<T*>(p.o) + ((long long)row * p.Hq + k.head) * p.Dv +
             (C == 0 ? 0 : nv0 * COLS) + 2 * t4;
#pragma unroll
    for (int j = 0; j < O_BOXES; ++j) {
      if (j >= own) break;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8)
        *reinterpret_cast<uint32_t*>(dst + COLS * j + 8 * j8) =
            pack2<T>(o[32 * j + 4 * j8 + 2 * hh] * inv, o[32 * j + 4 * j8 + 2 * hh + 1] * inv);
    }
    if (C == 0 && t4 == 0)
      p.lse[(long long)k.head * p.tq + row] = m[hh] + logf(fmaxf(lt, 1e-38f));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    varlen_fwd_wgmma_kernel(const __grid_constant__ Maps maps, const VarlenParams p) {
  extern __shared__ unsigned char smem_raw[];
  // Boxes on 1024 B boundaries: the 128 B swizzle's atom. The offset is
  // added to smem_raw itself, so the compiler keeps every pointer below in
  // the shared space (32-bit) rather than generic (64-bit, two registers).
  unsigned char* base = smem_raw + ((1024u - (cvta_smem(smem_raw) & 1023u)) & 1023u);
  const int nd = p.D / COLS, nv = p.Dv / COLS, nv0 = (nv + 1) / 2;
  const Smem sm = carve(base, nd);
  // Block order: the query heads of a Q tile side by side, the Q tiles in
  // the schedule's order (most needed KV tiles first).
  const int tile = p.order[blockIdx.y];
  const Block k = {(int)blockIdx.x, tile * ROWS, tile * p.tiles_ld, p.ntile[tile]};
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMER_WARPS);
    }
    mbar_init(sm.q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    // A Q tile that needs no KV tile loads nothing (not even Q).
    if (threadIdx.x == 0 && k.n > 0) produce(maps, p, sm, k, nd, nv, nv0);
  } else {
    setmaxnreg_inc<240>();
    if (threadIdx.x < 256)
      consume<T, 0>(p, sm, k, nd, nv, nv0);
    else
      consume<T, 1>(p, sm, k, nd, nv, nv0);
  }
}

// The host side of one launch: tensor maps over the packed layout (dims (D,
// T, H), strides in bytes), shared memory, the grid (query heads, Q tiles).
template <typename T>
cudaError_t launch(const VarlenParams& p, const Plan& pl, int num_q_tiles, cudaStream_t stream) {
  const dim3 grid(p.Hq, num_q_tiles);
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
  e = cudaFuncSetAttribute(varlen_fwd_wgmma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)pl.smem);
  if (e != cudaSuccess) return e;
  varlen_fwd_wgmma_kernel<T><<<grid, THREADS, pl.smem, stream>>>(maps, p);
  return cudaGetLastError();
}

}  // namespace tma

}  // namespace

// o [Tq, Hq, Dv] in the input type and lse [Hq, Tq] fp32; the route is
// tma::make_plan's, by head dims alone. On the wgmma route a block owns 64
// Q rows (num_q_tiles = ceil(Tq / 64); block_q is only checked) and walks
// tiles[tile * num_kv_tiles ..][0, ntile[tile]) of its Q tile, the Q tiles
// in order's order; jmin / jmax are not read. On mma.sync a block owns
// block_q rows (num_q_tiles = ceil(Tq / block_q)) and walks every KV tile of
// [jmin, jmax]; tiles, ntile and order are not read.
extern "C" int ffpa_varlen_fwd(const void* q, const void* k, const void* v, long long q_rs,
                               long long q_hs, long long k_rs, long long k_hs, long long v_rs,
                               long long v_hs, void* o, float* lse, const int* q_seg,
                               const int* q_rank, const int* k_seg, const int* k_pos,
                               const int* jmin, const int* jmax, const int* tiles,
                               const int* ntile, const int* order, const float* alibi,
                               int is_fp16, int block_q, int Hq, int Hkv, int tq, int tk,
                               int num_q_tiles, int num_kv_tiles, int D, int Dv, float scale,
                               float softcap, int window_left, int window_right, void* stream) {
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
  p.jmin = jmin;
  p.jmax = jmax;
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
  // Registers hold block_q x Dv fp32 (64 per thread); D and Dv are 64-multiples.
  if (D <= 0 || Dv <= 0 || D % CH != 0 || Dv % CH != 0 || (long long)block_q * Dv > 32 * 1024 ||
      (block_q != 64 && block_q != 32) || num_q_tiles < 1 || Hkv < 1 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const tma::Plan pl = tma::make_plan(D, Dv);
  if (pl.route == tma::WGMMA) {
    if (tiles == nullptr || ntile == nullptr || order == nullptr ||
        (long long)num_q_tiles * tma::ROWS < tq || (long long)num_kv_tiles * KV_TILE < tk)
      return (int)cudaErrorInvalidValue;
    return (int)(is_fp16 ? tma::launch<__half>(p, pl, num_q_tiles, st)
                         : tma::launch<__nv_bfloat16>(p, pl, num_q_tiles, st));
  }
  if (jmin == nullptr || jmax == nullptr || (long long)num_q_tiles * block_q < tq)
    return (int)cudaErrorInvalidValue;
  if (is_fp16) {
    return (int)(block_q == 64 ? launch<__half, 64>(p, num_q_tiles, st)
                               : launch<__half, 32>(p, num_q_tiles, st));
  }
  return (int)(block_q == 64 ? launch<__nv_bfloat16, 64>(p, num_q_tiles, st)
                             : launch<__nv_bfloat16, 32>(p, num_q_tiles, st));
}

// The route and tiling ffpa_varlen_fwd takes at head dims (D, Dv), multiples
// of 64, in ffpa_flash_fwd_plan's layout: out[0..4] are the route (1 wgmma,
// 0 mma.sync), the Q rows of a block (for mma.sync the largest row tile the
// registers hold), the KV rows of a tile, the ring's stages and the dynamic
// shared-memory bytes (bf16); out[5] the number of O column blocks (the
// consumers' halves, or the whole block's), then (first column, width) of
// each; cap is out's length.
extern "C" int ffpa_varlen_fwd_plan(int D, int Dv, int* out, int cap) {
  if (D <= 0 || Dv <= 0 || D % CH != 0 || Dv % CH != 0 || cap < 10)
    return (int)cudaErrorInvalidValue;
  const tma::Plan pl = tma::make_plan(D, Dv);
  out[0] = pl.route;
  out[1] = pl.rows;
  out[2] = KV_TILE;
  out[3] = pl.stages;
  out[4] = (int)pl.smem;
  if (pl.route == tma::WGMMA) {
    out[5] = 2;
    out[6] = 0;
    out[7] = pl.nv0 * CH;
    out[8] = pl.nv0 * CH;
    out[9] = (pl.nv - pl.nv0) * CH;
  } else {
    out[5] = 1;
    out[6] = 0;
    out[7] = Dv;
  }
  return 0;
}

// Registers a thread (at launch, before setmaxnreg moves them between the
// warpgroups) and local (spill) bytes a thread of a varlen forward kernel:
// route 1 the wgmma kernel, 0 varlen_fwd_kernel at row tile block_q (64 or
// 32), in f16 or bf16.
extern "C" int ffpa_varlen_fwd_attrs(int route, int is_fp16, int block_q, int* regs,
                                     int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e;
  if (route == tma::WGMMA)
    e = is_fp16 ? cudaFuncGetAttributes(&a, tma::varlen_fwd_wgmma_kernel<__half>)
                : cudaFuncGetAttributes(&a, tma::varlen_fwd_wgmma_kernel<__nv_bfloat16>);
  else if (block_q == 64)
    e = is_fp16 ? cudaFuncGetAttributes(&a, varlen_fwd_kernel<__half, 64>)
                : cudaFuncGetAttributes(&a, varlen_fwd_kernel<__nv_bfloat16, 64>);
  else
    e = is_fp16 ? cudaFuncGetAttributes(&a, varlen_fwd_kernel<__half, 32>)
                : cudaFuncGetAttributes(&a, varlen_fwd_kernel<__nv_bfloat16, 32>);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}
