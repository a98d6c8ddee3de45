// Forward attention kernels for Hopper (sm_90a): the counterpart of the
// Pallas _fwd_kernel (ffpa_attn_tpu/ops/flash_fwd.py). ops/flash_fwd.py calls
// the C entry point ffpa_flash_fwd through ctypes.
//
// Two routes, chosen by head dims alone (fwd::make_plan, handed out by
// ffpa_flash_fwd_plan and mirrored by ops/config.py fwd_plan): D and Dv up
// to 512 take the TMA + mbarrier + wgmma block of namespace fwd (details
// beside it); wider heads take the mma.sync block fwd_kernel below. Both
// compute the same function:
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
// The mma.sync block (D or Dv > 512): grid (Hq, B, ceil(Nq / BQ)), one block
// of 16 warps per BQ query rows of one query head; K/V are read from head
// h / group (GQA). BQ is 64 for Dv up to 512 and 32 up to 1024. Blocks are
// dispatched x-fastest, so every head's longest causal tiles (the last
// query rows) go out first and the short ones fill the tail. The TPU kernel
// keeps a BQ x Dv fp32 accumulator in VMEM. At Dv 512..1024 no single warp
// can hold its rows' accumulator, so the O tile is split over the block's
// 16 warps by rows and columns: warp w owns 16 rows (rt = w / WC) and, in
// every 64-wide column chunk of Dv, CW = 64 / WC columns (wc = w % WC), 64
// fp32 registers per thread in all. Products are mma.sync m16n8k16 (bf16 or
// f16 in, fp32 accumulate) fed by ldmatrix:
//   * Q stays resident in shared memory for the whole KV walk;
//   * K and V stream through a ring of shared-memory slots in 64 x 64
//     chunks with cp.async, NST - 1 chunks ahead of the math: per KV tile
//     the D / 64 K chunks, then the Dv / 64 V chunks;
//   * S = Q K^T (each warp a 16 x CW piece) goes through shared memory so
//     that the online softmax sees whole rows; P goes back the same way and
//     every warp multiplies it into its own O columns.
//
// Bound on an H100: operations (2 units of 2 * pairs * D flop, 989 TFLOP/s
// dense bf16 / f16; utils/profiling.py).
#include <string.h>

#include <type_traits>

#include "common.cuh"
#include "rng.cuh"
#include "sm90.cuh"

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

// Dynamic shared memory of one block; ops/config.py fwd_smem_bytes is the
// same formula (the S residual adds none).
template <typename T>
size_t fwd_smem_bytes(int bq, int d) {
  return (size_t)bq * (d + 8) * sizeof(T)             // resident Q
         + (size_t)NST * KV_TILE * LDC * sizeof(T)     // K / V ring
         + (size_t)bq * LDS * sizeof(float)            // S
         + (size_t)bq * LDC * sizeof(T)                // P
         + 3 * (size_t)bq * sizeof(float);             // m, l, alpha
}

template <typename T, int BQ>
__global__ void __launch_bounds__(NTHR, 1) fwd_kernel(const FwdParams p) {
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

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rt = warp / WC, wc = warp % WC;
  const int head = blockIdx.x, b = blockIdx.y, kvh = head / p.group;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // the longest causal rows start first
  const int row_last = min(row0 + BQ, p.nq) - 1;
  int kv_lo = 0, kv_hi = p.nkv;
  // Band tile skipping: tiles no row of this block attends are never loaded.
  if (p.window_right >= 0) kv_hi = min(p.nkv, row_last + p.causal_offset + p.window_right + 1);
  if (p.window_left >= 0) kv_lo = max(0, row0 + p.causal_offset - p.window_left);
  kv_lo = (kv_lo / KV_TILE) * KV_TILE;

  const T* qb = static_cast<const T*>(p.q) + ((long long)(b * p.Hq + head) * p.nq) * p.D;
  const T* kb = static_cast<const T*>(p.k) + ((long long)(b * p.Hkv + kvh) * p.nkv) * p.D;
  const T* vb = static_cast<const T*>(p.v) + ((long long)(b * p.Hkv + kvh) * p.nkv) * p.Dv;
  const float slope = p.alibi != nullptr ? p.alibi[b * p.Hq + head] : 0.f;

  // Resident Q: rows past Nq are zero-filled.
  for (int i = tid; i < BQ * (p.D / 8); i += NTHR) {
    const int r = i / (p.D / 8), c = (i % (p.D / 8)) * 8;
    const bool ok = row0 + r < p.nq;
    cp_async16(Qs + r * LDQ + c, ok ? qb + (long long)(row0 + r) * p.D + c : qb, ok);
  }
  cp_async_commit();
  for (int i = tid; i < BQ; i += NTHR) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }

  const int nD = p.D / CH, nV = p.Dv / CH, per_tile = nD + nV;
  const int ntiles = kv_hi > kv_lo ? (kv_hi - kv_lo + KV_TILE - 1) / KV_TILE : 0;
  const int total = ntiles * per_tile;

  // Chunk g of the stream: per KV tile, the nD K chunks then the nV V chunks,
  // 64 rows x 64 columns each, rows past Nkv zero-filled.
  auto issue = [&](int gi) {
    if (gi < total) {
      const int t = gi / per_tile, c = gi - t * per_tile;
      const int kv0 = kv_lo + t * KV_TILE;
      const T* src = c < nD ? kb : vb;
      const int ld = c < nD ? p.D : p.Dv;
      const int c0 = (c < nD ? c : c - nD) * CH;
      T* dst = ring + (gi % NST) * (KV_TILE * LDC);
      const int r = tid >> 3, cv = (tid & 7) * 8;  // one 16-byte vector per thread
      const bool ok = kv0 + r < p.nkv;
      cp_async16(dst + r * LDC + cv, ok ? src + (long long)(kv0 + r) * ld + c0 + cv : src, ok);
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

  // ldmatrix lane addressing (see common.cuh): A tiles and trans-B tiles
  // take rows lane % 16 at column 8 * (lane / 16); B from a [n][k] tile takes
  // n = lane % 8 (+ 8 for the second n8 tile), k = 8 * ((lane / 8) % 2).
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

    // Online softmax: each warp owns RPW rows, two columns per lane; the
    // rows' reductions are interleaved so their latencies overlap.
    {
      float sv[RPW][2], red[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp + i * NW, row = row0 + r;
        const bool valid = row < p.nq;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int cc = lane + 32 * j, col = kv0 + cc;
          const float s = score(p, S[r * LDS + cc], b, head, row, col, kv_hi, slope);
          sv[i][j] = s;
          if (p.s_out != nullptr)
            p.s_out[((long long)(b * p.Hq + head) * p.s_rows + row) * p.s_ld + col] =
                __float2bfloat16((!valid || s == -INFINITY) ? MASK_VALUE : s);
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
        m_new[i] = fmaxf(m_old, red[i]);
        float p0 = 0.f, p1 = 0.f;
        alpha[i] = 1.f;
        if (m_new[i] != -INFINITY) {
          alpha[i] = __expf(m_old - m_new[i]);
          p0 = __expf(sv[i][0] - m_new[i]);
          p1 = __expf(sv[i][1] - m_new[i]);
        }
        red[i] = p0 + p1;
        if (p.dropout_p > 0.f) {
          const int row = row0 + r, col = kv0 + lane;
          if (dropout_uniform(p.seed, b, head, row, col) < p.dropout_p) p0 = 0.f;
          if (dropout_uniform(p.seed, b, head, row, col + 32) < p.dropout_p) p1 = 0.f;
          p0 *= p.dropout_inv;
          p1 *= p.dropout_inv;
        }
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
    if (row >= p.nq) continue;
    const float l = l_s[r];
    const float l_safe = (l == 0.f) ? 1.f : l;
    const long long base = ((long long)(b * p.Hq + head) * p.nq) + row;
    T* dst = static_cast<T*>(p.o) + base * p.Dv;
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
    if (wc == 0 && t4 == 0) p.lse[base] = m_s[r] + logf(fmaxf(l, 1e-38f));
  }
}

template <typename T, int BQ>
cudaError_t launch(const FwdParams& p, int B, cudaStream_t stream) {
  auto kern = fwd_kernel<T, BQ>;
  const size_t smem = fwd_smem_bytes<T>(BQ, p.D);
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.Hq, B, (p.nq + BQ - 1) / BQ);
  kern<<<grid, NTHR, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// D, Dv <= 512: TMA + mbarrier + wgmma
// ---------------------------------------------------------------------------

// The Hopper route of ffpa_flash_fwd (the reference's SM90 split-D forward
// block, FFPAAttnFwdSm90SplitD). The mma.sync block above is bound by its
// block barriers and shared-memory round trips: every 64 x 64 chunk waits at
// two __syncthreads, S goes out to shared memory for a softmax on 512
// threads and P comes back the same way. Here a block of 384 threads owns
// 64 Q rows of one query head, with the same grid and block order:
//  - warpgroup 0 is the producer (setmaxnreg 24): one thread loads Q once
//    by TMA into D / 64 resident 64 x 64 boxes (128 B swizzle), then per KV
//    tile of the band streams the D / 64 K boxes and the Dv / 64 V boxes
//    through a ring of two-box stages (one mbarrier handshake per two
//    boxes); tensor maps at the true extents zero-fill rows past Nq and Nkv;
//  - warpgroups 1 and 2 are the consumers (setmaxnreg 240). The fp32 O
//    tile (64 x 512 at Dv 512) does not fit one warpgroup, so O is split by
//    columns: consumer c owns the Dv boxes of its half (128 registers a
//    thread at Dv 512) for the whole walk, and a V stage holds one box of
//    each half;
//  - per KV tile, consumer c computes S for KV columns 32c..32c+31 (wgmma
//    m64n32k16 over D, Q and the K box both K-major), so both do the same
//    tensor work. The scores stay in the accumulator's layout: a row lives
//    in the 4 threads of a quad (two shuffles a reduction); the two halves
//    of a row meet through a shared buffer of row maxima (a named barrier).
//    Each consumer writes its half of P into the shared P box (swizzled,
//    K-major); after a second named barrier, O[:, own columns] += P V
//    (m64n64k16 a box, V N-major with the transpose bit). The row sum l
//    stays per thread and is combined in the epilogue;
//  - a tile with no bias, ALiBi, softcap or dropout, inside the band and
//    the Nkv edge on every element, skips the per-element feature code.
// The two named barriers a tile also order the reuse of the P box and the
// exchange buffer. ptxas keeps the wgmma pipeline (no C7515 / C7520 note)
// because products start with scale-d 0, roles are template arguments,
// stage releases are predicated arrivals and every ordinary write of O (the
// zeros, the rescale) is fenced off from the products around it. A block
// reads its band's K and V from L2 once per 64 Q rows: 64 flop a byte.
namespace fwd {

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
// D, Dv <= 512 take this block, consumer 0 owning the first ceil(nv / 2)
// Dv boxes and consumer 1 the rest; wider heads take fwd_kernel, whose
// row tile is the largest the registers hold (block_q * Dv <= 64 * 512).
// ffpa_flash_fwd_plan hands it out; ops/config.py fwd_plan mirrors it and
// the card test holds the two equal.
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
    pl.smem = fwd_smem_bytes<__nv_bfloat16>(pl.rows, D);
  }
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

// A block's rows and the KV tiles of its band, [kv_lo, kv_hi) in ntiles
// tiles: the same in every thread.
struct Block {
  int b, head, kvh, row0, kv_lo, kv_hi, ntiles;
};
__device__ __forceinline__ Block block_of(const FwdParams& p) {
  Block k;
  k.head = blockIdx.x;
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

// The producer's thread: Q once, then per KV tile the K stages (two boxes
// each, an odd last box alone) and the V stages (box j of consumer 0's
// half beside box j of consumer 1's, alone where that half is shorter).
__device__ __forceinline__ void produce(const Maps& maps, const FwdParams& p, const Smem& sm,
                                        const Block& k, int nd, int nv, int nv0) {
  prefetch_map(&maps.q_map);
  prefetch_map(&maps.k_map);
  prefetch_map(&maps.v_map);
  const int bq = k.b * p.Hq + k.head, bkv = k.b * p.Hkv + k.kvh;
  mbar_arrive_expect_tx(sm.q_full, nd * BOX_BYTES);
  for (int j = 0; j < nd; ++j)
    tma_load_3d(sm.q + j * BOX_BYTES, &maps.q_map, sm.q_full, j * COLS, k.row0, bq);
  int it = 0;
  // Stage it % STAGES, free again, expecting nb boxes.
  auto claim = [&](int nb) -> unsigned char* {
    const int st = it % STAGES;
    if (it >= STAGES) mbar_wait(&sm.empty[st], ((it / STAGES) - 1) & 1);
    mbar_arrive_expect_tx(&sm.full[st], nb * BOX_BYTES);
    return sm.ring + st * STAGE_BYTES;
  };
  for (int t = 0; t < k.ntiles; ++t) {
    const int kv0 = k.kv_lo + t * KV_TILE;
    for (int c = 0; c < nd; c += STAGE_BOXES, ++it) {
      const int nb = min(STAGE_BOXES, nd - c);
      unsigned char* dst = claim(nb);
      for (int g = 0; g < nb; ++g)
        tma_load_3d(dst + g * BOX_BYTES, &maps.k_map, &sm.full[it % STAGES], (c + g) * COLS,
                    kv0, bkv);
    }
    for (int j = 0; j < nv0; ++j, ++it) {
      const bool both = nv0 + j < nv;
      unsigned char* dst = claim(both ? 2 : 1);
      tma_load_3d(dst, &maps.v_map, &sm.full[it % STAGES], j * COLS, kv0, bkv);
      if (both)
        tma_load_3d(dst + BOX_BYTES, &maps.v_map, &sm.full[it % STAGES], (nv0 + j) * COLS, kv0,
                    bkv);
    }
  }
}

// Consumer C of a block; C is a template argument so that no branch around
// a wgmma depends on the thread (ptxas serializes wgmma on a path it cannot
// prove uniform). Accumulator element 4 j + 2 hh + e of thread (warp, g =
// lane / 4, t4 = lane % 4) is row 16 warp + g + 8 hh and, in its 8-column
// block j, column 8 j + 2 t4 + e.
template <typename T, int C>
__device__ __forceinline__ void consume(const FwdParams& p, const Smem& sm, const Block& k,
                                        int nd, int nv, int nv0) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
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

  mbar_wait(sm.q_full, 0);
  for (int t = 0; t < k.ntiles; ++t) {
    const int kc = k.kv_lo + t * KV_TILE + 32 * C;  // this consumer's first KV column

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
        if (row >= p.s_rows) continue;
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
    T* dst = static_cast<T*>(p.o) + (bh * p.nq + row) * p.Dv + (C == 0 ? 0 : nv0 * COLS) + 2 * t4;
#pragma unroll
    for (int j = 0; j < O_BOXES; ++j) {
      if (j >= own) break;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8)
        *reinterpret_cast<uint32_t*>(dst + COLS * j + 8 * j8) =
            pack2<T>(o[32 * j + 4 * j8 + 2 * hh] * inv, o[32 * j + 4 * j8 + 2 * hh + 1] * inv);
    }
    if (C == 0 && t4 == 0) p.lse[bh * p.nq + row] = m[hh] + logf(fmaxf(lt, 1e-38f));
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) wgmma_fwd_kernel(const __grid_constant__ Maps maps,
                                                               const FwdParams p) {
  extern __shared__ unsigned char smem_raw[];
  // Boxes on 1024 B boundaries: the 128 B swizzle's atom.
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int nd = p.D / COLS, nv = p.Dv / COLS, nv0 = (nv + 1) / 2;
  const Smem sm = carve(base, nd);
  const Block k = block_of(p);
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
    if (threadIdx.x == 0) produce(maps, p, sm, k, nd, nv, nv0);
  } else {
    setmaxnreg_inc<240>();
    if (threadIdx.x < 256)
      consume<T, 0>(p, sm, k, nd, nv, nv0);
    else
      consume<T, 1>(p, sm, k, nd, nv, nv0);
  }
}

// The host side of one launch: tensor maps, shared memory, the grid.
template <typename T>
cudaError_t launch(const FwdParams& p, const Plan& pl, int B, cudaStream_t stream) {
  const dim3 grid(p.Hq, B, (p.nq + ROWS - 1) / ROWS);
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
  e = cudaFuncSetAttribute(wgmma_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)pl.smem);
  if (e != cudaSuccess) return e;
  wgmma_fwd_kernel<T><<<grid, THREADS, pl.smem, stream>>>(maps, p);
  return cudaGetLastError();
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
                              void* stream) {
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
  // Registers hold block_q x Dv fp32 (64 per thread); D and Dv are 64-multiples.
  // The S residual's rows cover every block's rows, its columns every tile.
  if (D % CH != 0 || Dv % CH != 0 || (long long)block_q * Dv > 32 * 1024 ||
      (block_q != 64 && block_q != 32) ||
      (s_out != nullptr && (s_rows < ((nq + block_q - 1) / block_q) * block_q ||
                            s_ld < ((nkv + KV_TILE - 1) / KV_TILE) * KV_TILE)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const fwd::Plan pl = fwd::make_plan(D, Dv);
  if (pl.route == fwd::WGMMA)  // picks its own 64-row tile; block_q is only checked
    return (int)(is_fp16 ? fwd::launch<__half>(p, pl, B, st)
                         : fwd::launch<__nv_bfloat16>(p, pl, B, st));
  if (is_fp16) {
    return (int)(block_q == 64 ? launch<__half, 64>(p, B, st) : launch<__half, 32>(p, B, st));
  }
  return (int)(block_q == 64 ? launch<__nv_bfloat16, 64>(p, B, st)
                             : launch<__nv_bfloat16, 32>(p, B, st));
}

// The route and tiling ffpa_flash_fwd takes at head dims (D, Dv), multiples
// of 64: out[0..4] are the route (1 wgmma, 0 mma.sync), the Q rows of a
// block (for mma.sync the largest row tile the registers hold), the KV
// rows of a tile, the ring's stages and the dynamic shared-memory bytes;
// out[5] the number of O column blocks (the consumers' halves, or the
// whole block's), then (first column, width) of each; cap is out's length.
extern "C" int ffpa_flash_fwd_plan(int D, int Dv, int* out, int cap) {
  if (D <= 0 || Dv <= 0 || D % CH != 0 || Dv % CH != 0 || cap < 10)
    return (int)cudaErrorInvalidValue;
  const fwd::Plan pl = fwd::make_plan(D, Dv);
  out[0] = pl.route;
  out[1] = pl.rows;
  out[2] = KV_TILE;
  out[3] = pl.stages;
  out[4] = (int)pl.smem;
  if (pl.route == fwd::WGMMA) {
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
// warpgroups) and local (spill) bytes a thread of a forward kernel: route 1
// the wgmma kernel, 0 fwd_kernel at row tile block_q (64 or 32), in f16 or
// bf16.
extern "C" int ffpa_flash_fwd_attrs(int route, int is_fp16, int block_q, int* regs,
                                    int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e;
  if (route == fwd::WGMMA)
    e = is_fp16 ? cudaFuncGetAttributes(&a, fwd::wgmma_fwd_kernel<__half>)
                : cudaFuncGetAttributes(&a, fwd::wgmma_fwd_kernel<__nv_bfloat16>);
  else if (block_q == 64)
    e = is_fp16 ? cudaFuncGetAttributes(&a, fwd_kernel<__half, 64>)
                : cudaFuncGetAttributes(&a, fwd_kernel<__nv_bfloat16, 64>);
  else
    e = is_fp16 ? cudaFuncGetAttributes(&a, fwd_kernel<__half, 32>)
                : cudaFuncGetAttributes(&a, fwd_kernel<__nv_bfloat16, 32>);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}
