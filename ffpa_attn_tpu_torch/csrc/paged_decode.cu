// Paged decode attention for Hopper (sm_90a): the counterpart of the Pallas
// _paged_decode_kernel (ffpa_attn_tpu/ops/paged.py). ops/paged.py calls the C
// entry point ffpa_paged_decode through ctypes.
//
// K/V live in a global pool of pages [P, Hkv, page, D] (bf16/f16, or int8
// with per-row fp32 scales [P, Hkv, page]); sequence b's cache position pos
// is row pos % page of pool page table[b * max_pages + pos / page], and
// lens[b] rows are valid. Packed row r (query head hkv * group + r / nq at
// position r % nq, PackGQA: K/V stream once per KV head) attends cached
// positions < lens - (nq - 1) + r % nq (all nq new tokens already appended),
// and with a window those >= that limit - 1 - window_left. int8 pools: the K
// scale multiplies S (before softcap, so the cap sees the true logit) and the
// V scale multiplies P after the row sum, so no page is dequantized.
//
// Bound on an H100: bytes. At R = 2 packed rows the kernel does 2
// multiply-adds per K element it loads, against the card's balance point of
// 295 flop per byte (utils/profiling.py paged_decode_counts): the time is the
// cache's bytes over 3.35 TB/s plus whatever latency is not hidden. The TPU
// grid (B, Hkv, max_pages) walks one sequence's pages in order; at the
// serving shape that is 16 blocks for 132 SMs. So the walk is split, and
// launch 2 merges the splits by LSE (split_merge.cuh, the dense decode's):
//   launch 1, grid (splits, Hkv * row_blocks, B), writes fp32 partials
//     normalised by their own l with lse_s = m + log l (-inf where a split
//     attended nothing), [B, Hkv, splits, R, Dv] and [B, Hkv, splits, R].
//
// Two routes for launch 1, chosen by make_plan (ffpa_paged_plan hands it out,
// ops/config.py paged_plan mirrors it):
//
// * TMA (namespace tma; D, Dv <= 512 in 64-column multiples, pages of a
//   multiple of 16 rows): built for bytes in flight and blocks with work.
//   Each block cuts its split from its own sequence's length on the device:
//   the live range [first, lens[b]) (first: the window's first position
//   rounded down to a 64-row tile, else 0) is cut into `splits` near-equal
//   runs of whole tiles, so every block of a live sequence streams about the
//   same bytes and none streams positions past lens[b]. One producer thread
//   reads the page table once per box and keeps a ring of 8 KiB stages full
//   (up to 12, about 90 KiB in flight a block, two blocks an SM): each stage
//   is 64 cache rows x 128 B of K or V (64 bf16/f16 or 128 int8 columns), as
//   TMA boxes of box_rows rows (box_rows divides the page and 64, so a box
//   never crosses a page) through a 3-D map (D, page, P * Hkv) with the 128 B
//   swizzle. One consumer warpgroup does the math with wgmma, roles swapped
//   so the 64 cache rows are M and the packed rows N = 16: S^T = K Q^T (Q
//   resident in 16-row boxes) and O^T += V^T P^T (V read M-major, P^T through
//   one swizzled 16 x 64 box); S and the fp32 O^T (64 registers a thread at
//   Dv 512) stay in registers, the row maxima cross the four warps through
//   shared memory, and only two 128-thread named barriers a tile stand
//   between the stages. int8 stages are widened to the query type into two
//   swizzled 64 x 64 boxes by the consumers before their products.
// * cp.async (paged_decode_kernel below; any other shape: D or Dv > 512, a
//   page that is no multiple of 16): a block of BQ packed rows walks
//   [s * kv_per_split, (s + 1) * kv_per_split) cut to [window start, lens)
//   in 64-row tiles with nvcuda::wmma fragments, the fp32 O tile in shared
//   memory, Q/K chunk pairs and V chunks streamed through two slots one chunk
//   ahead with each row's address looked up in the page table; int8 chunks
//   are widened into a staging tile.
#include <mma.h>
#include <string.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "sm90.cuh"
#include "split_merge.cuh"

namespace {

using namespace ffpa;
using namespace nvcuda;

constexpr int KV_TILE = 64;   // K/V rows per tile (ops/config.py KV_TILE)
constexpr int D_CHUNK = 64;   // head-dim columns per streamed chunk
constexpr int PAD_T = 8;      // row padding of 16-bit tiles, in elements
constexpr int PAD_F = 4;      // row padding of fp32 tiles, in elements
constexpr int LDT = D_CHUNK + PAD_T;  // Q/K/V chunk and P row stride (KV_TILE == D_CHUNK)
constexpr int LDS = KV_TILE + PAD_F;  // S row stride
constexpr int LDB = D_CHUNK + 16;     // int8 chunk row stride, in bytes
constexpr int NSTAGES = 2;    // stream slots (ops/config.py DECODE_STREAM_STAGES)
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory a block may opt into
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
static_assert(NTHREADS == KV_TILE * (D_CHUNK / 16), "one int8 vector per thread per chunk");

struct PagedParams {
  const void* q;          // packed [B, Hkv, R, D]
  const void* k_pages;    // [P, Hkv, page, D]
  const void* v_pages;    // [P, Hkv, page, Dv]
  const float* k_scales;  // [P, Hkv, page] (int8 pools), else null
  const float* v_scales;
  const int* table;       // [B * max_pages] pool page ids
  const int* lens;        // [B] cached positions per sequence
  float* o_part;          // [B, Hkv, splits, R, Dv] fp32 partials
  float* lse_part;        // [B, Hkv, splits, R]
  int Hkv, nrows, nq, D, Dv, page, max_pages;
  float scale, softcap;
  int window_left;
  int kv_per_split, num_splits, row_blocks;
};

// Dynamic shared memory of one block; ops/config.py paged_smem_bytes is the
// same formula.
template <typename T, bool Q8>
size_t paged_smem_bytes(int bq, int dv) {
  return (size_t)bq * (dv + PAD_F) * 4 + (size_t)bq * LDS * 4 + (size_t)bq * LDT * sizeof(T) +
         NSTAGES * (size_t)(bq + KV_TILE) * LDT * sizeof(T) + 3 * (size_t)bq * 4 +
         (Q8 ? (size_t)KV_TILE * LDT * sizeof(T) : 0);
}

template <typename T, int BQ, bool Q8>
__global__ void __launch_bounds__(NTHREADS) paged_decode_kernel(const PagedParams p) {
  using KVT = typename std::conditional<Q8, int8_t, T>::type;
  constexpr int RT = BQ / 16;                          // 16-row tiles
  constexpr int CT = KV_TILE / 16;                     // 16-col tiles per S / O chunk
  constexpr int NT = RT * CT;                          // wmma tiles per S / O chunk
  constexpr int TPW = (NT + NWARPS - 1) / NWARPS;      // tiles per warp
  constexpr int SLOT = (BQ + KV_TILE) * LDT;           // elements per stream slot
  constexpr int RPW = BQ / NWARPS;                     // softmax rows per warp
  constexpr int KV_ROW_BYTES = Q8 ? LDB : LDT * (int)sizeof(T);  // K/V chunk row stride
  constexpr int VPR = D_CHUNK * (int)sizeof(KVT) / 16;  // 16-byte vectors per K/V chunk row
  static_assert(BQ % NWARPS == 0, "row tile must split evenly over the warps");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int LDO = p.Dv + PAD_F;
  float* O = reinterpret_cast<float*>(smem_raw);
  float* S = O + BQ * LDO;
  T* P = reinterpret_cast<T*>(S + BQ * LDS);
  T* slots = P + BQ * LDT;
  T* KT = slots + NSTAGES * SLOT;  // int8 pools: the widened K or V chunk
  float* m_s = reinterpret_cast<float*>(KT + (Q8 ? KV_TILE * LDT : 0));
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y / p.row_blocks;
  const int row0 = (blockIdx.y % p.row_blocks) * BQ;
  const int split_lo = blockIdx.x * p.kv_per_split;
  const int n = p.lens[b];
  int kv_lo = split_lo;
  if (p.window_left >= 0) {
    // The earliest position any of the nq rows attends (row 0's window start).
    const int first = max(0, n - p.nq - p.window_left);
    kv_lo = max(kv_lo, (first / KV_TILE) * KV_TILE);
  }
  const int kv_hi = min(min(split_lo + p.kv_per_split, n), p.max_pages * p.page);
  const int* trow = p.table + (long long)b * p.max_pages;
  const T* qb = static_cast<const T*>(p.q) + ((long long)(b * p.Hkv + kvh) * p.nrows) * p.D;
  const KVT* kpool = static_cast<const KVT*>(p.k_pages);
  const KVT* vpool = static_cast<const KVT*>(p.v_pages);

  // Pool row (in units of head-dim rows) of this sequence's cache position.
  auto pool_row = [&](int pos) -> long long {
    return ((long long)trow[pos / p.page] * p.Hkv + kvh) * p.page + pos % p.page;
  };

  for (int i = tid; i < BQ * LDO; i += NTHREADS) O[i] = 0.f;
  for (int i = tid; i < BQ; i += NTHREADS) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
    a_s[i] = 1.f;
  }

  const int nD = p.D / D_CHUNK, nV = p.Dv / D_CHUNK, per_tile = nD + nV;
  const int ntiles = kv_hi > kv_lo ? (kv_hi - kv_lo + KV_TILE - 1) / KV_TILE : 0;
  const int total = ntiles * per_tile;

  // A [64, 64] chunk of K or V at cache positions kv0.., through the table;
  // positions past kv_hi are zero-filled.
  auto load_kv = [&](T* dst, const KVT* pool, int kv0, int ld, int c0) {
    for (int i = tid; i < KV_TILE * VPR; i += NTHREADS) {
      const int r = i / VPR, cv = (i % VPR) * (16 / (int)sizeof(KVT));
      const int pos = kv0 + r;
      const bool ok = pos < kv_hi;
      const KVT* src = ok ? pool + pool_row(pos) * ld + c0 + cv : pool;
      cp_async16(reinterpret_cast<unsigned char*>(dst) + r * KV_ROW_BYTES + cv * sizeof(KVT), src,
                 ok);
    }
  };
  // Chunk g of the stream: per KV tile, nD (Q, K) chunk pairs then nV V chunks.
  auto issue = [&](int g) {
    if (g < total) {
      const int t = g / per_tile, c = g - t * per_tile;
      T* dst = slots + (g % NSTAGES) * SLOT;
      const int kv0 = kv_lo + t * KV_TILE;
      if (c < nD) {
        for (int i = tid; i < BQ * (D_CHUNK / 8); i += NTHREADS) {
          const int r = i / (D_CHUNK / 8), cv = (i % (D_CHUNK / 8)) * 8;
          const bool ok = row0 + r < p.nrows;
          cp_async16(dst + r * LDT + cv,
                     ok ? qb + (long long)(row0 + r) * p.D + c * D_CHUNK + cv : qb, ok);
        }
        load_kv(dst + BQ * LDT, kpool, kv0, p.D, c * D_CHUNK);
      } else {
        load_kv(dst, vpool, kv0, p.Dv, (c - nD) * D_CHUNK);
      }
    }
    cp_async_commit();
  };
  // int8 pools: widen the raw chunk at raw into KT (64 rows x 4 vectors of 16).
  auto widen = [&](const T* raw) {
    const int r = tid >> 2, c16 = (tid & 3) * 16;
    const int4 x =
        *reinterpret_cast<const int4*>(reinterpret_cast<const unsigned char*>(raw) + r * LDB + c16);
    const int8_t* e = reinterpret_cast<const int8_t*>(&x);
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = pack2<T>((float)e[2 * i], (float)e[2 * i + 1]);
    uint4* d = reinterpret_cast<uint4*>(KT + r * LDT + c16);
    d[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d[1] = make_uint4(w[4], w[5], w[6], w[7]);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TPW];
#pragma unroll
  for (int g = 0; g < NSTAGES - 1; ++g) issue(g);
  for (int t = 0; t < ntiles; ++t) {
    const int kv0 = kv_lo + t * KV_TILE;
#pragma unroll
    for (int i = 0; i < TPW; ++i) wmma::fill_fragment(acc[i], 0.f);
    for (int c = 0; c < per_tile; ++c) {
      const int g = t * per_tile + c;
      issue(g + NSTAGES - 1);  // into the slot chunk g - 1 used
      cp_async_wait<NSTAGES - 1>();
      __syncthreads();
      const T* cur = slots + (g % NSTAGES) * SLOT;
      const T* kv_tile = c < nD ? cur + BQ * LDT : cur;  // the K or V chunk, [64, LDT]
      if constexpr (Q8) {
        widen(kv_tile);
        __syncthreads();
        kv_tile = KT;
      }
      if (c < nD) {
        // S += Q_chunk K_chunk^T
#pragma unroll
        for (int i = 0; i < TPW; ++i) {
          const int tile = warp + i * NWARPS;
          if (tile < NT) {
            const int rt = tile / CT, ct = tile % CT;
#pragma unroll
            for (int kk = 0; kk < D_CHUNK / 16; ++kk) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
              wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> fb;
              wmma::load_matrix_sync(fa, cur + rt * 16 * LDT + kk * 16, LDT);
              wmma::load_matrix_sync(fb, kv_tile + ct * 16 * LDT + kk * 16, LDT);
              wmma::mma_sync(acc[i], fa, fb, acc[i]);
            }
          }
        }
        if (c == nD - 1) {
#pragma unroll
          for (int i = 0; i < TPW; ++i) {
            const int tile = warp + i * NWARPS;
            if (tile < NT) {
              const int rt = tile / CT, ct = tile % CT;
              wmma::store_matrix_sync(S + rt * 16 * LDS + ct * 16, acc[i], LDS,
                                      wmma::mem_row_major);
            }
          }
          __syncthreads();
          // Online softmax: each warp owns RPW rows, two columns per lane.
          float ksc[2] = {1.f, 1.f}, vsc[2] = {1.f, 1.f};
          if constexpr (Q8) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int pos = kv0 + lane + 32 * j;
              if (pos < kv_hi) {
                const long long pr = pool_row(pos);
                ksc[j] = p.k_scales[pr];
                vsc[j] = p.v_scales[pr];
              }
            }
          }
          float sv[RPW][2], red[RPW];
          bool keep[RPW][2];
#pragma unroll
          for (int i = 0; i < RPW; ++i) {
            const int r = warp + i * NWARPS;
            const int row = row0 + r;
            const bool valid = row < p.nrows;
            const int limit = n - (p.nq - 1) + row % p.nq;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int cc = lane + 32 * j, col = kv0 + cc;
              bool kp = valid && col < kv_hi && col < limit;
              if (p.window_left >= 0) kp = kp && col >= limit - 1 - p.window_left;
              float s = MASK_VALUE;
              if (kp) {
                s = S[r * LDS + cc] * p.scale * ksc[j];
                if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
              }
              sv[i][j] = s;
              keep[i][j] = kp;
            }
            red[i] = fmaxf(sv[i][0], sv[i][1]);
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
#pragma unroll
            for (int i = 0; i < RPW; ++i)
              red[i] = fmaxf(red[i], __shfl_xor_sync(0xffffffffu, red[i], o));
          float m_new[RPW], alpha[RPW];
#pragma unroll
          for (int i = 0; i < RPW; ++i) {
            const int r = warp + i * NWARPS;
            const float m_old = m_s[r];
            m_new[i] = fmaxf(m_old, red[i]);  // >= MASK_VALUE: finite from the first tile on
            alpha[i] = __expf(m_old - m_new[i]);
            const float p0 = keep[i][0] ? __expf(sv[i][0] - m_new[i]) : 0.f;
            const float p1 = keep[i][1] ? __expf(sv[i][1] - m_new[i]) : 0.f;
            P[r * LDT + lane] = from_float<T>(p0 * vsc[0]);  // V's dequant folded into P
            P[r * LDT + lane + 32] = from_float<T>(p1 * vsc[1]);
            red[i] = p0 + p1;
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
#pragma unroll
            for (int i = 0; i < RPW; ++i) red[i] += __shfl_xor_sync(0xffffffffu, red[i], o);
          __syncwarp();
          if (lane == 0) {
#pragma unroll
            for (int i = 0; i < RPW; ++i) {
              const int r = warp + i * NWARPS;
              m_s[r] = m_new[i];
              l_s[r] = alpha[i] * l_s[r] + red[i];
              a_s[r] = alpha[i];
            }
          }
        }
      } else {
        // O[:, chunk] = alpha * O[:, chunk] + P V_chunk
        const int vc = c - nD;
#pragma unroll
        for (int i = 0; i < TPW; ++i) {
          const int tile = warp + i * NWARPS;
          if (tile < NT) {
            const int rt = tile / CT, ct = tile % CT;
            float* op = O + rt * 16 * LDO + vc * D_CHUNK + ct * 16;
            if (t > 0) {
              const int r = lane >> 1, c8 = (lane & 1) * 8;
              const float al = a_s[rt * 16 + r];
              float4* o4 = reinterpret_cast<float4*>(op + r * LDO + c8);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float4 x = o4[h];
                x.x *= al;
                x.y *= al;
                x.z *= al;
                x.w *= al;
                o4[h] = x;
              }
              __syncwarp();
            }
            wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc;
            wmma::load_matrix_sync(oacc, op, LDO, wmma::mem_row_major);
#pragma unroll
            for (int kk = 0; kk < KV_TILE / 16; ++kk) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa;
              wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb;
              wmma::load_matrix_sync(fa, P + rt * 16 * LDT + kk * 16, LDT);
              wmma::load_matrix_sync(fb, kv_tile + kk * 16 * LDT + ct * 16, LDT);
              wmma::mma_sync(oacc, fa, fb, oacc);
            }
            wmma::store_matrix_sync(op, oacc, LDO, wmma::mem_row_major);
          }
        }
      }
      __syncthreads();  // the slot (and staging tile) read here is refilled next
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: partial o_s = O / l and lse_s = m + log(l); a row that attended
  // nothing here gives o_s = 0 and lse_s = -inf, which the merge weighs 0.
  for (int r = warp; r < BQ; r += NWARPS) {
    const int row = row0 + r;
    if (row >= p.nrows) continue;
    const float l = l_s[r];
    const float l_safe = (l == 0.f) ? 1.f : l;
    const float* orow = O + r * LDO;
    const long long base =
        (((long long)(b * p.Hkv + kvh) * p.num_splits + blockIdx.x) * p.nrows) + row;
    float* dst = p.o_part + base * p.Dv;
    for (int c = lane * 4; c < p.Dv; c += 128) {
      float4 x = *reinterpret_cast<const float4*>(orow + c);
      x.x /= l_safe;
      x.y /= l_safe;
      x.z /= l_safe;
      x.w /= l_safe;
      *reinterpret_cast<float4*>(dst + c) = x;
    }
    if (lane == 0) p.lse_part[base] = (l == 0.f) ? -INFINITY : m_s[r] + logf(fmaxf(l, 1e-38f));
  }
}

template <typename T, int BQ, bool Q8>
cudaError_t launch_partials(const PagedParams& p, dim3 grid, cudaStream_t stream) {
  auto kern = paged_decode_kernel<T, BQ, Q8>;
  const size_t smem = paged_smem_bytes<T, Q8>(BQ, p.Dv);
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool Q8>
cudaError_t launch_paged(const PagedParams& p, void* o, float* lse, int block_rows, int B,
                         cudaStream_t st) {
  const dim3 grid(p.num_splits, p.Hkv * p.row_blocks, B);
  cudaError_t e;
  switch (block_rows) {
    case 16: e = launch_partials<T, 16, Q8>(p, grid, st); break;
    case 32: e = launch_partials<T, 32, Q8>(p, grid, st); break;
    case 64: e = launch_partials<T, 64, Q8>(p, grid, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  return launch_split_merge<T>(p.o_part, p.lse_part, o, lse, p.nrows, p.num_splits, p.Dv,
                               B * p.Hkv, st);
}

// ---------------------------------------------------------------------------
// The TMA route
// ---------------------------------------------------------------------------

namespace tma {

using namespace ffpa::sm90;

constexpr int ROWS = 16;                       // packed rows of a block: wgmma's N
constexpr int TILE = 64;                       // cache rows of a tile: wgmma's M (KV_TILE)
constexpr int STAGE_BYTES = TILE * 128;        // 64 rows x 128 B of K or V
constexpr int MAX_BOXES = 8;                   // D, Dv <= 512: 64-column boxes of Q and of O
constexpr int MAX_STAGES = 12;
constexpr int CONSUMERS = 128;                 // one warpgroup: the math
constexpr int THREADS = CONSUMERS + 32;        // and one producer warp
constexpr int CONSUMER_WARPS = CONSUMERS / 32; // arrivals that free a stage
constexpr int Q_BOX_BYTES = ROWS * 128;        // 16 rows x 64 columns of Q, or of P^T
constexpr int STAGING_BYTES = 2 * BOX_BYTES;   // an int8 stage widened: two 64 x 64 boxes
constexpr int XCH_FLOATS = 2 * CONSUMER_WARPS * ROWS;  // per-warp row maxima, two tiles
// Two blocks an SM: 228 KiB of shared memory, 1 KiB of it reserved a block.
constexpr size_t BLOCK_SMEM = 115712;
static_assert(TILE == KV_TILE, "a tile is the cp.async kernel's");

// Shared memory of a block besides its ring (a stage is STAGE_COST with its
// two barriers): the 1024 B alignment, int8's two staging buffers, Q's
// boxes, the P^T box and the exchange.
constexpr size_t fixed_bytes(int nd, bool q8) {
  return 1024 + (q8 ? 2 * (size_t)STAGING_BYTES : 0) + (size_t)(nd + 1) * Q_BOX_BYTES +
         XCH_FLOATS * sizeof(float);
}
constexpr size_t STAGE_COST = STAGE_BYTES + 2 * sizeof(uint64_t);
static_assert(fixed_bytes(MAX_BOXES, true) + 2 * STAGE_COST <= BLOCK_SMEM,
              "int8 at D512 keeps a ring of two stages or more");

// Shared memory of a block, from a 1024 B boundary.
struct Smem {
  unsigned char* ring;     // stages x 8 KiB
  unsigned char* staging;  // int8: two buffers of two widened boxes
  unsigned char* q;        // nd boxes of 16 x 64
  unsigned char* p;        // P^T: 16 packed rows x 64 cache rows
  float* xch;              // [2][CONSUMER_WARPS][ROWS]
  uint64_t* full;
  uint64_t* empty;
};
__device__ __forceinline__ Smem carve(unsigned char* base, int nd, int stages, bool q8) {
  Smem sm;
  sm.ring = base;
  sm.staging = sm.ring + (size_t)stages * STAGE_BYTES;
  sm.q = sm.staging + (q8 ? 2 * STAGING_BYTES : 0);
  sm.p = sm.q + nd * Q_BOX_BYTES;
  sm.xch = reinterpret_cast<float*>(sm.p + Q_BOX_BYTES);
  sm.full = reinterpret_cast<uint64_t*>(sm.xch + XCH_FLOATS);
  sm.empty = sm.full + stages;
  return sm;
}

// The kernel's tensor maps, a __grid_constant__ parameter of their own (TMA
// reads them by address); the scalars stay an ordinary parameter.
struct Maps {
  CUtensorMap k_map;  // (D, page, P * Hkv); box (128 B, box_rows, 1)
  CUtensorMap v_map;  // (Dv, page, P * Hkv)
};

struct Params {
  const void* q;          // packed [B, Hkv, R, D]
  const float* k_scales;  // [P, Hkv, page] (int8 pools), else null
  const float* v_scales;
  const int* table;       // [B * max_pages]
  const int* lens;        // [B]
  float* o_part;          // [B, Hkv, splits, R, Dv]
  float* lse_part;        // [B, Hkv, splits, R]
  int Hkv, nrows, nq, D, Dv, page, max_pages, box_rows, stages, num_splits, row_blocks;
  float scale, softcap;
  int window_left;
};

// A pool map: 3-D (columns, row in page, page * Hkv + kv head) of one pool,
// 128 B boxes of box_rows rows, 128 B swizzle. int8 pools move as bytes.
inline cudaError_t encode_pool(CUtensorMap* map, int esize, bool f16, const void* base, int cols,
                               int page, uint64_t slabs, int box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const CUtensorMapDataType dt = esize == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                 : f16      ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)page, slabs};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * esize, (cuuint64_t)page * cols * esize};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / esize), (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || strides[0] % 16 != 0)
    return cudaErrorInvalidValue;
  const CUresult r = fn(map, dt, 3, const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A block's packed rows and cache rows: its split of the live range
// [first, n), cut on the device from lens[b] into num_splits near-equal runs
// of whole tiles (ops/paged.py paged_split_ranges is the same rule). The
// same in every thread.
struct Range {
  int b, kvh, row0, n, kv_lo, kv_hi, ntiles;
};
__device__ __forceinline__ Range range_of(const Params& p) {
  Range r;
  r.b = blockIdx.z;
  r.kvh = blockIdx.y / p.row_blocks;
  r.row0 = (blockIdx.y % p.row_blocks) * ROWS;
  r.n = min(p.lens[r.b], p.max_pages * p.page);
  int first = 0;
  if (p.window_left >= 0) first = (max(0, r.n - p.nq - p.window_left) / TILE) * TILE;
  const int live = r.n > first ? (r.n - first + TILE - 1) / TILE : 0;
  const int t0 = (int)((long long)blockIdx.x * live / p.num_splits);
  const int t1 = (int)((long long)(blockIdx.x + 1) * live / p.num_splits);
  r.kv_lo = first + t0 * TILE;
  r.kv_hi = min(first + t1 * TILE, r.n);
  r.ntiles = t1 - t0;
  return r;
}

// The producer's thread: per tile, the page of each box read once from the
// table (past the table's end, the null page: such rows are masked), then
// the K stages and the V stages, each all the boxes of 64 rows of one 128 B
// column slab.
__device__ __forceinline__ void produce(const Maps& maps, const Params& p, const Smem& sm,
                                        const Range& r, int nks, int nvs, int slab_cols) {
  prefetch_map(&maps.k_map);
  prefetch_map(&maps.v_map);
  const int* trow = p.table + (long long)r.b * p.max_pages;
  const int nb = TILE / p.box_rows;
  int it = 0;
  for (int t = 0; t < r.ntiles; ++t) {
    const int kv0 = r.kv_lo + t * TILE;
    int slab[4], off[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      slab[i] = 0;
      off[i] = 0;
      if (i < nb) {
        const int pos = kv0 + i * p.box_rows, pi = pos / p.page;
        const int pid = pi < p.max_pages ? __ldg(trow + pi) : 0;
        slab[i] = pid * p.Hkv + r.kvh;
        off[i] = pos - pi * p.page;
      }
    }
#pragma unroll 1
    for (int kv = 0; kv < 2; ++kv) {
      const CUtensorMap* map = kv ? &maps.v_map : &maps.k_map;
      const int ns = kv ? nvs : nks;
      for (int j = 0; j < ns; ++j, ++it) {
        const int st = it % p.stages;
        if (it >= p.stages) mbar_wait(&sm.empty[st], ((it / p.stages) - 1) & 1);
        mbar_arrive_expect_tx(&sm.full[st], STAGE_BYTES);
        unsigned char* dst = sm.ring + (size_t)st * STAGE_BYTES;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i < nb)
            tma_load_3d(dst + i * p.box_rows * 128, map, &sm.full[st], j * slab_cols, off[i],
                        slab[i]);
      }
    }
  }
}

// Four int8 values (one 32-bit word) as two pairs of the query type; exact
// (|x| <= 128 fits both types' significands).
template <typename T>
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo, uint32_t& hi);
template <>
__device__ __forceinline__ void widen4<__half>(uint32_t w, uint32_t& lo, uint32_t& hi) {
  // 0x64uu is 1024 + u in f16; u = x + 128.
  const uint32_t u = w ^ 0x80808080u;
  const uint32_t a = __byte_perm(u, 0x64646464u, 0x4140), b = __byte_perm(u, 0x64646464u, 0x4342);
  const __half2 bias = __halves2half2(__ushort_as_half(0x6480), __ushort_as_half(0x6480));
  const __half2 x = __hsub2(*reinterpret_cast<const __half2*>(&a), bias);
  const __half2 y = __hsub2(*reinterpret_cast<const __half2*>(&b), bias);
  lo = *reinterpret_cast<const uint32_t*>(&x);
  hi = *reinterpret_cast<const uint32_t*>(&y);
}
template <>
__device__ __forceinline__ void widen4<__nv_bfloat16>(uint32_t w, uint32_t& lo, uint32_t& hi) {
  // 0x4B0000uu is 2^23 + u in fp32; the integer result's top half is its bf16.
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// An int8 stage (64 rows x 128 columns, swizzled) widened to two swizzled
// 64 x 64 boxes of T: thread tid takes half a row, 4 chunks of 16 values
// (the second half in rotated order, so no two threads of a quarter warp
// meet in a bank).
template <typename T>
__device__ __forceinline__ void widen_stage(const unsigned char* src, unsigned char* dst,
                                            int tid) {
  const int row = tid >> 1, half = tid & 1, sw = row & 7;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cc = half ? 4 + ((k + 2) & 3) : k;  // 16-column chunk of the int8 row
    const uint4 x = *reinterpret_cast<const uint4*>(src + row * 128 + ((cc ^ sw) << 4));
    uint32_t w[8];
    widen4<T>(x.x, w[0], w[1]);
    widen4<T>(x.y, w[2], w[3]);
    widen4<T>(x.z, w[4], w[5]);
    widen4<T>(x.w, w[6], w[7]);
    unsigned char* box = dst + (cc >> 2) * BOX_BYTES + row * 128;
    const int c0 = 2 * (cc & 3);  // its two 8-column chunks in the box
    *reinterpret_cast<uint4*>(box + ((c0 ^ sw) << 4)) = make_uint4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<uint4*>(box + (((c0 + 1) ^ sw) << 4)) = make_uint4(w[4], w[5], w[6], w[7]);
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

// The consumer warpgroup. Accumulator element 4 j + 2 hh + e of thread (warp,
// g = lane / 4, t4 = lane % 4) is M row 16 warp + g + 8 hh and packed row
// (N column) 8 j + 2 t4 + e: for S^T the cache row kv0 + 16 warp + g + 8 hh,
// for O^T box i's column 64 i + 16 warp + g + 8 hh. Element 4 j + 2 hh + e
// belongs to this thread's packed-row slot jj = 2 j + e.
template <typename T, bool Q8>
__device__ __forceinline__ void consume(const Params& p, const Smem& sm, const Range& r, int nd,
                                        int nv, int nks, int nvs) {
  constexpr int MAX_VS = Q8 ? MAX_BOXES / 2 : MAX_BOXES;  // V stages of a tile, at most
  constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  // Q: the block's 16 packed rows (zeros past R) into nd swizzled boxes.
  const T* qb = static_cast<const T*>(p.q) + (long long)(r.b * p.Hkv + r.kvh) * p.nrows * p.D;
  for (int i = tid; i < ROWS * nd * 8; i += CONSUMERS) {
    const int row = i / (nd * 8), c = i - row * (nd * 8);  // 8-column chunk c of the row
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r.row0 + row < p.nrows)
      x = *reinterpret_cast<const uint4*>(qb + (long long)(r.row0 + row) * p.D + 8 * c);
    *reinterpret_cast<uint4*>(sm.q + (c >> 3) * Q_BOX_BYTES + swz(row, 8 * (c & 7))) = x;
  }

  int col[4], lim[4];
  bool live[4];
  float m[4], l[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    col[jj] = 8 * (jj >> 1) + 2 * t4 + (jj & 1);
    const int row = r.row0 + col[jj];
    live[jj] = row < p.nrows;
    lim[jj] = r.n - (p.nq - 1) + row % p.nq;
    m[jj] = -INFINITY;
    l[jj] = 0.f;
  }
  float o[MAX_BOXES * 8];
#pragma unroll
  for (int i = 0; i < MAX_BOXES * 8; ++i) o[i] = 0.f;
  fence_operands(o);
  fence_proxy_async();
  named_barrier_sync(1, CONSUMERS);  // Q is in

  // it: the stream's stage index; held: a stage whose products may still
  // run (one group stays in flight); sg: int8 staging buffers used.
  int it = 0, held = -1, sg = 0;
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
  // int8: stage st widened into the next staging buffer, then freed; the
  // buffer's products of two stages before completed at the last wait.
  auto widen = [&](int st) -> const unsigned char* {
    unsigned char* stg = sm.staging + (sg++ & 1) * STAGING_BYTES;
    widen_stage<T>(sm.ring + (size_t)st * STAGE_BYTES, stg, tid);
    __syncwarp();
    release(st, true);
    fence_proxy_async();
    named_barrier_sync(1, CONSUMERS);
    return stg;
  };
  const int* trow = p.table + (long long)r.b * p.max_pages;

  for (int t = 0; t < r.ntiles; ++t) {
    const int kv0 = r.kv_lo + t * TILE;
    int pos[2];
    float ksc[2] = {1.f, 1.f}, vsc[2] = {1.f, 1.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      pos[hh] = kv0 + 16 * warp + g + 8 * hh;
      if constexpr (Q8) {
        // The row scales, once a tile; read before the stream's wait.
        if (pos[hh] < r.kv_hi) {
          const long long pg = __ldg(trow + pos[hh] / p.page);
          const long long pr = (pg * p.Hkv + r.kvh) * p.page + pos[hh] % p.page;
          ksc[hh] = __ldg(p.k_scales + pr);
          vsc[hh] = __ldg(p.v_scales + pr);
        }
      }
    }

    // S^T = K Q^T over D: stage j holds the 128 B column slab j.
    float s[8];
    for (int j = 0; j < nks; ++j, ++it) {
      const int st = it % p.stages;
      mbar_wait(&sm.full[st], (it / p.stages) & 1);
      if constexpr (Q8) {
        const unsigned char* stg = widen(st);
        wgmma_fence();
        box_mma<T, ROWS, 0>(s, stg, sm.q + 2 * j * Q_BOX_BYTES, j == 0);
        if (2 * j + 1 < nd)
          box_mma<T, ROWS, 0>(s, stg + BOX_BYTES, sm.q + (2 * j + 1) * Q_BOX_BYTES);
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_fence();
        box_mma<T, ROWS, 0>(s, sm.ring + (size_t)st * STAGE_BYTES, sm.q + j * Q_BOX_BYTES, j == 0);
        done_with(st);
      }
    }
    drain();  // also completes the tile before's P V products
    fence_operands(s);
    fence_operands(o);  // no rescale of O moves above the wait

    // Scores in log2 units; masked ones MASK_VALUE (finite, so m is).
    float sv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int hh = (i >> 1) & 1, jj = 2 * (i >> 2) + (i & 1);
      const int ps = pos[hh];
      bool keep = live[jj] && ps < r.kv_hi && ps < lim[jj];
      if (p.window_left >= 0) keep = keep && ps >= lim[jj] - 1 - p.window_left;
      float x = s[i] * p.scale * ksc[hh];
      if (p.softcap > 0.f) x = p.softcap * tanhf(__fdividef(x, p.softcap));
      sv[i] = keep ? x * LOG2E : MASK_VALUE;
    }

    // Column (packed-row) maxima: this thread's two cache rows, the warp's
    // 16 (lanes of one t4), then the four warps through the exchange.
    float* xch = sm.xch + (t & 1) * (CONSUMER_WARPS * ROWS);
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
    named_barrier_sync(1, CONSUMERS);
    float alpha[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float mt = xch[col[jj]];
#pragma unroll
      for (int w = 1; w < CONSUMER_WARPS; ++w) mt = fmaxf(mt, xch[w * ROWS + col[jj]]);
      const float mn = fmaxf(m[jj], mt);
      alpha[jj] = ex2(m[jj] - mn);  // 0 on the first tile (m = -inf)
      m[jj] = mn;
    }

    // P = 2^(s - m); l sums it before the V scale; P^T into its box.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int hh = (i >> 1) & 1, jj = 2 * (i >> 2) + (i & 1);
      const float pv = sv[i] == MASK_VALUE ? 0.f : ex2(sv[i] - m[jj]);
      if ((i & 2) == 0) l[jj] *= alpha[jj];
      l[jj] += pv;
      *reinterpret_cast<T*>(sm.p + swz(col[jj], 16 * warp + g + 8 * hh)) =
          from_float<T>(pv * vsc[hh]);
    }
#pragma unroll
    for (int i = 0; i < MAX_BOXES * 8; ++i) o[i] *= alpha[2 * ((i & 7) >> 2) + (i & 1)];
    fence_operands(o);
    fence_proxy_async();
    named_barrier_sync(1, CONSUMERS);  // P^T is in; every warp has read the maxima

    // O^T += V^T P^T: V stage j is the 128 B column slab j (Dv box j, or
    // boxes 2 j and 2 j + 1 of an int8 pool).
#pragma unroll
    for (int j = 0; j < MAX_VS; ++j) {
      if (j < nvs) {
        const int st = it % p.stages;
        mbar_wait(&sm.full[st], (it / p.stages) & 1);
        if constexpr (Q8) {
          const unsigned char* stg = widen(st);
          wgmma_fence();
          pv_mma<T>(*reinterpret_cast<float(*)[8]>(o + 16 * j), stg, sm.p);
          if (2 * j + 1 < nv)
            pv_mma<T>(*reinterpret_cast<float(*)[8]>(o + 16 * j + 8), stg + BOX_BYTES, sm.p);
          wgmma_commit();
          wgmma_wait<1>();
        } else {
          wgmma_fence();
          pv_mma<T>(*reinterpret_cast<float(*)[8]>(o + 8 * j), sm.ring + (size_t)st * STAGE_BYTES,
                    sm.p);
          done_with(st);
        }
        ++it;
      }
    }
  }
  drain();
  fence_operands(o);

  // Epilogue: l over the warp's lanes and the four warps; o_s = O / l and
  // lse_s = m + log l on rows below R (l == 0: o_s = 0, lse_s = -inf).
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    l[jj] += __shfl_xor_sync(0xffffffffu, l[jj], 4);
    l[jj] += __shfl_xor_sync(0xffffffffu, l[jj], 8);
    l[jj] += __shfl_xor_sync(0xffffffffu, l[jj], 16);
    if (g == 0) sm.xch[warp * ROWS + col[jj]] = l[jj];  // read by all before the last barrier
  }
  named_barrier_sync(1, CONSUMERS);
  const long long base = ((long long)(r.b * p.Hkv + r.kvh) * p.num_splits + blockIdx.x) * p.nrows;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    if (!live[jj]) continue;
    float lt = 0.f;
#pragma unroll
    for (int w = 0; w < CONSUMER_WARPS; ++w) lt += sm.xch[w * ROWS + col[jj]];
    const float inv = lt == 0.f ? 0.f : __fdividef(1.f, lt);
    const long long row = base + r.row0 + col[jj];
    float* dst = p.o_part + row * p.Dv + 16 * warp + g;
#pragma unroll
    for (int i = 0; i < MAX_BOXES; ++i) {
      if (i < nv) {
        dst[64 * i] = o[8 * i + 4 * (jj >> 1) + (jj & 1)] * inv;
        dst[64 * i + 8] = o[8 * i + 4 * (jj >> 1) + 2 + (jj & 1)] * inv;
      }
    }
    if (warp == 0 && g == 0) p.lse_part[row] = lt == 0.f ? -INFINITY : m[jj] * LN2 + logf(lt);
  }
}

template <typename T, bool Q8>
__global__ void __launch_bounds__(THREADS, 2)
    paged_tma_kernel(const __grid_constant__ Maps maps, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  // Boxes on 1024 B boundaries: the 128 B swizzle's atom.
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int nd = p.D / 64, nv = p.Dv / 64;
  constexpr int SLAB_COLS = Q8 ? 128 : 64;  // columns of a 128 B slab
  const int nks = (p.D + SLAB_COLS - 1) / SLAB_COLS, nvs = (p.Dv + SLAB_COLS - 1) / SLAB_COLS;
  const Range r = range_of(p);
  if (r.ntiles == 0) {
    // A split with no tile: o_s = 0, lse_s = -inf, which the merge weighs 0.
    const long long base_row =
        ((long long)(r.b * p.Hkv + r.kvh) * p.num_splits + blockIdx.x) * p.nrows + r.row0;
    const int rows = min(ROWS, p.nrows - r.row0);
    for (int i = threadIdx.x; i < rows * p.Dv; i += THREADS) p.o_part[base_row * p.Dv + i] = 0.f;
    if (threadIdx.x < rows) p.lse_part[base_row + threadIdx.x] = -INFINITY;
    return;
  }
  const Smem sm = carve(base, nd, p.stages, Q8);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x < CONSUMERS)
    consume<T, Q8>(p, sm, r, nd, nv, nks, nvs);
  else if (threadIdx.x == CONSUMERS)
    produce(maps, p, sm, r, nks, nvs, SLAB_COLS);
}

template <typename T, bool Q8>
cudaError_t launch(const Params& p, size_t smem, const void* k_pages, const void* v_pages,
                   int num_pages, int B, cudaStream_t st) {
  const bool f16 = std::is_same<T, __half>::value;
  const int esize = Q8 ? 1 : 2;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const uint64_t slabs = (uint64_t)num_pages * p.Hkv;
  cudaError_t e = encode_pool(&maps.k_map, esize, f16, k_pages, p.D, p.page, slabs, p.box_rows);
  if (e == cudaSuccess)
    e = encode_pool(&maps.v_map, esize, f16, v_pages, p.Dv, p.page, slabs, p.box_rows);
  if (e != cudaSuccess) return e;
  auto kern = paged_tma_kernel<T, Q8>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.num_splits, p.Hkv * p.row_blocks, B);
  kern<<<grid, THREADS, smem, st>>>(maps, p);
  return cudaGetLastError();
}

}  // namespace tma

// The route and tiling of a launch (head dims multiples of 64, R packed
// rows): D, Dv <= 512 and a page of a multiple of 16 rows take the TMA
// block (16 packed rows; box_rows the largest of 64, 32, 16 dividing the
// page; as many 8 KiB stages, at most 12, as leave two blocks an SM);
// anything else the cp.async block (the smallest of 16, 32, 64 rows holding
// R, halved while its shared memory does not fit). ffpa_paged_plan hands it
// out; ops/config.py paged_plan mirrors it and the card test holds the two
// equal.
constexpr int TMA = 1, CP_ASYNC = 0;  // routes
struct Plan {
  int route, rows, box_rows, stages;
  size_t smem;
};
inline Plan make_plan(int D, int Dv, int R, int page, bool q8) {
  Plan pl = {};
  if (D <= 512 && Dv <= 512 && page % 16 == 0) {
    pl.route = TMA;
    pl.rows = tma::ROWS;
    pl.box_rows = page % 64 == 0 ? 64 : page % 32 == 0 ? 32 : 16;
    const size_t fixed = tma::fixed_bytes(D / 64, q8);
    pl.stages = (int)std::min((size_t)tma::MAX_STAGES, (tma::BLOCK_SMEM - fixed) / tma::STAGE_COST);
    pl.smem = fixed + pl.stages * tma::STAGE_COST;
  } else {
    pl.route = CP_ASYNC;
    pl.rows = R <= 16 ? 16 : R <= 32 ? 32 : 64;
    auto bytes = [&](int bq) {
      return q8 ? paged_smem_bytes<__nv_bfloat16, true>(bq, Dv)
                : paged_smem_bytes<__nv_bfloat16, false>(bq, Dv);
    };
    while (pl.rows > 16 && bytes(pl.rows) > SMEM_LIMIT) pl.rows /= 2;
    pl.stages = NSTAGES;
    pl.smem = bytes(pl.rows);
  }
  return pl;
}

template <typename T>
cudaError_t launch_paged_tma(const PagedParams& pp, const Plan& pl, bool q8, const void* k_pages,
                             const void* v_pages, int num_pages, void* o, float* lse, int B,
                             cudaStream_t st) {
  tma::Params p = {};
  p.q = pp.q;
  p.k_scales = pp.k_scales;
  p.v_scales = pp.v_scales;
  p.table = pp.table;
  p.lens = pp.lens;
  p.o_part = pp.o_part;
  p.lse_part = pp.lse_part;
  p.Hkv = pp.Hkv;
  p.nrows = pp.nrows;
  p.nq = pp.nq;
  p.D = pp.D;
  p.Dv = pp.Dv;
  p.page = pp.page;
  p.max_pages = pp.max_pages;
  p.box_rows = pl.box_rows;
  p.stages = pl.stages;
  p.num_splits = pp.num_splits;
  p.row_blocks = pp.row_blocks;
  p.scale = pp.scale;
  p.softcap = pp.softcap;
  p.window_left = pp.window_left;
  cudaError_t e = q8 ? tma::launch<T, true>(p, pl.smem, k_pages, v_pages, num_pages, B, st)
                     : tma::launch<T, false>(p, pl.smem, k_pages, v_pages, num_pages, B, st);
  if (e != cudaSuccess) return e;
  return launch_split_merge<T>(pp.o_part, pp.lse_part, o, lse, pp.nrows, pp.num_splits, pp.Dv,
                               B * pp.Hkv, st);
}

}  // namespace

extern "C" int ffpa_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                                 const float* k_scales, const float* v_scales, const int* table,
                                 const int* lens, void* o, float* lse, float* o_part,
                                 float* lse_part, int is_fp16, int quantized, int block_rows,
                                 int B, int Hkv, int R, int nq, int D, int Dv, int page,
                                 int max_pages, int num_pages, float scale, float softcap,
                                 int window_left, int kv_per_split, int num_splits,
                                 void* stream) {
  if (D % D_CHUNK != 0 || Dv % D_CHUNK != 0 || page < 1 || max_pages < 1 || num_pages < 1 ||
      nq < 1 || R < 1 || num_splits < 1 || kv_per_split % KV_TILE != 0 ||
      (quantized && (k_scales == nullptr || v_scales == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(D, Dv, R, page, quantized != 0);
  if (block_rows != pl.rows) return (int)cudaErrorInvalidValue;  // the wrapper follows the plan
  PagedParams p = {};
  p.q = q;
  p.k_pages = k_pages;
  p.v_pages = v_pages;
  p.k_scales = k_scales;
  p.v_scales = v_scales;
  p.table = table;
  p.lens = lens;
  p.o_part = o_part;
  p.lse_part = lse_part;
  p.Hkv = Hkv;
  p.nrows = R;
  p.nq = nq;
  p.D = D;
  p.Dv = Dv;
  p.page = page;
  p.max_pages = max_pages;
  p.scale = scale;
  p.softcap = softcap;
  p.window_left = window_left;
  p.kv_per_split = kv_per_split;
  p.num_splits = num_splits;
  p.row_blocks = (R + pl.rows - 1) / pl.rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pl.route == TMA)
    return (int)(is_fp16 ? launch_paged_tma<__half>(p, pl, quantized, k_pages, v_pages, num_pages,
                                                    o, lse, B, st)
                         : launch_paged_tma<__nv_bfloat16>(p, pl, quantized, k_pages, v_pages,
                                                           num_pages, o, lse, B, st));
  if (is_fp16)
    return (int)(quantized ? launch_paged<__half, true>(p, o, lse, pl.rows, B, st)
                           : launch_paged<__half, false>(p, o, lse, pl.rows, B, st));
  return (int)(quantized ? launch_paged<__nv_bfloat16, true>(p, o, lse, pl.rows, B, st)
                         : launch_paged<__nv_bfloat16, false>(p, o, lse, pl.rows, B, st));
}

// The route and tiling ffpa_paged_decode takes at head dims (D, Dv),
// multiples of 64, R packed rows and a page of `page` rows: out[0..4] are
// the route (1 TMA, 0 cp.async), the packed rows of a block, the rows of a
// TMA box (0 on cp.async), the ring's stages and the dynamic shared-memory
// bytes of a block; cap is out's length.
extern "C" int ffpa_paged_plan(int D, int Dv, int R, int page, int quantized, int* out, int cap) {
  if (D <= 0 || Dv <= 0 || D % D_CHUNK != 0 || Dv % D_CHUNK != 0 || R < 1 || page < 1 || cap < 5)
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(D, Dv, R, page, quantized != 0);
  out[0] = pl.route;
  out[1] = pl.rows;
  out[2] = pl.box_rows;
  out[3] = pl.stages;
  out[4] = (int)pl.smem;
  return 0;
}

// Registers a thread and local (spill) bytes a thread of the launch-1
// kernel of `route` (1 TMA, 0 cp.async at 16 rows), in f16 or bf16, over an
// int8 pool or not.
extern "C" int ffpa_paged_attrs(int route, int is_fp16, int quantized, int* regs,
                                int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e;
  if (route == TMA) {
    if (is_fp16)
      e = quantized ? cudaFuncGetAttributes(&a, tma::paged_tma_kernel<__half, true>)
                    : cudaFuncGetAttributes(&a, tma::paged_tma_kernel<__half, false>);
    else
      e = quantized ? cudaFuncGetAttributes(&a, tma::paged_tma_kernel<__nv_bfloat16, true>)
                    : cudaFuncGetAttributes(&a, tma::paged_tma_kernel<__nv_bfloat16, false>);
  } else {
    if (is_fp16)
      e = quantized ? cudaFuncGetAttributes(&a, paged_decode_kernel<__half, 16, true>)
                    : cudaFuncGetAttributes(&a, paged_decode_kernel<__half, 16, false>);
    else
      e = quantized ? cudaFuncGetAttributes(&a, paged_decode_kernel<__nv_bfloat16, 16, true>)
                    : cudaFuncGetAttributes(&a, paged_decode_kernel<__nv_bfloat16, 16, false>);
  }
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}
