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
// Two routes for launch 1, chosen by make_plan (ffpa_decode_plan hands it
// out, ops/config.py decode_plan mirrors it):
//
// * TMA (namespace tma; D, Dv <= 512): built for bytes in flight. Split s of
//   S walks tiles [s * T / S, (s + 1) * T / S) of the band's T 64-row tiles
//   (ops/decode.py decode_split_ranges is the same rule), and the wrapper
//   takes as many splits as give every SM one block, at most one a tile
//   (ops/decode.py _tma_splits), so every block of the launch is resident
//   at once, two an SM at most. 160 threads: one producer thread keeps a ring of 8 KiB
//   stages full (up to 12, about 90 KiB in flight a block), each stage one
//   64 x 64 box (128 B rows, 128 B swizzle) of K or V from a 3-D map (D,
//   Nkv, B * Hkv) at the cache's true extents, so TMA zero-fills past Nkv;
//   per tile the K boxes come first, then the V boxes. One consumer warpgroup does the math
//   with wgmma, roles swapped so the 64 cache rows are M and the 16 packed
//   rows N: S^T = K Q^T (Q resident in 16-row boxes) and O^T += V^T P^T (V
//   read M-major, P^T through one swizzled 16 x 64 box); S and the fp32 O^T
//   (64 registers a thread at Dv 512) stay in registers, the row maxima cross
//   the four warps through shared memory. Scores stay in natural units until
//   ex2((s - m) * log2 e): in log2 units the validity bias (MASK_VALUE)
//   overflows to -inf and a masked split's max with it.
// * cp.async (decode_kernel below; D or Dv > 512): a block of BQ packed rows
//   walks [kv_start + s * kv_per_split, + kv_per_split) in 64-row tiles with
//   nvcuda::wmma fragments, the fp32 O tile in shared memory, Q/K chunk pairs
//   and V chunks streamed through two slots one chunk ahead.
//
// Score residual (return_scores, the decode backward's input), both routes:
// launch 1 also writes each valid row's masked post-softcap / bias scores in
// fp32 to [B, Hkv, R, s_ld], each split its own tiles' columns, masked and
// padding entries as MASK_VALUE.
#include <limits.h>
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
constexpr int NSTAGES = 2;    // stream slots (ops/config.py DECODE_STREAM_STAGES)
constexpr size_t SMEM_LIMIT = 232448;  // dynamic shared memory a block may opt into
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

struct DecodeParams {
  const void* q;    // packed [B, Hkv, R, D]
  const void* k;
  const void* v;
  float* o_part;    // [B, Hkv, splits, R, Dv] fp32 partials
  float* lse_part;  // [B, Hkv, splits, R]
  const float* bias;  // additive fp32 bias packed like q, or null
  long long sb, sh, sr, sc;  // bias strides, 0 on broadcast dims
  int Hkv, nrows, nq, nkv, D, Dv;
  float scale, softcap;
  int causal_offset, window_left, window_right;  // window_right: 0 when causal, -1 open
  int kv_start, kv_end, kv_per_split, num_splits, row_blocks;
  float* s_out;  // fp32 score residual [B, Hkv, R, s_ld], or null
  int s_ld;
};

// Dynamic shared memory of one block; ops/config.py decode_smem_bytes is the
// same formula.
template <typename T>
size_t decode_smem_bytes(int bq, int dv) {
  return (size_t)bq * (dv + PAD_F) * 4 + (size_t)bq * LDS * 4 + (size_t)bq * LDT * sizeof(T) +
         NSTAGES * (size_t)(bq + KV_TILE) * LDT * sizeof(T) + 3 * (size_t)bq * 4;
}

// Rows [r0, r0 + ROWS) x cols [c0, c0 + 64) of a row-major matrix with row
// stride ld into a [ROWS, LDT] shared tile; rows >= rmax are zero-filled.
template <typename T, int ROWS>
__device__ __forceinline__ void load_chunk(T* dst, const T* src, int r0, int rmax, int ld,
                                           int c0, int tid) {
  for (int i = tid; i < ROWS * (D_CHUNK / 8); i += NTHREADS) {
    const int r = i / (D_CHUNK / 8);
    const int cv = (i % (D_CHUNK / 8)) * 8;
    const int gr = r0 + r;
    const bool ok = gr < rmax;
    cp_async16(dst + r * LDT + cv, ok ? src + (long long)gr * ld + c0 + cv : src, ok);
  }
}

template <typename T, int BQ>
__global__ void __launch_bounds__(NTHREADS) decode_kernel(const DecodeParams p) {
  constexpr int RT = BQ / 16;                          // 16-row tiles
  constexpr int CT = KV_TILE / 16;                     // 16-col tiles per S / O chunk
  constexpr int NT = RT * CT;                          // wmma tiles per S / O chunk
  constexpr int TPW = (NT + NWARPS - 1) / NWARPS;      // tiles per warp
  constexpr int SLOT = (BQ + KV_TILE) * LDT;           // elements per stream slot
  constexpr int RPW = BQ / NWARPS;                     // softmax rows per warp
  static_assert(BQ % NWARPS == 0, "row tile must split evenly over the warps");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int LDO = p.Dv + PAD_F;
  float* O = reinterpret_cast<float*>(smem_raw);
  float* S = O + BQ * LDO;
  T* P = reinterpret_cast<T*>(S + BQ * LDS);
  T* slots = P + BQ * LDT;
  float* m_s = reinterpret_cast<float*>(slots + NSTAGES * SLOT);
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z;
  const int kvh = blockIdx.y / p.row_blocks;
  const int row0 = (blockIdx.y % p.row_blocks) * BQ;
  const int split = blockIdx.x;
  const int kv_lo = p.kv_start + split * p.kv_per_split;
  const int kv_hi = min(p.kv_end, kv_lo + p.kv_per_split);
  const T* qb = static_cast<const T*>(p.q) + ((long long)(b * p.Hkv + kvh) * p.nrows) * p.D;
  const T* kb = static_cast<const T*>(p.k) + ((long long)(b * p.Hkv + kvh) * p.nkv) * p.D;
  const T* vb = static_cast<const T*>(p.v) + ((long long)(b * p.Hkv + kvh) * p.nkv) * p.Dv;

  for (int i = tid; i < BQ * LDO; i += NTHREADS) O[i] = 0.f;
  for (int i = tid; i < BQ; i += NTHREADS) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
    a_s[i] = 1.f;
  }

  const int nD = p.D / D_CHUNK, nV = p.Dv / D_CHUNK, per_tile = nD + nV;
  const int ntiles = kv_hi > kv_lo ? (kv_hi - kv_lo + KV_TILE - 1) / KV_TILE : 0;
  const int total = ntiles * per_tile;

  // Chunk g of the stream: per KV tile, nD (Q, K) chunk pairs then nV V chunks.
  auto issue = [&](int g) {
    if (g < total) {
      const int t = g / per_tile, c = g - t * per_tile;
      T* dst = slots + (g % NSTAGES) * SLOT;
      const int kv0 = kv_lo + t * KV_TILE;
      if (c < nD) {
        load_chunk<T, BQ>(dst, qb, row0, p.nrows, p.D, c * D_CHUNK, tid);
        load_chunk<T, KV_TILE>(dst + BQ * LDT, kb, kv0, p.nkv, p.D, c * D_CHUNK, tid);
      } else {
        load_chunk<T, KV_TILE>(dst, vb, kv0, p.nkv, p.Dv, (c - nD) * D_CHUNK, tid);
      }
    }
    cp_async_commit();
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
      if (c < nD) {
        // S += Q_chunk K_chunk^T
        const T* kc = cur + BQ * LDT;
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
              wmma::load_matrix_sync(fb, kc + ct * 16 * LDT + kk * 16, LDT);
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
          // Online softmax: each warp owns RPW rows, two columns per lane;
          // the rows' reductions are interleaved so their latencies overlap.
          float sv[RPW][2], red[RPW];
#pragma unroll
          for (int i = 0; i < RPW; ++i) {
            const int r = warp + i * NWARPS;
            const int row = row0 + r;
            const bool valid = row < p.nrows;
            const int qpos = row % p.nq;
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int cc = lane + 32 * j, col = kv0 + cc;
              float s;
              if (!valid) {
                s = 0.f;  // padding row: computed, never stored
              } else if (col >= kv_hi) {
                s = -INFINITY;  // past this block's KV range
              } else {
                s = S[r * LDS + cc] * p.scale;
                if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
                if (p.bias != nullptr)
                  s += p.bias[(long long)b * p.sb + (long long)kvh * p.sh +
                              (long long)row * p.sr + (long long)col * p.sc];
                if (p.window_right >= 0 && col > qpos + p.causal_offset + p.window_right)
                  s = MASK_VALUE;
                if (p.window_left >= 0 && col < qpos + p.causal_offset - p.window_left)
                  s = MASK_VALUE;
              }
              sv[i][j] = s;
              // Score residual: each split writes its own tiles' columns.
              if (valid && p.s_out != nullptr)
                p.s_out[((long long)(b * p.Hkv + kvh) * p.nrows + row) * p.s_ld + col] =
                    s == -INFINITY ? MASK_VALUE : s;
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
            m_new[i] = fmaxf(m_old, red[i]);
            float p0 = 0.f, p1 = 0.f;
            alpha[i] = 1.f;
            if (m_new[i] != -INFINITY) {
              alpha[i] = __expf(m_old - m_new[i]);
              p0 = __expf(sv[i][0] - m_new[i]);
              p1 = __expf(sv[i][1] - m_new[i]);
            }
            P[r * LDT + lane] = from_float<T>(p0);
            P[r * LDT + lane + 32] = from_float<T>(p1);
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
              wmma::load_matrix_sync(fb, cur + kk * 16 * LDT + ct * 16, LDT);
              wmma::mma_sync(oacc, fa, fb, oacc);
            }
            wmma::store_matrix_sync(op, oacc, LDO, wmma::mem_row_major);
          }
        }
      }
      __syncthreads();  // the slot read here is refilled by the next issue
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Epilogue: partial o_s = O / l and lse_s = m + log(max(l, 1e-38)); an
  // empty split gives o_s = 0 and lse_s = -inf, which the merge weighs 0. A
  // row whose split saw only masked scores divides by the band's width (see
  // the top of this file).
  for (int r = warp; r < BQ; r += NWARPS) {
    const int row = row0 + r;
    if (row >= p.nrows) continue;
    const float l = l_s[r];
    const float l_safe =
        (l == 0.f) ? 1.f : m_s[r] <= MASK_VALUE ? (float)(p.kv_end - p.kv_start) : l;
    const float* orow = O + r * LDO;
    const long long base =
        (((long long)(b * p.Hkv + kvh) * p.num_splits + split) * p.nrows) + row;
    float* dst = p.o_part + base * p.Dv;
    for (int c = lane * 4; c < p.Dv; c += 128) {
      float4 x = *reinterpret_cast<const float4*>(orow + c);
      x.x /= l_safe;
      x.y /= l_safe;
      x.z /= l_safe;
      x.w /= l_safe;
      *reinterpret_cast<float4*>(dst + c) = x;
    }
    if (lane == 0) p.lse_part[base] = m_s[r] + logf(fmaxf(l, 1e-38f));
  }
}

template <typename T, int BQ>
cudaError_t launch_partials(const DecodeParams& p, dim3 grid, cudaStream_t stream) {
  auto kern = decode_kernel<T, BQ>;
  const size_t smem = decode_smem_bytes<T>(BQ, p.Dv);
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}


template <typename T>
cudaError_t launch_decode(const DecodeParams& p, void* o, float* lse, int block_rows, int B,
                          cudaStream_t st) {
  const dim3 grid(p.num_splits, p.Hkv * p.row_blocks, B);
  cudaError_t e;
  switch (block_rows) {
    case 16: e = launch_partials<T, 16>(p, grid, st); break;
    case 32: e = launch_partials<T, 32>(p, grid, st); break;
    case 64: e = launch_partials<T, 64>(p, grid, st); break;
    case 128: e = launch_partials<T, 128>(p, grid, st); break;
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
constexpr int STAGE_BYTES = BOX_BYTES;         // one 64 x 64 box of K or V
constexpr int MAX_BOXES = 8;                   // D, Dv <= 512: 64-column boxes of Q and of O
constexpr int MAX_STAGES = 12;
constexpr int CONSUMERS = 128;                 // one warpgroup: the math
constexpr int THREADS = CONSUMERS + 32;        // and one producer warp
constexpr int CONSUMER_WARPS = CONSUMERS / 32; // arrivals that free a stage
constexpr int Q_BOX_BYTES = ROWS * 128;        // 16 rows x 64 columns of Q, or of P^T
constexpr int XCH_FLOATS = 2 * CONSUMER_WARPS * ROWS;  // per-warp row maxima, two tiles
// Two blocks an SM: 228 KiB of shared memory, 1 KiB of it reserved a block.
constexpr size_t BLOCK_SMEM = 115712;
static_assert(TILE == KV_TILE && TILE * 128 == STAGE_BYTES, "a stage is one tile's box");

// Shared memory of a block besides its ring (a stage is STAGE_COST with its
// two barriers): the 1024 B alignment, Q's boxes, the P^T box and the
// exchange.
constexpr size_t fixed_bytes(int nd) {
  return 1024 + (size_t)(nd + 1) * Q_BOX_BYTES + XCH_FLOATS * sizeof(float);
}
constexpr size_t STAGE_COST = STAGE_BYTES + 2 * sizeof(uint64_t);

// Shared memory of a block, from a 1024 B boundary.
struct Smem {
  unsigned char* ring;  // stages x 8 KiB
  unsigned char* q;     // nd boxes of 16 x 64
  unsigned char* p;     // P^T: 16 packed rows x 64 cache rows
  float* xch;           // [2][CONSUMER_WARPS][ROWS]
  uint64_t* full;
  uint64_t* empty;
};
__device__ __forceinline__ Smem carve(unsigned char* base, int nd, int stages) {
  Smem sm;
  sm.ring = base;
  sm.q = sm.ring + (size_t)stages * STAGE_BYTES;
  sm.p = sm.q + nd * Q_BOX_BYTES;
  sm.xch = reinterpret_cast<float*>(sm.p + Q_BOX_BYTES);
  sm.full = reinterpret_cast<uint64_t*>(sm.xch + XCH_FLOATS);
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

// The consumer warpgroup. Accumulator element 4 j + 2 hh + e of thread (warp,
// g = lane / 4, t4 = lane % 4) is M row 16 warp + g + 8 hh and packed row
// (N column) 8 j + 2 t4 + e: for S^T the cache row kv0 + 16 warp + g + 8 hh,
// for O^T box i's column 64 i + 16 warp + g + 8 hh. Element 4 j + 2 hh + e
// belongs to this thread's packed-row slot jj = 2 j + e.
template <typename T>
__device__ __forceinline__ void consume(const Params& p, const Smem& sm, const Range& r, int nd,
                                        int nv) {
  constexpr float LOG2E = 1.4426950408889634f;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = r.b * p.Hkv + r.kvh;

  // Q: the block's 16 packed rows (zeros past R) into nd swizzled boxes.
  const T* qb = static_cast<const T*>(p.q) + (long long)bh * p.nrows * p.D;
  for (int i = tid; i < ROWS * nd * 8; i += CONSUMERS) {
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
  named_barrier_sync(1, CONSUMERS);  // Q is in

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

  for (int t = 0; t < r.ntiles; ++t) {
    const int kv0 = r.kv_lo + opaque(t) * TILE;
    int pos[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) pos[hh] = kv0 + 16 * warp + g + 8 * hh;

    // The bias, read before the stream's wait: a row-broadcast bias (the
    // main path's [1|B, 1, 1, Nkv]) is one load a cache row, else one an
    // element.
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
    if (p.s_out != nullptr) {
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
      *reinterpret_cast<T*>(sm.p + swz(col[jj], 16 * warp + g + 8 * hh)) = from_float<T>(pv);
    }
#pragma unroll
    for (int i = 0; i < MAX_BOXES * 8; ++i) o[i] *= alpha[2 * ((i & 7) >> 2) + (i & 1)];
    fence_operands(o);
    fence_proxy_async();
    named_barrier_sync(1, CONSUMERS);  // P^T is in; every warp has read the maxima

    // O^T += V^T P^T: V stage j is Dv box j.
#pragma unroll
    for (int j = 0; j < MAX_BOXES; ++j) {
      if (j < nv) {
        const int st = it % p.stages;
        mbar_wait(&sm.full[st], (it / p.stages) & 1);
        wgmma_fence();
        pv_mma<T>(*reinterpret_cast<float(*)[8]>(o + 8 * j), sm.ring + (size_t)st * STAGE_BYTES,
                  sm.p);
        done_with(st);
        ++it;
      }
    }
  }
  drain();
  fence_operands(o);

  // Epilogue: l over the warp's lanes and the four warps; o_s = O / l and
  // lse_s = m + log l on rows below R (l == 0: o_s = 0, lse_s = -inf; a max
  // at or below MASK_VALUE: O over the band's width, see the top of the file).
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    l[jj] += __shfl_xor_sync(0xffffffffu, l[jj], 4);
    l[jj] += __shfl_xor_sync(0xffffffffu, l[jj], 8);
    l[jj] += __shfl_xor_sync(0xffffffffu, l[jj], 16);
    if (g == 0) sm.xch[warp * ROWS + col[jj]] = l[jj];  // read by all before the last barrier
  }
  named_barrier_sync(1, CONSUMERS);
  const long long base = ((long long)bh * p.num_splits + blockIdx.x) * p.nrows;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    if (!live[jj]) continue;
    float lt = 0.f;
#pragma unroll
    for (int w = 0; w < CONSUMER_WARPS; ++w) lt += sm.xch[w * ROWS + col[jj]];
    const float norm = m[jj] <= MASK_VALUE ? (float)(p.kv_end - p.kv_start) : lt;
    const float inv = lt == 0.f ? 0.f : __fdividef(1.f, norm);
    const long long row = base + r.row0 + col[jj];
    float* dst = p.o_part + row * p.Dv + 16 * warp + g;
#pragma unroll
    for (int i = 0; i < MAX_BOXES; ++i) {
      if (i < nv) {
        dst[64 * i] = o[8 * i + 4 * (jj >> 1) + (jj & 1)] * inv;
        dst[64 * i + 8] = o[8 * i + 4 * (jj >> 1) + 2 + (jj & 1)] * inv;
      }
    }
    if (warp == 0 && g == 0) p.lse_part[row] = lt == 0.f ? -INFINITY : m[jj] + logf(lt);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    decode_tma_kernel(const __grid_constant__ Maps maps, const Params p) {
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
    for (int i = threadIdx.x; i < rows * p.Dv; i += THREADS) p.o_part[base_row * p.Dv + i] = 0.f;
    if (threadIdx.x < rows) p.lse_part[base_row + threadIdx.x] = -INFINITY;
    return;
  }
  const Smem sm = carve(base, nd, p.stages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x < CONSUMERS)
    consume<T>(p, sm, r, nd, nv);
  else if (threadIdx.x == CONSUMERS)
    produce(maps, p, sm, r, nd, nv);
}

template <typename T>
cudaError_t launch(const Params& p, size_t smem, const void* k, const void* v, int nkv, int B,
                   cudaStream_t st) {
  const bool f16 = std::is_same<T, __half>::value;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const uint64_t slabs = (uint64_t)B * p.Hkv;
  cudaError_t e = encode_cache(&maps.k_map, f16, k, p.D, nkv, slabs);
  if (e == cudaSuccess) e = encode_cache(&maps.v_map, f16, v, p.Dv, nkv, slabs);
  if (e != cudaSuccess) return e;
  auto kern = decode_tma_kernel<T>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(p.num_splits, p.Hkv * p.row_blocks, B);
  kern<<<grid, THREADS, smem, st>>>(maps, p);
  return cudaGetLastError();
}

}  // namespace tma

// The route and tiling of a launch (head dims multiples of 64, R packed
// rows): D, Dv <= 512 take the TMA block (16 packed rows; as many 8 KiB
// stages, at most 12, as leave two blocks an SM); wider heads the cp.async
// block (the smallest of 16, 32, 64, 128 rows holding R, halved while its
// shared memory does not fit). ffpa_decode_plan hands it out;
// ops/config.py decode_plan mirrors it and the card test holds the two
// equal.
constexpr int TMA = 1, CP_ASYNC = 0;  // routes
struct Plan {
  int route, rows, stages;
  size_t smem;
};
inline Plan make_plan(int D, int Dv, int R) {
  Plan pl = {};
  if (D <= 512 && Dv <= 512) {
    pl.route = TMA;
    pl.rows = tma::ROWS;
    const size_t fixed = tma::fixed_bytes(D / 64);
    pl.stages =
        (int)std::min((size_t)tma::MAX_STAGES, (tma::BLOCK_SMEM - fixed) / tma::STAGE_COST);
    pl.smem = fixed + pl.stages * tma::STAGE_COST;
  } else {
    pl.route = CP_ASYNC;
    pl.rows = R <= 16 ? 16 : R <= 32 ? 32 : R <= 64 ? 64 : 128;
    while (pl.rows > 16 && decode_smem_bytes<__nv_bfloat16>(pl.rows, Dv) > SMEM_LIMIT)
      pl.rows /= 2;
    pl.stages = NSTAGES;
    pl.smem = decode_smem_bytes<__nv_bfloat16>(pl.rows, Dv);
  }
  return pl;
}

template <typename T>
cudaError_t launch_decode_tma(const DecodeParams& dp, const Plan& pl, void* o, float* lse, int B,
                              cudaStream_t st) {
  tma::Params p = {};
  p.q = dp.q;
  p.o_part = dp.o_part;
  p.lse_part = dp.lse_part;
  p.bias = dp.bias;
  p.sb = dp.sb;
  p.sh = dp.sh;
  p.sr = dp.sr;
  p.sc = dp.sc;
  p.s_out = dp.s_out;
  p.s_ld = dp.s_ld;
  p.Hkv = dp.Hkv;
  p.nrows = dp.nrows;
  p.nq = dp.nq;
  p.D = dp.D;
  p.Dv = dp.Dv;
  p.stages = pl.stages;
  p.num_splits = dp.num_splits;
  p.row_blocks = dp.row_blocks;
  p.scale = dp.scale;
  p.softcap = dp.softcap;
  p.causal_offset = dp.causal_offset;
  p.window_left = dp.window_left;
  p.window_right = dp.window_right;
  p.kv_start = dp.kv_start;
  p.kv_end = dp.kv_end;
  cudaError_t e = tma::launch<T>(p, pl.smem, dp.k, dp.v, dp.nkv, B, st);
  if (e != cudaSuccess) return e;
  return launch_split_merge<T>(dp.o_part, dp.lse_part, o, lse, dp.nrows, dp.num_splits, dp.Dv,
                               B * dp.Hkv, st);
}

}  // namespace

// Launch 1 on the plan's route, then the merge. block_rows must be the
// plan's rows. The TMA route cuts the band [kv_start, kv_end) into
// num_splits near-equal runs of whole tiles; the cp.async route walks
// kv_per_split rows a split from kv_start.
extern "C" int ffpa_decode_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                               float* o_part, float* lse_part, const float* bias, long long sb,
                               long long sh, long long sr, long long sc, int is_fp16,
                               int block_rows, int B, int Hkv, int R, int nq, int nkv, int D,
                               int Dv, float scale, float softcap, int causal_offset,
                               int window_left, int window_right, int kv_start, int kv_end,
                               int kv_per_split, int num_splits, float* s_out, int s_ld,
                               void* stream) {
  if (D % D_CHUNK != 0 || Dv % D_CHUNK != 0 || R < 1 || nq < 1 || num_splits < 1 ||
      (s_out != nullptr && s_ld < ((nkv + KV_TILE - 1) / KV_TILE) * KV_TILE))
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(D, Dv, R);
  if (block_rows != pl.rows) return (int)cudaErrorInvalidValue;  // the wrapper follows the plan
  DecodeParams p = {};
  p.s_out = s_out;
  p.s_ld = s_ld;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o_part = o_part;
  p.lse_part = lse_part;
  p.bias = bias;
  p.sb = sb;
  p.sh = sh;
  p.sr = sr;
  p.sc = sc;
  p.Hkv = Hkv;
  p.nrows = R;
  p.nq = nq;
  p.nkv = nkv;
  p.D = D;
  p.Dv = Dv;
  p.scale = scale;
  p.softcap = softcap;
  p.causal_offset = causal_offset;
  p.window_left = window_left;
  p.window_right = window_right;
  p.kv_start = kv_start;
  p.kv_end = kv_end;
  p.kv_per_split = kv_per_split;
  p.num_splits = num_splits;
  p.row_blocks = (R + block_rows - 1) / block_rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pl.route == TMA)
    return (int)(is_fp16 ? launch_decode_tma<__half>(p, pl, o, lse, B, st)
                         : launch_decode_tma<__nv_bfloat16>(p, pl, o, lse, B, st));
  return (int)(is_fp16 ? launch_decode<__half>(p, o, lse, block_rows, B, st)
                       : launch_decode<__nv_bfloat16>(p, o, lse, block_rows, B, st));
}

// The route and tiling ffpa_decode_fwd takes at head dims (D, Dv),
// multiples of 64, and R packed rows: out[0..3] are the route (1 TMA, 0
// cp.async), the packed rows of a block, the ring's stages and the dynamic
// shared-memory bytes of a block; cap is out's length.
extern "C" int ffpa_decode_plan(int D, int Dv, int R, int* out, int cap) {
  if (D <= 0 || Dv <= 0 || D % D_CHUNK != 0 || Dv % D_CHUNK != 0 || R < 1 || cap < 4)
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(D, Dv, R);
  out[0] = pl.route;
  out[1] = pl.rows;
  out[2] = pl.stages;
  out[3] = (int)pl.smem;
  return 0;
}

// Registers a thread and local (spill) bytes a thread of the launch-1
// kernel of `route` (1 TMA, 0 cp.async at 16 rows), in f16 or bf16.
extern "C" int ffpa_decode_attrs(int route, int is_fp16, int* regs, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e;
  if (route == TMA)
    e = is_fp16 ? cudaFuncGetAttributes(&a, tma::decode_tma_kernel<__half>)
                : cudaFuncGetAttributes(&a, tma::decode_tma_kernel<__nv_bfloat16>);
  else
    e = is_fp16 ? cudaFuncGetAttributes(&a, decode_kernel<__half, 16>)
                : cudaFuncGetAttributes(&a, decode_kernel<__nv_bfloat16, 16>);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}
