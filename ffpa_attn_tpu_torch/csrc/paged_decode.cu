// Paged decode attention for Hopper (sm_90a): the counterpart of the Pallas
// _paged_decode_kernel (ffpa_attn_tpu/ops/paged.py). ops/paged.py calls the C
// entry point ffpa_paged_decode through ctypes.
//
// K/V live in a global pool of pages [P, Hkv, page, D] (bf16/f16, or int8
// with per-row fp32 scales [P, Hkv, page]); sequence b's cache position pos
// is row pos % page of pool page table[b * max_pages + pos / page], and
// lens[b] rows are valid. The TPU grid (B, Hkv, max_pages) walks one
// sequence's pages in order; at the serving shape (B4, Hkv4) that is 16
// blocks for an H100's 132 SMs. So, as the dense decode kernel does, the
// page walk is split:
//   launch 1, grid (splits, Hkv * row_blocks, B): split s owns cache
//     positions [s * kv_per_split, (s + 1) * kv_per_split), cut to
//     [window start, lens[b]) with lens and the table read on the device (no
//     host sync). It walks them in 64-row KV tiles, each row's address looked
//     up in the page table (tables need not be contiguous, pages may be
//     smaller than a tile), and writes fp32 partials normalised by their own
//     l with lse_s = m + log l (-inf where it attended nothing: a split past
//     lens[b], a sequence with lens = 0);
//   launch 2 merges the splits by LSE (split_merge.cuh, the dense decode's).
// Positions past lens[b], or before the window's first position, are
// neither read nor computed.
//
// The block is the dense decode's (decode.cu): the PackGQA row tile (row r is
// query head hkv * group + r / nq at position r % nq, so K/V stream once per
// KV head), nvcuda::wmma bf16/f16 fragments with fp32 accumulation, the fp32
// O tile in shared memory, Q/K chunk pairs and V chunks streamed through two
// shared-memory slots with cp.async one chunk ahead of the math. Masks follow
// the TPU kernel: packed row r attends cached positions < lens - (nq - 1) +
// r % nq (all nq new tokens already appended), and with a window those
// >= that limit - 1 - window_left. int8 pools: each chunk is widened to the
// query type in a staging tile (int8 values are exact there); the K scale
// multiplies S (before softcap, so the cap sees the true logit) and the V
// scale multiplies P after the row sum, so the [page, D] operands are never
// dequantized.
#include <mma.h>

#include <type_traits>

#include "common.cuh"
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

}  // namespace

extern "C" int ffpa_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                                 const float* k_scales, const float* v_scales, const int* table,
                                 const int* lens, void* o, float* lse, float* o_part,
                                 float* lse_part, int is_fp16, int quantized, int block_rows,
                                 int B, int Hkv, int R, int nq, int D, int Dv, int page,
                                 int max_pages, float scale, float softcap, int window_left,
                                 int kv_per_split, int num_splits, void* stream) {
  if (D % D_CHUNK != 0 || Dv % D_CHUNK != 0 || page < 1 || max_pages < 1 || nq < 1 ||
      num_splits < 1 || kv_per_split % KV_TILE != 0 ||
      (quantized && (k_scales == nullptr || v_scales == nullptr)))
    return (int)cudaErrorInvalidValue;
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
  p.row_blocks = (R + block_rows - 1) / block_rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_fp16)
    return (int)(quantized ? launch_paged<__half, true>(p, o, lse, block_rows, B, st)
                           : launch_paged<__half, false>(p, o, lse, block_rows, B, st));
  return (int)(quantized ? launch_paged<__nv_bfloat16, true>(p, o, lse, block_rows, B, st)
                         : launch_paged<__nv_bfloat16, false>(p, o, lse, block_rows, B, st));
}
