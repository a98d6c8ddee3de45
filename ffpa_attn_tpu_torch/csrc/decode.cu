// Split-KV decode attention for Hopper (sm_90a): the counterpart of the
// Pallas _decode_kernel (ffpa_attn_tpu/ops/decode.py). ops/decode.py calls the
// C entry point ffpa_decode_fwd through ctypes.
//
// The TPU kernel is one pass over the KV axis per KV head, because a TPU v5e
// has one TensorCore. At B=1 and Hkv=4 that grid would fill 4 of an H100's
// 132 SMs, so the KV range is split:
//   launch 1, grid (splits, Hkv * row_blocks, B): each block holds the
//     PackGQA row tile (row r is query head hkv*group + r / Nq at position
//     r % Nq, so K/V stream once per KV head, not once per query head) and
//     walks its KV slice with an fp32 online softmax, writing fp32 partials
//     (o_s normalised by its own l, lse_s = m + log l);
//   launch 2, grid (ceil(Dv / 128), R, B * Hkv): merges the splits by LSE,
//     lse = log sum exp(lse_s), o = sum exp(lse_s - lse) * o_s (split_merge.cuh,
//     shared with the paged decode kernel).
//
// The tile of launch 1 is split-D, with nvcuda::wmma bf16/f16 fragments and
// fp32 accumulation: S = Q K^T accumulates over 64-wide head-dim chunks, the
// fp32 O tile [BQ, Dv] lives in shared memory, and O += P V runs over 64-wide
// column chunks of V, each warp rescaling its own O sub-tiles by alpha right
// before it accumulates into them. Q/K chunk pairs and V chunks stream through
// two shared-memory slots with cp.async, one chunk ahead of the math
// (zero-filled past the ragged edge).
//
// Score residual (return_scores, the decode backward's input): launch 1
// also writes each valid row's masked post-softcap / bias scores in fp32
// to [B, Hkv, R, s_ld], each split its own columns, masked and padding
// entries as MASK_VALUE.
#include <mma.h>

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
constexpr int NSTAGES = 2;    // stream slots (ops/config.py DECODE_STREAM_STAGES)
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
  // empty split gives o_s = 0 and lse_s = -inf, which the merge weighs 0.
  for (int r = warp; r < BQ; r += NWARPS) {
    const int row = row0 + r;
    if (row >= p.nrows) continue;
    const float l = l_s[r];
    const float l_safe = (l == 0.f) ? 1.f : l;
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

}  // namespace

extern "C" int ffpa_decode_fwd(const void* q, const void* k, const void* v, void* o, float* lse,
                               float* o_part, float* lse_part, const float* bias, long long sb,
                               long long sh, long long sr, long long sc, int is_fp16,
                               int block_rows, int B, int Hkv, int R, int nq, int nkv, int D,
                               int Dv, float scale, float softcap, int causal_offset,
                               int window_left, int window_right, int kv_start, int kv_end,
                               int kv_per_split, int num_splits, float* s_out, int s_ld,
                               void* stream) {
  if (D % D_CHUNK != 0 || Dv % D_CHUNK != 0 ||
      (s_out != nullptr && s_ld < ((nkv + KV_TILE - 1) / KV_TILE) * KV_TILE))
    return (int)cudaErrorInvalidValue;
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
  return (int)(is_fp16 ? launch_decode<__half>(p, o, lse, block_rows, B, st)
                       : launch_decode<__nv_bfloat16>(p, o, lse, block_rows, B, st));
}
