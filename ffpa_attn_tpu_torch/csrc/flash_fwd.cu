// Forward attention kernel for Hopper (sm_90a): the counterpart of the
// Pallas _fwd_kernel (ffpa_attn_tpu/ops/flash_fwd.py). ops/flash_fwd.py calls
// the C entry point ffpa_flash_fwd through ctypes.
//
// Grid (Hq, B, ceil(Nq / BQ)): one block of 16 warps per BQ query rows of one
// query head; K/V are read from head h / group (GQA). BQ is 64 for head dims
// up to 512 and 32 up to 1024. Blocks are dispatched x-fastest, so every
// head's longest causal tiles (the last query rows) go out first and the
// short ones fill the tail.
//
// The TPU kernel keeps a BQ x Dv fp32 accumulator in VMEM. At Dv 512..1024
// no single warp can hold its rows' accumulator, so the O tile is split
// over the block's 16 warps by rows and columns: warp w owns 16 rows
// (rt = w / WC) and, in every 64-wide column chunk of Dv, CW = 64 / WC
// columns (wc = w % WC), 64 fp32 registers per thread in all. Products are
// mma.sync m16n8k16 (bf16 or f16 in, fp32 accumulate) fed by ldmatrix:
//   * Q stays resident in shared memory for the whole KV walk;
//   * K and V stream through a ring of shared-memory slots in 64 x 64
//     chunks with cp.async, NST - 1 chunks ahead of the math: per KV tile
//     the D / 64 K chunks, then the Dv / 64 V chunks;
//   * S = Q K^T (each warp a 16 x CW piece) goes through shared memory so
//     that the online softmax sees whole rows; P goes back the same way and
//     every warp multiplies it into its own O columns.
// Tail-aligned causal and sliding-window tiles outside the band are never
// loaded; the bias is read with strides of 0 on its broadcast dims. Dropout
// drops P after the row sum l (which keeps every element) from the hash of
// rng.cuh, the bits the backward kernels replay.
//
// S residual (return_scores, the S-resident backward's input): each visited
// tile's post-scale / softcap / ALiBi / bias / mask scores go straight from
// the softmax's registers to the bf16 slab [B, Hq, s_rows, s_ld], masked and
// padding entries as MASK_VALUE (never +-inf: the backward's softcap factor
// 1 - (s/cap)^2 reads them). Tiles the band skips are never written; the
// from-S kernel re-masks the band and never reads them.
#include "common.cuh"
#include "rng.cuh"

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
          float s;
          if (!valid) {
            s = 0.f;  // padding row: computed, never stored
          } else if (col >= kv_hi) {
            s = -INFINITY;  // past this block's KV range
          } else {
            s = S[r * LDS + cc] * p.scale;
            if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
            if (p.alibi != nullptr) s -= slope * fabsf((float)(row + p.causal_offset - col));
            if (p.bias != nullptr)
              s += p.bias[(long long)b * p.sb + (long long)head * p.sh + (long long)row * p.sr +
                          (long long)col * p.sc];
            if (p.window_right >= 0 && col > row + p.causal_offset + p.window_right)
              s = MASK_VALUE;
            if (p.window_left >= 0 && col < row + p.causal_offset - p.window_left)
              s = MASK_VALUE;
          }
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
  if (is_fp16) {
    return (int)(block_q == 64 ? launch<__half, 64>(p, B, st) : launch<__half, 32>(p, B, st));
  }
  return (int)(block_q == 64 ? launch<__nv_bfloat16, 64>(p, B, st)
                             : launch<__nv_bfloat16, 32>(p, B, st));
}
