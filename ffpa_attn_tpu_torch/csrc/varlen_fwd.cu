// Packed (THD) varlen forward attention for Hopper (sm_90a): the counterpart
// of the Pallas _varlen_fwd_kernel (ffpa_attn_tpu/ops/varlen.py).
// ops/varlen.py calls the C entry point ffpa_varlen_fwd through ctypes.
//
// The TPU kernel walks a (Hq, Tq / bq, Tk / bkv) grid over head-major
// [H, T, D] copies of the inputs, clamping the KV axis into each Q tile's
// [jmin, jmax] interval. Here one block of 16 warps owns BQ packed query rows
// of one query head (grid (Hq, ceil(Tq / BQ)), heads fastest) and loops over
// the KV tiles of its interval itself; the intervals are read from device
// memory, computed on the device at this kernel's tiles (BQ rows, 64 keys).
// q [Tq, Hq, D], k [Tk, Hkv, D] and v [Tk, Hkv, Dv] are read through their
// row and head strides (no head-major copy, no padding of T); o [Tq, Hq, Dv]
// and lse [Hq, Tq] are written directly, the ragged tail bounds-checked.
//
// The block is the dense forward's (flash_fwd.cu): Split-D with the fp32 O
// tile over the registers of 16 warps, mma.sync m16n8k16 fed by ldmatrix,
// Q resident in shared memory, K and V streaming through a cp.async ring in
// 64 x 64 chunks. The causal tile test becomes the segment / rank keep-mask
//   (q_seg == k_seg) & (k_pos <= q_rank [+ wr]) [& k_pos >= q_rank - wl]
// on the per-token metadata (the row tile's in shared memory, each key
// tile's in registers). Masked scores are MASK_VALUE and their P is exactly
// 0, so a row whose keep-mask is empty (padding, an empty interval's [0, 0]
// tile) gives o = 0 and lse = MASK_VALUE + log(1e-38), as on the TPU.
#include "common.cuh"

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
  const int* jmin;    // [num_q_tiles] first KV tile of each Q tile's interval
  const int* jmax;    // last KV tile
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

}  // namespace

extern "C" int ffpa_varlen_fwd(const void* q, const void* k, const void* v, long long q_rs,
                               long long q_hs, long long k_rs, long long k_hs, long long v_rs,
                               long long v_hs, void* o, float* lse, const int* q_seg,
                               const int* q_rank, const int* k_seg, const int* k_pos,
                               const int* jmin, const int* jmax, const float* alibi, int is_fp16,
                               int block_q, int Hq, int Hkv, int tq, int tk, int num_q_tiles,
                               int D, int Dv, float scale, float softcap, int window_left,
                               int window_right, void* stream) {
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
  p.alibi = alibi;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.tq = tq;
  p.tk = tk;
  p.D = D;
  p.Dv = Dv;
  p.group = Hq / Hkv;
  p.scale = scale;
  p.softcap = softcap;
  p.window_left = window_left;
  p.window_right = window_right;
  // Registers hold block_q x Dv fp32 (64 per thread); D and Dv are 64-multiples.
  if (D % CH != 0 || Dv % CH != 0 || (long long)block_q * Dv > 32 * 1024 ||
      (block_q != 64 && block_q != 32) || num_q_tiles < 1 || Hkv < 1 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    return (int)(block_q == 64 ? launch<__half, 64>(p, num_q_tiles, st)
                               : launch<__half, 32>(p, num_q_tiles, st));
  }
  return (int)(block_q == 64 ? launch<__nv_bfloat16, 64>(p, num_q_tiles, st)
                             : launch<__nv_bfloat16, 32>(p, num_q_tiles, st));
}
