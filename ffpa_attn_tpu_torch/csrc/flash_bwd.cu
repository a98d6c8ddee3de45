// Backward attention kernels for Hopper (sm_90a): the counterparts of five
// Pallas kernels of ffpa_attn_tpu/ops/flash_bwd.py. ops/flash_bwd.py calls
// the C entry points through ctypes.
//
//   ffpa_bwd_dkdv        <- _dkdv_kernel: dK, dV, and optionally the dS slab
//   ffpa_bwd_dq          <- _dq_kernel: dQ, and optionally the fp32 dbias slab
//   ffpa_bwd_banded_dq   <- _banded_dq_kernel: dQ = scale * dS K from the slab
//   ffpa_bwd_dkdv_from_s <- _dkdv_from_s_kernel: dV (and dK) from the
//                           forward's S residual, dS written over S in place
//   ffpa_bwd_banded_dk   <- _banded_dk_kernel: dK = scale * dS^T Q from the slab
//
// All three are built from the forward's pieces (flash_fwd.cu): 16 warps,
// mma.sync m16n8k16 (bf16 or f16 in, fp32 accumulate) fed by ldmatrix, a
// block's owned tile resident in shared memory and the other operand
// streamed in 64 x 64 chunks through a 4-slot cp.async ring, fp32
// accumulators split over the warps' registers by rows and columns.
//
// The score gradient of one element is _recompute_ds: s = scale * q.k,
// softcap (keeping its 1 - (s/cap)^2 chain factor for the dK / dQ products
// but not for dbias), ALiBi, bias, causal / window and ragged-edge masks,
// p = exp(s - lse) (zero on rows past Nq), dropout replayed from the hash of
// rng.cuh on global row / col ids (row_offset / col_offset for striped
// launches), dS = p * (dP - delta). Queries are tail-aligned:
// causal_offset = Nkv - Nq. Whole tiles outside the causal / window band
// are never loaded.
//
// dK/dV (TPU: one grid cell per KV tile, the GQA group x Q tiles on a
// sequential grid axis; here: a loop inside the block). A block owns 32 KV
// rows of one KV head, with K and V resident, and walks the group's 128-row
// Q tiles (128 rows give each warp 8 mma between block barriers; 64 rows
// gave 4 and took 1.5x the time). S^T = K Q^T streams the Q chunks; P^T
// goes to shared memory;
// dP^T = V dO^T and dV += P^T dO share one stream of the dO chunks; dS^T goes
// to shared memory (and to the slab); dK += dS^T Q streams the Q chunks
// again. dK and dV come out group-reduced with one store each and no
// atomics. Two 32 x 512 fp32 accumulators take the 64 registers a thread
// has for them, so wider heads split the dK / dV columns over col_passes
// blocks, each recomputing S and dP (the reference's SM90 D512 D-split).
//
// dQ (recompute tier): a block owns BQ query rows with Q and dO resident
// and walks the KV tiles of its band: S over the K chunks, dP over the V
// chunks, dS to shared memory (and fp32 dS to the dbias slab), then
// dQ += dS K over the K chunks again; the BQ x D fp32 dQ tile lives in
// registers exactly like the forward's O tile.
//
// Banded dQ (dS-handoff tier): a block owns a BQ-row panel and walks the KV
// tiles up to the diagonal; each dS tile passes through the ring into
// registers (A fragments), then the K chunks stream past it.
//
// From-S dK/dV and banded dK (S-resident tier, bf16 only): below, beside
// their kernels.
//
// Bound on an H100: operations (4 matmul units of 2 * pairs * D flop for
// dK/dV, 3 for dQ, 1 for banded dQ and banded dK, 2 or 3 for from-S dK/dV;
// see utils/profiling.py).
#include "bwd_tiles.cuh"
#include "rng.cuh"

namespace {

using namespace ffpa;

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, Hq, Nq]
  const float* delta;  // [B, Hq, Nq]: rowsum(dO * O)
  void* dq;            // [B, Hq, Nq, D]
  void* dk;            // [B, Hkv, Nkv, D]
  void* dv;            // [B, Hkv, Nkv, Dv]
  void* ds;            // dS slab [B, Hq, ds_rows, ds_ld] in the input type, or null
  float* dbias;        // fp32 dS slab [B, Hq, ds_rows, ds_ld], or null
  const float* bias;
  long long sb, sh, sr, sc;  // bias strides, 0 on broadcast dims
  const float* alibi;        // [B, Hq] slopes, or null
  int Hq, Hkv, group, nq, nkv, D, Dv;
  int ds_ld, ds_rows, col_passes, out_f32;
  float scale, softcap;
  int causal_offset, window_left, window_right;  // window_right: 0 when causal, -1 open
  float dropout_p, dropout_inv;
  uint32_t seed;
  int row_offset, col_offset;
};

__device__ __forceinline__ int floordiv(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// p = exp(s - lse) of one score element from its raw q.k, its softcap chain
// factor and its dropout keep bit. Rows past Nq and columns past Nkv give 0.
struct Prob {
  float p, cap;
  bool keep;
};

__device__ __forceinline__ Prob score_prob(const BwdParams& p, int b, int h, int row, int col,
                                           float qk, float lse, float slope) {
  Prob r = {0.f, 1.f, true};
  if (row >= p.nq || col >= p.nkv) return r;
  float s = qk * p.scale;
  if (p.softcap > 0.f) {
    s = p.softcap * tanhf(s / p.softcap);
    const float u = s / p.softcap;
    r.cap = 1.f - u * u;
  }
  if (p.alibi != nullptr) s -= slope * fabsf((float)(row + p.causal_offset - col));
  if (p.bias != nullptr)
    s += p.bias[(long long)b * p.sb + (long long)h * p.sh + (long long)row * p.sr +
                (long long)col * p.sc];
  if (p.window_right >= 0 && col > row + p.causal_offset + p.window_right) s = MASK_VALUE;
  if (p.window_left >= 0 && col < row + p.causal_offset - p.window_left) s = MASK_VALUE;
  r.p = __expf(s - lse);
  if (p.dropout_p > 0.f)
    r.keep = dropout_uniform(p.seed, b, h, row + p.row_offset, col + p.col_offset) >= p.dropout_p;
  return r;
}

// x with the element's dropout applied: 0 where dropped, scaled where kept.
__device__ __forceinline__ float dropped(const BwdParams& p, bool keep, float x) {
  return p.dropout_p > 0.f ? (keep ? x * p.dropout_inv : 0.f) : x;
}

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------

// Dynamic shared memory of one dK/dV block; ops/config.py dkdv_smem_bytes is
// the same formula.
template <typename T>
size_t dkdv_smem_bytes(int d, int dv) {
  return ((size_t)KVT * (d + 8) + (size_t)KVT * (dv + 8) + (size_t)NST * QT * LDC +
          2 * (size_t)KVT * LDP) * sizeof(T) + 2 * QT * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(NTHR, 1) dkdv_kernel(const BwdParams p) {
  constexpr int RT = KVT / 16;  // 16-row tiles of the KV tile (2)
  constexpr int WC = NW / RT;   // warps per row tile (8)
  constexpr int CQ = QT / WC;   // Q columns of S^T / dP^T per warp (16: two n8 tiles)
  constexpr int CW = CH / WC;   // dK / dV columns per chunk per warp (8: one n8 tile)
  static_assert(CQ == 16 && CW == 8, "warp tiles");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int LDK = p.D + 8, LDV = p.Dv + 8;
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + KVT * LDK;
  T* ring = Vs + KVT * LDV;
  T* Pt = ring + NST * QT * LDC;  // P (dropped) transposed: [kv][q]
  T* dSt = Pt + KVT * LDP;        // dS (with the softcap factor) transposed
  float* lse_s = reinterpret_cast<float*>(dSt + KVT * LDP);
  float* delta_s = lse_s + QT;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rt = warp / WC, wc = warp % WC;
  const Lanes L(lane);
  const int kvh = blockIdx.x / p.col_passes, pass = blockIdx.x % p.col_passes;
  const int b = blockIdx.y, kv0 = blockIdx.z * KVT;
  const int nD = p.D / CH, nV = p.Dv / CH;
  const int d_lo = pass * nD / p.col_passes, ndo = (pass + 1) * nD / p.col_passes - d_lo;
  const int v_lo = pass * nV / p.col_passes, nvo = (pass + 1) * nV / p.col_passes - v_lo;
  const bool emit = p.ds != nullptr && pass == 0;

  // Q tiles of the band: [i_lo, i_hi) of every group member.
  const int nqt = (p.nq + QT - 1) / QT;
  int i_lo = 0, i_hi = nqt;
  if (p.window_right >= 0)
    i_lo = max(0, floordiv(kv0 - p.causal_offset - p.window_right, QT));
  if (p.window_left >= 0)
    i_hi = min(nqt, floordiv(kv0 + KVT - 1 - p.causal_offset + p.window_left, QT) + 1);
  const int ni = max(0, i_hi - i_lo);
  const int ntiles = p.group * ni;

  const T* kb = static_cast<const T*>(p.k) + ((long long)(b * p.Hkv + kvh) * p.nkv) * p.D;
  const T* vb = static_cast<const T*>(p.v) + ((long long)(b * p.Hkv + kvh) * p.nkv) * p.Dv;

  // Resident K and V: rows past Nkv are zero-filled.
  for (int i = tid; i < KVT * (p.D / 8); i += NTHR) {
    const int r = i / (p.D / 8), c = (i % (p.D / 8)) * 8;
    const bool ok = kv0 + r < p.nkv;
    cp_async16(Ks + r * LDK + c, ok ? kb + (long long)(kv0 + r) * p.D + c : kb, ok);
  }
  for (int i = tid; i < KVT * (p.Dv / 8); i += NTHR) {
    const int r = i / (p.Dv / 8), c = (i % (p.Dv / 8)) * 8;
    const bool ok = kv0 + r < p.nkv;
    cp_async16(Vs + r * LDV + c, ok ? vb + (long long)(kv0 + r) * p.Dv + c : vb, ok);
  }
  cp_async_commit();

  // Chunk gi of the stream: per Q tile, the nD Q chunks (S), the nV dO
  // chunks, this block's own dV columns first (dP and dV), then this
  // block's ndo Q chunks again (dK); 128 rows x 64 columns, rows past Nq
  // zero-filled.
  const int per_tile = nD + nV + ndo;
  const int total = ntiles * per_tile;
  auto issue = [&](int gi) {
    if (gi < total) {
      const int t = gi / per_tile, c = gi - t * per_tile;
      const int h = kvh * p.group + t / ni, q0 = (i_lo + t % ni) * QT;
      const T* src;
      int ld, c0;
      if (c < nD) {
        src = static_cast<const T*>(p.q);
        ld = p.D;
        c0 = c;
      } else if (c < nD + nV) {
        const int vc = c - nD;  // own chunks first, then the others in order
        src = static_cast<const T*>(p.dout);
        ld = p.Dv;
        c0 = vc < nvo ? v_lo + vc : (vc - nvo < v_lo ? vc - nvo : vc);
      } else {
        src = static_cast<const T*>(p.q);
        ld = p.D;
        c0 = d_lo + c - nD - nV;
      }
      src += ((long long)(b * p.Hq + h) * p.nq) * ld;
      T* dst = ring + (gi % NST) * (QT * LDC);
#pragma unroll
      for (int half = 0; half < QT / 64; ++half) {  // two 16-byte vectors per thread
        const int r = (tid >> 3) + 64 * half, cv = (tid & 7) * 8;
        const bool ok = q0 + r < p.nq;
        cp_async16(dst + r * LDC + cv, ok ? src + (long long)(q0 + r) * ld + c0 * CH + cv : src,
                   ok);
      }
    }
    cp_async_commit();
  };
  auto begin = [&](int gi) -> const T* {
    issue(gi + NST - 1);
    cp_async_wait<NST - 1>();
    __syncthreads();
    return ring + (gi % NST) * (QT * LDC);
  };

  float dk_acc[MAXC][1][4], dv_acc[MAXC][1][4];
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[c][0][e] = dv_acc[c][0][e] = 0.f;

  const T* Krow = Ks + (rt * 16) * LDK;
  const T* Vrow = Vs + (rt * 16) * LDV;
  const int kv_loc = rt * 16 + g;  // + 8 for fragment elements 2, 3

#pragma unroll
  for (int gi = 0; gi < NST - 1; ++gi) issue(gi);
  for (int t = 0; t < ntiles; ++t) {
    const int h = kvh * p.group + t / ni, q0 = (i_lo + t % ni) * QT;
    const int gt = t * per_tile;
    const float slope = p.alibi != nullptr ? p.alibi[b * p.Hq + h] : 0.f;
    __syncthreads();  // the previous tile's readers of lse_s / delta_s are done
    if (tid < QT) {
      const long long idx = (long long)(b * p.Hq + h) * p.nq + q0 + tid;
      const bool ok = q0 + tid < p.nq;
      lse_s[tid] = ok ? p.lse[idx] : 0.f;
      delta_s[tid] = ok ? p.delta[idx] : 0.f;
    }

    // S^T = K Q^T: this warp's 16 KV rows x 16 Q columns.
    float st[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int c = 0; c < nD; ++c) {
      const T* ch = begin(gt + c);
      mma_abt<T, 2>(st, Krow + c * CH, LDK, ch + (wc * CQ) * LDC, L, lane);
      __syncthreads();  // the slot read here is refilled by a later issue
    }

    // P (dropped) to shared memory, transposed; p times the softcap factor
    // and the keep bits stay in registers for dS.
    float pc[2][4];
    uint32_t kept = 0;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kvl = kv_loc + ((e >> 1) << 3), ql = wc * CQ + n * 8 + 2 * t4 + (e & 1);
        const Prob pr = score_prob(p, b, h, q0 + ql, kv0 + kvl, st[n][e], lse_s[ql], slope);
        pc[n][e] = pr.p * pr.cap;
        kept |= (uint32_t)pr.keep << (4 * n + e);
        st[n][e] = dropped(p, pr.keep, pr.p);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(Pt + (kv_loc + 8 * hh) * LDP + wc * CQ + n * 8 + 2 * t4) =
            pack2<T>(st[n][2 * hh], st[n][2 * hh + 1]);
    }

    // dP^T = V dO^T over every dO chunk; dV += P^T dO over this block's own.
    float dpt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int vc = 0; vc < MAXC; ++vc) {
      if (vc < nvo) {
        const T* ch = begin(gt + nD + vc);
        mma_abt<T, 2>(dpt, Vrow + (v_lo + vc) * CH, LDV, ch + (wc * CQ) * LDC, L, lane);
        mma_ab<T, 1, QT / 16>(dv_acc[vc], Pt + (rt * 16) * LDP, LDP, ch + wc * CW, L);
        __syncthreads();
      }
    }
    for (int vc = nvo; vc < nV; ++vc) {
      const T* ch = begin(gt + nD + vc);
      const int c0 = vc - nvo < v_lo ? vc - nvo : vc;
      mma_abt<T, 2>(dpt, Vrow + c0 * CH, LDV, ch + (wc * CQ) * LDC, L, lane);
      __syncthreads();
    }

    // dS = P * (dP - delta), transposed into shared memory.
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = wc * CQ + n * 8 + 2 * t4 + (e & 1);
        dsv[e] = pc[n][e] * (dropped(p, (kept >> (4 * n + e)) & 1u, dpt[n][e]) - delta_s[ql]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(dSt + (kv_loc + 8 * hh) * LDP + wc * CQ + n * 8 + 2 * t4) =
            pack2<T>(dsv[2 * hh], dsv[2 * hh + 1]);
    }
    if (emit) {
      __syncthreads();
      // Slab rows q0..q0+127, columns kv0..kv0+31: 8 columns per thread.
      const int ql = tid >> 2, kv8 = (tid & 3) * 8;
      T vals[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) vals[j] = dSt[(kv8 + j) * LDP + ql];
      T* dst = static_cast<T*>(p.ds) +
               ((long long)(b * p.Hq + h) * p.ds_rows + q0 + ql) * p.ds_ld + kv0 + kv8;
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(vals);
    }

    // dK += dS^T Q over this block's own Q chunks; this warp's dS^T rows
    // stay in registers as A fragments across the chunks (32 registers:
    // P, dP and the keep bits are dead by now).
    uint32_t dsf[QT / 16][4];
#pragma unroll
    for (int dc = 0; dc < MAXC; ++dc) {
      if (dc < ndo) {
        const T* ch = begin(gt + nD + nV + dc);
        if (dc == 0) {
#pragma unroll
          for (int kk = 0; kk < QT / 16; ++kk)
            ldsm_x4(dsf[kk], dSt + (rt * 16 + L.a_row) * LDP + kk * 16 + L.a_col);
        }
#pragma unroll
        for (int kk = 0; kk < QT / 16; ++kk) {
          uint32_t bf[2];
          ldsm_x2_trans(bf, ch + (kk * 16 + L.bt_row) * LDC + wc * CW);
          mma16816<T>(dk_acc[dc][0], dsf[kk], bf[0], bf[1]);
        }
        __syncthreads();
      }
    }
  }
  cp_async_wait<0>();

  // Skipped Q tiles of the band still define their dS slab tile: zeros.
  if (emit) {
    const int ql = tid >> 2, kv8 = (tid & 3) * 8;
    for (int gg = 0; gg < p.group; ++gg) {
      const int h = kvh * p.group + gg;
      for (int i = 0; i < nqt; ++i) {
        if (i >= i_lo && i < i_hi) continue;
        T* dst = static_cast<T*>(p.ds) +
                 ((long long)(b * p.Hq + h) * p.ds_rows + i * QT + ql) * p.ds_ld + kv0 + kv8;
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  }

  // Epilogue: dK = scale * sum, dV; rows past Nkv are not stored.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kv = kv0 + kv_loc + 8 * hh;
    if (kv >= p.nkv) continue;
    const long long rk = ((long long)(b * p.Hkv + kvh) * p.nkv + kv) * p.D;
    const long long rv = ((long long)(b * p.Hkv + kvh) * p.nkv + kv) * p.Dv;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int col = wc * CW + 2 * t4;
      if (c < ndo)
        store2<T>(p.dk, rk + (d_lo + c) * CH + col, dk_acc[c][0][2 * hh] * p.scale,
                  dk_acc[c][0][2 * hh + 1] * p.scale, p.out_f32);
      if (c < nvo)
        store2<T>(p.dv, rv + (v_lo + c) * CH + col, dv_acc[c][0][2 * hh],
                  dv_acc[c][0][2 * hh + 1], p.out_f32);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ (recompute)
// ---------------------------------------------------------------------------

template <typename T>
size_t dq_smem_bytes(int bq, int d, int dv) {
  return ((size_t)bq * (d + 8) + (size_t)bq * (dv + 8) + (size_t)NST * CH * LDC +
          (size_t)bq * LDC) * sizeof(T) + 2 * (size_t)bq * sizeof(float);
}

// The KV range [kv_lo, kv_hi) rows row0..row_last see, kv_lo tile-aligned.
__device__ __forceinline__ void kv_band(const BwdParams& p, int row0, int row_last, int& kv_lo,
                                        int& kv_hi) {
  kv_lo = 0;
  kv_hi = p.nkv;
  if (p.window_right >= 0)
    kv_hi = min(p.nkv, row_last + p.causal_offset + p.window_right + 1);
  if (p.window_left >= 0) kv_lo = max(0, row0 + p.causal_offset - p.window_left);
  kv_lo = (kv_lo / CH) * CH;
}

template <typename T, int BQ>
__global__ void __launch_bounds__(NTHR, 1) dq_kernel(const BwdParams p) {
  constexpr int RT = BQ / 16;
  constexpr int WC = NW / RT;
  constexpr int CW = CH / WC;
  constexpr int N8 = CW / 8;
  constexpr int NVMAX = ACC_PER_THREAD / (4 * N8);  // D chunks the registers hold
  static_assert(N8 == 1 || N8 == 2, "BQ must be 32 or 64");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int LDQ = p.D + 8, LDO = p.Dv + 8;
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* dOs = Qs + BQ * LDQ;
  T* ring = dOs + BQ * LDO;
  T* dSs = ring + NST * CH * LDC;
  float* lse_s = reinterpret_cast<float*>(dSs + BQ * LDC);
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rt = warp / WC, wc = warp % WC;
  const Lanes L(lane);
  const int head = blockIdx.x, b = blockIdx.y, kvh = head / p.group;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // the longest causal rows start first
  const int row_last = min(row0 + BQ, p.nq) - 1;
  int kv_lo, kv_hi;
  kv_band(p, row0, row_last, kv_lo, kv_hi);
  const int nD = p.D / CH, nV = p.Dv / CH;
  const int ntiles = kv_hi > kv_lo ? (kv_hi - kv_lo + CH - 1) / CH : 0;

  const long long qh = (long long)(b * p.Hq + head) * p.nq;
  const T* qb = static_cast<const T*>(p.q) + qh * p.D;
  const T* ob = static_cast<const T*>(p.dout) + qh * p.Dv;
  const T* kb = static_cast<const T*>(p.k) + ((long long)(b * p.Hkv + kvh) * p.nkv) * p.D;
  const T* vb = static_cast<const T*>(p.v) + ((long long)(b * p.Hkv + kvh) * p.nkv) * p.Dv;
  const float slope = p.alibi != nullptr ? p.alibi[b * p.Hq + head] : 0.f;

  // Resident Q and dO: rows past Nq zero-filled.
  for (int i = tid; i < BQ * (p.D / 8); i += NTHR) {
    const int r = i / (p.D / 8), c = (i % (p.D / 8)) * 8;
    const bool ok = row0 + r < p.nq;
    cp_async16(Qs + r * LDQ + c, ok ? qb + (long long)(row0 + r) * p.D + c : qb, ok);
  }
  for (int i = tid; i < BQ * (p.Dv / 8); i += NTHR) {
    const int r = i / (p.Dv / 8), c = (i % (p.Dv / 8)) * 8;
    const bool ok = row0 + r < p.nq;
    cp_async16(dOs + r * LDO + c, ok ? ob + (long long)(row0 + r) * p.Dv + c : ob, ok);
  }
  cp_async_commit();
  for (int i = tid; i < BQ; i += NTHR) {
    const bool ok = row0 + i < p.nq;
    lse_s[i] = ok ? p.lse[qh + row0 + i] : 0.f;
    delta_s[i] = ok ? p.delta[qh + row0 + i] : 0.f;
  }

  // Chunk gi of the stream: per KV tile, the nD K chunks (S), the nV V
  // chunks (dP), the nD K chunks again (dQ); rows past Nkv zero-filled.
  const int per_tile = 2 * nD + nV;
  const int total = ntiles * per_tile;
  auto issue = [&](int gi) {
    if (gi < total) {
      const int t = gi / per_tile, c = gi - t * per_tile;
      const int kv0 = kv_lo + t * CH;
      const bool is_v = c >= nD && c < nD + nV;
      const T* src = is_v ? vb : kb;
      const int ld = is_v ? p.Dv : p.D;
      const int c0 = c < nD ? c : (is_v ? c - nD : c - nD - nV);
      T* dst = ring + (gi % NST) * (CH * LDC);
      const int r = tid >> 3, cv = (tid & 7) * 8;
      const bool ok = kv0 + r < p.nkv;
      cp_async16(dst + r * LDC + cv, ok ? src + (long long)(kv0 + r) * ld + c0 * CH + cv : src, ok);
    }
    cp_async_commit();
  };
  auto begin = [&](int gi) -> const T* {
    issue(gi + NST - 1);
    cp_async_wait<NST - 1>();
    __syncthreads();
    return ring + (gi % NST) * (CH * LDC);
  };

  float o[NVMAX][N8][4];
#pragma unroll
  for (int vc = 0; vc < NVMAX; ++vc)
#pragma unroll
    for (int n = 0; n < N8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[vc][n][e] = 0.f;

#pragma unroll
  for (int gi = 0; gi < NST - 1; ++gi) issue(gi);
  for (int t = 0; t < ntiles; ++t) {
    const int kv0 = kv_lo + t * CH;
    const int gt = t * per_tile;

    float s_acc[N8][4], dp_acc[N8][4];
#pragma unroll
    for (int n = 0; n < N8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s_acc[n][e] = dp_acc[n][e] = 0.f;
    for (int c = 0; c < nD; ++c) {
      const T* ch = begin(gt + c);
      mma_abt<T, N8>(s_acc, Qs + (rt * 16) * LDQ + c * CH, LDQ, ch + (wc * CW) * LDC, L, lane);
      __syncthreads();
    }
    for (int c = 0; c < nV; ++c) {
      const T* ch = begin(gt + nD + c);
      mma_abt<T, N8>(dp_acc, dOs + (rt * 16) * LDO + c * CH, LDO, ch + (wc * CW) * LDC, L, lane);
      __syncthreads();
    }

    // dS to shared memory (with the softcap factor) and to the dbias slab
    // (without it).
#pragma unroll
    for (int n = 0; n < N8; ++n) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rl = rt * 16 + g + 8 * hh, cl = wc * CW + n * 8 + 2 * t4;
        float ds[2], dsqk[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const Prob pr = score_prob(p, b, head, row0 + rl, kv0 + cl + j, s_acc[n][2 * hh + j],
                                     lse_s[rl], slope);
          ds[j] = pr.p * (dropped(p, pr.keep, dp_acc[n][2 * hh + j]) - delta_s[rl]);
          dsqk[j] = ds[j] * pr.cap;
        }
        *reinterpret_cast<uint32_t*>(dSs + rl * LDC + cl) = pack2<T>(dsqk[0], dsqk[1]);
        if (p.dbias != nullptr)
          *reinterpret_cast<float2*>(p.dbias + ((long long)(b * p.Hq + head) * p.ds_rows + row0 + rl) *
                                                   p.ds_ld + kv0 + cl) = make_float2(ds[0], ds[1]);
      }
    }

    // dQ += dS K over the K chunks.
#pragma unroll
    for (int vc = 0; vc < NVMAX; ++vc) {
      if (vc < nD) {
        const T* ch = begin(gt + nD + nV + vc);
        mma_ab<T, N8>(o[vc], dSs + (rt * 16) * LDC, LDC, ch + wc * CW, L);
        __syncthreads();
      }
    }
  }
  cp_async_wait<0>();

  // dbias tiles outside the band: zeros.
  if (p.dbias != nullptr) {
    const int kv_end = kv_lo + ntiles * CH;
    for (int i = tid; i < BQ * (p.ds_ld / 4); i += NTHR) {
      const int r = i / (p.ds_ld / 4), c = (i % (p.ds_ld / 4)) * 4;
      if (c >= kv_lo && c < kv_end) continue;
      *reinterpret_cast<float4*>(p.dbias + ((long long)(b * p.Hq + head) * p.ds_rows + row0 + r) *
                                               p.ds_ld + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // Epilogue: dQ = scale * sum.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + rt * 16 + g + 8 * hh;
    if (row >= p.nq) continue;
    const long long base = (qh + row) * p.D;
#pragma unroll
    for (int vc = 0; vc < NVMAX; ++vc) {
      if (vc < nD) {
#pragma unroll
        for (int n = 0; n < N8; ++n) {
          const int col = vc * CH + wc * CW + n * 8 + 2 * t4;
          store2<T>(p.dq, base + col, o[vc][n][2 * hh] * p.scale, o[vc][n][2 * hh + 1] * p.scale,
                    p.out_f32);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Banded dQ from the dS slab (causal)
// ---------------------------------------------------------------------------

template <typename T, int BQ>
__global__ void __launch_bounds__(NTHR, 1) banded_dq_kernel(const BwdParams p) {
  constexpr int RT = BQ / 16;
  constexpr int WC = NW / RT;
  constexpr int CW = CH / WC;
  constexpr int N8 = CW / 8;
  constexpr int NVMAX = ACC_PER_THREAD / (4 * N8);
  static_assert(N8 == 1 || N8 == 2, "BQ must be 32 or 64");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rt = warp / WC, wc = warp % WC;
  const Lanes L(lane);
  const int head = blockIdx.x, b = blockIdx.y, kvh = head / p.group;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int row_last = min(row0 + BQ, p.nq) - 1;
  const int kv_hi = min(p.nkv, row_last + p.causal_offset + 1);
  const int ntiles = kv_hi > 0 ? (kv_hi + CH - 1) / CH : 0;
  const int nD = p.D / CH;

  const T* dsb = static_cast<const T*>(p.ds) + ((long long)(b * p.Hq + head) * p.ds_rows) * p.ds_ld;
  const T* kb = static_cast<const T*>(p.k) + ((long long)(b * p.Hkv + kvh) * p.nkv) * p.D;

  // Chunk gi of the stream: per KV tile, the dS tile (BQ rows x 64
  // columns; columns past the slab zero-filled) then the nD K chunks (rows
  // past Nkv zero-filled).
  const int per_tile = 1 + nD;
  const int total = ntiles * per_tile;
  auto issue = [&](int gi) {
    if (gi < total) {
      const int t = gi / per_tile, c = gi - t * per_tile;
      const int kv0 = t * CH;
      T* dst = ring + (gi % NST) * (CH * LDC);
      const int r = tid >> 3, cv = (tid & 7) * 8;
      if (c == 0) {
        if (r < BQ) {
          const bool ok = kv0 + cv < p.ds_ld;
          cp_async16(dst + r * LDC + cv, ok ? dsb + (long long)(row0 + r) * p.ds_ld + kv0 + cv : dsb,
                     ok);
        }
      } else {
        const bool ok = kv0 + r < p.nkv;
        cp_async16(dst + r * LDC + cv, ok ? kb + (long long)(kv0 + r) * p.D + (c - 1) * CH + cv : kb,
                   ok);
      }
    }
    cp_async_commit();
  };
  auto begin = [&](int gi) -> const T* {
    issue(gi + NST - 1);
    cp_async_wait<NST - 1>();
    __syncthreads();
    return ring + (gi % NST) * (CH * LDC);
  };

  float o[NVMAX][N8][4];
#pragma unroll
  for (int vc = 0; vc < NVMAX; ++vc)
#pragma unroll
    for (int n = 0; n < N8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[vc][n][e] = 0.f;

#pragma unroll
  for (int gi = 0; gi < NST - 1; ++gi) issue(gi);
  for (int t = 0; t < ntiles; ++t) {
    const int gt = t * per_tile;
    // This warp's 16 dS rows as A fragments, held while the K chunks pass.
    uint32_t af[CH / 16][4];
    {
      const T* ch = begin(gt);
#pragma unroll
      for (int kk = 0; kk < CH / 16; ++kk)
        ldsm_x4(af[kk], ch + (rt * 16 + L.a_row) * LDC + kk * 16 + L.a_col);
      __syncthreads();
    }
#pragma unroll
    for (int vc = 0; vc < NVMAX; ++vc) {
      if (vc < nD) {
        const T* ch = begin(gt + 1 + vc);
#pragma unroll
        for (int kk = 0; kk < CH / 16; ++kk) {
          if (N8 == 2) {
            uint32_t bf[4];
            ldsm_x4_trans(bf, ch + (kk * 16 + L.bt_row) * LDC + wc * CW + L.bt_col);
            mma16816<T>(o[vc][0], af[kk], bf[0], bf[1]);
            mma16816<T>(o[vc][N8 - 1], af[kk], bf[2], bf[3]);
          } else {
            uint32_t bf[2];
            ldsm_x2_trans(bf, ch + (kk * 16 + L.bt_row) * LDC + wc * CW);
            mma16816<T>(o[vc][0], af[kk], bf[0], bf[1]);
          }
        }
        __syncthreads();
      }
    }
  }
  cp_async_wait<0>();

  const long long qh = (long long)(b * p.Hq + head) * p.nq;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + rt * 16 + g + 8 * hh;
    if (row >= p.nq) continue;
#pragma unroll
    for (int vc = 0; vc < NVMAX; ++vc) {
      if (vc < nD) {
#pragma unroll
        for (int n = 0; n < N8; ++n) {
          const int col = vc * CH + wc * CW + n * 8 + 2 * t4;
          store2<T>(p.dq, (qh + row) * p.D + col, o[vc][n][2 * hh] * p.scale,
                    o[vc][n][2 * hh + 1] * p.scale, p.out_f32);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dK / dV from the forward's S residual (S-resident backward, bf16)
// ---------------------------------------------------------------------------

// Dynamic shared memory of one from-S block; ops/config.py
// dkdv_from_s_smem_bytes is the same formula. No K tile: S comes from the
// slab through the ring.
template <int KV>
size_t from_s_smem_bytes(int dv) {
  return ((size_t)KV * (dv + 8) + (size_t)NST * QT * LDC + 2 * (size_t)KV * LDP) *
             sizeof(__nv_bfloat16) +
         2 * QT * sizeof(float);
}

// A block owns KV rows [kv0, kv0 + KV) of one KV head with V resident and
// walks the GQA group's 128-row Q tiles of the causal band. Per tile the
// ring brings the S tile (128 x KV of the slab), then the dO chunks, then
// (DK) the Q chunks. P = exp(S - lse) is re-masked here (rows past Nq,
// columns past Nkv or above the causal diagonal give 0 whatever the slab
// holds there), dP^T = V dO^T and dV += P^T dO share the dO stream, dS =
// P (dP - delta) (times the softcap factor 1 - (s/cap)^2 read from S)
// overwrites the S tile in place, and with DK dK += dS^T Q. Exactly one
// block owns each slab tile and reads it before it writes it, so the
// in-place update has no race. Q tiles the band skips get zeros, so every
// tile of the slab is defined for banded dQ / dK and dbias.
//
// KV = 64 (dK out of kernel, Dv <= 512): 16 warps as 4 row tiles x 4, the
// fp32 dV tile (64 x 512) in 64 registers a thread. KV = 32: 2 x 8 warps,
// dV alone up to 1024 columns, or dK and dV up to 512 each (DK).
template <int KV, bool DK>
__global__ void __launch_bounds__(NTHR, 1) dkdv_from_s_kernel(const BwdParams p) {
  using T = __nv_bfloat16;
  constexpr int RT = KV / 16;    // 16-row tiles of the KV tile
  constexpr int WC = NW / RT;    // warps per row tile
  constexpr int CQ = QT / WC;    // Q columns of S^T / dP^T per warp (16 or 32)
  constexpr int NQ8 = CQ / 8;    // n8 tiles of them (2 or 4)
  constexpr int CW = CH / WC;    // dK / dV columns per chunk per warp (8 or 16)
  constexpr int NC8 = CW / 8;    // n8 tiles of them (1 or 2)
  constexpr int MAXV = ACC_PER_THREAD / ((DK ? 2 : 1) * 4 * NC8);  // dV chunks held
  static_assert(!DK || KV == 32, "dK in kernel takes 32-row KV tiles");
  static_assert(KV * QT / 8 % NTHR == 0, "slab tile vectors per thread");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int LDV = p.Dv + 8;
  T* Vs = reinterpret_cast<T*>(smem_raw);
  T* ring = Vs + KV * LDV;
  T* Pt = ring + NST * QT * LDC;  // P (dropped) transposed: [kv][q]
  T* dSt = Pt + KV * LDP;         // dS (with the softcap factor) transposed
  float* lse_s = reinterpret_cast<float*>(dSt + KV * LDP);
  float* delta_s = lse_s + QT;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rt = warp / WC, wc = warp % WC;
  const Lanes L(lane);
  const int kvh = blockIdx.x, b = blockIdx.y, kv0 = blockIdx.z * KV;
  const int nD = p.D / CH, nV = p.Dv / CH;

  // Q tiles of the band: [i_lo, nqt) of every group member.
  const int nqt = (p.ds_rows + QT - 1) / QT;
  const int i_lo =
      p.window_right >= 0 ? max(0, floordiv(kv0 - p.causal_offset - p.window_right, QT)) : 0;
  const int ni = max(0, nqt - i_lo);
  const int ntiles = p.group * ni;

  const T* vb = static_cast<const T*>(p.v) + ((long long)(b * p.Hkv + kvh) * p.nkv) * p.Dv;
  T* slab = static_cast<T*>(p.ds);

  // Resident V: rows past Nkv are zero-filled.
  for (int i = tid; i < KV * (p.Dv / 8); i += NTHR) {
    const int r = i / (p.Dv / 8), c = (i % (p.Dv / 8)) * 8;
    const bool ok = kv0 + r < p.nkv;
    cp_async16(Vs + r * LDV + c, ok ? vb + (long long)(kv0 + r) * p.Dv + c : vb, ok);
  }
  cp_async_commit();

  // Chunk gi of the stream: per Q tile, the S tile (128 rows x KV columns
  // of the slab; rows past the slab zero-filled), the nV dO chunks, and
  // with DK the nD Q chunks (128 x 64, rows past Nq zero-filled).
  const int per_tile = 1 + nV + (DK ? nD : 0);
  const int total = ntiles * per_tile;
  auto issue = [&](int gi) {
    if (gi < total) {
      const int t = gi / per_tile, c = gi - t * per_tile;
      const int h = kvh * p.group + t / ni, q0 = (i_lo + t % ni) * QT;
      T* dst = ring + (gi % NST) * (QT * LDC);
      if (c == 0) {
        const T* src = slab + ((long long)(b * p.Hq + h) * p.ds_rows) * p.ds_ld + kv0;
#pragma unroll
        for (int k = 0; k < KV * QT / 8 / NTHR; ++k) {
          const int i = tid + k * NTHR;
          const int r = i / (KV / 8), cv = (i % (KV / 8)) * 8;
          const bool ok = q0 + r < p.ds_rows;
          cp_async16(dst + r * LDC + cv, ok ? src + (long long)(q0 + r) * p.ds_ld + cv : src, ok);
        }
      } else {
        const bool is_do = c <= nV;
        const T* src = static_cast<const T*>(is_do ? p.dout : p.q);
        const int ld = is_do ? p.Dv : p.D;
        const int c0 = is_do ? c - 1 : c - 1 - nV;
        src += ((long long)(b * p.Hq + h) * p.nq) * ld;
#pragma unroll
        for (int half = 0; half < QT / 64; ++half) {
          const int r = (tid >> 3) + 64 * half, cv = (tid & 7) * 8;
          const bool ok = q0 + r < p.nq;
          cp_async16(dst + r * LDC + cv,
                     ok ? src + (long long)(q0 + r) * ld + c0 * CH + cv : src, ok);
        }
      }
    }
    cp_async_commit();
  };
  auto begin = [&](int gi) -> const T* {
    issue(gi + NST - 1);
    cp_async_wait<NST - 1>();
    __syncthreads();
    return ring + (gi % NST) * (QT * LDC);
  };

  float dv_acc[MAXV][NC8][4];
  float dk_acc[DK ? MAXV : 1][1][4];
#pragma unroll
  for (int c = 0; c < MAXV; ++c)
#pragma unroll
    for (int n = 0; n < NC8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv_acc[c][n][e] = 0.f;
#pragma unroll
  for (int c = 0; c < (DK ? MAXV : 1); ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[c][0][e] = 0.f;

  const T* Vrow = Vs + (rt * 16) * LDV;
  const int kv_loc = rt * 16 + g;  // + 8 for fragment elements 2, 3

#pragma unroll
  for (int gi = 0; gi < NST - 1; ++gi) issue(gi);
  for (int t = 0; t < ntiles; ++t) {
    const int h = kvh * p.group + t / ni, q0 = (i_lo + t % ni) * QT;
    const int gt = t * per_tile;
    __syncthreads();  // the previous tile's readers of lse_s / delta_s are done
    if (tid < QT) {
      const long long idx = (long long)(b * p.Hq + h) * p.nq + q0 + tid;
      const bool ok = q0 + tid < p.nq;
      lse_s[tid] = ok ? p.lse[idx] : 0.f;
      delta_s[tid] = ok ? p.delta[idx] : 0.f;
    }

    // P from the S tile: this warp's 16 KV rows x CQ Q columns. p times
    // the softcap factor and the keep bits stay in registers for dS.
    float pc[NQ8][4];
    uint32_t kept = 0;
    {
      const T* st = begin(gt);
#pragma unroll
      for (int n = 0; n < NQ8; ++n) {
        float pd[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kvl = kv_loc + ((e >> 1) << 3), ql = wc * CQ + n * 8 + 2 * t4 + (e & 1);
          const int row = q0 + ql, col = kv0 + kvl;
          float pv = 0.f, cap = 1.f;
          bool keep = true;
          if (row < p.nq && col < p.nkv &&
              (p.window_right < 0 || col <= row + p.causal_offset + p.window_right)) {
            const float s = __bfloat162float(st[ql * LDC + kvl]);
            pv = __expf(s - lse_s[ql]);
            if (p.softcap > 0.f) {
              const float u = s / p.softcap;
              cap = fmaxf(1.f - u * u, 0.f);
            }
            if (p.dropout_p > 0.f)
              keep = dropout_uniform(p.seed, b, h, row, col) >= p.dropout_p;
          }
          pc[n][e] = pv * cap;
          kept |= (uint32_t)keep << (4 * n + e);
          pd[e] = dropped(p, keep, pv);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<uint32_t*>(Pt + (kv_loc + 8 * hh) * LDP + wc * CQ + n * 8 + 2 * t4) =
              pack2<T>(pd[2 * hh], pd[2 * hh + 1]);
      }
      __syncthreads();  // the S slot is refilled by a later issue; P^T is complete
    }

    // dP^T = V dO^T and dV += P^T dO over the dO chunks.
    float dpt[NQ8][4];
#pragma unroll
    for (int n = 0; n < NQ8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[n][e] = 0.f;
#pragma unroll
    for (int vc = 0; vc < MAXV; ++vc) {
      if (vc < nV) {
        const T* ch = begin(gt + 1 + vc);
        mma_abt<T, NQ8>(dpt, Vrow + vc * CH, LDV, ch + (wc * CQ) * LDC, L, lane);
        mma_ab<T, NC8, QT / 16>(dv_acc[vc], Pt + (rt * 16) * LDP, LDP, ch + wc * CW, L);
        __syncthreads();
      }
    }

    // dS = P * (dP - delta), transposed into shared memory.
#pragma unroll
    for (int n = 0; n < NQ8; ++n) {
      float dsv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = wc * CQ + n * 8 + 2 * t4 + (e & 1);
        dsv[e] = pc[n][e] * (dropped(p, (kept >> (4 * n + e)) & 1u, dpt[n][e]) - delta_s[ql]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(dSt + (kv_loc + 8 * hh) * LDP + wc * CQ + n * 8 + 2 * t4) =
            pack2<T>(dsv[2 * hh], dsv[2 * hh + 1]);
    }
    __syncthreads();
    // dS over the S tile in place: 8 columns per 16-byte vector.
#pragma unroll
    for (int k = 0; k < KV * QT / 8 / NTHR; ++k) {
      const int i = tid + k * NTHR;
      const int ql = i / (KV / 8), kv8 = (i % (KV / 8)) * 8;
      if (q0 + ql < p.ds_rows) {
        T vals[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) vals[j] = dSt[(kv8 + j) * LDP + ql];
        *reinterpret_cast<uint4*>(slab + ((long long)(b * p.Hq + h) * p.ds_rows + q0 + ql) *
                                             p.ds_ld + kv0 + kv8) =
            *reinterpret_cast<const uint4*>(vals);
      }
    }

    if constexpr (DK) {
      // dK += dS^T Q over the Q chunks, this warp's dS^T rows held as A
      // fragments across the chunks.
      uint32_t dsf[QT / 16][4];
#pragma unroll
      for (int dc = 0; dc < MAXV; ++dc) {
        if (dc < nD) {
          const T* ch = begin(gt + 1 + nV + dc);
          if (dc == 0) {
#pragma unroll
            for (int kk = 0; kk < QT / 16; ++kk)
              ldsm_x4(dsf[kk], dSt + (rt * 16 + L.a_row) * LDP + kk * 16 + L.a_col);
          }
#pragma unroll
          for (int kk = 0; kk < QT / 16; ++kk) {
            uint32_t bf[2];
            ldsm_x2_trans(bf, ch + (kk * 16 + L.bt_row) * LDC + wc * CW);
            mma16816<T>(dk_acc[dc][0], dsf[kk], bf[0], bf[1]);
          }
          __syncthreads();
        }
      }
    }
  }
  cp_async_wait<0>();

  // Q tiles above the band: zeros over this block's columns of the slab.
  for (int gg = 0; gg < p.group; ++gg) {
    const int h = kvh * p.group + gg;
    for (int i = tid; i < i_lo * QT * (KV / 8); i += NTHR) {
      const int r = i / (KV / 8), kv8 = (i % (KV / 8)) * 8;
      if (r >= p.ds_rows) continue;
      *reinterpret_cast<uint4*>(slab + ((long long)(b * p.Hq + h) * p.ds_rows + r) * p.ds_ld +
                                kv0 + kv8) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // Epilogue: dV (and dK = scale * sum); rows past Nkv are not stored.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kv = kv0 + kv_loc + 8 * hh;
    if (kv >= p.nkv) continue;
    const long long rv = ((long long)(b * p.Hkv + kvh) * p.nkv + kv) * p.Dv;
    const long long rk = ((long long)(b * p.Hkv + kvh) * p.nkv + kv) * p.D;
#pragma unroll
    for (int c = 0; c < MAXV; ++c) {
#pragma unroll
      for (int n = 0; n < NC8; ++n) {
        const int col = c * CH + wc * CW + n * 8 + 2 * t4;
        if (c < nV)
          store2<T>(p.dv, rv + col, dv_acc[c][n][2 * hh], dv_acc[c][n][2 * hh + 1], p.out_f32);
        if constexpr (DK) {
          if (c < nD)
            store2<T>(p.dk, rk + col, dk_acc[c][0][2 * hh] * p.scale,
                      dk_acc[c][0][2 * hh + 1] * p.scale, p.out_f32);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Banded dK from the dS slab (causal)
// ---------------------------------------------------------------------------

// The mirror of banded dQ: a block owns BKV KV rows of one KV head, the
// fp32 dK tile (BKV x D) in registers like the forward's O tile, and walks
// the GQA group's 64-row Q tiles at or below the diagonal. Each dS tile
// (64 q x BKV kv) passes through the ring and is read transposed
// (ldmatrix.trans) into A fragments of dS^T held while the Q chunks stream
// past. dK is stored group-reduced once, no atomics.
template <int BKV>
__global__ void __launch_bounds__(NTHR, 1) banded_dk_kernel(const BwdParams p) {
  using T = __nv_bfloat16;
  constexpr int RT = BKV / 16;
  constexpr int WC = NW / RT;
  constexpr int CW = CH / WC;
  constexpr int N8 = CW / 8;
  constexpr int NVMAX = ACC_PER_THREAD / (4 * N8);
  constexpr int QB = CH;  // Q rows per tile
  static_assert(N8 == 1 || N8 == 2, "BKV must be 32 or 64");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rt = warp / WC, wc = warp % WC;
  const Lanes L(lane);
  const int kvh = blockIdx.x, b = blockIdx.y, kv0 = blockIdx.z * BKV;
  const int nD = p.D / CH;
  const int nqt = (p.nq + QB - 1) / QB;
  const int i_lo = max(0, floordiv(kv0 - p.causal_offset, QB));
  const int ni = max(0, nqt - i_lo);
  const int ntiles = p.group * ni;

  // Chunk gi of the stream: per Q tile, the dS tile (rows past the slab
  // zero-filled) then the nD Q chunks (rows past Nq zero-filled).
  const int per_tile = 1 + nD;
  const int total = ntiles * per_tile;
  auto issue = [&](int gi) {
    if (gi < total) {
      const int t = gi / per_tile, c = gi - t * per_tile;
      const int h = kvh * p.group + t / ni, q0 = (i_lo + t % ni) * QB;
      T* dst = ring + (gi % NST) * (CH * LDC);
      if (c == 0) {
        if (tid < QB * BKV / 8) {
          const int r = tid / (BKV / 8), cv = (tid % (BKV / 8)) * 8;
          const T* src = static_cast<const T*>(p.ds) +
                         ((long long)(b * p.Hq + h) * p.ds_rows) * p.ds_ld + kv0;
          const bool ok = q0 + r < p.ds_rows;
          cp_async16(dst + r * LDC + cv, ok ? src + (long long)(q0 + r) * p.ds_ld + cv : src, ok);
        }
      } else {
        const T* src = static_cast<const T*>(p.q) + ((long long)(b * p.Hq + h) * p.nq) * p.D;
        const int r = tid >> 3, cv = (tid & 7) * 8;
        const bool ok = q0 + r < p.nq;
        cp_async16(dst + r * LDC + cv, ok ? src + (long long)(q0 + r) * p.D + (c - 1) * CH + cv : src,
                   ok);
      }
    }
    cp_async_commit();
  };
  auto begin = [&](int gi) -> const T* {
    issue(gi + NST - 1);
    cp_async_wait<NST - 1>();
    __syncthreads();
    return ring + (gi % NST) * (CH * LDC);
  };

  float o[NVMAX][N8][4];
#pragma unroll
  for (int vc = 0; vc < NVMAX; ++vc)
#pragma unroll
    for (int n = 0; n < N8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[vc][n][e] = 0.f;

#pragma unroll
  for (int gi = 0; gi < NST - 1; ++gi) issue(gi);
  for (int t = 0; t < ntiles; ++t) {
    const int gt = t * per_tile;
    // This warp's 16 dS^T rows (KV) x 64 k (Q) as A fragments: the slab
    // tile is [q][kv], so ldmatrix.trans of its [k][m] 8 x 8 blocks.
    uint32_t af[QB / 16][4];
    {
      const T* ch = begin(gt);
#pragma unroll
      for (int kk = 0; kk < QB / 16; ++kk)
        ldsm_x4_trans(af[kk], ch + (kk * 16 + L.bn_row) * LDC + rt * 16 + L.bn_col);
      __syncthreads();
    }
#pragma unroll
    for (int vc = 0; vc < NVMAX; ++vc) {
      if (vc < nD) {
        const T* ch = begin(gt + 1 + vc);
#pragma unroll
        for (int kk = 0; kk < QB / 16; ++kk) {
          if (N8 == 2) {
            uint32_t bf[4];
            ldsm_x4_trans(bf, ch + (kk * 16 + L.bt_row) * LDC + wc * CW + L.bt_col);
            mma16816<T>(o[vc][0], af[kk], bf[0], bf[1]);
            mma16816<T>(o[vc][N8 - 1], af[kk], bf[2], bf[3]);
          } else {
            uint32_t bf[2];
            ldsm_x2_trans(bf, ch + (kk * 16 + L.bt_row) * LDC + wc * CW);
            mma16816<T>(o[vc][0], af[kk], bf[0], bf[1]);
          }
        }
        __syncthreads();
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kv = kv0 + rt * 16 + g + 8 * hh;
    if (kv >= p.nkv) continue;
    const long long base = ((long long)(b * p.Hkv + kvh) * p.nkv + kv) * p.D;
#pragma unroll
    for (int vc = 0; vc < NVMAX; ++vc) {
      if (vc < nD) {
#pragma unroll
        for (int n = 0; n < N8; ++n) {
          const int col = vc * CH + wc * CW + n * 8 + 2 * t4;
          store2<T>(p.dk, base + col, o[vc][n][2 * hh] * p.scale, o[vc][n][2 * hh + 1] * p.scale,
                    p.out_f32);
        }
      }
    }
  }
}

template <typename K>
cudaError_t launch(K kern, dim3 grid, size_t smem, const BwdParams& p, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (grid.x * grid.y * grid.z == 0) return cudaSuccess;
  kern<<<grid, NTHR, smem, stream>>>(p);
  return cudaGetLastError();
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const float* bias, long long sb,
                      long long sh, long long sr, long long sc, const float* alibi, int Hq,
                      int Hkv, int nq, int nkv, int D, int Dv, float scale, float softcap,
                      int causal_offset, int window_left, int window_right, float dropout_p,
                      float dropout_inv, unsigned seed, int row_offset, int col_offset) {
  BwdParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.bias = bias;
  p.sb = sb;
  p.sh = sh;
  p.sr = sr;
  p.sc = sc;
  p.alibi = alibi;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.group = Hq / Hkv;
  p.nq = nq;
  p.nkv = nkv;
  p.D = D;
  p.Dv = Dv;
  p.col_passes = 1;
  p.scale = scale;
  p.softcap = softcap;
  p.causal_offset = causal_offset;
  p.window_left = window_left;
  p.window_right = window_right;
  p.dropout_p = dropout_p;
  p.dropout_inv = dropout_inv;
  p.seed = seed;
  p.row_offset = row_offset;
  p.col_offset = col_offset;
  return p;
}

}  // namespace

extern "C" int ffpa_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dk, void* dv, void* ds,
                             const float* bias, long long sb, long long sh, long long sr,
                             long long sc, const float* alibi, int is_fp16, int out_f32, int B,
                             int Hq, int Hkv, int nq, int nkv, int D, int Dv, int col_passes,
                             int ds_rows, int ds_ld, float scale, float softcap,
                             int causal_offset, int window_left, int window_right,
                             float dropout_p, float dropout_inv, unsigned seed, int row_offset,
                             int col_offset, void* stream) {
  BwdParams p = make_params(q, k, v, dout, lse, delta, bias, sb, sh, sr, sc, alibi, Hq, Hkv, nq,
                            nkv, D, Dv, scale, softcap, causal_offset, window_left, window_right,
                            dropout_p, dropout_inv, seed, row_offset, col_offset);
  p.dk = dk;
  p.dv = dv;
  p.ds = ds;
  p.ds_rows = ds_rows;
  p.ds_ld = ds_ld;
  p.col_passes = col_passes;
  p.out_f32 = out_f32;
  // Every pass owns at most MAXC chunks of dK and of dV; the slab's tiles
  // are QT x KVT.
  if (D % CH != 0 || Dv % CH != 0 || col_passes < 1 ||
      (D / CH + col_passes - 1) / col_passes > MAXC || (Dv / CH + col_passes - 1) / col_passes > MAXC ||
      (ds != nullptr && (ds_ld % KVT != 0 || ds_rows % QT != 0)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv * col_passes, B, (nkv + KVT - 1) / KVT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_fp16)
    return (int)launch(dkdv_kernel<__half>, grid, dkdv_smem_bytes<__half>(D, Dv), p, st);
  return (int)launch(dkdv_kernel<__nv_bfloat16>, grid, dkdv_smem_bytes<__nv_bfloat16>(D, Dv), p, st);
}

extern "C" int ffpa_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dq, float* dbias,
                           const float* bias, long long sb, long long sh, long long sr,
                           long long sc, const float* alibi, int is_fp16, int out_f32,
                           int block_q, int B, int Hq, int Hkv, int nq, int nkv, int D, int Dv,
                           int ds_rows, int ds_ld, float scale, float softcap, int causal_offset,
                           int window_left, int window_right, float dropout_p, float dropout_inv,
                           unsigned seed, void* stream) {
  BwdParams p = make_params(q, k, v, dout, lse, delta, bias, sb, sh, sr, sc, alibi, Hq, Hkv, nq,
                            nkv, D, Dv, scale, softcap, causal_offset, window_left, window_right,
                            dropout_p, dropout_inv, seed, 0, 0);
  p.dq = dq;
  p.dbias = dbias;
  p.ds_rows = ds_rows;
  p.ds_ld = ds_ld;
  p.out_f32 = out_f32;
  // Registers hold block_q x D fp32 (64 per thread); D and Dv are 64-multiples.
  if (D % CH != 0 || Dv % CH != 0 || (long long)block_q * D > 32 * 1024 ||
      (block_q != 64 && block_q != 32) ||
      (dbias != nullptr && (ds_ld % CH != 0 || ds_rows % block_q != 0)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hq, B, (nq + block_q - 1) / block_q);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    return (int)(block_q == 64
                     ? launch(dq_kernel<__half, 64>, grid, dq_smem_bytes<__half>(64, D, Dv), p, st)
                     : launch(dq_kernel<__half, 32>, grid, dq_smem_bytes<__half>(32, D, Dv), p, st));
  }
  return (int)(block_q == 64 ? launch(dq_kernel<__nv_bfloat16, 64>, grid,
                                      dq_smem_bytes<__nv_bfloat16>(64, D, Dv), p, st)
                             : launch(dq_kernel<__nv_bfloat16, 32>, grid,
                                      dq_smem_bytes<__nv_bfloat16>(32, D, Dv), p, st));
}

// S-resident dK/dV (bf16): the slab holds S on entry and dS on return.
// kv_tile 64 takes dK out of kernel (Dv <= 512); kv_tile 32 takes dV up to
// 1024 columns, or dK and dV up to 512 each with dk_in_kernel.
extern "C" int ffpa_bwd_dkdv_from_s(const void* q, const void* v, const void* dout,
                                    const float* lse, const float* delta, void* slab, void* dk,
                                    void* dv, int dk_in_kernel, int kv_tile, int out_f32, int B,
                                    int Hq, int Hkv, int nq, int nkv, int D, int Dv,
                                    int ds_rows, int ds_ld, float scale, float softcap,
                                    int causal_offset, int window_right, float dropout_p,
                                    float dropout_inv, unsigned seed, void* stream) {
  BwdParams p = make_params(q, nullptr, v, dout, lse, delta, nullptr, 0, 0, 0, 0, nullptr, Hq,
                            Hkv, nq, nkv, D, Dv, scale, softcap, causal_offset, -1, window_right,
                            dropout_p, dropout_inv, seed, 0, 0);
  p.ds = slab;
  p.dk = dk;
  p.dv = dv;
  p.ds_rows = ds_rows;
  p.ds_ld = ds_ld;
  p.out_f32 = out_f32;
  const bool dk_in = dk_in_kernel != 0;
  if (D % CH != 0 || Dv % CH != 0 || ds_ld % kv_tile != 0 || ds_rows < nq || ds_ld < nkv ||
      (kv_tile != 32 && kv_tile != 64) || (dk_in && (kv_tile != 32 || D > 512 || Dv > 512)) ||
      (kv_tile == 64 && Dv > 512) || Dv > 1024)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv, B, ds_ld / kv_tile);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dk_in) return (int)launch(dkdv_from_s_kernel<32, true>, grid, from_s_smem_bytes<32>(Dv), p, st);
  if (kv_tile == 64)
    return (int)launch(dkdv_from_s_kernel<64, false>, grid, from_s_smem_bytes<64>(Dv), p, st);
  return (int)launch(dkdv_from_s_kernel<32, false>, grid, from_s_smem_bytes<32>(Dv), p, st);
}

// Causal dK = scale * dS^T Q from the slab (bf16); kv_tile 64 up to D 512,
// 32 up to 1024.
extern "C" int ffpa_bwd_banded_dk(const void* ds, const void* q, void* dk, int out_f32,
                                  int kv_tile, int B, int Hq, int Hkv, int nq, int nkv, int D,
                                  int ds_rows, int ds_ld, float scale, int causal_offset,
                                  void* stream) {
  BwdParams p = {};
  p.ds = const_cast<void*>(ds);
  p.q = q;
  p.dk = dk;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.group = Hq / Hkv;
  p.nq = nq;
  p.nkv = nkv;
  p.D = D;
  p.ds_rows = ds_rows;
  p.ds_ld = ds_ld;
  p.out_f32 = out_f32;
  p.scale = scale;
  p.causal_offset = causal_offset;
  if (D % CH != 0 || (long long)kv_tile * D > 32 * 1024 || (kv_tile != 64 && kv_tile != 32) ||
      ds_rows < nq || ds_ld < nkv || ds_ld % kv_tile != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv, B, (nkv + kv_tile - 1) / kv_tile);
  const size_t smem = (size_t)NST * CH * LDC * sizeof(__nv_bfloat16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(kv_tile == 64 ? launch(banded_dk_kernel<64>, grid, smem, p, st)
                             : launch(banded_dk_kernel<32>, grid, smem, p, st));
}

extern "C" int ffpa_bwd_banded_dq(const void* ds, const void* k, void* dq, int is_fp16,
                                  int out_f32, int block_q, int B, int Hq, int Hkv, int nq,
                                  int nkv, int D, int ds_rows, int ds_ld, float scale,
                                  int causal_offset, void* stream) {
  BwdParams p = {};
  p.ds = const_cast<void*>(ds);
  p.k = k;
  p.dq = dq;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.group = Hq / Hkv;
  p.nq = nq;
  p.nkv = nkv;
  p.D = D;
  p.ds_rows = ds_rows;
  p.ds_ld = ds_ld;
  p.out_f32 = out_f32;
  p.scale = scale;
  p.causal_offset = causal_offset;
  if (D % CH != 0 || (long long)block_q * D > 32 * 1024 || (block_q != 64 && block_q != 32) ||
      ds_rows % block_q != 0 || ds_rows < nq || ds_ld % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hq, B, (nq + block_q - 1) / block_q);
  const size_t smem = (size_t)NST * CH * LDC * (is_fp16 ? sizeof(__half) : sizeof(__nv_bfloat16));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    return (int)(block_q == 64 ? launch(banded_dq_kernel<__half, 64>, grid, smem, p, st)
                               : launch(banded_dq_kernel<__half, 32>, grid, smem, p, st));
  }
  return (int)(block_q == 64 ? launch(banded_dq_kernel<__nv_bfloat16, 64>, grid, smem, p, st)
                             : launch(banded_dq_kernel<__nv_bfloat16, 32>, grid, smem, p, st));
}
