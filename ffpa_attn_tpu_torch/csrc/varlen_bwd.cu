// Packed (THD) varlen backward attention for Hopper (sm_90a): the
// counterparts of the Pallas _varlen_dkdv_kernel and _varlen_dq_kernel
// (ffpa_attn_tpu/ops/varlen.py). ops/varlen.py calls the C entry points
// ffpa_varlen_bwd_dkdv and ffpa_varlen_bwd_dq through ctypes.
//
// Both are the dense backward's blocks (flash_bwd.cu, tiles and products in
// bwd_tiles.cuh) with two changes:
//   * the causal / window band test becomes the segment / rank keep-mask of
//     the forward (varlen_fwd.cu),
//       (q_seg == k_seg) & (k_pos <= q_rank [+ wr]) [& k_pos >= q_rank - wl],
//     read from the per-token metadata in device memory; masked elements
//     get P = 0 and dS = 0 exactly, so rows with no key (padding, rows past
//     Tq, an empty interval's [0, 0] tile) add nothing;
//   * the tile range of each block is an interval read from device memory,
//     computed on the device at this kernel's own tiles (ops/varlen.py
//     _varlen_bwd_schedules): for dK/dV a KV tile's [imin, imax] of 128-row
//     Q tiles, for dQ a Q tile's [jmin, jmax] of 64-row KV tiles.
// q, dO [T, Hq, D|Dv] and k, v [T, Hkv, D|Dv] are read through their row
// and head strides (no head-major copy, no padding of T); dq, dk and dv are
// written packed, the ragged tails bounds-checked. lse and delta are [Hq, Tq]
// fp32 (delta = rowsum(dO * O), the sink-inclusive O where there are sinks).
//
// dK/dV: a block owns 32 KV rows of one KV head with K and V resident and
// walks, for every q-head of its GQA group, the 128-row Q tiles of its
// interval: S^T = K Q^T over the Q chunks, P^T to shared memory, dP^T = V dO^T
// and dV += P^T dO over one stream of dO chunks, dS^T to shared memory, dK +=
// dS^T Q over the Q chunks again. The group is reduced in fp32 in the
// block's registers and dK, dV are stored once each (the TPU kernel writes a
// per-q-head dK/dV in the input type and sums the group afterwards). Above
// 512 columns of dK or dV, col_passes blocks split the columns, each
// recomputing S and dP.
//
// dQ: a block owns BQ packed query rows of one head with Q and dO resident
// and walks the KV tiles of its interval: S over the K chunks, dP over the V
// chunks, dS to shared memory, dQ += dS K over the K chunks again, the fp32
// dQ tile in registers like the forward's O tile.
//
// Bound on an H100: operations (4 matmul units of 2 * pairs * D flop for
// dK/dV, 3 for dQ, over the segments' bands; utils/profiling.py
// varlen_backward_counts). The design against it is the dense backward's,
// walking only the intervals' tiles.
#include "bwd_tiles.cuh"

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
  const int* lo;       // [tiles] first tile of each block's interval
  const int* hi;       // last tile
  const float* alibi;  // [Hq] slopes, or null
  int Hq, Hkv, group, tq, tk, D, Dv, col_passes;
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

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------

// Dynamic shared memory of one dK/dV block; ops/config.py
// varlen_dkdv_smem_bytes is the same formula: the dense block's, plus the Q
// tile's segment ids and ranks and the KV tile's segment ids and positions.
template <typename T>
size_t dkdv_smem_bytes(int d, int dv) {
  return ((size_t)KVT * (d + 8) + (size_t)KVT * (dv + 8) + (size_t)NST * QT * LDC +
          2 * (size_t)KVT * LDP) * sizeof(T) + 2 * QT * sizeof(float) +
         2 * QT * sizeof(int) + 2 * KVT * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(NTHR, 1) varlen_dkdv_kernel(const VarlenBwdParams p) {
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
  T* Pt = ring + NST * QT * LDC;  // P transposed: [kv][q]
  T* dSt = Pt + KVT * LDP;        // dS (with the softcap factor) transposed
  float* lse_s = reinterpret_cast<float*>(dSt + KVT * LDP);
  float* delta_s = lse_s + QT;
  int* qseg_s = reinterpret_cast<int*>(delta_s + QT);
  int* qrank_s = qseg_s + QT;
  int* kseg_s = qrank_s + QT;
  int* kpos_s = kseg_s + KVT;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rt = warp / WC, wc = warp % WC;
  const Lanes L(lane);
  const int kvh = blockIdx.x / p.col_passes, pass = blockIdx.x % p.col_passes;
  const int kv0 = blockIdx.y * KVT;
  const int nD = p.D / CH, nV = p.Dv / CH;
  const int d_lo = pass * nD / p.col_passes, ndo = (pass + 1) * nD / p.col_passes - d_lo;
  const int v_lo = pass * nV / p.col_passes, nvo = (pass + 1) * nV / p.col_passes - v_lo;

  // Q tiles of the interval, [i_lo, i_lo + ni) of every group member; an
  // empty interval is [0, 0]: one fully masked tile.
  const int i_lo = p.lo[blockIdx.y];
  const int ni = p.hi[blockIdx.y] - i_lo + 1;
  const int ntiles = p.group * ni;

  const T* kb = static_cast<const T*>(p.k) + (long long)kvh * p.k_hs;
  const T* vb = static_cast<const T*>(p.v) + (long long)kvh * p.v_hs;

  // Resident K and V: rows past Tk are zero-filled.
  for (int i = tid; i < KVT * (p.D / 8); i += NTHR) {
    const int r = i / (p.D / 8), c = (i % (p.D / 8)) * 8;
    const bool ok = kv0 + r < p.tk;
    cp_async16(Ks + r * LDK + c, ok ? kb + (long long)(kv0 + r) * p.k_rs + c : kb, ok);
  }
  for (int i = tid; i < KVT * (p.Dv / 8); i += NTHR) {
    const int r = i / (p.Dv / 8), c = (i % (p.Dv / 8)) * 8;
    const bool ok = kv0 + r < p.tk;
    cp_async16(Vs + r * LDV + c, ok ? vb + (long long)(kv0 + r) * p.v_rs + c : vb, ok);
  }
  cp_async_commit();
  if (tid < KVT) {
    kseg_s[tid] = p.k_seg[kv0 + tid];
    kpos_s[tid] = p.k_pos[kv0 + tid];
  }

  // Chunk gi of the stream: per Q tile, the nD Q chunks (S), the nV dO
  // chunks, this block's own dV columns first (dP and dV), then this
  // block's ndo Q chunks again (dK); 128 rows x 64 columns, rows past Tq
  // zero-filled.
  const int per_tile = nD + nV + ndo;
  const int total = ntiles * per_tile;
  auto issue = [&](int gi) {
    if (gi < total) {
      const int t = gi / per_tile, c = gi - t * per_tile;
      const int h = kvh * p.group + t / ni, q0 = (i_lo + t % ni) * QT;
      const T* src;
      long long rs;
      int c0;
      if (c < nD) {
        src = static_cast<const T*>(p.q) + (long long)h * p.q_hs;
        rs = p.q_rs;
        c0 = c;
      } else if (c < nD + nV) {
        const int vc = c - nD;  // own chunks first, then the others in order
        src = static_cast<const T*>(p.dout) + (long long)h * p.do_hs;
        rs = p.do_rs;
        c0 = vc < nvo ? v_lo + vc : (vc - nvo < v_lo ? vc - nvo : vc);
      } else {
        src = static_cast<const T*>(p.q) + (long long)h * p.q_hs;
        rs = p.q_rs;
        c0 = d_lo + c - nD - nV;
      }
      T* dst = ring + (gi % NST) * (QT * LDC);
#pragma unroll
      for (int half = 0; half < QT / 64; ++half) {  // two 16-byte vectors per thread
        const int r = (tid >> 3) + 64 * half, cv = (tid & 7) * 8;
        const bool ok = q0 + r < p.tq;
        cp_async16(dst + r * LDC + cv, ok ? src + (long long)(q0 + r) * rs + c0 * CH + cv : src,
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
    const float slope = p.alibi != nullptr ? p.alibi[h] : 0.f;
    __syncthreads();  // the previous tile's readers of the row arrays are done
    if (tid < QT) {
      const long long idx = (long long)h * p.tq + q0 + tid;
      const bool ok = q0 + tid < p.tq;
      lse_s[tid] = ok ? p.lse[idx] : 0.f;
      delta_s[tid] = ok ? p.delta[idx] : 0.f;
      qseg_s[tid] = p.q_seg[q0 + tid];
      qrank_s[tid] = p.q_rank[q0 + tid];
    }

    // S^T = K Q^T: this warp's 16 KV rows x 16 Q columns.
    float st[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int c = 0; c < nD; ++c) {
      const T* ch = begin(gt + c);
      mma_abt<T, 2>(st, Krow + c * CH, LDK, ch + (wc * CQ) * LDC, L, lane);
      __syncthreads();  // the slot read here is refilled by a later issue
    }

    // P to shared memory, transposed; p times the softcap factor stays in
    // registers for dS.
    float pc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kvl = kv_loc + ((e >> 1) << 3), ql = wc * CQ + n * 8 + 2 * t4 + (e & 1);
        const int qr = qrank_s[ql], kp = kpos_s[kvl];
        const Prob pr = score_prob(p, keeps(p, qseg_s[ql], qr, kseg_s[kvl], kp), st[n][e],
                                   lse_s[ql], slope, qr - kp);
        pc[n][e] = pr.p * pr.cap;
        st[n][e] = pr.p;
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
        dsv[e] = pc[n][e] * (dpt[n][e] - delta_s[ql]);
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(dSt + (kv_loc + 8 * hh) * LDP + wc * CQ + n * 8 + 2 * t4) =
            pack2<T>(dsv[2 * hh], dsv[2 * hh + 1]);
    }

    // dK += dS^T Q over this block's own Q chunks; this warp's dS^T rows
    // stay in registers as A fragments across the chunks.
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

  // Epilogue: dK = scale * sum, dV, packed [Tk, Hkv, D]; rows past Tk are
  // not stored.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kv = kv0 + kv_loc + 8 * hh;
    if (kv >= p.tk) continue;
    const long long rk = ((long long)kv * p.Hkv + kvh) * p.D;
    const long long rv = ((long long)kv * p.Hkv + kvh) * p.Dv;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      const int col = wc * CW + 2 * t4;
      if (c < ndo)
        store2<T>(p.dk, rk + (d_lo + c) * CH + col, dk_acc[c][0][2 * hh] * p.scale,
                  dk_acc[c][0][2 * hh + 1] * p.scale, 0);
      if (c < nvo)
        store2<T>(p.dv, rv + (v_lo + c) * CH + col, dv_acc[c][0][2 * hh],
                  dv_acc[c][0][2 * hh + 1], 0);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

// ops/config.py varlen_dq_smem_bytes is the same formula: the dense dQ
// block's, plus the row tile's segment ids and ranks.
template <typename T>
size_t dq_smem_bytes(int bq, int d, int dv) {
  return ((size_t)bq * (d + 8) + (size_t)bq * (dv + 8) + (size_t)NST * CH * LDC +
          (size_t)bq * LDC) * sizeof(T) + 2 * (size_t)bq * sizeof(float) +
         2 * (size_t)bq * sizeof(int);
}

template <typename T, int BQ>
__global__ void __launch_bounds__(NTHR, 1) varlen_dq_kernel(const VarlenBwdParams p) {
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
  int* qseg_s = reinterpret_cast<int*>(delta_s + BQ);
  int* qrank_s = qseg_s + BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rt = warp / WC, wc = warp % WC;
  const Lanes L(lane);
  const int head = blockIdx.x, tile = blockIdx.y, kvh = head / p.group;
  const int row0 = tile * BQ;
  const int kv_lo = p.lo[tile] * CH;
  const int ntiles = p.hi[tile] - p.lo[tile] + 1;  // an empty interval is [0, 0]
  const int nD = p.D / CH, nV = p.Dv / CH;

  const T* qb = static_cast<const T*>(p.q) + (long long)head * p.q_hs;
  const T* ob = static_cast<const T*>(p.dout) + (long long)head * p.do_hs;
  const T* kb = static_cast<const T*>(p.k) + (long long)kvh * p.k_hs;
  const T* vb = static_cast<const T*>(p.v) + (long long)kvh * p.v_hs;
  const float slope = p.alibi != nullptr ? p.alibi[head] : 0.f;

  // Resident Q and dO: rows past Tq zero-filled.
  for (int i = tid; i < BQ * (p.D / 8); i += NTHR) {
    const int r = i / (p.D / 8), c = (i % (p.D / 8)) * 8;
    const bool ok = row0 + r < p.tq;
    cp_async16(Qs + r * LDQ + c, ok ? qb + (long long)(row0 + r) * p.q_rs + c : qb, ok);
  }
  for (int i = tid; i < BQ * (p.Dv / 8); i += NTHR) {
    const int r = i / (p.Dv / 8), c = (i % (p.Dv / 8)) * 8;
    const bool ok = row0 + r < p.tq;
    cp_async16(dOs + r * LDO + c, ok ? ob + (long long)(row0 + r) * p.do_rs + c : ob, ok);
  }
  cp_async_commit();
  for (int i = tid; i < BQ; i += NTHR) {
    const bool ok = row0 + i < p.tq;
    lse_s[i] = ok ? p.lse[(long long)head * p.tq + row0 + i] : 0.f;
    delta_s[i] = ok ? p.delta[(long long)head * p.tq + row0 + i] : 0.f;
    qseg_s[i] = p.q_seg[row0 + i];
    qrank_s[i] = p.q_rank[row0 + i];
  }

  // Chunk gi of the stream: per KV tile, the nD K chunks (S), the nV V
  // chunks (dP), the nD K chunks again (dQ); rows past Tk zero-filled.
  const int per_tile = 2 * nD + nV;
  const int total = ntiles * per_tile;
  auto issue = [&](int gi) {
    if (gi < total) {
      const int t = gi / per_tile, c = gi - t * per_tile;
      const int kv0 = kv_lo + t * CH;
      const bool is_v = c >= nD && c < nD + nV;
      const T* src = is_v ? vb : kb;
      const long long rs = is_v ? p.v_rs : p.k_rs;
      const int c0 = c < nD ? c : (is_v ? c - nD : c - nD - nV);
      T* dst = ring + (gi % NST) * (CH * LDC);
      const int r = tid >> 3, cv = (tid & 7) * 8;
      const bool ok = kv0 + r < p.tk;
      cp_async16(dst + r * LDC + cv, ok ? src + (long long)(kv0 + r) * rs + c0 * CH + cv : src, ok);
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

    // dS (with the softcap factor) to shared memory. Every column of a tile
    // lies below ceil(Tk / 64) * 64, the key metadata's length.
#pragma unroll
    for (int n = 0; n < N8; ++n) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rl = rt * 16 + g + 8 * hh, cl = wc * CW + n * 8 + 2 * t4;
        const int qs = qseg_s[rl], qr = qrank_s[rl];
        float ds[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kp = __ldg(p.k_pos + kv0 + cl + j);
          const bool keep = keeps(p, qs, qr, __ldg(p.k_seg + kv0 + cl + j), kp);
          const Prob pr = score_prob(p, keep, s_acc[n][2 * hh + j], lse_s[rl], slope, qr - kp);
          ds[j] = pr.p * (dp_acc[n][2 * hh + j] - delta_s[rl]) * pr.cap;
        }
        *reinterpret_cast<uint32_t*>(dSs + rl * LDC + cl) = pack2<T>(ds[0], ds[1]);
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

  // Epilogue: dQ = scale * sum, packed [Tq, Hq, D].
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + rt * 16 + g + 8 * hh;
    if (row >= p.tq) continue;
    const long long base = ((long long)row * p.Hq + head) * p.D;
#pragma unroll
    for (int vc = 0; vc < NVMAX; ++vc) {
      if (vc < nD) {
#pragma unroll
        for (int n = 0; n < N8; ++n) {
          const int col = vc * CH + wc * CW + n * 8 + 2 * t4;
          store2<T>(p.dq, base + col, o[vc][n][2 * hh] * p.scale, o[vc][n][2 * hh + 1] * p.scale,
                    0);
        }
      }
    }
  }
}

template <typename K>
cudaError_t launch(K kern, dim3 grid, size_t smem, const VarlenBwdParams& p, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (grid.x * grid.y == 0) return cudaSuccess;
  kern<<<grid, NTHR, smem, stream>>>(p);
  return cudaGetLastError();
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

}  // namespace

// dK, dV [Tk, Hkv, D|Dv] in the input type, the GQA group reduced. One block
// per (KV head, column pass) and 32-row KV tile: num_kv_tiles = ceil(Tk / 32);
// lo / hi hold each KV tile's interval of 128-row Q tiles.
extern "C" int ffpa_varlen_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                                    long long q_rs, long long q_hs, long long k_rs,
                                    long long k_hs, long long v_rs, long long v_hs,
                                    long long do_rs, long long do_hs, const float* lse,
                                    const float* delta, void* dk, void* dv, const int* q_seg,
                                    const int* q_rank, const int* k_seg, const int* k_pos,
                                    const int* imin, const int* imax, const float* alibi,
                                    int is_fp16, int Hq, int Hkv, int tq, int tk,
                                    int num_kv_tiles, int D, int Dv, int col_passes, float scale,
                                    float softcap, int window_left, int window_right,
                                    void* stream) {
  VarlenBwdParams p = make_params(q, k, v, dout, q_rs, q_hs, k_rs, k_hs, v_rs, v_hs, do_rs,
                                  do_hs, lse, delta, q_seg, q_rank, k_seg, k_pos, imin, imax,
                                  alibi, Hq, Hkv, tq, tk, D, Dv, scale, softcap, window_left,
                                  window_right);
  p.dk = dk;
  p.dv = dv;
  p.col_passes = col_passes;
  // Every pass owns at most MAXC chunks of dK and of dV.
  if (D % CH != 0 || Dv % CH != 0 || col_passes < 1 || Hkv < 1 || Hq % Hkv != 0 ||
      (D / CH + col_passes - 1) / col_passes > MAXC ||
      (Dv / CH + col_passes - 1) / col_passes > MAXC || num_kv_tiles * KVT < tk)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hkv * col_passes, num_kv_tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_fp16)
    return (int)launch(varlen_dkdv_kernel<__half>, grid, dkdv_smem_bytes<__half>(D, Dv), p, st);
  return (int)launch(varlen_dkdv_kernel<__nv_bfloat16>, grid,
                     dkdv_smem_bytes<__nv_bfloat16>(D, Dv), p, st);
}

// dQ [Tq, Hq, D] in the input type. One block per (head, block_q-row Q tile):
// num_q_tiles = ceil(Tq / block_q); lo / hi hold each Q tile's interval of
// 64-row KV tiles.
extern "C" int ffpa_varlen_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                  long long q_rs, long long q_hs, long long k_rs, long long k_hs,
                                  long long v_rs, long long v_hs, long long do_rs,
                                  long long do_hs, const float* lse, const float* delta, void* dq,
                                  const int* q_seg, const int* q_rank, const int* k_seg,
                                  const int* k_pos, const int* jmin, const int* jmax,
                                  const float* alibi, int is_fp16, int block_q, int Hq, int Hkv,
                                  int tq, int tk, int num_q_tiles, int D, int Dv, float scale,
                                  float softcap, int window_left, int window_right,
                                  void* stream) {
  VarlenBwdParams p = make_params(q, k, v, dout, q_rs, q_hs, k_rs, k_hs, v_rs, v_hs, do_rs,
                                  do_hs, lse, delta, q_seg, q_rank, k_seg, k_pos, jmin, jmax,
                                  alibi, Hq, Hkv, tq, tk, D, Dv, scale, softcap, window_left,
                                  window_right);
  p.dq = dq;
  // Registers hold block_q x D fp32 (64 per thread); D and Dv are 64-multiples.
  if (D % CH != 0 || Dv % CH != 0 || (long long)block_q * D > 32 * 1024 ||
      (block_q != 64 && block_q != 32) || Hkv < 1 || Hq % Hkv != 0 ||
      num_q_tiles * block_q < tq)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Hq, num_q_tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_fp16) {
    return (int)(block_q == 64
                     ? launch(varlen_dq_kernel<__half, 64>, grid, dq_smem_bytes<__half>(64, D, Dv),
                              p, st)
                     : launch(varlen_dq_kernel<__half, 32>, grid, dq_smem_bytes<__half>(32, D, Dv),
                              p, st));
  }
  return (int)(block_q == 64 ? launch(varlen_dq_kernel<__nv_bfloat16, 64>, grid,
                                      dq_smem_bytes<__nv_bfloat16>(64, D, Dv), p, st)
                             : launch(varlen_dq_kernel<__nv_bfloat16, 32>, grid,
                                      dq_smem_bytes<__nv_bfloat16>(32, D, Dv), p, st));
}
