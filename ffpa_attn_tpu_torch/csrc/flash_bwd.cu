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
// dK/dV runs on TMA and wgmma (namespace dkdv, details beside it) on two
// routes, by head dims alone (dkdv::make_plan): one block at D, Dv <= 512,
// a thread-block cluster of two that splits D and Dv above, up to 1024.
// The recompute dQ does too (namespace dq, dq::make_plan's route), and so
// does from-S with dK out of the kernel (namespace from_s, the route
// from_s::make_plan's): one block at Dv <= 512, a cluster of two that
// splits Dv above, up to 1024. From-S with dK in the kernel is built from
// the mma.sync pieces of bwd_tiles.cuh: 16 warps, mma.sync m16n8k16 (bf16
// or f16 in, fp32 accumulate) fed by ldmatrix, a block's owned tile
// resident in shared memory and the other operand streamed in 64 x 64
// chunks through a 4-slot cp.async ring, fp32 accumulators split over the
// warps' registers by rows and columns.
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
// sequential grid axis; here: a loop inside the block). A block (or a
// cluster) owns 64 KV rows of one KV head with K and V resident and walks
// the group's 64-row Q tiles; dK and dV come out group-reduced with one
// store each and no atomics. Two 64 x 256 fp32 accumulators take the 128
// registers a consumer thread has for them, so wider heads split the dK /
// dV columns over passes, each recomputing S and dP (the reference's SM90
// D512 D-split); above D512 the cluster's ranks split D and Dv and add
// their partial S^T and dP^T through distributed shared memory. The
// mma.sync block that held D or Dv > 512 before (32 KV rows, 128-row Q
// tiles, 512-column passes) is gone; varlen_bwd.cu keeps its own.
//
// dQ (recompute tier): a block (or a cluster) owns 64 query rows of one
// head with Q and dO resident and walks the KV tiles of its band: S and dP
// over the K and V boxes, dS exchanged between its consumers (and fp32 dS
// to the dbias slab), then dQ += dS K over the K boxes again; above D512
// the cluster's ranks split D and Dv and add their partial S and dP
// through distributed shared memory. The mma.sync block that held D or Dv
// > 512 before (32 or 64 rows, its fp32 dQ tile over 16 warps' registers)
// is gone; varlen_bwd.cu keeps its own.
//
// From-S dK/dV (S-resident tier, bf16 only): below, beside its two kernels.
//
// Banded dQ (dS-handoff and S-resident tiers) and banded dK (S-resident,
// bf16): plain GEMMs over a causal k-range, redesigned for Hopper's TMA and
// wgmma (sm90.cuh) in place of the mma.sync kernels they replaced. Those
// walked 64 x 512 panels through the 4-slot cp.async ring, two
// __syncthreads and 8 mma.sync a warp per 64 x 64 chunk, ~58 flop per byte
// from L2 (training shape: 2.15 ms and 2.86 ms against a 0.278 ms bound).
// Now a block owns 128 rows x at most 256 columns, a producer warpgroup
// keeps a 4-stage ring of 48 KB TMA stages full and two consumer
// warpgroups run wgmma.m64n256k16 on it: ~87 flop per byte from L2, no
// block barrier in the loop. Details beside the kernels.
//
// Bound on an H100: operations (4 matmul units of 2 * pairs * D flop for
// dK/dV, 3 for dQ, 1 for banded dQ and banded dK, 2 or 3 for from-S dK/dV;
// see utils/profiling.py).
#include <string.h>

#include <algorithm>
#include <type_traits>

#include <cuda_fp8.h>

#include "bwd_tiles.cuh"
#include "rng.cuh"
#include "sm90.cuh"

namespace {

using namespace ffpa;

// Whether a ring cap is one the entry points take: 0 (the plan's depth) or
// least..deepest, from the fewest stages the kernel's walk needs (a
// shallower ring deadlocks) up to the plan's.
inline bool ring_cap_ok(int ring_cap, int deepest, int least) {
  return ring_cap == 0 || (ring_cap >= least && ring_cap <= deepest);
}

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
  void* ds;            // dS slab [B, Hq, ds_rows, ds_ld] (input type or e4m3), or null
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

// The e4m3 dS slab (BlockConfig ds_store_bits 8). Two fp32 values as two
// e4m3 in the low 16 bits, lo in the low byte: round to nearest even,
// saturated to +-448 past the range (cvt.rn.satfinite.e4m3x2.f32; NaN stays
// NaN). ops/flash_bwd.py quantize_e4m3 is the same rule.
__device__ __forceinline__ uint32_t e4m3x2(float lo, float hi) {
  return __nv_cvt_float2_to_fp8x2(make_float2(lo, hi), __NV_SATFINITE, __NV_E4M3);
}
// Two e4m3 (the low 16 bits of v, low byte first) as bf16x2, exactly: every
// e4m3 value is an f16 value and a bf16 value.
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint32_t v) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(v & 0xffffu), __NV_E4M3);
  const float2 f = __half22float2(__half2(h));
  const __nv_bfloat162 b = __float22bfloat162_rn(f);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// The KV range [kv_lo, kv_hi) rows row0..row_last see (the recompute dQ's
// band, namespace dq), kv_lo tile-aligned.
__device__ __forceinline__ void kv_band(const BwdParams& p, int row0, int row_last, int& kv_lo,
                                        int& kv_hi) {
  kv_lo = 0;
  kv_hi = p.nkv;
  if (p.window_right >= 0)
    kv_hi = min(p.nkv, row_last + p.causal_offset + p.window_right + 1);
  if (p.window_left >= 0) kv_lo = max(0, row0 + p.causal_offset - p.window_left);
  kv_lo = (kv_lo / CH) * CH;
}

// ---------------------------------------------------------------------------
// dK / dV from the forward's S residual (S-resident backward, bf16)
// ---------------------------------------------------------------------------

// Dynamic shared memory of one mma.sync from-S block; ops/config.py
// from_s_plan is the same formula. No K tile: S comes from the slab through
// the ring.
size_t from_s_smem_bytes(int dv) {
  return ((size_t)KVT * (dv + 8) + (size_t)NST * QT * LDC + 2 * (size_t)KVT * LDP) *
             sizeof(__nv_bfloat16) +
         2 * QT * sizeof(float);
}

// The mma.sync route of ffpa_bwd_dkdv_from_s: dK in the kernel (dK out of
// it takes the wgmma block of namespace from_s below, or its cluster of two
// above Dv 512). A block owns KV rows [kv0, kv0 + 32) of one KV
// head with V resident and walks the GQA group's 128-row Q tiles of the
// causal band. Per tile the ring brings the S tile (128 x 32 of the slab),
// then the dO chunks, then the Q chunks. P = exp(S - lse) is re-masked
// here (rows past Nq, columns past Nkv or above the causal diagonal give 0
// whatever the slab holds there), dP^T = V dO^T and dV += P^T dO share the
// dO stream, dS = P (dP - delta) (times the softcap factor 1 - (s/cap)^2
// read from S) overwrites the S tile in place, and dK += dS^T Q.
// Exactly one block owns each slab tile and reads it before it writes it,
// so the in-place update has no race. Q tiles the band skips get zeros, so
// every tile of the slab is defined for banded dQ / dK and dbias. 16 warps
// as 2 row tiles x 8: dK and dV up to 512 columns each, in 64 fp32
// registers a thread.
__global__ void __launch_bounds__(NTHR, 1) dkdv_from_s_kernel(const BwdParams p) {
  using T = __nv_bfloat16;
  constexpr int KV = KVT;
  constexpr int RT = KV / 16;    // 16-row tiles of the KV tile (2)
  constexpr int WC = NW / RT;    // warps per row tile (8)
  constexpr int CQ = QT / WC;    // Q columns of S^T / dP^T per warp (16)
  constexpr int NQ8 = CQ / 8;    // n8 tiles of them (2)
  constexpr int CW = CH / WC;    // dK / dV columns per chunk per warp (8)
  constexpr int NC8 = CW / 8;    // n8 tiles of them (1)
  constexpr int MAXV = ACC_PER_THREAD / (2 * 4 * NC8);  // dK and dV chunks held
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
  // of the slab; rows past the slab zero-filled), the nV dO chunks and the
  // nD Q chunks (128 x 64, rows past Nq zero-filled).
  const int per_tile = 1 + nV + nD;
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
  float dk_acc[MAXV][1][4];
#pragma unroll
  for (int c = 0; c < MAXV; ++c)
#pragma unroll
    for (int n = 0; n < NC8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv_acc[c][n][e] = 0.f;
#pragma unroll
  for (int c = 0; c < MAXV; ++c)
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

  // Epilogue: dV and dK = scale * sum; rows past Nkv are not stored.
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
        if (c < nD)
          store2<T>(p.dk, rk + col, dk_acc[c][0][2 * hh] * p.scale,
                    dk_acc[c][0][2 * hh + 1] * p.scale, p.out_f32);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Banded dQ and banded dK from the dS slab (causal): TMA + mbarrier + wgmma
// ---------------------------------------------------------------------------

// Both are one GEMM over a per-block k-range; the slab is zero above the
// band and on its padding, so nothing is masked. A block owns 128 output
// rows (Q rows for dQ, KV rows for dK) x one column block of D (at most
// 256 columns: 4 TMA boxes of 64) and runs 384 threads: warpgroup 0 is the
// producer (one thread issues TMA loads into a STAGES-deep ring of full /
// empty mbarriers), warpgroups 1 and 2 each own 64 of the rows and issue
// wgmma.m64nNk16 on the stage with an fp32 accumulator of N / 2 registers a
// thread (N = 64 x chunks of the column block).
//  - dQ = scale * dS K: A is the dS tile [128 q][64 kv] (K-major), B the K
//    tile [64 kv][N d] (N-major, the transpose-B bit). The k-range runs to
//    the panel's last row + causal_offset.
//  - dK = scale * dS^T Q: A is dS^T read from the [64 q][128 kv] slab tile
//    as two M-major boxes (the transpose-A bit, no register transpose), B
//    the Q tile [64 q][N d] (N-major). A block walks the GQA group's Q
//    tiles from the diagonal down and sums the group in the accumulator:
//    one store, no atomics.
// The tensor maps declare dS with extents (nkv, nq), Q with nq rows and K
// with nkv rows, so TMA zero-fills past them: padding of the slab is never
// read, a ragged last tile needs no mask.
//
// Banded dQ over an e4m3 slab (FP8, bf16 K; ds_store_bits 8 in
// ops/config.py): an e4m3 wgmma needs both operands e4m3 and K-major, and K
// is bf16 read N-major, so dS is widened to bf16 first. TMA loads the 1-byte
// dS tile (128 rows of 64 B, unswizzled) into an 8 KB box at the end of the
// stage; each consumer widens its 64 rows exactly (e4m3 -> f16 -> bf16) into
// the 128 B-swizzled bf16 A tile at the head of the stage, which the wgmma
// reads as it reads a 16-bit slab's tile, after a proxy fence and a barrier
// of its warpgroup. The stage is freed once its products completed, as
// always, so the widened tile is never overwritten under them. A stage is
// 8 KB larger (4 stages of 56 KB at D512, 230,464 B of the 232,448). The
// slab's stream halves (1 B an element); the widening costs each consumer
// thread two 16 B loads, 16 conversions and four 16 B stores a stage, under
// the previous stage's products.
namespace band {

using namespace ffpa::sm90;

constexpr int ROWS = 128;          // output rows of a block
constexpr int KT = 64;             // k-step: KV columns (dQ) or Q rows (dK)
constexpr int COLS = 64;           // D columns of one B box (128 B of 16-bit)
constexpr int MAX_CHUNKS = 4;      // boxes of a column block: N <= 256
constexpr int STAGES = 4;          // ring depth
constexpr int THREADS = 384;       // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMER_WARPS = 8;  // arrivals that free a stage
constexpr int A_BYTES = ROWS * KT * 2;      // the dS tile of a stage (16 KB)
constexpr int BOX_BYTES = KT * COLS * 2;    // one 64 x 64 box (8 KB)
constexpr int A8_BYTES = ROWS * KT;         // an e4m3 dS tile (8 KB), at the end of a stage

struct Params {
  CUtensorMap ds_map;  // dS: (nkv, nq, B * Hq); box 64 x 128 (dQ) or 64 x 64 (dK)
  CUtensorMap b_map;   // K: (D, nkv, B * Hkv) for dQ; Q: (D, nq, B * Hq) for dK
  void* out;           // dQ [B, Hq, nq, D] or dK [B, Hkv, nkv, D]
  int Hq, Hkv, group, nq, nkv, D;
  int chunks, col_blocks, stage_bytes, out_f32, causal_offset;
  float scale;
};

// The tiling of a launch at head dim D (a multiple of COLS): the column
// blocks, the bytes of a stage (the dS tile, the widest block's boxes and,
// over an e4m3 slab, its 1-byte tile) and the block's dynamic shared memory
// (the stages, their mbarriers and the 1024 B alignment of the swizzled
// stages). ffpa_bwd_banded_plan hands it out; ops/config.py banded_plan
// mirrors it and the card test holds the two equal.
struct Plan {
  int chunks, col_blocks, stage_bytes;
  size_t smem;
};
inline Plan make_plan(int D, bool fp8 = false) {
  Plan pl;
  pl.chunks = D / COLS;
  pl.col_blocks = (pl.chunks + MAX_CHUNKS - 1) / MAX_CHUNKS;
  pl.stage_bytes = A_BYTES + col_block(pl.chunks, pl.col_blocks, 0).nc * BOX_BYTES +
                   (fp8 ? A8_BYTES : 0);
  pl.smem = (size_t)STAGES * pl.stage_bytes + 2 * STAGES * sizeof(uint64_t) + 1024;
  return pl;
}

// The e4m3 dS tile's 64 rows of consumer cw widened to bf16 into its rows
// of the stage's 16-bit A tile (128 B swizzle, as TMA lays a 16-bit tile
// out), then a proxy fence and a barrier of the warpgroup: the wgmma reads
// them next. Thread tid takes rows tid / 4 and 32 + tid / 4, 16 columns
// each (a warp reads 512 B in a row, writes 16 B chunks of distinct banks).
__device__ __forceinline__ void widen_ds(unsigned char* st, int stage_bytes, int cw) {
  const unsigned char* a8 = st + stage_bytes - A8_BYTES + cw * (A8_BYTES / 2);
  unsigned char* a16 = st + cw * (A_BYTES / 2);
  const int tid = threadIdx.x & 127;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = (tid >> 2) + 32 * i, c = (tid & 3) * 16;
    const uint4 raw = *reinterpret_cast<const uint4*>(a8 + r * KT + c);
    const uint4 lo = make_uint4(e4m3x2_to_bf16x2(raw.x), e4m3x2_to_bf16x2(raw.x >> 16),
                                e4m3x2_to_bf16x2(raw.y), e4m3x2_to_bf16x2(raw.y >> 16));
    const uint4 hi = make_uint4(e4m3x2_to_bf16x2(raw.z), e4m3x2_to_bf16x2(raw.z >> 16),
                                e4m3x2_to_bf16x2(raw.w), e4m3x2_to_bf16x2(raw.w >> 16));
    *reinterpret_cast<uint4*>(a16 + swz(r, c)) = lo;
    *reinterpret_cast<uint4*>(a16 + swz(r, c + 8)) = hi;
  }
  fence_proxy_async();
  named_barrier_sync(1 + cw, 128);
}

// A consumer warpgroup's part: wait for each stage (over an e4m3 slab,
// widen its dS rows), 4 wgmma k16 steps on it, free the previous stage
// once its products completed (one group stays in flight), then scale and
// store its 64 rows x N columns.
template <typename T, int NC, bool DK, bool FP8>
__device__ __forceinline__ void consume(const Params& p, unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, int ntiles, int cw, int row0, int c0,
                                        long long out_rows, int row_limit) {
  constexpr int N = NC * COLS;
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  // Over an e4m3 slab the zeros are pinned before the walk: without the
  // fence ptxas serialized the products (C7515).
  if constexpr (FP8) fence_operands(acc);
  const int lane = threadIdx.x & 31;
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    unsigned char* st = smem + s * p.stage_bytes;
    if constexpr (FP8) widen_ds(st, p.stage_bytes, cw);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      // dQ: this warpgroup's 64 dS rows, K-major, 16 k = 32 B along the row.
      // dK: its 64-column dS box read M-major, 16 k = 16 rows of 128 B.
      const uint64_t a = DK ? desc_b128(st + cw * BOX_BYTES + kk * 2048, BOX_BYTES, 1024)
                            : desc_b128(st + cw * (A_BYTES / 2) + kk * 32, 16, 1024);
      const uint64_t b = desc_b128(st + A_BYTES + kk * 2048, BOX_BYTES, 1024);
      wgmma_ss<T, N, DK ? 1 : 0, 1>(acc, a, b);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (t > 0 && lane == 0) mbar_arrive(&empty[(t - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_operands(acc);
  const int w = (threadIdx.x >> 5) & 3, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + cw * 64 + w * 16 + g + 8 * hh;
    if (row >= row_limit) continue;
    const long long base = (out_rows + row) * p.D + c0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      store2<T>(p.out, base + 8 * j, acc[4 * j + 2 * hh] * p.scale,
                acc[4 * j + 2 * hh + 1] * p.scale, p.out_f32);
  }
}

template <typename T, bool DK, bool FP8 = false>
__global__ void __launch_bounds__(THREADS, 1) banded_kernel(const __grid_constant__ Params p) {
  static_assert(!FP8 || (!DK && std::is_same<T, __nv_bfloat16>::value),
                "an e4m3 slab is read by banded dQ with bf16 K");
  extern __shared__ unsigned char smem_raw[];
  // Stage buffers on 1024 B boundaries: the 128 B swizzle's atom.
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * p.stage_bytes);
  uint64_t* empty = full + STAGES;

  // Block order: the column blocks of a row panel side by side (they read
  // the same dS tiles), then the panels of one head, longest first (they
  // share its K or Q), then the heads: the blocks on the card at once touch
  // one or two heads' operands, which stay in L2.
  const int head = blockIdx.y;  // the Q head (dQ) or the KV head (dK)
  const int b = blockIdx.z;
  const Cols cols = col_block(p.chunks, p.col_blocks, blockIdx.x % p.col_blocks);
  const int panel = blockIdx.x / p.col_blocks, npanels = gridDim.x / p.col_blocks;
  int row0, ntiles, i_lo = 0, ni = 0;
  if constexpr (DK) {
    // KV rows row0.. see Q rows from row0 - causal_offset on: the first
    // panels walk the most Q tiles.
    row0 = panel * ROWS;
    i_lo = max(0, floordiv(row0 - p.causal_offset, KT));
    ni = max(0, (p.nq + KT - 1) / KT - i_lo);
    ntiles = p.group * ni;
  } else {
    // The last rows see the most KV columns.
    row0 = (npanels - 1 - panel) * ROWS;
    const int row_last = min(row0 + ROWS, p.nq) - 1;
    const int kv_hi = min(p.nkv, row_last + p.causal_offset + 1);
    ntiles = kv_hi > 0 ? (kv_hi + KT - 1) / KT : 0;
  }

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      prefetch_map(&p.ds_map);
      prefetch_map(&p.b_map);
      const uint32_t bytes = (FP8 ? A8_BYTES : A_BYTES) + cols.nc * BOX_BYTES;
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        unsigned char* st = smem + s * p.stage_bytes;
        mbar_arrive_expect_tx(&full[s], bytes);
        int k0, bh;
        if constexpr (DK) {
          const int h = head * p.group + t / ni;
          k0 = (i_lo + t % ni) * KT;  // Q rows
          bh = b * p.Hq + h;
          tma_load_3d(st, &p.ds_map, &full[s], row0, k0, bh);
          tma_load_3d(st + BOX_BYTES, &p.ds_map, &full[s], row0 + COLS, k0, bh);
        } else {
          k0 = t * KT;  // KV columns
          bh = b * p.Hkv + head / p.group;
          tma_load_3d(FP8 ? st + p.stage_bytes - A8_BYTES : st, &p.ds_map, &full[s], k0, row0,
                      b * p.Hq + head);
        }
        for (int j = 0; j < cols.nc; ++j)
          tma_load_3d(st + A_BYTES + j * BOX_BYTES, &p.b_map, &full[s], cols.c0 + j * COLS, k0,
                      bh);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const long long out_rows =
        DK ? (long long)(b * p.Hkv + head) * p.nkv : (long long)(b * p.Hq + head) * p.nq;
    const int limit = DK ? p.nkv : p.nq;
    switch (cols.nc) {
      case 4:
        consume<T, 4, DK, FP8>(p, smem, full, empty, ntiles, cw, row0, cols.c0, out_rows,
                                 limit);
        break;
      case 3:
        consume<T, 3, DK, FP8>(p, smem, full, empty, ntiles, cw, row0, cols.c0, out_rows,
                                 limit);
        break;
      case 2:
        consume<T, 2, DK, FP8>(p, smem, full, empty, ntiles, cw, row0, cols.c0, out_rows,
                                 limit);
        break;
      default:
        consume<T, 1, DK, FP8>(p, smem, full, empty, ntiles, cw, row0, cols.c0, out_rows,
                               limit);
        break;
    }
  }
}

// The host side of one launch: the plan, tensor maps, shared memory. FP8:
// the slab is e4m3 (rows of 16 B multiples), read through a map of bytes.
template <typename T, bool DK, bool FP8 = false>
cudaError_t launch(const void* ds, const void* bsrc, void* out, int out_f32, int B, int Hq,
                   int Hkv, int nq, int nkv, int D, int ds_rows, int ds_ld, float scale,
                   int causal_offset, cudaStream_t stream) {
  if (D <= 0 || D % COLS != 0 || Hkv <= 0 || Hq % Hkv != 0 || ds_rows < nq || ds_ld < nkv ||
      ds_ld % (FP8 ? 16 : 8) != 0)
    return cudaErrorInvalidValue;
  const bool f16 = std::is_same<T, __half>::value;
  Params p;
  memset(&p, 0, sizeof(p));
  p.out = out;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.group = Hq / Hkv;
  p.nq = nq;
  p.nkv = nkv;
  p.D = D;
  const Plan pl = make_plan(D, FP8);
  p.chunks = pl.chunks;
  p.col_blocks = pl.col_blocks;
  p.stage_bytes = pl.stage_bytes;
  p.out_f32 = out_f32;
  p.causal_offset = causal_offset;
  p.scale = scale;
  const dim3 grid(p.col_blocks * (((DK ? nkv : nq) + ROWS - 1) / ROWS), DK ? Hkv : Hq, B);
  if (grid.x * grid.y * grid.z == 0) return cudaSuccess;
  // Extents of at least 1 keep an empty operand encodable; its tiles are
  // never loaded (the k-range is empty).
  const uint64_t mq = nq > 0 ? nq : 1, mkv = nkv > 0 ? nkv : 1;
  cudaError_t e =
      FP8 ? encode_3d_bytes(&p.ds_map, ds, mkv, mq, (uint64_t)B * Hq, (uint64_t)ds_ld,
                            (uint64_t)ds_rows * ds_ld, KT, ROWS)
          : encode_3d(&p.ds_map, f16, ds, mkv, mq, (uint64_t)B * Hq, (uint64_t)ds_ld * 2,
                      (uint64_t)ds_rows * ds_ld * 2, COLS, DK ? KT : ROWS);
  if (e != cudaSuccess) return e;
  e = DK ? encode_3d(&p.b_map, f16, bsrc, D, mq, (uint64_t)B * Hq, (uint64_t)D * 2,
                     (uint64_t)nq * D * 2, COLS, KT)
         : encode_3d(&p.b_map, f16, bsrc, D, mkv, (uint64_t)B * Hkv, (uint64_t)D * 2,
                     (uint64_t)nkv * D * 2, COLS, KT);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(banded_kernel<T, DK, FP8>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (e != cudaSuccess) return e;
  banded_kernel<T, DK, FP8><<<grid, THREADS, pl.smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace band

// ---------------------------------------------------------------------------
// dK / dV: TMA + mbarrier + wgmma, one block (D, Dv <= 512) or a cluster of
// two (D or Dv in (512, 1024])
// ---------------------------------------------------------------------------

// ffpa_bwd_dkdv's kernel (the reference's SM90 split-D dK/dV block). A
// block owns 64 KV rows of one KV head and one column pass: at most 256
// columns of dK and of dV, whose fp32 tiles (64 x 256 each) take 128
// registers of each thread of a consumer warpgroup. K and V (64 x D,
// 64 x Dv) are loaded by TMA once and stay resident in 128 B-swizzled
// boxes; warpgroup 0 is the producer (one thread streams the group's Q and
// dO tiles, 64 rows x 64 columns a box, through a ring of two-box stages:
// one barrier handshake and one wgmma group per two boxes); warpgroups 1
// and 2 are the consumers. Per Q tile (group member
// outer, Q tiles of the band inner):
//  - S^T = K Q^T and dP^T = V dO^T over all of D and Dv: consumer c takes
//    Q rows 32c..32c+31 of both (wgmma.m64n32k16, K and the Q / dO box
//    both K-major), so the elementwise step is split evenly and each
//    thread holds its own S, dP, lse and delta: no fp32 exchange;
//  - P (dropped) and dS = P (dP - delta) (softcap's factor included) from
//    score_prob on the accumulator's (kv, q) coordinates; each consumer
//    writes its 32 columns of P^T and dS^T into two swizzled [kv][q] boxes;
//  - consumer 0 runs dK += dS^T Q over the pass's Q boxes, consumer 1
//    dV += P^T dO over its dO boxes (wgmma.m64n64k16 per box, A K-major
//    from the exchange box, B N-major with the transpose bit); the pass's
//    boxes come again after the S^T / dP^T boxes, its dO boxes then its Q
//    boxes, and the ring holds them all, so both consumers work at once;
//  - pass 0 writes the dS tile to the slab ([q][kv], 16 B a thread) from
//    the exchange box; or, for an e4m3 slab (FP8, bf16 only), from its own
//    fp32 dS: each thread rounds its 16 values to e4m3 in pairs
//    (cvt.rn.satfinite.e4m3x2.f32, never through bf16, which would round
//    some ties the other way), the 8 lanes of a warp that share t4 trade
//    bytes in three xor-shuffle rounds until lane (x, t4) holds Q column
//    8 (x / 2) + 2 t4 + x % 2 over the warp's 16 KV rows, and each thread
//    stores those 16 bytes: no shared memory (the D512 block and the
//    cluster leave less than 2 KB). Beside the writer's registers the
//    16-bit instance's held P and dS pairs spilled, so this instance takes
//    the box barrier first and writes each pair as it is formed. The
//    16-bit dS box that dK's product reads is the same, so dK and dV are
//    bit-equal to a 16-bit-slab launch.
// Two named barriers a tile order the exchange. S and dP are recomputed in
// every pass: at D512 (two passes) 6 matmul units are executed against the
// bound's 4 (operations: 1.11 ms at the training shape on an H100). Q tiles
// the band skips get zeros in the slab. On the card the barrier handshakes
// of the stream cost more than its bytes: two boxes a stage beat one,
// while a 2-CTA cluster multicasting the S^T / dP^T boxes to both passes,
// or holding the pass's boxes in the ring instead of loading them again,
// did not help (times in PERF.md).
//
// D, Dv <= 512 (SPLIT false): one block holds all of D and Dv, 6 stages at
// most (5 at D512).
//
// Wider heads (SPLIT true, D or Dv in (512, 1024]): K and V of 64 rows at
// D1024 (256 KB) fit no block, so a cluster of two blocks (grid x = 2 x KV
// tiles x passes, the pair adjacent in x: the same block order) owns the
// 64 KV rows and one pass and splits both head dims: rank r holds the K
// boxes of its half of D and the V boxes of its half of Dv, resident (rank
// 0 the larger half; sm90.cuh col_block), and per Q tile streams only its
// own Q and dO boxes, so every byte of Q, K, V and dO is read once per
// cluster, as one D512 block reads it. Consumer c of each rank computes a
// partial S^T over its rank's D boxes and a partial dP^T over its Dv boxes
// (64 x 32 fp32, 8 KB each), stores both into the shared memory of the
// partner's consumer c (st.async, completing their bytes on the partner's
// barrier; S^T as soon as its products complete, so its bytes travel
// under the dP^T products) and adds the partner's partials to its own. fp32 addition of
// two values is commutative, so both ranks hold bit-identical S^T and
// dP^T, and so the same P, dS and dropout mask, with no further exchange.
// Each rank then runs dK += dS^T Q over the pass's share of its D boxes
// and dV += P^T dO over its share of its Dv boxes (passes of at most 256
// columns of a rank's half, each recomputing the partials: 2 at D1024) and
// stores its own columns; rank 0's pass 0 writes the slab. The exchange
// has one slot (the arithmetic is beside make_plan), so a rank stores tile
// t's partials only after the partner has read tile t - 1's: each thread
// that read its share of the slot arrives on the partner's "free" barrier
// (a remote arrive, release at cluster scope), which the storing consumer
// waits on with acquire. Both ranks walk the same Q tiles (the band
// depends on KV rows alone). A rank may hold no D box (D64 / Dv1024) or no
// Dv box (D1024 / Dv64): it sends zero partials of that product and owns
// no columns of that gradient. The cluster barrier at the start publishes
// the barriers' initialisation, the one at the end keeps a block alive
// while its partner may still store or arrive into it.
namespace dkdv {

using namespace ffpa::sm90;

constexpr int ROWS = 64;                     // KV rows of a block
constexpr int QROWS = 64;                    // Q rows of a streamed tile
constexpr int COLS = 64;                     // columns of a box (128 B of 16-bit)
constexpr int MAX_BOXES = 8;                 // D, Dv boxes of a block: D512, a rank's half of D1024
constexpr int MAX_HEAD_DIM = 2 * MAX_BOXES * COLS;  // D, Dv of either route
constexpr int PASS_BOXES = 4;                // dK / dV columns of a pass: 256
constexpr int STAGE_BOXES = 2;               // boxes a stage (one barrier handshake)
static_assert(STAGE_BOXES == 2, "the consumers' stage loops take pairs of boxes");
constexpr int STAGE_BYTES = STAGE_BOXES * BOX_BYTES;
constexpr int MAX_STAGES = 6;
constexpr int THREADS = 384;                 // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMER_WARPS = 8;            // arrivals that free a stage
constexpr int CONSUMER_THREADS = 128;        // arrivals that free a consumer's exchange slot
constexpr int PART_BYTES = ROWS * 32 * 4;    // one consumer's partial S^T or dP^T (64 x 32 fp32)
constexpr int PART_BUF_BYTES = 2 * 2 * PART_BYTES;  // both consumers' S^T and dP^T: one slot
constexpr int PART_BARRIERS = 4;             // landed and free, per consumer
constexpr int SMEM_LIMIT = 232448;
constexpr int WGMMA = 1, CLUSTER = 2;        // routes

// A block's share of the head dims: its first D box and D boxes, its first
// Dv box and Dv boxes. Alone a block holds everything; split, rank r holds
// half of each, rank 0 the larger half.
struct Part {
  int d0, nd, v0, nv;
};
__host__ __device__ inline Part part_of(int nd, int nv, bool split, int rank) {
  if (!split) return {0, nd, 0, nv};
  const Cols d = col_block(nd, 2, rank), v = col_block(nv, 2, rank);
  return {d.c0 / COLS, d.nc, v.c0 / COLS, v.nc};
}

// Shared memory of a block laid out for nd K boxes and nv V boxes, apart
// from the ring: K, V, the P and dS boxes, the 1024 B alignment, the K/V
// barrier and, split, the exchange's slot and its barriers. A ring stage is
// STAGE_BOXES boxes and its two barriers.
inline size_t fixed_bytes(int nd, int nv, bool split) {
  return (size_t)(nd + nv + 2) * BOX_BYTES + 1024 + sizeof(uint64_t) +
         (split ? (size_t)PART_BUF_BYTES + PART_BARRIERS * sizeof(uint64_t) : 0);
}
constexpr size_t STAGE_SMEM = STAGE_BYTES + 2 * sizeof(uint64_t);

// The route and tiling of a launch at head dims (D, Dv), multiples of 64
// up to 1024: D, Dv <= 512 take one block, wider heads the cluster; ceil(
// (a block's boxes of D or of Dv) / 4) passes whose column blocks split a
// block's D boxes and its Dv boxes as evenly as possible (sm90.cuh
// col_block), and as many ring stages (at most 6) as shared memory holds
// beside the rest. Both ranks of a cluster lay out rank 0's share. At D =
// Dv = 1024 a rank's K and V take 16 boxes (128 KB), the P and dS boxes 16
// KB and the exchange's slot 32 KB (2 consumers x (S^T + dP^T) x 8 KB):
// with the alignment and the barriers 181,288 B, and 3 stages of 16,400 B
// make 230,488 of the 232,448 a block may ask for. A second slot (as the
// forward's double buffer) would leave room for 1 stage: one slot, and the
// "free" barriers. ffpa_bwd_dkdv_plan hands the plan out; ops/config.py
// dkdv_plan mirrors it and the card test holds the two equal.
//
// ring_cap > 0 caps the ring at that many stages (the autotune's knob; the
// device code takes the depth as an argument, so only the shared memory a
// block asks for changes). The walk needs MIN_STAGES: consumer 1 holds the
// last stage of its dV run while it frees the (up to 2) stages of consumer
// 0's dK run, which the producer then fills into the other slots.
constexpr int MIN_STAGES = 3;
struct Plan {
  int route, passes, stages;
  Part part[2];  // each rank's share (the lone block's is part[0])
  size_t smem;
};
inline Plan make_plan(int D, int Dv, int ring_cap = 0) {
  const int nd = D / COLS, nv = Dv / COLS;
  const bool split = nd > MAX_BOXES || nv > MAX_BOXES;
  Plan pl;
  pl.route = split ? CLUSTER : WGMMA;
  pl.part[0] = part_of(nd, nv, split, 0);
  pl.part[1] = part_of(nd, nv, split, 1);
  const Part& lay = pl.part[0];
  pl.passes = std::max((lay.nd + PASS_BOXES - 1) / PASS_BOXES,
                       (lay.nv + PASS_BOXES - 1) / PASS_BOXES);
  const size_t fixed = fixed_bytes(lay.nd, lay.nv, split);
  pl.stages = (int)std::min((size_t)MAX_STAGES, (SMEM_LIMIT - fixed) / STAGE_SMEM);
  if (ring_cap > 0) pl.stages = std::min(pl.stages, ring_cap);
  pl.smem = fixed + pl.stages * STAGE_SMEM;
  return pl;
}

// The kernel's tensor maps, a __grid_constant__ parameter of their own (TMA
// reads them by address); the scalars stay an ordinary parameter, read
// from the constant bank (p.col_passes is the plan's passes).
struct Maps {
  CUtensorMap q_map, do_map;  // (D | Dv, nq, B * Hq); box 64 x 64
  CUtensorMap k_map, v_map;   // (D | Dv, nkv, B * Hkv); box 64 x 64
};

// Shared memory of a block, from a 1024 B boundary: the K boxes, the V
// boxes, the P and dS boxes, the ring's stages, the exchange's slot
// (split), the stages' full / empty barriers, K/V's barrier and the
// exchange's barriers (split). Both ranks of a cluster lay it out alike
// (for rank 0's share), so an offset here is the same offset in the
// partner.
struct Smem {
  unsigned char* k;
  unsigned char* v;
  unsigned char* p;     // P^T (dropped), swizzled [kv][q]
  unsigned char* ds;    // dS^T (softcap's factor included), swizzled [kv][q]
  unsigned char* ring;
  unsigned char* part;  // [2][2][PART_BYTES]: consumer c's partial S^T, dP^T from the partner
  uint64_t* full;
  uint64_t* empty;
  uint64_t* kv_full;
  uint64_t* part_full;  // [2]: the partner's partials for consumer c have landed
  uint64_t* part_free;  // [2]: the partner's consumer c has read the partials sent to it
};
template <bool SPLIT>
__device__ __forceinline__ Smem carve(unsigned char* base, int nd, int nv, int stages) {
  Smem sm;
  sm.k = base;
  sm.v = base + nd * BOX_BYTES;
  sm.p = base + (nd + nv) * BOX_BYTES;
  sm.ds = sm.p + BOX_BYTES;
  sm.ring = sm.ds + BOX_BYTES;
  sm.part = sm.ring + stages * STAGE_BYTES;
  sm.full = reinterpret_cast<uint64_t*>(sm.part + (SPLIT ? PART_BUF_BYTES : 0));
  sm.empty = sm.full + stages;
  sm.kv_full = sm.empty + stages;
  sm.part_full = sm.kv_full + 1;
  sm.part_free = sm.part_full + 2;
  return sm;
}

// The producer's thread: the block's K and V boxes once, then per Q tile
// four runs of boxes: its nd Q boxes, its nv dO boxes, the pass's dO boxes,
// the pass's Q boxes; a stage takes up to STAGE_BOXES boxes of one run.
__device__ __forceinline__ void produce(const Maps& maps, const BwdParams& p, const Smem& sm,
                                        int stages, const Part& pt, sm90::Cols dc,
                                        sm90::Cols vc, int ntiles, int ni, int i_lo, int kvh,
                                        int b, int kv0) {
  prefetch_map(&maps.q_map);
  prefetch_map(&maps.do_map);
  prefetch_map(&maps.k_map);
  prefetch_map(&maps.v_map);
  const int bkv = b * p.Hkv + kvh;
  mbar_arrive_expect_tx(sm.kv_full, (pt.nd + pt.nv) * BOX_BYTES);
  for (int j = 0; j < pt.nd; ++j)
    tma_load_3d(sm.k + j * BOX_BYTES, &maps.k_map, sm.kv_full, (pt.d0 + j) * COLS, kv0, bkv);
  for (int j = 0; j < pt.nv; ++j)
    tma_load_3d(sm.v + j * BOX_BYTES, &maps.v_map, sm.kv_full, (pt.v0 + j) * COLS, kv0, bkv);
  int it = 0;
  auto run = [&](const CUtensorMap* map, int first, int n, int q0, int bh) {
    for (int c = 0; c < n; c += STAGE_BOXES, ++it) {
      const int st = it % stages, nb = min(STAGE_BOXES, n - c);
      if (it >= stages) mbar_wait(&sm.empty[st], ((it / stages) - 1) & 1);
      mbar_arrive_expect_tx(&sm.full[st], nb * BOX_BYTES);
      for (int g = 0; g < nb; ++g)
        tma_load_3d(sm.ring + st * STAGE_BYTES + g * BOX_BYTES, map, &sm.full[st],
                    (first + c + g) * COLS, q0, bh);
    }
  };
  for (int t = 0; t < ntiles; ++t) {
    const int h = kvh * p.group + t / ni, q0 = (i_lo + t % ni) * QROWS;
    const int bh = b * p.Hq + h;
    run(&maps.q_map, pt.d0, pt.nd, q0, bh);
    run(&maps.do_map, pt.v0, pt.nv, q0, bh);
    run(&maps.do_map, vc.c0 / COLS, vc.nc, q0, bh);
    run(&maps.q_map, dc.c0 / COLS, dc.nc, q0, bh);
  }
}

// The e4m3 slab's part of a warp: lane (g, t4) holds in q8[jj] its dS of Q
// columns 8 jj + 2 t4 + e as e4m3, bytes (KV row g, e 0), (g, 1),
// (g + 8, 0), (g + 8, 1) of the warp's 16 rows. Each of three rounds swaps
// one bit of the lane's g with one bit of the column index x = 2 jj + e
// between partner lanes (xor 4, 8, 16: the same t4): e is a byte's place
// in its half, jj a word. After them lane (x, t4) holds column x, KV row
// r in byte r % 2 of word r / 2 (r < 8) or byte 2 + r % 2 (r >= 8), and
// stores its 16 bytes at row 8 (x / 2) + 2 t4 + x % 2 of `base` (the
// warp's first column of the consumer's first Q row).
__device__ __forceinline__ void store_e4m3(unsigned char* base, int ld, uint32_t (&q8)[4], int g,
                                           int t4) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t o = __shfl_xor_sync(0xffffffffu, q8[j], 4);
    q8[j] = __byte_perm(q8[j], o, (g & 1) ? 0x3715 : 0x6240);
  }
#pragma unroll
  for (int j = 0; j < 4; j += 2) {
    const uint32_t o = __shfl_xor_sync(0xffffffffu, (g & 2) ? q8[j] : q8[j + 1], 8);
    if (g & 2)
      q8[j] = o;
    else
      q8[j + 1] = o;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint32_t o = __shfl_xor_sync(0xffffffffu, (g & 4) ? q8[j] : q8[j + 2], 16);
    if (g & 4)
      q8[j] = o;
    else
      q8[j + 2] = o;
  }
  const int row = 8 * (g >> 1) + 2 * t4 + (g & 1);
  *reinterpret_cast<uint4*>(base + (long long)row * ld) =
      make_uint4(__byte_perm(q8[0], q8[1], 0x5410), __byte_perm(q8[2], q8[3], 0x5410),
                 __byte_perm(q8[0], q8[1], 0x7632), __byte_perm(q8[2], q8[3], 0x7632));
}

// Consumer CW (0: dK, 1: dV) of a block; CW is a template argument so
// that no branch around a wgmma depends on the thread (ptxas serializes
// wgmma on a path it cannot prove uniform). dc and vc are the pass's dK and
// dV columns (absolute).
template <typename T, int CW, bool SPLIT, bool FP8>
__device__ __forceinline__ void consume(const BwdParams& p, int stages, const Smem& sm,
                                        int ntiles, int ni, int i_lo, int kvh, int b, int kv0,
                                        const Part& pt, sm90::Cols dc, sm90::Cols vc, bool emit,
                                        int rank) {
  const int nd = pt.nd, nv = pt.nv;
  constexpr int cw = CW;  // 0: dK, Q columns 0..31; 1: dV, 32..63
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int own = CW == 0 ? dc.nc : vc.nc;  // boxes of this consumer's product
  constexpr float LOG2E = 1.4426950408889634f;
  const float scale_log2 = p.scale * LOG2E;
  const bool plain =
      p.bias == nullptr && p.alibi == nullptr && p.softcap <= 0.f && p.dropout_p <= 0.f;

  float acc[PASS_BOXES * 32];
#pragma unroll
  for (int i = 0; i < PASS_BOXES * 32; ++i) acc[i] = 0.f;

  // it: the stream's box index; held: a stage whose products may still
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

  mbar_wait(sm.kv_full, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int h = kvh * p.group + t / ni, q0 = (i_lo + t % ni) * QROWS;
    const long long bh = (long long)b * p.Hq + h;
    // lse and delta of this thread's 8 Q columns: 32 cw + 8 jj + 2 t4 + e.
    float lse_r[8], dl_r[8];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = q0 + 32 * cw + 8 * jj + 2 * t4 + e;
        const bool ok = q < p.nq;
        lse_r[2 * jj + e] = ok ? p.lse[bh * p.nq + q] : 0.f;
        dl_r[2 * jj + e] = ok ? p.delta[bh * p.nq + q] : 0.f;
      }

    // S^T and dP^T: this warpgroup's 32 Q rows of each box, a stage's
    // boxes in one wgmma group. The stages of two boxes, then an odd last
    // box alone: a conditional wgmma inside a stage makes ptxas serialize.
    float s[16], dp[16];
    auto stream = [&](float(&a)[16], const unsigned char* res, int n) {
      int c = 0;
      for (; c + 2 <= n; c += 2, ++it) {
        const int st = it % stages;
        const unsigned char* sb = sm.ring + st * STAGE_BYTES + cw * 4096;
        mbar_wait(&sm.full[st], (it / stages) & 1);
        wgmma_fence();
        box_mma<T, 32, 0>(a, res + c * BOX_BYTES, sb, c == 0);
        box_mma<T, 32, 0>(a, res + (c + 1) * BOX_BYTES, sb + BOX_BYTES);
        done_with(st);
      }
      if (c < n) {
        const int st = it % stages;
        mbar_wait(&sm.full[st], (it / stages) & 1);
        wgmma_fence();
        box_mma<T, 32, 0>(a, res + c * BOX_BYTES, sm.ring + st * STAGE_BYTES + cw * 4096,
                          c == 0);
        done_with(st);
        ++it;
      }
    };
    // Split: S^T and dP^T = this rank's partials + the partner's, the same
    // bits in both. Element 4 i + e of thread tid sits at (i * 128 + tid) *
    // 16 + 4 e bytes of its consumer's S^T slot, and as far into the dP^T
    // slot PART_BYTES on; a thread reads back what the partner's thread tid
    // stored. A rank without D (Dv) boxes sends zeros for S^T (dP^T). S^T
    // goes out before the dP^T products, so its bytes travel under them
    // (1-2 % at D640 and D1024 against sending it beside dP^T).
    const uint32_t partner = rank ^ 1;
    const uint32_t mine = cvta_smem(sm.part) + CW * 2 * PART_BYTES + tid * 16;
    auto send = [&](float(&a)[16], int n, uint32_t off) {
      const uint32_t there = mapa(mine + off, partner);
      const uint32_t there_bar = mapa(cvta_smem(&sm.part_full[CW]), partner);
#pragma unroll
      for (int i = 0; i < 16; ++i) a[i] = n > 0 ? a[i] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) st_async_v4(there + i * 2048, a + 4 * i, there_bar);
    };
    stream(s, sm.k, nd);
    if constexpr (SPLIT) {
      drain();
      fence_operands(s);
      // The partner has read tile t - 1's partials (at t = 0 the wait for
      // parity 1 of a fresh barrier returns at once).
      mbar_wait_cluster(&sm.part_free[CW], (t + 1) & 1);
      send(s, nd, 0);
    }
    stream(dp, sm.v, nv);
    drain();
    fence_operands(s);
    fence_operands(dp);

    if constexpr (SPLIT) {
      send(dp, nv, PART_BYTES);
      mbar_arrive_expect_tx_if(&sm.part_full[CW], 2 * PART_BYTES, tid == 0);
      mbar_wait_cluster(&sm.part_full[CW], t & 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x[4], y[4];
        lds_v4(mine + i * 2048, x);
        lds_v4(mine + PART_BYTES + i * 2048, y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * i + e] += x[e];
          dp[4 * i + e] += y[e];
        }
      }
      mbar_arrive_cluster(mapa(cvta_smem(&sm.part_free[CW]), partner));
      fence_operands(s);
      fence_operands(dp);
    }

    // P (dropped) and dS at the accumulator's (kv, q) coordinates: element
    // 4 jj + 2 hh + e is KV row 16 warp + g + 8 hh, Q column 32 cw + 8 jj +
    // 2 t4 + e.
    // A tile with no feature, inside the band and the ragged edges on
    // every element, takes p = 2^(s * scale * log2 e - lse * log2 e) alone;
    // the others score_prob, element by element.
    const int qc = q0 + 32 * cw;  // this consumer's first Q column
    // The one-block e4m3 instance forms the test's block values here from
    // values the compiler cannot hoist: formed before the walk, they were
    // spilled (as were its lane values and its zero tiles' range below).
    int kvt = kv0;
    const float* bias_t = p.bias;
    if constexpr (FP8 && !SPLIT) asm volatile("" : "+r"(kvt), "+l"(bias_t));
    const bool plain_t = FP8 && !SPLIT ? bias_t == nullptr && p.alibi == nullptr &&
                                             p.softcap <= 0.f && p.dropout_p <= 0.f
                                       : plain;
    const bool interior =
        plain_t && qc + 31 < p.nq && kvt + ROWS - 1 < p.nkv &&
        (p.window_right < 0 || kvt + ROWS - 1 <= qc + p.causal_offset + p.window_right) &&
        (p.window_left < 0 || kvt >= qc + 31 + p.causal_offset - p.window_left);
    // 16-bit slab: P and dS go to the boxes from pw / dw after the other
    // consumer is done with them. e4m3 slab: the writer's registers (q8[jj]:
    // this thread's dS of Q columns 8 jj + 2 t4 + e as e4m3, each rounded
    // from fp32 once; store_e4m3 has the byte order) did not fit beside
    // pw / dw (the D512 block spilled), so that wait comes first and each
    // pair goes to its box as it is formed, at 32-bit shared addresses
    // (their 64-bit generic forms, formed before the walk, spilled too).
    uint32_t pw[8], dw[8], q8[4];
    int row = 16 * warp + g;
    if constexpr (FP8) {
      if constexpr (!SPLIT) asm volatile("" : "+r"(row));
      // The other consumer is done with the previous tile's P and dS boxes.
      named_barrier_sync(1, 2 * 128);
    }
    auto keep = [&](int jj, int hh, const float(&pv)[2], const float(&dsv)[2]) {
      if constexpr (FP8) {
        const uint32_t off = swz(row + 8 * hh, 32 * cw + 8 * jj + 2 * t4);
        sts_u32(cvta_smem(sm.p) + off, pack2<T>(pv[0], pv[1]));
        sts_u32(cvta_smem(sm.ds) + off, pack2<T>(dsv[0], dsv[1]));
        const uint32_t e = e4m3x2(dsv[0], dsv[1]);
        q8[jj] = hh == 0 ? e : q8[jj] | (e << 16);
      } else {
        pw[2 * jj + hh] = pack2<T>(pv[0], pv[1]);
        dw[2 * jj + hh] = pack2<T>(dsv[0], dsv[1]);
      }
    };
    if (interior) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float pv[2], dsv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * jj + 2 * hh + e;
            pv[e] = exp2f(fmaf(s[idx], scale_log2, -lse_r[2 * jj + e] * LOG2E));
            dsv[e] = pv[e] * (dp[idx] - dl_r[2 * jj + e]);
          }
          keep(jj, hh, pv, dsv);
        }
    } else {
      const float slope = p.alibi != nullptr ? p.alibi[bh] : 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float pv[2], dsv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * jj + 2 * hh + e;
            const Prob pr = score_prob(p, b, h, qc + 8 * jj + 2 * t4 + e,
                                       kv0 + 16 * warp + g + 8 * hh, s[idx], lse_r[2 * jj + e],
                                       slope);
            pv[e] = dropped(p, pr.keep, pr.p);
            dsv[e] = pr.p * pr.cap * (dropped(p, pr.keep, dp[idx]) - dl_r[2 * jj + e]);
          }
          keep(jj, hh, pv, dsv);
        }
    }
    if constexpr (!FP8) {
      // The other consumer is done with the previous tile's P and dS boxes
      // (its products completed, its slab reads returned).
      named_barrier_sync(1, 2 * 128);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const uint32_t off = swz(16 * warp + g + 8 * hh, 32 * cw + 8 * jj + 2 * t4);
          *reinterpret_cast<uint32_t*>(sm.p + off) = pw[2 * jj + hh];
          *reinterpret_cast<uint32_t*>(sm.ds + off) = dw[2 * jj + hh];
        }
    }
    fence_proxy_async();
    named_barrier_sync(1, 2 * 128);

    if constexpr (FP8) {
      if (emit) {
        int gg = g, tt = t4, col = kv0 + 16 * warp;
        if constexpr (!SPLIT) asm volatile("" : "+r"(gg), "+r"(tt), "+r"(col));
        store_e4m3(static_cast<unsigned char*>(p.ds) + (bh * p.ds_rows + q0 + 32 * cw) * p.ds_ld +
                       col,
                   p.ds_ld, q8, gg, tt);
      }
    } else if (emit) {
      // Slab rows q0..q0+63, columns kv0..kv0+63: 16 columns a thread.
      const int u = threadIdx.x - 128, ql = u >> 2, kb = (u & 3) * 16;
      T* dst = static_cast<T*>(p.ds) + (bh * p.ds_rows + q0 + ql) * p.ds_ld + kv0 + kb;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        T vals[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          vals[e] = *reinterpret_cast<const T*>(sm.ds + swz(kb + 8 * half + e, ql));
        *reinterpret_cast<uint4*>(dst + 8 * half) = *reinterpret_cast<const uint4*>(vals);
      }
    }

    // dV += P^T dO (consumer 1) over the pass's dO boxes, which come
    // first, and dK += dS^T Q (consumer 0) over its Q boxes; each frees
    // the other's boxes as they arrive. The accumulator box of each
    // product is fixed at compile time.
    auto skip = [&](int n) {  // the stages of n boxes
      for (int c = 0; c < n; c += STAGE_BOXES, ++it) {
        const int st = it % stages;
        mbar_wait(&sm.full[st], (it / stages) & 1);
        release(st, true);
      }
    };
    if constexpr (CW == 0) skip(vc.nc);
    const unsigned char* a_box = CW == 0 ? sm.ds : sm.p;
#pragma unroll
    for (int jj = 0; jj < PASS_BOXES; jj += 2) {
      if (jj + 2 <= own) {
        const int st = it % stages;
        mbar_wait(&sm.full[st], (it / stages) & 1);
        wgmma_fence();
        box_mma<T, 64, 1>(*reinterpret_cast<float(*)[32]>(acc + 32 * jj), a_box,
                          sm.ring + st * STAGE_BYTES);
        box_mma<T, 64, 1>(*reinterpret_cast<float(*)[32]>(acc + 32 * (jj + 1)), a_box,
                          sm.ring + st * STAGE_BYTES + BOX_BYTES);
        done_with(st);
        ++it;
      } else if (jj < own) {
        const int st = it % stages;
        mbar_wait(&sm.full[st], (it / stages) & 1);
        wgmma_fence();
        box_mma<T, 64, 1>(*reinterpret_cast<float(*)[32]>(acc + 32 * jj), a_box,
                          sm.ring + st * STAGE_BYTES);
        done_with(st);
        ++it;
      }
    }
    if constexpr (CW == 1) skip(dc.nc);
    drain();
  }
  fence_operands(acc);

  // Q tiles the band skips: zeros over this block's columns of the slab
  // (every 64-row tile of ds_rows outside [i_lo, i_lo + ni)); 16 B a store,
  // 8 elements of 16 bits or 16 of e4m3.
  if (emit) {
    const int u = threadIdx.x - 128;
    for (int gg = 0; gg < p.group; ++gg) {
      const long long bh = (long long)b * p.Hq + kvh * p.group + gg;
      for (int i = 0; i < p.ds_rows / QROWS; ++i) {
        int lo_t = i_lo, n_t = ni;
        if constexpr (FP8 && !SPLIT) asm volatile("" : "+r"(lo_t), "+r"(n_t));
        if (i >= lo_t && i < lo_t + n_t) continue;
        if constexpr (FP8) {
          const int ql = u >> 2, kb = (u & 3) * 16;
          *reinterpret_cast<uint4*>(static_cast<unsigned char*>(p.ds) +
                                    (bh * p.ds_rows + i * QROWS + ql) * p.ds_ld + kv0 + kb) =
              make_uint4(0u, 0u, 0u, 0u);
        } else {
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const int v = u + 256 * k, ql = v >> 3, kb = (v & 7) * 8;
            *reinterpret_cast<uint4*>(static_cast<T*>(p.ds) +
                                      (bh * p.ds_rows + i * QROWS + ql) * p.ds_ld + kv0 + kb) =
                make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }
    }
  }

  // Epilogue: dK = scale * sum (consumer 0) or dV (consumer 1); rows past
  // Nkv are not stored.
  const int nc = cw == 0 ? dc.nc : vc.nc, col0 = cw == 0 ? dc.c0 : vc.c0;
  const int ld = cw == 0 ? p.D : p.Dv;
  const float mul = cw == 0 ? p.scale : 1.f;
  void* out = cw == 0 ? p.dk : p.dv;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kv = kv0 + 16 * warp + g + 8 * hh;
    if (kv >= p.nkv) continue;
    const long long base = ((long long)(b * p.Hkv + kvh) * p.nkv + kv) * ld + col0 + 2 * t4;
#pragma unroll
    for (int jj = 0; jj < PASS_BOXES; ++jj) {
      if (jj >= nc) break;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8)
        store2<T>(out, base + 64 * jj + 8 * j8, acc[32 * jj + 4 * j8 + 2 * hh] * mul,
                  acc[32 * jj + 4 * j8 + 2 * hh + 1] * mul, p.out_f32);
    }
  }
}

template <typename T, bool SPLIT, bool FP8 = false>
__global__ void __launch_bounds__(THREADS, 1) kernel(const __grid_constant__ Maps maps,
                                                     const BwdParams p, const int stages) {
  static_assert(!FP8 || std::is_same<T, __nv_bfloat16>::value, "an e4m3 slab takes bf16");
  extern __shared__ unsigned char smem_raw[];
  // Boxes on 1024 B boundaries: the 128 B swizzle's atom. On the cluster
  // route the offset is added to the shared array itself, so every pointer
  // into it stays a 32-bit shared one (the forward's cluster spilled a
  // 64-bit generic one beside its accumulators).
  unsigned char* base;
  if constexpr (SPLIT)
    base = smem_raw + ((1024 - (cvta_smem(smem_raw) & 1023)) & 1023);
  else
    base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int rank = SPLIT ? (int)cluster_rank() : 0;
  const int nd = p.D / COLS, nv = p.Dv / COLS, passes = p.col_passes;
  const Part pt = part_of(nd, nv, SPLIT, rank);
  const Part lay = part_of(nd, nv, SPLIT, 0);  // both ranks alike
  const Smem sm = carve<SPLIT>(base, lay.nd, lay.nv, stages);

  // Block order: the passes of a KV tile side by side (they read the same
  // Q and dO tiles; on the cluster route each pass's two ranks adjacent),
  // the KV tiles of a head longest first (under causal the first tiles walk
  // the most Q tiles), then the heads.
  const int blk = SPLIT ? (int)(blockIdx.x >> 1) : (int)blockIdx.x;
  const int pass = blk % passes, kv0 = (blk / passes) * ROWS;
  const int kvh = blockIdx.y, b = blockIdx.z;
  sm90::Cols dc = sm90::col_block(pt.nd, passes, pass);
  sm90::Cols vc = sm90::col_block(pt.nv, passes, pass);
  dc.c0 += pt.d0 * COLS;
  vc.c0 += pt.v0 * COLS;

  // Q tiles of the band: [i_lo, i_lo + ni) of every group member.
  const int nqt = (p.nq + QROWS - 1) / QROWS;
  int i_lo = 0, i_hi = nqt;
  if (p.window_right >= 0)
    i_lo = max(0, floordiv(kv0 - p.causal_offset - p.window_right, QROWS));
  if (p.window_left >= 0)
    i_hi = min(nqt, floordiv(kv0 + ROWS - 1 - p.causal_offset + p.window_left, QROWS) + 1);
  const int ni = max(0, i_hi - i_lo);
  const int ntiles = p.group * ni;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMER_WARPS);
    }
    mbar_init(sm.kv_full, 1);
    if constexpr (SPLIT)
      for (int c = 0; c < 2; ++c) {
        mbar_init(&sm.part_full[c], 1);
        mbar_init(&sm.part_free[c], CONSUMER_THREADS);
      }
    fence_barrier_init();
  }
  // The partner's barriers are initialised before this block's first
  // store into its shared memory.
  if constexpr (SPLIT)
    cluster_sync();
  else
    __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) produce(maps, p, sm, stages, pt, dc, vc, ntiles, ni, i_lo, kvh, b, kv0);
  } else {
    setmaxnreg_inc<232>();
    const bool emit = p.ds != nullptr && pass == 0 && rank == 0;
    if (threadIdx.x < 256)
      consume<T, 0, SPLIT, FP8>(p, stages, sm, ntiles, ni, i_lo, kvh, b, kv0, pt, dc, vc, emit,
                                rank);
    else
      consume<T, 1, SPLIT, FP8>(p, stages, sm, ntiles, ni, i_lo, kvh, b, kv0, pt, dc, vc, emit,
                                rank);
  }
  if constexpr (SPLIT) cluster_sync();  // the partner may still store or arrive into this block
}

// The host side of one launch: tensor maps, shared memory, the grid (KV
// tiles over the slab's columns when it is written, so each of its
// columns is; for the split, the cluster of two along x). FP8: the slab is
// e4m3.
template <typename T, bool SPLIT, bool FP8 = false>
cudaError_t launch(const BwdParams& bp, const Plan& pl, int B, cudaStream_t stream) {
  const bool f16 = std::is_same<T, __half>::value;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  BwdParams p = bp;
  p.col_passes = pl.passes;
  const uint64_t mq = bp.nq > 0 ? bp.nq : 1, mkv = bp.nkv > 0 ? bp.nkv : 1;
  cudaError_t e = encode_3d(&maps.q_map, f16, bp.q, bp.D, mq, (uint64_t)B * bp.Hq,
                            (uint64_t)bp.D * 2, mq * bp.D * 2, COLS, QROWS);
  if (e == cudaSuccess)
    e = encode_3d(&maps.do_map, f16, bp.dout, bp.Dv, mq, (uint64_t)B * bp.Hq,
                  (uint64_t)bp.Dv * 2, mq * bp.Dv * 2, COLS, QROWS);
  if (e == cudaSuccess)
    e = encode_3d(&maps.k_map, f16, bp.k, bp.D, mkv, (uint64_t)B * bp.Hkv, (uint64_t)bp.D * 2,
                  mkv * bp.D * 2, COLS, ROWS);
  if (e == cudaSuccess)
    e = encode_3d(&maps.v_map, f16, bp.v, bp.Dv, mkv, (uint64_t)B * bp.Hkv,
                  (uint64_t)bp.Dv * 2, mkv * bp.Dv * 2, COLS, ROWS);
  if (e != cudaSuccess) return e;
  const int kv_tiles = bp.ds != nullptr ? bp.ds_ld / ROWS : (bp.nkv + ROWS - 1) / ROWS;
  const dim3 grid((SPLIT ? 2 : 1) * kv_tiles * pl.passes, bp.Hkv, B);
  auto kern = kernel<T, SPLIT, FP8>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (e != cudaSuccess) return e;
  if (grid.x * grid.y * grid.z == 0) return cudaSuccess;
  if constexpr (SPLIT) {
    return launch_cluster(kern, grid, THREADS, pl.smem, stream, 2, maps, p, pl.stages);
  } else {
    kern<<<grid, THREADS, pl.smem, stream>>>(maps, p, pl.stages);
    return cudaGetLastError();
  }
}

// An e4m3 slab (fp8) takes bf16 inputs and a slab to write.
template <bool SPLIT>
cudaError_t launch_typed(bool f16, bool fp8, const BwdParams& p, const Plan& pl, int B,
                         cudaStream_t stream) {
  if (fp8)
    return f16 || p.ds == nullptr ? cudaErrorInvalidValue
                                  : launch<__nv_bfloat16, SPLIT, true>(p, pl, B, stream);
  return f16 ? launch<__half, SPLIT>(p, pl, B, stream)
             : launch<__nv_bfloat16, SPLIT>(p, pl, B, stream);
}

}  // namespace dkdv

// ---------------------------------------------------------------------------
// dQ (recompute): TMA + mbarrier + wgmma, one block (D, Dv <= 512) or a
// cluster of two (D or Dv in (512, 1024])
// ---------------------------------------------------------------------------

// ffpa_bwd_dq's kernel (ffpa_attn_tpu/ops/flash_bwd.py _dq_kernel, the
// recompute tier's second launch). Bound on an H100: operations, 3 matmul
// units (S, dP, dQ) of 2 * pairs * (D, Dv, D) flop. The mma.sync block it
// replaced walked 2 D / 64 + Dv / 64 chunks a KV tile through a cp.async
// ring, each behind two __syncthreads (48 block barriers a tile at D512),
// with no product in flight during a barrier: 10x its bound at the
// windowed training shape on an H100, this block 3x (PERF.md). This block
// is the forward's (flash_fwd.cu namespace fwd) with dP beside S and no
// softmax, and the mirror of dkdv::kernel with (K, V) and (Q, dO) swapped
// and one output. 384 threads own 64 Q rows of one query head (the longest
// causal rows first), and walk the KV tiles of the rows' causal / window
// band:
//  - warpgroup 0 is the producer (setmaxnreg 24). One thread loads Q and
//    dO once by TMA into D / 64 and Dv / 64 resident 64 x 64 boxes (128 B
//    swizzle; tensor maps at the true extents, so rows past Nq and Nkv read
//    as zero), then per KV tile streams the K boxes (for S) and the V boxes
//    (for dP) in two-box stages, then the K boxes again (for dQ), box j of
//    consumer 0's half of D beside box j of consumer 1's: one stage feeds
//    both consumers' dQ products. Warps 1..3 meanwhile write the zeros of
//    the dbias slab outside the band;
//  - warpgroups 1 and 2 are the consumers (setmaxnreg 240, as the
//    forward's: at 232 the feature path spilled). Consumer c computes
//    S = Q K^T and dP = dO V^T for KV columns 32c..32c+31
//    (wgmma m64n32k16, the Q / dO box and rows 32c.. of the K / V box
//    both K-major), so each thread holds its own S, dP, lse and delta. It
//    forms dS = p (dP - delta) (dropout replayed, softcap's factor for the
//    product, not for dbias), stores fp32 dS to the dbias slab when asked,
//    and writes its 32 columns of dS into one swizzled [q][kv] exchange
//    box. After a named barrier each runs dQ[:, own half of D] += dS K
//    (m64n64k16 a box, A the exchange box K-major, B the K box N-major
//    with the transpose bit; 128 fp32 registers a thread at D512);
//  - a tile with no bias, ALiBi, softcap or dropout, inside the band and
//    the ragged edges on every element, takes p = 2^(s scale log2 e - lse
//    log2 e) alone; the others take the feature path, branch-free, one
//    pair of elements at a time behind an empty asm that also ties the
//    tile's bias and dbias addresses (without it the compiler hoisted a
//    64-bit address per element out of the walk and spilled them).
// Two named barriers a tile order the exchange box: the first finds both
// consumers' earlier dQ products complete, the second both halves of dS
// written. ptxas keeps the wgmma pipeline for the forward's reasons:
// products start with scale-d 0, roles and dropout are template arguments,
// each stage's products are committed in their own block, stage releases
// and the dbias stores are predicated instructions, and the zeros of dQ
// are fenced off from its products.
//
// D, Dv <= 512 (SPLIT false): one block holds all of D and Dv, 5 stages at
// D = Dv = 512.
//
// Wider heads (SPLIT true, D or Dv in (512, 1024]): Q and dO of 64 rows at
// D1024 (256 KB) fit no block, and a 64 x 512 fp32 dQ half is all a
// consumer's registers hold, so a cluster of two blocks (grid x = 2 Hq,
// the pair adjacent in x: the same block order) owns the 64 Q rows and
// splits both head dims: rank r holds the Q boxes of its half of D and the
// dO boxes of its half of Dv, resident (rank 0 the larger half; sm90.cuh
// col_block), and per KV tile streams only its K boxes (for S), its V
// boxes (for dP) and its K boxes again (for dQ), so every byte of Q, dO, K
// and V is read once per cluster, as one D512 block reads it. Consumer c
// of each rank computes a partial S over its rank's D boxes and a partial
// dP over its Dv boxes (64 x 32 fp32, 8 KB each), stores both into the
// shared memory of the partner's consumer c (st.async, completing their
// bytes on the partner's barrier; S as soon as its products complete, so
// its bytes travel under the dP products) and adds the partner's partials
// to its own. fp32 addition of two values is commutative, so both ranks
// hold bit-identical S and dP, and so the same P, dS and dropout mask,
// with no further exchange. Each rank writes the whole dS box and runs
// dQ[:, its half of D] += dS K over its own K boxes (consumer c owning
// ceil or floor of the rank's boxes, at most 4: 128 registers a thread, as
// at D512) and stores its own dQ columns. Rank 0 alone writes the dbias
// slab (its consumers the band, its producer warps 1..3 the zeros outside
// it), so each of its bytes has one writer. The exchange has one slot (the
// arithmetic is beside make_plan), so a rank stores tile t's partials only
// after the partner has read tile t - 1's: each thread that read its share
// of the slot arrives on the partner's "free" barrier (a remote arrive,
// release at cluster scope), which the storing consumer waits on with
// acquire. Both ranks walk the same KV tiles (the band depends on rows
// alone). A rank may hold no D box (D64 / Dv1024) or no Dv box (D1024 /
// Dv64): it sends zero partials of that product and, without D boxes,
// owns no dQ columns. The exchange addresses are formed once, before the
// products (the dK/dV cluster spilled in fp16 when they were formed after
// them). The cluster barrier at the start publishes the barriers'
// initialisation, the one at the end keeps a block alive while its partner
// may still store or arrive into it.
namespace dq {

using namespace ffpa::sm90;
using dkdv::Part;     // a block's first D box and D boxes, first Dv box and Dv boxes
using dkdv::part_of;  // alone everything; split, rank r's half (rank 0 the larger)

constexpr int ROWS = 64;                   // Q rows of a block
constexpr int KV_ROWS = 64;                // KV rows of a streamed tile
constexpr int COLS = 64;                   // columns of a box (128 B of 16-bit)
static_assert(KV_ROWS == CH, "kv_band aligns the band to the chunk width");
static_assert(COLS == dkdv::COLS, "part_of counts boxes of dkdv::COLS columns");
constexpr int MAX_BOXES = 8;               // D, Dv boxes of a block: D512, a rank's half of D1024
constexpr int MAX_HEAD_DIM = 2 * MAX_BOXES * COLS;  // D, Dv of either route
constexpr int Q_BOXES = MAX_BOXES / 2;     // D boxes of one consumer's dQ: 64 x 256 fp32
constexpr int STAGE_BYTES = 2 * BOX_BYTES;
constexpr int MAX_STAGES = 8;
constexpr int THREADS = 384;               // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMER_WARPS = 8;          // arrivals that free a stage
constexpr int CONSUMER_THREADS = 128;      // arrivals that free a consumer's exchange slot
constexpr int PART_BYTES = ROWS * 32 * 4;  // one consumer's partial S or dP (64 x 32 fp32)
constexpr int PART_BUF_BYTES = 2 * 2 * PART_BYTES;  // both consumers' S and dP: one slot
// The exchange's slot and its 4 barriers (landed and free, per consumer),
// padded to a 1024 B atom: on the cluster route they lead the layout, at
// offsets the compiler knows.
constexpr int XCH_BYTES = PART_BUF_BYTES + 1024;
constexpr int SMEM_LIMIT = 232448;
constexpr int WGMMA = 1, CLUSTER = 2;      // routes

// Shared memory of a block laid out for nd Q boxes and nv dO boxes, apart
// from the ring: Q, dO, the dS box, the 1024 B alignment, Q's barrier and,
// split, the exchange's slot and barriers. A ring stage is two boxes and
// its two barriers.
inline size_t fixed_bytes(int nd, int nv, bool split) {
  return (size_t)(nd + nv + 1) * BOX_BYTES + 1024 + sizeof(uint64_t) + (split ? XCH_BYTES : 0);
}
constexpr size_t STAGE_SMEM = STAGE_BYTES + 2 * sizeof(uint64_t);

// The route and tiling of a launch at head dims (D, Dv), multiples of 64
// up to 1024: D, Dv <= 512 take one block, wider heads the cluster; within
// a block (a rank) consumer 0 owns the first ceil(nd / 2) of its nd D
// boxes of dQ and consumer 1 the rest (sm90.cuh col_block), with as many
// ring stages (at most 8) as shared memory holds beside the rest: 5 at D =
// Dv = 512. Both ranks of a cluster lay out rank 0's share. At D = Dv =
// 1024 a rank's Q and dO take 16 boxes (128 KB), the dS box 8 KB and the
// exchange's slot 32 KB (2 consumers x (S + dP) x 8 KB) with its barriers
// in a 1 KB atom: with the alignment and Q's barrier 174,088 B, and 3
// stages of 16,400 B make 223,288 of the 232,448 a block may ask for. A
// second slot would leave room for 1 stage: one slot, and the "free"
// barriers. ffpa_bwd_dq_plan
// hands the plan out; ops/config.py dq_plan mirrors it and the card test
// holds the two equal.
//
// ring_cap > 0 caps the ring at that many stages (the autotune's knob). A
// consumer with one dQ box fewer frees its last K stage unread but keeps
// the stage of its last product into the next tile's S walk, so the walk
// needs MIN_STAGES.
constexpr int MIN_STAGES = 3;
struct Plan {
  int route, stages;
  Part part[2];  // each rank's share (the lone block's is part[0])
  size_t smem;
};
inline Plan make_plan(int D, int Dv, int ring_cap = 0) {
  const int nd = D / COLS, nv = Dv / COLS;
  const bool split = nd > MAX_BOXES || nv > MAX_BOXES;
  Plan pl;
  pl.route = split ? CLUSTER : WGMMA;
  pl.part[0] = part_of(nd, nv, split, 0);
  pl.part[1] = part_of(nd, nv, split, 1);
  const size_t fixed = fixed_bytes(pl.part[0].nd, pl.part[0].nv, split);
  pl.stages = (int)std::min((size_t)MAX_STAGES, (SMEM_LIMIT - fixed) / STAGE_SMEM);
  if (ring_cap > 0) pl.stages = std::min(pl.stages, ring_cap);
  pl.smem = fixed + pl.stages * STAGE_SMEM;
  return pl;
}

// The kernel's tensor maps, a __grid_constant__ parameter of their own (TMA
// reads them by address); the scalars stay an ordinary parameter.
struct Maps {
  CUtensorMap q_map, do_map;  // (D | Dv, nq, B * Hq); box 64 x 64
  CUtensorMap k_map, v_map;   // (D | Dv, nkv, B * Hkv); box 64 x 64
};

// Shared memory of a block, from a 1024 B boundary: split, the exchange's
// slot and its barriers (an atom); the Q boxes, the dO boxes, the dS box,
// the ring's stages, their full / empty barriers and the barrier of Q and
// dO. The exchange leads so that its addresses are constant offsets from
// the base: formed from the ring's extent they took registers the feature
// path needs (the non-dropout cluster spilled 8 B). Both ranks of a
// cluster lay it out alike (for rank 0's share), so an offset here is the
// same offset in the partner.
struct Smem {
  unsigned char* q;
  unsigned char* dout;
  unsigned char* ds;    // dS (softcap's factor included): [q][kv]
  unsigned char* ring;
  unsigned char* part;  // [2][2][PART_BYTES]: consumer c's partial S, dP from the partner
  uint64_t* full;
  uint64_t* empty;
  uint64_t* q_full;
  uint64_t* part_full;  // [2]: the partner's partials for consumer c have landed
  uint64_t* part_free;  // [2]: the partner's consumer c has read the partials sent to it
};
template <bool SPLIT>
__device__ __forceinline__ Smem carve(unsigned char* base, int nd, int nv, int stages) {
  Smem sm;
  sm.part = base;
  sm.part_full = reinterpret_cast<uint64_t*>(base + PART_BUF_BYTES);
  sm.part_free = sm.part_full + 2;
  sm.q = base + (SPLIT ? XCH_BYTES : 0);
  sm.dout = sm.q + nd * BOX_BYTES;
  sm.ds = sm.dout + nv * BOX_BYTES;
  sm.ring = sm.ds + BOX_BYTES;
  sm.full = reinterpret_cast<uint64_t*>(sm.ring + stages * STAGE_BYTES);
  sm.empty = sm.full + stages;
  sm.q_full = sm.empty + stages;
  return sm;
}

// A block's Q rows and the KV tiles of its band, [kv_lo, kv_lo + 64
// ntiles): the same in every thread and in both ranks of a cluster.
struct Block {
  int b, head, kvh, row0, kv_lo, ntiles;
};
template <bool SPLIT>
__device__ __forceinline__ Block block_of(const BwdParams& p) {
  Block k;
  k.head = SPLIT ? (int)(blockIdx.x >> 1) : (int)blockIdx.x;
  k.b = blockIdx.y;
  k.kvh = k.head / p.group;
  k.row0 = (gridDim.z - 1 - blockIdx.z) * ROWS;  // the longest causal rows start first
  int kv_hi;
  kv_band(p, k.row0, min(k.row0 + ROWS, p.nq) - 1, k.kv_lo, kv_hi);
  k.ntiles = kv_hi > k.kv_lo ? (kv_hi - k.kv_lo + KV_ROWS - 1) / KV_ROWS : 0;
  return k;
}

// The producer's thread: the block's Q and dO boxes once, then per KV tile
// the stages of its K boxes and of its V boxes (two boxes each, an odd last
// box alone), then the dQ stages (K box j of consumer 0's share beside box
// nd0 + j of consumer 1's, alone where that share is shorter).
__device__ __forceinline__ void produce(const Maps& maps, const BwdParams& p, const Smem& sm,
                                        const Block& k, int stages, const Part& pt, int nd0) {
  prefetch_map(&maps.q_map);
  prefetch_map(&maps.do_map);
  prefetch_map(&maps.k_map);
  prefetch_map(&maps.v_map);
  const int bq = k.b * p.Hq + k.head, bkv = k.b * p.Hkv + k.kvh;
  mbar_arrive_expect_tx(sm.q_full, (pt.nd + pt.nv) * BOX_BYTES);
  for (int j = 0; j < pt.nd; ++j)
    tma_load_3d(sm.q + j * BOX_BYTES, &maps.q_map, sm.q_full, (pt.d0 + j) * COLS, k.row0, bq);
  for (int j = 0; j < pt.nv; ++j)
    tma_load_3d(sm.dout + j * BOX_BYTES, &maps.do_map, sm.q_full, (pt.v0 + j) * COLS, k.row0,
                bq);
  int it = 0;
  // Stage it % stages, free again, expecting nb boxes.
  auto claim = [&](int nb) -> unsigned char* {
    const int st = it % stages;
    if (it >= stages) mbar_wait(&sm.empty[st], ((it / stages) - 1) & 1);
    mbar_arrive_expect_tx(&sm.full[st], nb * BOX_BYTES);
    return sm.ring + st * STAGE_BYTES;
  };
  auto run = [&](const CUtensorMap* map, int first, int n, int kv0) {
    for (int c = 0; c < n; c += 2, ++it) {
      const int nb = min(2, n - c);
      unsigned char* dst = claim(nb);
      for (int g = 0; g < nb; ++g)
        tma_load_3d(dst + g * BOX_BYTES, map, &sm.full[it % stages], (first + c + g) * COLS, kv0,
                    bkv);
    }
  };
  for (int t = 0; t < k.ntiles; ++t) {
    const int kv0 = k.kv_lo + t * KV_ROWS;
    run(&maps.k_map, pt.d0, pt.nd, kv0);
    run(&maps.v_map, pt.v0, pt.nv, kv0);
    for (int j = 0; j < nd0; ++j, ++it) {
      const bool both = nd0 + j < pt.nd;
      unsigned char* dst = claim(both ? 2 : 1);
      tma_load_3d(dst, &maps.k_map, &sm.full[it % stages], (pt.d0 + j) * COLS, kv0, bkv);
      if (both)
        tma_load_3d(dst + BOX_BYTES, &maps.k_map, &sm.full[it % stages],
                    (pt.d0 + nd0 + j) * COLS, kv0, bkv);
    }
  }
}

// Warps 1..3 of the producer warpgroup (of rank 0 on the cluster): zeros
// over the block's 64 rows of the dbias slab in the columns outside the
// band's tiles, [0, kv_lo) and [kv_lo + 64 ntiles, ds_ld), 16 B a store.
__device__ __forceinline__ void zero_dbias_outside(const BwdParams& p, const Block& k) {
  const int u = threadIdx.x - 32, n = 96;
  const int lo4 = k.kv_lo / 4, hi = k.kv_lo + k.ntiles * KV_ROWS;
  const int per_row = lo4 + (p.ds_ld - hi) / 4;
  float* dst = p.dbias + ((long long)(k.b * p.Hq + k.head) * p.ds_rows + k.row0) * p.ds_ld;
  for (int i = u; i < ROWS * per_row; i += n) {
    const int r = i / per_row, c4 = i - r * per_row;
    const int col = c4 < lo4 ? 4 * c4 : hi + 4 * (c4 - lo4);
    *reinterpret_cast<float4*>(dst + (long long)r * p.ds_ld + col) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Two fp32 values to global memory where pred is set, without a branch (a
// predicated instruction).
__device__ __forceinline__ void st_global_f2_if(float* dst, float a, float b, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\n@p st.global.v2.f32 [%0], {%1, %2};\n}\n" ::"l"(
          dst),
      "f"(a), "f"(b), "r"((int)pred)
      : "memory");
}

// dS of one score element on the feature path from its raw q.k and dp:
// (dS times softcap's chain factor, dS). Branch-free: softcap's tanh and
// factor are selected away where softcap is 0, ALiBi's slope is 0 without
// ALiBi, the bias (at bias_at) is read only inside the ragged edges, masks
// select MASK_VALUE, and rows past Nq or columns past Nkv give 0.
template <bool DROP>
__device__ __forceinline__ float2 ds_feature(const BwdParams& p, int b, int h, int row, int col,
                                             float qk, float dpv, float lse2, float dl,
                                             float slope, float inv_cap, const float* bias_at) {
  constexpr float LOG2E = 1.4426950408889634f;
  float x = qk * p.scale;
  const float th = tanhf(x * inv_cap);
  const bool capped = p.softcap > 0.f;
  const float cap = capped ? 1.f - th * th : 1.f;
  x = capped ? p.softcap * th : x;
  const int rel = row + p.causal_offset - col;
  x -= slope * fabsf((float)rel);
  const bool in = row < p.nq && col < p.nkv;
  if (p.bias != nullptr && in) x += *bias_at;
  const bool masked = (p.window_right >= 0 && -rel > p.window_right) ||
                      (p.window_left >= 0 && rel > p.window_left);
  x = masked ? MASK_VALUE : x;
  const float pe = in ? ex2(fmaf(x, LOG2E, -lse2)) : 0.f;
  float dpe = dpv;
  if constexpr (DROP) {
    const bool keep =
        dropout_uniform(p.seed, b, h, row + p.row_offset, col + p.col_offset) >= p.dropout_p;
    dpe = keep ? dpv * p.dropout_inv : 0.f;
  }
  const float ds = pe * (dpe - dl);
  return make_float2(ds * cap, ds);
}

// Consumer C of a block; C, DROP and SPLIT are template arguments so that
// no branch around a wgmma depends on the thread. Accumulator element 4 j
// + 2 hh + e of thread (warp, g = lane / 4, t4 = lane % 4) of S and dP is
// Q row 16 warp + g + 8 hh, KV column 32 C + 8 j + 2 t4 + e of the tile;
// of dQ's box jj, Q row 16 warp + g + 8 hh, column 8 j + 2 t4 + e of the
// box. pt is the block's share of the head dims, nd0 consumer 0's D boxes
// of it; rank the block's rank (0 alone), which alone writes dbias.
template <typename T, int C, bool DROP, bool SPLIT>
__device__ __forceinline__ void consume(const BwdParams& p, const Smem& sm, const Block& k,
                                        int stages, const Part& pt, int nd0, int rank) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // The block's box counts (D, Dv, consumer 0's D boxes) and its rank in
  // one register, unpacked where they are used; on the cluster route it
  // goes behind an empty asm each time, so the rank's values are not held
  // apart beside the dQ accumulators (held apart they spilled).
  const uint32_t counts = pt.nd | pt.nv << 8 | nd0 << 16 | rank << 24;
  auto count = [&](int field) -> int {
    uint32_t x = counts;
    if constexpr (SPLIT) asm volatile("" : "+r"(x));
    return (int)((x >> (8 * field)) & 255u);
  };
  const int r0 = 16 * warp + g;             // this thread's rows: r0, r0 + 8
  constexpr float LOG2E = 1.4426950408889634f;
  // The block's (batch, head) row of lse and delta, formed where it is
  // used; on the cluster route behind an empty asm (a 64-bit value held
  // across the walk spilled).
  auto head_row = [&]() -> long long {
    int x = k.b * p.Hq + k.head;
    if constexpr (SPLIT) asm volatile("" : "+r"(x));
    return x;
  };
  const bool plain = !DROP && p.bias == nullptr && p.alibi == nullptr && p.softcap <= 0.f;
  // scale log2 e, the ALiBi slope and 1 / softcap. One block forms them
  // once for its walk (the _w values); a rank of the cluster at each tile,
  // and not before the walk at all (held across its walk, or formed before
  // it, they spilled with dropout).
  const float scale_log2_w = SPLIT ? 0.f : p.scale * LOG2E;
  const float slope_w = SPLIT ? 0.f : (p.alibi != nullptr ? p.alibi[head_row()] : 0.f);
  const float inv_cap_w = SPLIT ? 0.f : (p.softcap > 0.f ? __fdividef(1.f, p.softcap) : 0.f);
  // Split: element 4 i + e of thread tid's partial S sits at (i * 128 +
  // tid) * 16 + 4 e bytes of its consumer's S slot, and its partial dP as
  // far into the dP slot PART_BYTES on; a thread reads back what the
  // partner's thread tid stored. The addresses are formed where they are
  // used, as the dK/dV cluster forms them, at constant offsets from the
  // base (held across the walk they spilled).
  auto slot = [&]() { return cvta_smem(sm.part) + C * 2 * PART_BYTES + tid * 16; };

  // lse (times log2 e) and delta of this thread's two rows. One block
  // loads them once for its walk; a rank of the cluster at each tile, after
  // the exchange (held across its walk, they spilled).
  float lse2[2], dl[2];
  auto load_rows = [&]() {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = k.row0 + r0 + 8 * hh;
      const bool ok = row < p.nq;
      const long long at = head_row() * p.nq + row;
      lse2[hh] = ok ? p.lse[at] * LOG2E : 0.f;
      dl[hh] = ok ? p.delta[at] : 0.f;
    }
  };
  if constexpr (!SPLIT) load_rows();
  const bool emit = p.dbias != nullptr && rank == 0;

  // Every ordinary write of an accumulator is fenced off from the wgmma
  // that follows, or ptxas serializes the pipeline.
  float acc[Q_BOXES * 32];
#pragma unroll
  for (int i = 0; i < Q_BOXES * 32; ++i) acc[i] = 0.f;
  fence_operands(acc);

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
  auto wait_full = [&](int st) { mbar_wait(&sm.full[st], (it / stages) & 1); };
  // S or dP for this consumer's 32 KV columns over n resident boxes: the
  // stages of two boxes, then an odd last box alone (a conditional wgmma
  // inside a stage would make ptxas serialize), each committed beside its
  // products.
  auto stream = [&](float(&a)[16], const unsigned char* res, int n) {
    int c = 0;
    for (; c + 2 <= n; c += 2, ++it) {
      const int st = it % stages;
      const unsigned char* sb = sm.ring + st * STAGE_BYTES + C * 4096;
      wait_full(st);
      wgmma_fence();
      box_mma<T, 32, 0>(a, res + c * BOX_BYTES, sb, c == 0);
      box_mma<T, 32, 0>(a, res + (c + 1) * BOX_BYTES, sb + BOX_BYTES);
      done_with(st);
    }
    if (c < n) {
      const int st = it % stages;
      wait_full(st);
      wgmma_fence();
      box_mma<T, 32, 0>(a, res + c * BOX_BYTES, sm.ring + st * STAGE_BYTES + C * 4096, c == 0);
      done_with(st);
      ++it;
    }
  };
  // Split: this rank's partial a (zeros where the rank holds no box of the
  // product) into the partner's slot at off.
  auto send = [&](float(&a)[16], int n, uint32_t off) {
    const uint32_t there = mapa(slot() + off, count(3) ^ 1);
    const uint32_t there_bar = mapa(cvta_smem(&sm.part_full[C]), count(3) ^ 1);
#pragma unroll
    for (int i = 0; i < 16; ++i) a[i] = n > 0 ? a[i] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) st_async_v4(there + i * 2048, a + 4 * i, there_bar);
  };

  mbar_wait(sm.q_full, 0);
  for (int t = 0; t < k.ntiles; ++t) {
    const int kc = k.kv_lo + t * KV_ROWS + 32 * C;  // this consumer's first KV column
    const float scale_log2 = SPLIT ? p.scale * LOG2E : scale_log2_w;
    const float slope = SPLIT ? (p.alibi != nullptr ? p.alibi[head_row()] : 0.f) : slope_w;
    const float inv_cap = SPLIT ? (p.softcap > 0.f ? __fdividef(1.f, p.softcap) : 0.f) : inv_cap_w;
    float s[16], dp[16];
    stream(s, sm.q, count(0));
    if constexpr (SPLIT) {
      drain();  // also completes this consumer's dQ products of the tile before
      fence_operands(s);
      // The partner has read tile t - 1's partials (at t = 0 the wait for
      // parity 1 of a fresh barrier returns at once). S goes out before
      // the dP products, so its bytes travel under them.
      mbar_wait_cluster(&sm.part_free[C], (t + 1) & 1);
      send(s, count(0), 0);
    }
    stream(dp, sm.dout, count(1));
    drain();  // also completes this consumer's dQ products of the tile before
    fence_operands(s);
    fence_operands(dp);

    if constexpr (SPLIT) {
      // S and dP = this rank's partials + the partner's, the same bits in
      // both ranks.
      send(dp, count(1), PART_BYTES);
      mbar_arrive_expect_tx_if(&sm.part_full[C], 2 * PART_BYTES, tid == 0);
      mbar_wait_cluster(&sm.part_full[C], t & 1);
      const uint32_t mine = slot();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x[4], y[4];
        lds_v4(mine + i * 2048, x);
        lds_v4(mine + PART_BYTES + i * 2048, y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * i + e] += x[e];
          dp[4 * i + e] += y[e];
        }
      }
      mbar_arrive_cluster(mapa(cvta_smem(&sm.part_free[C]), count(3) ^ 1));
      fence_operands(s);
      fence_operands(dp);
      load_rows();
    }

    const bool interior =
        plain && k.row0 + ROWS - 1 < p.nq && kc + 31 < p.nkv &&
        (p.window_right < 0 || kc + 31 <= k.row0 + p.causal_offset + p.window_right) &&
        (p.window_left < 0 || kc >= k.row0 + ROWS - 1 + p.causal_offset - p.window_left);
    // This tile's dbias address at (row r0, column kc + 2 t4), formed here
    // and hidden from the compiler by the empty asm: otherwise it hoists a
    // 64-bit address for each element out of the walk and spills them. The
    // slab's rows cover the block's.
    float* dtile = p.dbias + (head_row() * p.ds_rows + k.row0 + r0) * p.ds_ld + kc + 2 * t4;
    asm volatile("" : "+l"(dtile));
    uint32_t dw[8];
    if (interior) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float dsv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * hh + e;
            dsv[e] = ex2(fmaf(s[idx], scale_log2, -lse2[hh])) * (dp[idx] - dl[hh]);
          }
          dw[2 * j + hh] = pack2<T>(dsv[0], dsv[1]);
          st_global_f2_if(dtile + 8 * hh * p.ds_ld + 8 * j, dsv[0], dsv[1], emit);
        }
    } else {
      // The bias at (row r0, column kc + 2 t4), formed per tile like dtile.
      const float* btile = p.bias + (long long)k.b * p.sb + (long long)k.head * p.sh +
                           (long long)(k.row0 + r0) * p.sr + (long long)(kc + 2 * t4) * p.sc;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          // One pair at a time: the empty asm ties the pair's scores, its
          // first column and the tile's addresses, so nothing of the pair
          // (addresses, bias loads, the dropout hash) is computed before the
          // pair before is stored, and the feature code's registers are
          // needed once, not 16 times beside the 128 of dQ.
          const int i0 = 4 * j + 2 * hh;
          int col = kc + 8 * j + 2 * t4;
          asm volatile("" : "+f"(s[i0]), "+f"(s[i0 + 1]), "+f"(dp[i0]), "+f"(dp[i0 + 1]),
                       "+r"(col), "+l"(btile), "+l"(dtile));
          // On the cluster route the row goes behind an asm too, so the
          // dropout hash of the row is formed per pair (two rows' hashes
          // held across the walk spilled).
          int row = k.row0 + r0 + 8 * hh;
          if constexpr (SPLIT) asm volatile("" : "+r"(row));
          float2 d2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            d2[e] = ds_feature<DROP>(p, k.b, k.head, row, col + e, s[i0 + e], dp[i0 + e],
                                     lse2[hh], dl[hh], slope, inv_cap,
                                     btile + 8 * hh * p.sr + (long long)(8 * j + e) * p.sc);
          dw[2 * j + hh] = pack2<T>(d2[0].x, d2[1].x);
          st_global_f2_if(dtile + 8 * hh * p.ds_ld + 8 * j, d2[0].y, d2[1].y, emit);
        }
    }
    // Both consumers have completed the tile before's dQ products: the dS
    // box is free.
    named_barrier_sync(1, 2 * 128);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(sm.ds + swz(r0 + 8 * hh, 32 * C + 8 * j + 2 * t4)) =
            dw[2 * j + hh];
    fence_proxy_async();
    named_barrier_sync(1, 2 * 128);  // both halves of dS are in the box

    // dQ[:, own boxes] += dS K: dQ stage j holds this consumer's K box j at
    // C * BOX_BYTES; a consumer with fewer boxes frees the stage unread.
    const int nd0_t = count(2), own = C == 0 ? nd0_t : count(0) - nd0_t;
#pragma unroll
    for (int j = 0; j < Q_BOXES; ++j) {
      if (j < nd0_t) {
        const int st = it % stages;
        wait_full(st);
        if (j < own) {
          wgmma_fence();
          box_mma<T, 64, 1>(*reinterpret_cast<float(*)[32]>(acc + 32 * j), sm.ds,
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
  fence_operands(acc);

  // Epilogue: dQ = scale * sum, in the output type or fp32; rows past Nq
  // are not stored.
  const int d0 = SPLIT ? part_of(p.D / COLS, p.Dv / COLS, true, count(3)).d0 : 0;
  const int nd0_e = count(2), own = C == 0 ? nd0_e : count(0) - nd0_e;
  const int col0 = (d0 + (C == 0 ? 0 : nd0_e)) * COLS;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = k.row0 + r0 + 8 * hh;
    if (row >= p.nq) continue;
    const long long base = (head_row() * p.nq + row) * p.D + col0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < Q_BOXES; ++j) {
      if (j >= own) break;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8)
        store2<T>(p.dq, base + COLS * j + 8 * j8, acc[32 * j + 4 * j8 + 2 * hh] * p.scale,
                  acc[32 * j + 4 * j8 + 2 * hh + 1] * p.scale, p.out_f32);
    }
  }
}

template <typename T, bool DROP, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
    wgmma_dq_kernel(const __grid_constant__ Maps maps, const BwdParams p, const int stages) {
  extern __shared__ unsigned char smem_raw[];
  // Boxes on 1024 B boundaries: the 128 B swizzle's atom. On the cluster
  // route the offset is added to the shared array itself, so every pointer
  // into it stays a 32-bit shared one (the forward's cluster spilled a
  // 64-bit generic one beside its accumulators).
  unsigned char* base;
  if constexpr (SPLIT)
    base = smem_raw + ((1024 - (cvta_smem(smem_raw) & 1023)) & 1023);
  else
    base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int rank = SPLIT ? (int)cluster_rank() : 0;
  const int nd = p.D / COLS, nv = p.Dv / COLS;
  const Part pt = part_of(nd, nv, SPLIT, rank);
  const Part lay = part_of(nd, nv, SPLIT, 0);  // both ranks alike
  const int nd0 = sm90::col_block(pt.nd, 2, 0).nc;
  const Smem sm = carve<SPLIT>(base, lay.nd, lay.nv, stages);
  const Block k = block_of<SPLIT>(p);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMER_WARPS);
    }
    mbar_init(sm.q_full, 1);
    if constexpr (SPLIT)
      for (int c = 0; c < 2; ++c) {
        mbar_init(&sm.part_full[c], 1);
        mbar_init(&sm.part_free[c], CONSUMER_THREADS);
      }
    fence_barrier_init();
  }
  // The partner's barriers are initialised before this block's first
  // store into its shared memory.
  if constexpr (SPLIT)
    cluster_sync();
  else
    __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0)
      produce(maps, p, sm, k, stages, pt, nd0);
    else if (threadIdx.x >= 32 && p.dbias != nullptr && rank == 0)
      zero_dbias_outside(p, k);
  } else {
    setmaxnreg_inc<240>();
    if (threadIdx.x < 256)
      consume<T, 0, DROP, SPLIT>(p, sm, k, stages, pt, nd0, rank);
    else
      consume<T, 1, DROP, SPLIT>(p, sm, k, stages, pt, nd0, rank);
  }
  if constexpr (SPLIT) cluster_sync();  // the partner may still store or arrive into this block
}

// The host side of one launch: tensor maps, shared memory, the grid (on
// the cluster route the pair of each head adjacent along x).
template <typename T, bool SPLIT>
cudaError_t launch(const BwdParams& p, const Plan& pl, int B, cudaStream_t stream) {
  const dim3 grid((SPLIT ? 2 : 1) * p.Hq, B, (p.nq + ROWS - 1) / ROWS);
  if (grid.x * grid.y * grid.z == 0) return cudaSuccess;
  const bool f16 = std::is_same<T, __half>::value;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const uint64_t mkv = p.nkv > 0 ? p.nkv : 1;
  cudaError_t e = encode_3d(&maps.q_map, f16, p.q, p.D, p.nq, (uint64_t)B * p.Hq,
                            (uint64_t)p.D * 2, (uint64_t)p.nq * p.D * 2, COLS, ROWS);
  if (e == cudaSuccess)
    e = encode_3d(&maps.do_map, f16, p.dout, p.Dv, p.nq, (uint64_t)B * p.Hq,
                  (uint64_t)p.Dv * 2, (uint64_t)p.nq * p.Dv * 2, COLS, ROWS);
  if (e == cudaSuccess)
    e = encode_3d(&maps.k_map, f16, p.k, p.D, mkv, (uint64_t)B * p.Hkv, (uint64_t)p.D * 2,
                  mkv * p.D * 2, COLS, KV_ROWS);
  if (e == cudaSuccess)
    e = encode_3d(&maps.v_map, f16, p.v, p.Dv, mkv, (uint64_t)B * p.Hkv, (uint64_t)p.Dv * 2,
                  mkv * p.Dv * 2, COLS, KV_ROWS);
  if (e != cudaSuccess) return e;
  auto kern =
      p.dropout_p > 0.f ? wgmma_dq_kernel<T, true, SPLIT> : wgmma_dq_kernel<T, false, SPLIT>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (e != cudaSuccess) return e;
  if constexpr (SPLIT) {
    return launch_cluster(kern, grid, THREADS, pl.smem, stream, 2, maps, p, pl.stages);
  } else {
    kern<<<grid, THREADS, pl.smem, stream>>>(maps, p, pl.stages);
    return cudaGetLastError();
  }
}

template <bool SPLIT>
cudaError_t launch_typed(bool f16, const BwdParams& p, const Plan& pl, int B,
                         cudaStream_t stream) {
  return f16 ? launch<__half, SPLIT>(p, pl, B, stream)
             : launch<__nv_bfloat16, SPLIT>(p, pl, B, stream);
}

}  // namespace dq

// ---------------------------------------------------------------------------
// dK / dV from the S residual, dK out of the kernel: TMA + mbarrier +
// wgmma, one block (Dv <= 512) or a cluster of two (Dv in (512, 1024])
// ---------------------------------------------------------------------------

// The Hopper route of ffpa_bwd_dkdv_from_s with dK out of the kernel (the
// pass the S-resident training step launches; ffpa_attn_tpu/ops/flash_bwd.py
// _dkdv_from_s_kernel with dk_in_kernel=False). Bound on an H100:
// operations, 2 matmul units (dP^T, dV) of 2 * pairs * Dv flop, with the
// bytes close behind (S read and dS written on the band, zeros above it).
// The design keeps dO to one load a tile and the zeros off the consumers'
// path; what holds it at ~3.2x its bound is the consumers' lockstep: no
// product is in flight during the elementwise step (PERF.md).
//
// It is the forward's wgmma block (flash_fwd.cu namespace fwd) with the
// roles renamed: V is resident where Q was, dP^T = V dO^T takes the place
// of S = Q K^T, P = exp(S - lse) from the slab that of the softmax (lse is
// known: no running maximum, no rescale, no exchange of maxima), dV +=
// P^T dO that of O += P V. A block of 384 threads owns 64 KV rows of one
// KV head and walks the GQA group's 64-row Q tiles of the band (group
// member outer); the grid goes KV tiles first, so under causal the longest
// blocks start first:
//  - warpgroup 0 is the producer (setmaxnreg 40). One thread loads V once
//    by TMA into Dv / 64 resident 64 x 64 boxes (128 B swizzle), then per Q
//    tile streams the slab's S box (64 q x 64 kv, through a tensor map at
//    the slab's extents, so rows past ds_rows read as 0) in a stage of its
//    own, then the Dv / 64 dO boxes in two-box stages, box j of consumer
//    0's half of Dv beside box j of consumer 1's. Each dO box feeds both
//    products (K-major for dP^T, N-major for dV): one load a tile. Warps
//    1..3 meanwhile write the zeros of the Q tiles above the band over the
//    block's 64 slab columns, half the bytes the pass writes at the
//    training shape, while the consumers' products run;
//  - warpgroups 1 and 2 are the consumers (setmaxnreg 232). Consumer c
//    computes dP^T for Q columns 32c..32c+31 (wgmma m64n32k16 over Dv: the
//    V box K-major, rows 32c.. of each dO box K-major) and reads S at the
//    accumulator's (kv, q) coordinates from the [q][kv] S box with
//    ldmatrix.trans (conflict-free on the swizzle). It forms p, the dropped
//    p and dS = p (dP - delta) (softcap's factor included), re-masking the
//    band by selection: outside it the slab may hold anything, NaN
//    included. Its half of P^T goes into the swizzled [kv][q] P box, its
//    half of dS into the [q][kv] dS box (stmatrix.trans). After a named
//    barrier each runs dV[:, own half of Dv] += P^T dO (m64n64k16 a box,
//    the dO box N-major with the transpose bit; 128 fp32 registers a thread
//    at Dv 512) and, while the products run, copies the dS box over the S
//    tile of the slab (16 B a thread, rows below ds_rows). A dO stage is
//    freed once both consumers' dV products completed.
// In place across proxies: the S tile is read by TMA, and the stores of dS
// over it come after the consumers waited on that load's barrier. Exactly
// one block owns each slab tile; the tiles above the band are never read,
// so their zeros race nothing. ptxas keeps the wgmma pipeline for the
// forward's reasons: products start with scale-d 0, roles (and dropout)
// are template arguments, each stage's products are committed in their
// own block, stage releases and the slab stores under wgmma are predicated
// instructions, and the zeros of dV are fenced off from its products.
//
// Dv <= 512 (SPLIT false): one block holds all of Dv, 9 stages at Dv 512.
//
// Wider Dv (SPLIT true, Dv in (512, 1024]; every bf16 S-resident backward
// above D512): a 64 x 1024 V tile (128 KB) leaves too little room for the
// ring, and a 64 x 512 fp32 dV half is all a consumer's registers hold, so
// a cluster of two blocks (grid x = 2 x KV tiles, the pair adjacent in x:
// the same block order) owns the 64 KV rows and splits Dv: rank r holds
// the V boxes of its half of Dv resident (rank 0 the larger; sm90.cuh
// col_block) and per Q tile streams only the dO boxes of that half, plus
// the S box, which both ranks load; every byte of V and dO is read once
// per cluster. Consumer c of each rank computes a partial dP^T over its
// rank's Dv boxes (64 x 32 fp32, 8 KB), stores it into the shared memory
// of the partner's consumer c (st.async, completing its bytes on the
// partner's barrier) and adds the partner's partial to its own. fp32
// addition of two values is commutative, so both ranks hold bit-identical
// dP^T, and so the same P, dS and dropout mask, with no second exchange.
// Each rank then runs dV[:, its half] += P^T dO on its own dO boxes (at
// most 4 a consumer: 128 registers a thread, as at Dv 512) and stores its
// own dV columns. Only dP^T crosses the pair: S is read from the slab, not
// recomputed, and no K or Q is resident.
// The exchange is double-buffered (32 KB; 7 stages at Dv 1024 beside a
// rank's 8 V boxes): a rank stores into slot t % 2 at tile t only after it
// received the partner's tile t - 1, which the partner stored after
// reading its slot of tile t - 2, so no slot is overwritten unread.
// The in-place write and the partner's read of the same S tile: rank 0
// alone writes dS over the slab (and the zero tiles above the band), and a
// consumer sends its partial of tile t only after it waited on its own S
// box's barrier for tile t (that TMA load has landed). Rank 0 forms dS of
// tile t only after both of its consumers received the partner's partials
// of tile t, so its stores come after rank 1's read of that tile. Both
// ranks walk the same Q tiles (the band depends on KV rows alone). The
// cluster barrier at the start publishes the barriers' initialisation, the
// one at the end keeps a block alive while its partner may still store
// into it.
namespace from_s {

using namespace ffpa::sm90;

constexpr int ROWS = 64;                 // KV rows of a block
constexpr int QROWS = 64;                // Q rows of a streamed tile
constexpr int COLS = 64;                 // columns of a box (128 B of 16-bit)
constexpr int MAX_BOXES = 8;             // Dv boxes of a block: Dv 512, a rank's half of Dv 1024
constexpr int V_BOXES = MAX_BOXES / 2;   // Dv boxes of one consumer's dV: 64 x 256 fp32
constexpr int STAGE_BYTES = 2 * BOX_BYTES;
constexpr int MAX_STAGES = 12;
constexpr int THREADS = 384;             // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMER_WARPS = 8;        // arrivals that free a stage
constexpr int PART_BYTES = ROWS * 32 * 4;  // one consumer's partial dP^T (64 x 32 fp32)
constexpr int PART_SLOTS = 2;            // the exchange is double-buffered
constexpr int XCH_BYTES = PART_SLOTS * 2 * PART_BYTES;  // both consumers, both slots
constexpr int SMEM_LIMIT = 232448;
constexpr int MMA_SYNC = 0, WGMMA = 1, CLUSTER = 2;  // routes

// A block's share of Dv: its first Dv box and its Dv boxes. Alone a block
// holds everything; split, rank r holds half, rank 0 the larger half.
struct Part {
  int v0, nv;
};
__host__ __device__ inline Part part_of(int nv, bool split, int rank) {
  if (!split) return {0, nv};
  const Cols c = col_block(nv, 2, rank);
  return {c.c0 / COLS, c.nc};
}

// Shared memory of a block laid out for nv V boxes, apart from the ring:
// V, the P and dS boxes, the 1024 B alignment, V's barrier and, split, the
// exchange's slots and their barriers. A ring stage is two boxes and its
// two barriers.
inline size_t fixed_bytes(int nv, bool split) {
  return (size_t)(nv + 2) * BOX_BYTES + 1024 + sizeof(uint64_t) +
         (split ? (size_t)XCH_BYTES + PART_SLOTS * 2 * sizeof(uint64_t) : 0);
}
constexpr size_t STAGE_SMEM = STAGE_BYTES + 2 * sizeof(uint64_t);

// The route and tiling of a from-S launch at value head dim Dv (a multiple
// of 64): dK out of the kernel takes this block at Dv <= 512 and its
// cluster of two up to Dv 1024; within a block (a rank) consumer 0 owns
// the first ceil(nv / 2) of its nv Dv boxes and consumer 1 the rest, with
// as many ring stages as shared memory holds beside the rest (a tile
// takes 1 + ceil(nv / 2) stages: 9 at Dv 512 hold 1.8 tiles; both ranks
// lay out rank 0's share, 7 at Dv 1024 hold 1.4). dK in the kernel takes
// the mma.sync dkdv_from_s_kernel. ffpa_bwd_from_s_plan hands it out;
// ops/config.py from_s_plan mirrors it and the card test holds the two
// equal.
//
// ring_cap > 0 caps the wgmma routes' ring at that many stages (the
// autotune's knob; the mma.sync route takes none). A tile holds its S stage
// and its ceil(nv / 2) dO stages at once (rank 0's share on the cluster,
// the larger), so the walk needs min_stages of them.
struct Plan {
  int route, kv_rows, q_rows, stages;
  Part part[2];  // each rank's share (the lone block's is part[0])
  size_t smem;
};
inline int min_stages(const Plan& pl) { return 1 + (pl.part[0].nv + 1) / 2; }
inline Plan make_plan(int Dv, bool dk_in, int ring_cap = 0) {
  Plan pl;
  const int nv = Dv / COLS;
  if (!dk_in && nv <= 2 * MAX_BOXES) {
    const bool split = nv > MAX_BOXES;
    pl.route = split ? CLUSTER : WGMMA;
    pl.kv_rows = ROWS;
    pl.q_rows = QROWS;
    pl.part[0] = part_of(nv, split, 0);
    pl.part[1] = part_of(nv, split, 1);
    const size_t fixed = fixed_bytes(pl.part[0].nv, split);
    pl.stages = (int)std::min((size_t)MAX_STAGES, (SMEM_LIMIT - fixed) / STAGE_SMEM);
    if (ring_cap > 0) pl.stages = std::min(pl.stages, ring_cap);
    pl.smem = fixed + pl.stages * STAGE_SMEM;
  } else {
    pl.route = MMA_SYNC;
    pl.kv_rows = KVT;
    pl.q_rows = QT;
    pl.stages = NST;
    pl.part[0] = pl.part[1] = {0, nv};
    pl.smem = from_s_smem_bytes(Dv);
  }
  return pl;
}

// The kernel's tensor maps, a __grid_constant__ parameter of their own (TMA
// reads them by address); the scalars stay an ordinary parameter.
struct Maps {
  CUtensorMap s_map;   // the slab: (ds_ld, ds_rows, B * Hq); box 64 x 64
  CUtensorMap do_map;  // dO: (Dv, nq, B * Hq); box 64 x 64
  CUtensorMap v_map;   // V: (Dv, nkv, B * Hkv); box 64 x 64
};

// Shared memory of a block, from a 1024 B boundary: the V boxes, the P and
// dS boxes, the ring's stages, the exchange's slots (split), their full /
// empty barriers, V's barrier and the exchange's barriers (split). Both
// ranks of a cluster lay it out alike (for rank 0's share), so an offset
// here is the same offset in the partner.
struct Smem {
  unsigned char* v;
  unsigned char* p;     // P^T (dropped): [kv][q]
  unsigned char* ds;    // dS: [q][kv], the slab's layout
  unsigned char* ring;
  unsigned char* part;  // [slot][consumer][PART_BYTES]: the partner's partial dP^T
  uint64_t* full;
  uint64_t* empty;
  uint64_t* v_full;
  uint64_t* part_full;  // [slot][consumer]: the partner's partial has landed
};
template <bool SPLIT>
__device__ __forceinline__ Smem carve(unsigned char* base, int nv, int stages) {
  Smem sm;
  sm.v = base;
  sm.p = base + nv * BOX_BYTES;
  sm.ds = sm.p + BOX_BYTES;
  sm.ring = sm.ds + BOX_BYTES;
  sm.part = sm.ring + stages * STAGE_BYTES;
  sm.full = reinterpret_cast<uint64_t*>(sm.part + (SPLIT ? XCH_BYTES : 0));
  sm.empty = sm.full + stages;
  sm.v_full = sm.empty + stages;
  sm.part_full = sm.v_full + 1;
  return sm;
}

// A block's KV rows and the Q tiles of its band, [i_lo, i_lo + ni) of
// every group member (64-row tiles of ds_rows): the same in every thread
// and in both ranks of a cluster.
struct Block {
  int b, kvh, kv0, i_lo, ni, ntiles;
};
template <bool SPLIT>
__device__ __forceinline__ Block block_of(const BwdParams& p) {
  Block k;
  k.kv0 = (SPLIT ? (int)(blockIdx.x >> 1) : (int)blockIdx.x) * ROWS;
  k.kvh = blockIdx.y;
  k.b = blockIdx.z;
  const int nqt = (p.ds_rows + QROWS - 1) / QROWS;
  k.i_lo = p.window_right >= 0
               ? max(0, floordiv(k.kv0 - p.causal_offset - p.window_right, QROWS))
               : 0;
  k.ni = max(0, nqt - k.i_lo);
  k.ntiles = p.group * k.ni;
  return k;
}

// The producer's thread: the block's V boxes once, then per Q tile the S
// stage and the dO stages of its share of Dv (box j and box nv0 + j of the
// share, alone where consumer 1's half is shorter).
__device__ __forceinline__ void produce(const Maps& maps, const BwdParams& p, const Smem& sm,
                                        const Block& k, int stages, const Part& pt, int nv0) {
  prefetch_map(&maps.s_map);
  prefetch_map(&maps.do_map);
  prefetch_map(&maps.v_map);
  const int bkv = k.b * p.Hkv + k.kvh;
  mbar_arrive_expect_tx(sm.v_full, pt.nv * BOX_BYTES);
  for (int j = 0; j < pt.nv; ++j)
    tma_load_3d(sm.v + j * BOX_BYTES, &maps.v_map, sm.v_full, (pt.v0 + j) * COLS, k.kv0, bkv);
  int it = 0;
  // Stage it % stages, free again, expecting nb boxes.
  auto claim = [&](int nb) -> unsigned char* {
    const int st = it % stages;
    if (it >= stages) mbar_wait(&sm.empty[st], ((it / stages) - 1) & 1);
    mbar_arrive_expect_tx(&sm.full[st], nb * BOX_BYTES);
    return sm.ring + st * STAGE_BYTES;
  };
  for (int t = 0; t < k.ntiles; ++t) {
    const int bh = k.b * p.Hq + k.kvh * p.group + t / k.ni, q0 = (k.i_lo + t % k.ni) * QROWS;
    unsigned char* dst = claim(1);
    tma_load_3d(dst, &maps.s_map, &sm.full[it % stages], k.kv0, q0, bh);
    ++it;
    for (int j = 0; j < nv0; ++j, ++it) {
      const bool both = nv0 + j < pt.nv;
      dst = claim(both ? 2 : 1);
      tma_load_3d(dst, &maps.do_map, &sm.full[it % stages], (pt.v0 + j) * COLS, q0, bh);
      if (both)
        tma_load_3d(dst + BOX_BYTES, &maps.do_map, &sm.full[it % stages],
                    (pt.v0 + nv0 + j) * COLS, q0, bh);
    }
  }
}

// Warps 1..3 of the producer warpgroup (of rank 0 on the cluster): zeros
// over the block's 64 slab columns in the Q tiles above the band (rows
// below ds_rows), 16 B a thread, 8 threads a row.
__device__ __forceinline__ void zero_above_band(const BwdParams& p, const Block& k) {
  const int u = threadIdx.x - 32, n = 96;
  const int rows = min(k.i_lo * QROWS, p.ds_rows);
  for (int gg = 0; gg < p.group; ++gg) {
    __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.ds) +
                         (long long)(k.b * p.Hq + k.kvh * p.group + gg) * p.ds_rows * p.ds_ld +
                         k.kv0;
    for (int i = u; i < rows * 8; i += n)
      *reinterpret_cast<uint4*>(dst + (long long)(i >> 3) * p.ds_ld + (i & 7) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

// A 16 B store where pred is set, without a branch (a predicated
// instruction): the consumers issue it while their wgmma products run.
__device__ __forceinline__ void st_global_16_if(void* dst, uint4 v, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n@p st.global.v4.b32 [%0], {%1, %2, %3, %4};\n}\n" ::"l"(
          dst),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"((int)pred)
      : "memory");
}

// Consumer C of a block; C is a template argument so that no branch around
// a wgmma depends on the thread. Accumulator element 4 jj + 2 hh + e of
// thread (warp, g = lane / 4, t4 = lane % 4) of dP^T is KV row 16 warp + g
// + 8 hh, Q column 32 C + 8 jj + 2 t4 + e. pt is the block's share of Dv,
// nv0 consumer 0's boxes of it; rank the block's rank (0 alone), which
// alone writes the slab.
template <int C, bool DROP, bool SPLIT>
__device__ __forceinline__ void consume(const BwdParams& p, const Smem& sm, const Block& k,
                                        int stages, const Part& pt, int nv0, int rank) {
  using T = __nv_bfloat16;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int nv = pt.nv;
  const int own = C == 0 ? nv0 : nv - nv0;  // Dv boxes of this consumer's dV
  const int pairs = nv - nv0;               // dO stages holding two boxes
  const int kr = k.kv0 + 16 * warp + g;     // this thread's KV rows: kr, kr + 8
  const bool emit = rank == 0;              // this block writes the slab
  // The lanes' row addresses of ldmatrix / stmatrix: matrix m = lane / 8 of
  // a call is (jj = 2 x + m / 2, hh = m % 2), its row lane % 8 the Q column.
  const int xq = 32 * C + 8 * (lane >> 4) + (lane & 7), xk = 16 * warp + 8 * ((lane >> 3) & 1);
  constexpr float LOG2E = 1.4426950408889634f;
  const float inv_cap = p.softcap > 0.f ? __fdividef(1.f, p.softcap) : 0.f;
  // Split: element 4 i + e of thread tid's partial dP^T sits at (i * 128 +
  // tid) * 16 + 4 e bytes of its consumer's slot; a thread reads back what
  // the partner's thread tid stored. The addresses are formed once, before
  // the products.
  const uint32_t mine = cvta_smem(sm.part) + C * PART_BYTES + tid * 16;
  const uint32_t there = SPLIT ? mapa(mine, rank ^ 1) : 0u;
  const uint32_t there_bar = SPLIT ? mapa(cvta_smem(&sm.part_full[C]), rank ^ 1) : 0u;

  // Every ordinary write of an accumulator is fenced off from the wgmma
  // that follows, or ptxas serializes the pipeline.
  float acc[V_BOXES * 32];
#pragma unroll
  for (int i = 0; i < V_BOXES * 32; ++i) acc[i] = 0.f;
  fence_operands(acc);

  int it = 0;
  mbar_wait(sm.v_full, 0);
  for (int t = 0; t < k.ntiles; ++t) {
    const int h = k.kvh * p.group + t / k.ni, q0 = (k.i_lo + t % k.ni) * QROWS;
    const long long bh = (long long)k.b * p.Hq + h;
    const int qc = q0 + 32 * C;  // this consumer's first Q column
    const int st_s = it % stages, it_do = it + 1;
    const uint32_t ph_s = (it / stages) & 1;
    it += 1 + nv0;

    // lse (times log2 e) and delta of this thread's 8 Q columns: 32 C + 8 jj
    // + 2 t4 + e (loads of a row below Nq, not predicated ones: columns past
    // Nq are selected to 0 later).
    float lse_r[8], dl_r[8];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long q = bh * p.nq + min(qc + 8 * jj + 2 * t4 + e, p.nq - 1);
        lse_r[2 * jj + e] = p.lse[q] * LOG2E;
        dl_r[2 * jj + e] = p.delta[q];
      }

    // dP^T for this consumer's 32 Q columns over the block's Dv: the pairs'
    // stages, then an odd last box alone (a conditional wgmma inside a stage
    // would make ptxas serialize), each committed beside its products: a
    // commit after the loop, with no wgmma in its block, became an empty
    // wgmma that ptxas scheduled into the next mbarrier wait's retry loop
    // (C7520).
    float dp[16];
    for (int j = 0; j < pairs; ++j) {
      const int st = (it_do + j) % stages;
      const unsigned char* sb = sm.ring + st * STAGE_BYTES + C * 4096;
      mbar_wait(&sm.full[st], ((it_do + j) / stages) & 1);
      wgmma_fence();
      box_mma<T, 32, 0>(dp, sm.v + j * BOX_BYTES, sb, j == 0);
      box_mma<T, 32, 0>(dp, sm.v + (nv0 + j) * BOX_BYTES, sb + BOX_BYTES);
      wgmma_commit();
    }
    if (pairs < nv0) {
      const int j = nv0 - 1, st = (it_do + j) % stages;
      mbar_wait(&sm.full[st], ((it_do + j) / stages) & 1);
      wgmma_fence();
      box_mma<T, 32, 0>(dp, sm.v + j * BOX_BYTES, sm.ring + st * STAGE_BYTES + C * 4096, j == 0);
      wgmma_commit();
    }

    // S at the accumulator's coordinates while the products run: sr[2 jj +
    // hh] holds Q columns 2 t4 and 2 t4 + 1 of row group jj at KV row g +
    // 8 hh, from the [q][kv] box (ldmatrix.trans).
    uint32_t sr[8];
    mbar_wait(&sm.full[st_s], ph_s);
    {
      const unsigned char* sbox = sm.ring + st_s * STAGE_BYTES;
      ldsm_x4_trans(*reinterpret_cast<uint32_t(*)[4]>(sr), sbox + swz(xq, xk));
      ldsm_x4_trans(*reinterpret_cast<uint32_t(*)[4]>(sr + 4), sbox + swz(xq + 16, xk));
    }
    wgmma_wait<0>();
    fence_operands(dp);

    if constexpr (SPLIT) {
      // dP^T = this rank's partial + the partner's, the same bits in both.
      // This consumer waited on its S box above, so its rank's load of the
      // tile's S has landed before the partial leaves: rank 0 writes dS
      // over that tile only after it received both of rank 1's partials.
      const int slot = t & 1;
      const uint32_t off = slot * 2 * PART_BYTES;
      uint64_t* landed = &sm.part_full[slot * 2 + C];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        st_async_v4(there + off + i * 2048, dp + 4 * i, there_bar + slot * 2 * sizeof(uint64_t));
      mbar_arrive_expect_tx_if(landed, PART_BYTES, tid == 0);
      mbar_wait_cluster(landed, (t >> 1) & 1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x[4];
        lds_v4(mine + off + i * 2048, x);
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[4 * i + e] += x[e];
      }
      fence_operands(dp);
    }

    // P (dropped) and dS. A tile with no softcap or dropout, inside the band
    // and the ragged edges on every element, takes p = 2^(s log2 e - lse
    // log2 e) alone; the others take the feature path, every output selected
    // to 0 outside the band. Neither branches inside: dropout is the DROP
    // template argument, and softcap's factor is 1 where inv_cap is 0.
    const bool interior =
        !DROP && p.softcap <= 0.f && qc + 31 < p.nq && k.kv0 + ROWS - 1 < p.nkv &&
        (p.window_right < 0 || k.kv0 + ROWS - 1 <= qc + p.causal_offset + p.window_right);
    uint32_t pw[8], dw[8];
    if (interior) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const __nv_bfloat162 s2 = *reinterpret_cast<const __nv_bfloat162*>(&sr[2 * jj + hh]);
          float pv[2], dsv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * jj + 2 * hh + e;
            pv[e] = ex2(fmaf(__bfloat162float(e ? s2.y : s2.x), LOG2E, -lse_r[2 * jj + e]));
            dsv[e] = pv[e] * (dp[idx] - dl_r[2 * jj + e]);
          }
          pw[2 * jj + hh] = pack2<T>(pv[0], pv[1]);
          dw[2 * jj + hh] = pack2<T>(dsv[0], dsv[1]);
        }
    } else {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const __nv_bfloat162 s2 = *reinterpret_cast<const __nv_bfloat162*>(&sr[2 * jj + hh]);
          float pv[2], dsv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * jj + 2 * hh + e;
            const float s = __bfloat162float(e ? s2.y : s2.x);
            const int row = qc + 8 * jj + 2 * t4 + e, col = kr + 8 * hh;
            const bool in = row < p.nq && col < p.nkv &&
                            (p.window_right < 0 || col <= row + p.causal_offset + p.window_right);
            const float pe = ex2(fmaf(s, LOG2E, -lse_r[2 * jj + e]));
            const float u = s * inv_cap;
            const float cap = fmaxf(1.f - u * u, 0.f);
            float pd = pe, dpe = dp[idx];
            if constexpr (DROP) {
              const bool keep = dropout_uniform(p.seed, k.b, h, row, col) >= p.dropout_p;
              pd = keep ? pe * p.dropout_inv : 0.f;
              dpe = keep ? dpe * p.dropout_inv : 0.f;
            }
            pv[e] = in ? pd : 0.f;
            dsv[e] = in ? pe * cap * (dpe - dl_r[2 * jj + e]) : 0.f;
          }
          pw[2 * jj + hh] = pack2<T>(pv[0], pv[1]);
          dw[2 * jj + hh] = pack2<T>(dsv[0], dsv[1]);
        }
    }
    // The S box is read (its values are consumed above): free its stage.
    __syncwarp();
    mbar_arrive_if(&sm.empty[st_s], lane == 0);

    // The other consumer is done with the previous tile's P and dS boxes
    // (its products completed, its copy of dS to the slab read them).
    named_barrier_sync(1, 2 * 128);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(sm.p + swz(16 * warp + g + 8 * hh, 32 * C + 8 * jj + 2 * t4)) =
            pw[2 * jj + hh];
    stsm_x4_trans(sm.ds + swz(xq, xk), *reinterpret_cast<const uint32_t(*)[4]>(dw));
    stsm_x4_trans(sm.ds + swz(xq + 16, xk), *reinterpret_cast<const uint32_t(*)[4]>(dw + 4));
    fence_proxy_async();
    named_barrier_sync(1, 2 * 128);  // both halves of P and dS are in their boxes

    // dV[:, own boxes] += P^T dO: dO stage j holds this consumer's box j at
    // C * BOX_BYTES.
#pragma unroll
    for (int j = 0; j < V_BOXES; ++j) {
      if (j < own) {
        wgmma_fence();
        box_mma<T, 64, 1>(*reinterpret_cast<float(*)[32]>(acc + 32 * j), sm.p,
                          sm.ring + ((it_do + j) % stages) * STAGE_BYTES + C * BOX_BYTES);
        wgmma_commit();
      }
    }

    // dS over the S tile of the slab while they run (rank 0 on the
    // cluster): rows q0..q0+63 (those below ds_rows), 8 columns a 16 B
    // store, 8 threads a row.
    {
      const int u = threadIdx.x - 128;
      T* dst = static_cast<T*>(p.ds) + (bh * p.ds_rows + q0) * p.ds_ld + k.kv0;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int v = u + 256 * x, r = v >> 3, c = v & 7;
        st_global_16_if(dst + (long long)r * p.ds_ld + 8 * c,
                        *reinterpret_cast<const uint4*>(sm.ds + r * 128 + ((c ^ (r & 7)) << 4)),
                        emit && q0 + r < p.ds_rows);
      }
    }
    wgmma_wait<0>();
    // This consumer's dV products of the tile completed: its arrivals on
    // the tile's dO stages (both consumers' free a stage).
    for (int j = 0; j < nv0; ++j) mbar_arrive_if(&sm.empty[(it_do + j) % stages], lane == 0);
  }
  fence_operands(acc);

  // Epilogue: dV (group-reduced in the walk); rows past Nkv are not stored.
  const int col0 = (pt.v0 + (C == 0 ? 0 : nv0)) * COLS;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kv = kr + 8 * hh;
    if (kv >= p.nkv) continue;
    const long long base = ((long long)(k.b * p.Hkv + k.kvh) * p.nkv + kv) * p.Dv + col0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < V_BOXES; ++j) {
      if (j >= own) break;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8)
        store2<T>(p.dv, base + COLS * j + 8 * j8, acc[32 * j + 4 * j8 + 2 * hh],
                  acc[32 * j + 4 * j8 + 2 * hh + 1], p.out_f32);
    }
  }
}

template <bool DROP, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
    wgmma_dkdv_from_s_kernel(const __grid_constant__ Maps maps, const BwdParams p,
                             const int stages) {
  extern __shared__ unsigned char smem_raw[];
  // Boxes on 1024 B boundaries: the 128 B swizzle's atom. On the cluster
  // route the offset is added to the shared array itself, so every pointer
  // into it stays a 32-bit shared one (the forward's cluster spilled a
  // 64-bit generic one beside its accumulators).
  unsigned char* base;
  if constexpr (SPLIT)
    base = smem_raw + ((1024 - (cvta_smem(smem_raw) & 1023)) & 1023);
  else
    base = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int rank = SPLIT ? (int)cluster_rank() : 0;
  const int nv = p.Dv / COLS;
  const Part pt = part_of(nv, SPLIT, rank);
  const int nv0 = (pt.nv + 1) / 2;
  const Smem sm = carve<SPLIT>(base, part_of(nv, SPLIT, 0).nv, stages);  // both ranks alike
  const Block k = block_of<SPLIT>(p);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMER_WARPS);
    }
    mbar_init(sm.v_full, 1);
    if constexpr (SPLIT)
      for (int s = 0; s < PART_SLOTS * 2; ++s) mbar_init(&sm.part_full[s], 1);
    fence_barrier_init();
  }
  // The partner's barriers are initialised before this block's first
  // store into its shared memory.
  if constexpr (SPLIT)
    cluster_sync();
  else
    __syncthreads();

  if (threadIdx.x < 128) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0)
      produce(maps, p, sm, k, stages, pt, nv0);
    else if (threadIdx.x >= 32 && rank == 0)
      zero_above_band(p, k);
  } else {
    setmaxnreg_inc<232>();
    if (threadIdx.x < 256)
      consume<0, DROP, SPLIT>(p, sm, k, stages, pt, nv0, rank);
    else
      consume<1, DROP, SPLIT>(p, sm, k, stages, pt, nv0, rank);
  }
  if constexpr (SPLIT) cluster_sync();  // the partner may still store into this block
}

// The host side of one launch: tensor maps, shared memory, the grid (every
// 64-column KV tile of the slab, so each of its columns is written; on the
// cluster route the pair of each tile adjacent along x).
cudaError_t launch(const BwdParams& p, const Plan& pl, int B, cudaStream_t stream) {
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const uint64_t mq = p.nq > 0 ? p.nq : 1, mkv = p.nkv > 0 ? p.nkv : 1;
  cudaError_t e = encode_3d(&maps.s_map, false, p.ds, p.ds_ld, p.ds_rows, (uint64_t)B * p.Hq,
                            (uint64_t)p.ds_ld * 2, (uint64_t)p.ds_rows * p.ds_ld * 2, COLS, QROWS);
  if (e == cudaSuccess)
    e = encode_3d(&maps.do_map, false, p.dout, p.Dv, mq, (uint64_t)B * p.Hq, (uint64_t)p.Dv * 2,
                  mq * p.Dv * 2, COLS, QROWS);
  if (e == cudaSuccess)
    e = encode_3d(&maps.v_map, false, p.v, p.Dv, mkv, (uint64_t)B * p.Hkv, (uint64_t)p.Dv * 2,
                  mkv * p.Dv * 2, COLS, ROWS);
  if (e != cudaSuccess) return e;
  const bool split = pl.route == CLUSTER, drop = p.dropout_p > 0.f;
  const dim3 grid((split ? 2 : 1) * (p.ds_ld / ROWS), p.Hkv, B);
  auto kern = split ? (drop ? wgmma_dkdv_from_s_kernel<true, true>
                            : wgmma_dkdv_from_s_kernel<false, true>)
                    : (drop ? wgmma_dkdv_from_s_kernel<true, false>
                            : wgmma_dkdv_from_s_kernel<false, false>);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (e != cudaSuccess) return e;
  if (grid.x * grid.y * grid.z == 0) return cudaSuccess;
  if (split) return launch_cluster(kern, grid, THREADS, pl.smem, stream, 2, maps, p, pl.stages);
  kern<<<grid, THREADS, pl.smem, stream>>>(maps, p, pl.stages);
  return cudaGetLastError();
}

}  // namespace from_s

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

// dK / dV (and the dS slab): the route is dkdv::make_plan's, by head dims
// alone (one block at D, Dv <= 512, the cluster of two up to 1024). The
// launcher picks its own passes and takes a slab of 64-row, 64-column
// tiles, of the input type (ds_bits 16) or e4m3 (ds_bits 8, bf16 only).
extern "C" int ffpa_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                             const float* lse, const float* delta, void* dk, void* dv, void* ds,
                             const float* bias, long long sb, long long sh, long long sr,
                             long long sc, const float* alibi, int is_fp16, int out_f32, int B,
                             int Hq, int Hkv, int nq, int nkv, int D, int Dv, int ds_rows,
                             int ds_ld, float scale, float softcap, int causal_offset,
                             int window_left, int window_right, float dropout_p,
                             float dropout_inv, unsigned seed, int row_offset, int col_offset,
                             int ds_bits, int ring_cap, void* stream) {
  BwdParams p = make_params(q, k, v, dout, lse, delta, bias, sb, sh, sr, sc, alibi, Hq, Hkv, nq,
                            nkv, D, Dv, scale, softcap, causal_offset, window_left, window_right,
                            dropout_p, dropout_inv, seed, row_offset, col_offset);
  p.dk = dk;
  p.dv = dv;
  p.ds = ds;
  p.ds_rows = ds_rows;
  p.ds_ld = ds_ld;
  p.out_f32 = out_f32;
  if (D <= 0 || Dv <= 0 || D % CH != 0 || Dv % CH != 0 || D > dkdv::MAX_HEAD_DIM ||
      Dv > dkdv::MAX_HEAD_DIM || Hkv <= 0 || Hq % Hkv != 0 || (ds_bits != 8 && ds_bits != 16) ||
      (ds != nullptr &&
       (ds_ld < nkv || ds_ld % dkdv::ROWS != 0 || ds_rows % dkdv::QROWS != 0 ||
        ds_rows < (nq + dkdv::QROWS - 1) / dkdv::QROWS * dkdv::QROWS)))
    return (int)cudaErrorInvalidValue;
  if (!ring_cap_ok(ring_cap, dkdv::make_plan(D, Dv).stages, dkdv::MIN_STAGES))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dkdv::Plan pl = dkdv::make_plan(D, Dv, ring_cap);
  const bool fp8 = ds_bits == 8;
  return (int)(pl.route == dkdv::CLUSTER
                   ? dkdv::launch_typed<true>(is_fp16, fp8, p, pl, B, st)
                   : dkdv::launch_typed<false>(is_fp16, fp8, p, pl, B, st));
}

// The route and tiling ffpa_bwd_dkdv takes at head dims (D, Dv), multiples
// of 64 up to 1024: out[0..6] are the route (1 one block, 2 the cluster of
// two), the passes, a block's KV rows, the streamed Q rows, the ring's
// stages, the dynamic shared-memory bytes of a block and the ranks that
// split the head dims (1 or 2); then for each block of a KV tile, rank by
// rank and pass by pass, the (first column, width) of dK and of dV it
// owns; then for each rank of the cluster (none for one block) its (first
// D column, D width, first Dv column, Dv width). cap is out's length;
// ring_cap the launch's (0: the plan's depth), as ffpa_bwd_dkdv takes it.
extern "C" int ffpa_bwd_dkdv_plan(int D, int Dv, int* out, int cap, int ring_cap) {
  if (D <= 0 || Dv <= 0 || D % CH != 0 || Dv % CH != 0 || D > dkdv::MAX_HEAD_DIM ||
      Dv > dkdv::MAX_HEAD_DIM)
    return (int)cudaErrorInvalidValue;
  if (!ring_cap_ok(ring_cap, dkdv::make_plan(D, Dv).stages, dkdv::MIN_STAGES))
    return (int)cudaErrorInvalidValue;
  const dkdv::Plan pl = dkdv::make_plan(D, Dv, ring_cap);
  const int ranks = pl.route == dkdv::CLUSTER ? 2 : 1;
  if (cap < 7 + 4 * ranks * pl.passes + (ranks == 2 ? 8 : 0)) return (int)cudaErrorInvalidValue;
  int n = 0;
  out[n++] = pl.route;
  out[n++] = pl.passes;
  out[n++] = dkdv::ROWS;
  out[n++] = dkdv::QROWS;
  out[n++] = pl.stages;
  out[n++] = (int)pl.smem;
  out[n++] = ranks;
  for (int r = 0; r < ranks; ++r) {
    const dkdv::Part& pt = pl.part[r];
    for (int ps = 0; ps < pl.passes; ++ps) {
      const sm90::Cols dc = sm90::col_block(pt.nd, pl.passes, ps);
      const sm90::Cols vc = sm90::col_block(pt.nv, pl.passes, ps);
      out[n++] = pt.d0 * CH + dc.c0;
      out[n++] = dc.nc * CH;
      out[n++] = pt.v0 * CH + vc.c0;
      out[n++] = vc.nc * CH;
    }
  }
  for (int r = 0; r < (ranks == 2 ? 2 : 0); ++r) {
    const dkdv::Part& pt = pl.part[r];
    out[n++] = pt.d0 * CH;
    out[n++] = pt.nd * CH;
    out[n++] = pt.v0 * CH;
    out[n++] = pt.nv * CH;
  }
  return 0;
}

// Registers a thread (at launch, before setmaxnreg moves them between the
// warpgroups) and local (spill) bytes a thread of the dK/dV kernel of
// route 1 (one block) or 2 (the cluster), in f16 or bf16; ds_bits 8 the
// bf16 instance that writes an e4m3 slab.
extern "C" int ffpa_bwd_dkdv_attrs(int route, int is_fp16, int ds_bits, int* regs,
                                   int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e;
  if ((ds_bits != 8 && ds_bits != 16) || (ds_bits == 8 && is_fp16))
    return (int)cudaErrorInvalidValue;
  if (route == dkdv::CLUSTER)
    e = ds_bits == 8 ? cudaFuncGetAttributes(&a, dkdv::kernel<__nv_bfloat16, true, true>)
        : is_fp16    ? cudaFuncGetAttributes(&a, dkdv::kernel<__half, true>)
                     : cudaFuncGetAttributes(&a, dkdv::kernel<__nv_bfloat16, true>);
  else if (route == dkdv::WGMMA)
    e = ds_bits == 8 ? cudaFuncGetAttributes(&a, dkdv::kernel<__nv_bfloat16, false, true>)
        : is_fp16    ? cudaFuncGetAttributes(&a, dkdv::kernel<__half, false>)
                     : cudaFuncGetAttributes(&a, dkdv::kernel<__nv_bfloat16, false>);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// dQ (and the fp32 dbias slab): the route is dq::make_plan's, by head dims
// alone (one block at D, Dv <= 512, the cluster of two up to 1024), at its
// own 64-row tile. block_q is not read: it stays in the argument list,
// which libraries built from older sources share (their mma.sync route
// above D512 took it). The dbias slab is of 64-row, 64-column tiles.
extern "C" int ffpa_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dq, float* dbias,
                           const float* bias, long long sb, long long sh, long long sr,
                           long long sc, const float* alibi, int is_fp16, int out_f32,
                           int block_q, int B, int Hq, int Hkv, int nq, int nkv, int D, int Dv,
                           int ds_rows, int ds_ld, float scale, float softcap, int causal_offset,
                           int window_left, int window_right, float dropout_p, float dropout_inv,
                           unsigned seed, int ring_cap, void* stream) {
  (void)block_q;
  BwdParams p = make_params(q, k, v, dout, lse, delta, bias, sb, sh, sr, sc, alibi, Hq, Hkv, nq,
                            nkv, D, Dv, scale, softcap, causal_offset, window_left, window_right,
                            dropout_p, dropout_inv, seed, 0, 0);
  p.dq = dq;
  p.dbias = dbias;
  p.ds_rows = ds_rows;
  p.ds_ld = ds_ld;
  p.out_f32 = out_f32;
  if (D <= 0 || Dv <= 0 || D % CH != 0 || Dv % CH != 0 || D > dq::MAX_HEAD_DIM ||
      Dv > dq::MAX_HEAD_DIM || Hkv <= 0 || Hq % Hkv != 0 ||
      (dbias != nullptr && (ds_ld % dq::KV_ROWS != 0 || ds_ld < nkv || ds_rows % dq::ROWS != 0 ||
                            ds_rows < nq)))
    return (int)cudaErrorInvalidValue;
  if (!ring_cap_ok(ring_cap, dq::make_plan(D, Dv).stages, dq::MIN_STAGES))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dq::Plan pl = dq::make_plan(D, Dv, ring_cap);
  return (int)(pl.route == dq::CLUSTER ? dq::launch_typed<true>(is_fp16, p, pl, B, st)
                                       : dq::launch_typed<false>(is_fp16, p, pl, B, st));
}

// The route and tiling ffpa_bwd_dq takes at head dims (D, Dv), multiples of
// 64 up to 1024: out[0..4] are the route (1 one block, 2 the cluster of
// two), the Q rows of a block, the KV rows of a tile, the ring's stages and
// the dynamic shared-memory bytes of a block; out[5] the number n of dQ
// column blocks (each rank's consumers' shares, rank by rank), then (first
// column, width) of each; out[6 + 2n] the number of ranks of a cluster (0
// for one block), then each rank's (first D column, D width, first Dv
// column, Dv width). cap is out's length; ring_cap the launch's (0: the
// plan's depth), as ffpa_bwd_dq takes it.
extern "C" int ffpa_bwd_dq_plan(int D, int Dv, int* out, int cap, int ring_cap) {
  if (D <= 0 || Dv <= 0 || D % CH != 0 || Dv % CH != 0 || D > dq::MAX_HEAD_DIM ||
      Dv > dq::MAX_HEAD_DIM || cap < 23 ||
      !ring_cap_ok(ring_cap, dq::make_plan(D, Dv).stages, dq::MIN_STAGES))
    return (int)cudaErrorInvalidValue;
  const dq::Plan pl = dq::make_plan(D, Dv, ring_cap);
  const int ranks = pl.route == dq::CLUSTER ? 2 : 1;
  out[0] = pl.route;
  out[1] = dq::ROWS;
  out[2] = dq::KV_ROWS;
  out[3] = pl.stages;
  out[4] = (int)pl.smem;
  int n = 6;
  out[5] = 2 * ranks;
  for (int r = 0; r < ranks; ++r)
    for (int c = 0; c < 2; ++c) {
      const sm90::Cols cb = sm90::col_block(pl.part[r].nd, 2, c);
      out[n++] = pl.part[r].d0 * CH + cb.c0;
      out[n++] = cb.nc * CH;
    }
  out[n++] = ranks == 2 ? 2 : 0;
  for (int r = 0; r < (ranks == 2 ? 2 : 0); ++r) {
    out[n++] = pl.part[r].d0 * CH;
    out[n++] = pl.part[r].nd * CH;
    out[n++] = pl.part[r].v0 * CH;
    out[n++] = pl.part[r].nv * CH;
  }
  return 0;
}

// Registers a thread (at launch, before setmaxnreg moves them between the
// warpgroups) and local (spill) bytes a thread of the dQ kernel of route 1
// (one block) or 2 (the cluster), in f16 or bf16: the registers of its
// instantiation without dropout, the larger spill of the two.
extern "C" int ffpa_bwd_dq_attrs(int route, int is_fp16, int* regs, int* local_bytes) {
  if (route != dq::WGMMA && route != dq::CLUSTER) return (int)cudaErrorInvalidValue;
  const bool split = route == dq::CLUSTER;
  cudaFuncAttributes a, d;
  cudaError_t e;
  if (is_fp16) {
    e = cudaFuncGetAttributes(&a, split ? dq::wgmma_dq_kernel<__half, false, true>
                                        : dq::wgmma_dq_kernel<__half, false, false>);
    if (e == cudaSuccess)
      e = cudaFuncGetAttributes(&d, split ? dq::wgmma_dq_kernel<__half, true, true>
                                          : dq::wgmma_dq_kernel<__half, true, false>);
  } else {
    e = cudaFuncGetAttributes(&a, split ? dq::wgmma_dq_kernel<__nv_bfloat16, false, true>
                                        : dq::wgmma_dq_kernel<__nv_bfloat16, false, false>);
    if (e == cudaSuccess)
      e = cudaFuncGetAttributes(&d, split ? dq::wgmma_dq_kernel<__nv_bfloat16, true, true>
                                          : dq::wgmma_dq_kernel<__nv_bfloat16, true, false>);
  }
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)std::max(a.localSizeBytes, d.localSizeBytes);
  return 0;
}

// Whether the from-S launch at (Dv, dk_in) takes ring_cap: 0, or on the
// wgmma routes from_s::min_stages..the plan's depth.
inline bool from_s_cap_ok(int Dv, bool dk_in, int ring_cap) {
  const from_s::Plan deepest = from_s::make_plan(Dv, dk_in);
  if (deepest.route == from_s::MMA_SYNC) return ring_cap == 0;
  return ring_cap_ok(ring_cap, deepest.stages, from_s::min_stages(deepest));
}

// S-resident dK/dV (bf16): the slab holds S on entry and dS on return. The
// route is from_s::make_plan's, by Dv and dk_in_kernel alone: dK out of the
// kernel takes the wgmma block at Dv <= 512 and its cluster of two up to
// Dv 1024 (a slab of 64-column tiles); dK in the kernel (D, Dv <= 512) the
// mma.sync kernel (32-column tiles). kv_tile is not read: it stays in the
// argument list, which libraries built from older sources share (they take
// 64 for dK out at Dv <= 512, else 32).
extern "C" int ffpa_bwd_dkdv_from_s(const void* q, const void* v, const void* dout,
                                    const float* lse, const float* delta, void* slab, void* dk,
                                    void* dv, int dk_in_kernel, int kv_tile, int out_f32, int B,
                                    int Hq, int Hkv, int nq, int nkv, int D, int Dv,
                                    int ds_rows, int ds_ld, float scale, float softcap,
                                    int causal_offset, int window_right, float dropout_p,
                                    float dropout_inv, unsigned seed, int ring_cap,
                                    void* stream) {
  (void)kv_tile;
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
  if (D % CH != 0 || Dv <= 0 || Dv % CH != 0 || Hkv <= 0 || Hq % Hkv != 0 || nq <= 0 ||
      ds_rows < nq || ds_ld < nkv || (dk_in && (D > 512 || Dv > 512)) || Dv > 1024)
    return (int)cudaErrorInvalidValue;
  if (!from_s_cap_ok(Dv, dk_in, ring_cap)) return (int)cudaErrorInvalidValue;
  const from_s::Plan pl = from_s::make_plan(Dv, dk_in, ring_cap);
  if (ds_ld % pl.kv_rows != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pl.route != from_s::MMA_SYNC) return (int)from_s::launch(p, pl, B, st);
  const dim3 grid(Hkv, B, ds_ld / KVT);
  return (int)launch(dkdv_from_s_kernel, grid, pl.smem, p, st);
}

// The route and tiling ffpa_bwd_dkdv_from_s takes at value head dim Dv (a
// multiple of 64) and dk_in_kernel: out[0..4] are the route (2 the wgmma
// cluster, 1 the wgmma block, 0 mma.sync), a block's KV rows, the streamed
// Q rows, the ring's stages and the dynamic shared-memory bytes; out[5] the
// number n of dV column blocks (each rank's consumers' halves, rank by
// rank, or the mma.sync block's whole Dv), then (first column, width) of
// each; out[6 + 2n] the number of ranks of a cluster (0 for one block),
// then (first column, width) of each rank's share of Dv; cap is out's
// length; ring_cap the launch's (0: the plan's depth), as
// ffpa_bwd_dkdv_from_s takes it.
extern "C" int ffpa_bwd_from_s_plan(int Dv, int dk_in_kernel, int* out, int cap, int ring_cap) {
  if (Dv <= 0 || Dv % CH != 0 || cap < 19 || !from_s_cap_ok(Dv, dk_in_kernel != 0, ring_cap))
    return (int)cudaErrorInvalidValue;
  const from_s::Plan pl = from_s::make_plan(Dv, dk_in_kernel != 0, ring_cap);
  out[0] = pl.route;
  out[1] = pl.kv_rows;
  out[2] = pl.q_rows;
  out[3] = pl.stages;
  out[4] = (int)pl.smem;
  int n = 0;
  if (pl.route == from_s::MMA_SYNC) {
    out[6] = 0;
    out[7] = Dv;
    n = 1;
  } else {
    const int ranks = pl.route == from_s::CLUSTER ? 2 : 1;
    for (int r = 0; r < ranks; ++r)
      for (int c = 0; c < 2; ++c, ++n) {
        const sm90::Cols cb = sm90::col_block(pl.part[r].nv, 2, c);
        out[6 + 2 * n] = pl.part[r].v0 * CH + cb.c0;
        out[7 + 2 * n] = cb.nc * CH;
      }
  }
  out[5] = n;
  const int ranks = pl.route == from_s::CLUSTER ? 2 : 0;
  out[6 + 2 * n] = ranks;
  for (int r = 0; r < ranks; ++r) {
    out[7 + 2 * n + 2 * r] = pl.part[r].v0 * CH;
    out[8 + 2 * n + 2 * r] = pl.part[r].nv * CH;
  }
  return 0;
}

// Registers a thread (at launch, before setmaxnreg moves them between the
// warpgroups) and local (spill) bytes a thread of a from-S kernel: route 1
// the wgmma block, 2 its cluster (each the registers of its instantiation
// without dropout, the larger spill of the two), 0 dkdv_from_s_kernel (dK
// in the kernel; dk_in_kernel is not read).
extern "C" int ffpa_bwd_from_s_attrs(int route, int dk_in_kernel, int* regs, int* local_bytes) {
  (void)dk_in_kernel;
  cudaFuncAttributes a, d;
  cudaError_t e;
  if (route == from_s::WGMMA || route == from_s::CLUSTER) {
    const bool split = route == from_s::CLUSTER;
    e = cudaFuncGetAttributes(&a, split ? from_s::wgmma_dkdv_from_s_kernel<false, true>
                                        : from_s::wgmma_dkdv_from_s_kernel<false, false>);
    if (e == cudaSuccess)
      e = cudaFuncGetAttributes(&d, split ? from_s::wgmma_dkdv_from_s_kernel<true, true>
                                          : from_s::wgmma_dkdv_from_s_kernel<true, false>);
    if (e == cudaSuccess) a.localSizeBytes = std::max(a.localSizeBytes, d.localSizeBytes);
  } else {
    e = cudaFuncGetAttributes(&a, dkdv_from_s_kernel);
  }
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// Causal dK = scale * dS^T Q from the slab (bf16). The kernel picks its own
// tiles (128 KV rows x column blocks of at most 256): kv_tile is not read;
// it stays in the argument list, which libraries built from older sources
// share.
extern "C" int ffpa_bwd_banded_dk(const void* ds, const void* q, void* dk, int out_f32,
                                  int kv_tile, int B, int Hq, int Hkv, int nq, int nkv, int D,
                                  int ds_rows, int ds_ld, float scale, int causal_offset,
                                  void* stream) {
  (void)kv_tile;
  return (int)band::launch<__nv_bfloat16, true>(ds, q, dk, out_f32, B, Hq, Hkv, nq, nkv, D,
                                                ds_rows, ds_ld, scale, causal_offset,
                                                static_cast<cudaStream_t>(stream));
}

// Causal dQ = scale * dS K from the slab (bf16 or f16, ds_bits 16; or e4m3
// with bf16 K, ds_bits 8). The kernel picks its own tiles (128-row panels x
// column blocks of at most 256): block_q is not read; it stays in the
// argument list, which libraries built from older sources share.
extern "C" int ffpa_bwd_banded_dq(const void* ds, const void* k, void* dq, int is_fp16,
                                  int out_f32, int block_q, int B, int Hq, int Hkv, int nq,
                                  int nkv, int D, int ds_rows, int ds_ld, float scale,
                                  int causal_offset, int ds_bits, void* stream) {
  (void)block_q;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((ds_bits != 8 && ds_bits != 16) || (ds_bits == 8 && is_fp16))
    return (int)cudaErrorInvalidValue;
  if (ds_bits == 8)
    return (int)band::launch<__nv_bfloat16, false, true>(ds, k, dq, out_f32, B, Hq, Hkv, nq, nkv,
                                                         D, ds_rows, ds_ld, scale, causal_offset,
                                                         st);
  if (is_fp16)
    return (int)band::launch<__half, false>(ds, k, dq, out_f32, B, Hq, Hkv, nq, nkv, D, ds_rows,
                                            ds_ld, scale, causal_offset, st);
  return (int)band::launch<__nv_bfloat16, false>(ds, k, dq, out_f32, B, Hq, Hkv, nq, nkv, D,
                                                 ds_rows, ds_ld, scale, causal_offset, st);
}

// The tiling band::launch takes at head dim D (a multiple of 64) over a
// slab of ds_bits (16, or 8: banded dQ over e4m3): out[0..4] are the column
// blocks, rows of a block, k-step, stages and dynamic shared-memory bytes,
// then (first column, width) of each column block; cap is out's length.
extern "C" int ffpa_bwd_banded_plan(int D, int ds_bits, int* out, int cap) {
  if (D <= 0 || D % band::COLS != 0 || (ds_bits != 8 && ds_bits != 16))
    return (int)cudaErrorInvalidValue;
  const band::Plan pl = band::make_plan(D, ds_bits == 8);
  if (cap < 5 + 2 * pl.col_blocks) return (int)cudaErrorInvalidValue;
  out[0] = pl.col_blocks;
  out[1] = band::ROWS;
  out[2] = band::KT;
  out[3] = band::STAGES;
  out[4] = (int)pl.smem;
  for (int cb = 0; cb < pl.col_blocks; ++cb) {
    const sm90::Cols c = sm90::col_block(pl.chunks, pl.col_blocks, cb);
    out[5 + 2 * cb] = c.c0;
    out[6 + 2 * cb] = c.nc * band::COLS;
  }
  return 0;
}

// Registers a thread (at launch, before setmaxnreg moves them between the
// warpgroups) and local (spill) bytes a thread of a banded kernel: dk 1 is
// banded dK, else banded dQ in f16 or bf16 over a 16-bit slab, or (ds_bits
// 8) bf16 over an e4m3 slab.
extern "C" int ffpa_bwd_banded_attrs(int dk, int is_fp16, int ds_bits, int* regs,
                                     int* local_bytes) {
  cudaFuncAttributes a;
  if ((ds_bits != 8 && ds_bits != 16) || (ds_bits == 8 && (dk || is_fp16)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      dk ? cudaFuncGetAttributes(&a, band::banded_kernel<__nv_bfloat16, true>)
      : ds_bits == 8
          ? cudaFuncGetAttributes(&a, band::banded_kernel<__nv_bfloat16, false, true>)
          : (is_fp16 ? cudaFuncGetAttributes(&a, band::banded_kernel<__half, false>)
                     : cudaFuncGetAttributes(&a, band::banded_kernel<__nv_bfloat16, false>));
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}
