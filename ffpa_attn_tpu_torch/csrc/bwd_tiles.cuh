// Tiles and mma.sync building blocks shared by the backward kernels
// (flash_bwd.cu, varlen_bwd.cu): 16 warps a block, 64-column chunks through
// a 4-slot cp.async ring, the ldmatrix lane addressing and the two product
// patterns (S = Q K^T and O += P V), fp32 stores of two outputs at once.
#pragma once

#include "common.cuh"

namespace ffpa {

constexpr int NW = 16;            // warps per block
constexpr int NTHR = NW * 32;
constexpr int CH = 64;            // columns per streamed chunk; the dQ kernels' KV tile
constexpr int NST = 4;            // stream ring slots (ops/config.py FWD_STREAM_STAGES)
constexpr int LDC = CH + 8;       // chunk / P / dS row stride (elements)
constexpr int KVT = 32;           // dK/dV block's KV rows (ops/config.py DKDV_KV_TILE)
constexpr int QT = 128;           // dK/dV streamed Q rows (DKDV_Q_TILE)
constexpr int LDP = QT + 8;       // dK/dV block's P / dS row stride (elements)
constexpr int MAXC = 8;           // 64-column chunks of dK (and of dV) one dK/dV block owns
constexpr int ACC_PER_THREAD = 64;  // dQ accumulator registers per thread

// Store two adjacent fp32 outputs in the input type or in fp32.
template <typename T>
__device__ __forceinline__ void store2(void* base, long long idx, float a, float b, int f32) {
  if (f32)
    *reinterpret_cast<float2*>(static_cast<float*>(base) + idx) = make_float2(a, b);
  else
    *reinterpret_cast<uint32_t*>(static_cast<T*>(base) + idx) = pack2<T>(a, b);
}

// ldmatrix lane addressing (see common.cuh and flash_fwd.cu): A tiles and
// trans-B tiles take rows lane % 16 at column 8 * (lane / 16); B from an
// [n][k] tile takes n = lane % 8 (+ 8 for the second n8 tile), k = 8 * ((lane / 8) % 2).
struct Lanes {
  int a_row, a_col, bn_row, bn_col, bt_row, bt_col;
  __device__ explicit Lanes(int lane)
      : a_row(lane & 15),
        a_col((lane >> 4) * 8),
        bn_row((lane & 7) + ((lane >> 4) << 3)),
        bn_col(((lane >> 3) & 1) * 8),
        bt_row((lane & 7) + (((lane >> 3) & 1) << 3)),
        bt_col((lane >> 4) * 8) {}
};

// acc[N8] += A (16 rows of a row-major tile, 64 k) * B^T where B is an
// [n][k] tile (rows n0.. of a chunk): the S = Q K^T pattern. N8 is 1 or
// even (pairs of n8 tiles per ldmatrix.x4).
template <typename T, int N8>
__device__ __forceinline__ void mma_abt(float (&acc)[N8][4], const T* a, int lda, const T* bt,
                                        const Lanes& L, int lane) {
#pragma unroll
  for (int kk = 0; kk < CH / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + L.a_row * lda + kk * 16 + L.a_col);
    if (N8 >= 2) {
#pragma unroll
      for (int n2 = 0; n2 < N8 / 2; ++n2) {
        uint32_t bf[4];
        ldsm_x4(bf, bt + (n2 * 16 + L.bn_row) * LDC + kk * 16 + L.bn_col);
        mma16816<T>(acc[2 * n2], af, bf[0], bf[1]);
        mma16816<T>(acc[2 * n2 + 1], af, bf[2], bf[3]);
      }
    } else {
      uint32_t bf[2];
      ldsm_x2(bf, bt + (lane & 7) * LDC + kk * 16 + L.bn_col);
      mma16816<T>(acc[0], af, bf[0], bf[1]);
    }
  }
}

// acc[N8] += A (16 rows x 16 * KS k, row-major) * B where B is a row-major
// [k][n] chunk (columns n0..): the O += P V pattern.
template <typename T, int N8, int KS = CH / 16>
__device__ __forceinline__ void mma_ab(float (&acc)[N8][4], const T* a, int lda, const T* b,
                                       const Lanes& L) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a + L.a_row * lda + kk * 16 + L.a_col);
    if (N8 == 2) {
      uint32_t bf[4];
      ldsm_x4_trans(bf, b + (kk * 16 + L.bt_row) * LDC + L.bt_col);
      mma16816<T>(acc[0], af, bf[0], bf[1]);
      mma16816<T>(acc[N8 - 1], af, bf[2], bf[3]);
    } else {
      uint32_t bf[2];
      ldsm_x2_trans(bf, b + (kk * 16 + L.bt_row) * LDC);
      mma16816<T>(acc[0], af, bf[0], bf[1]);
    }
  }
}

}  // namespace ffpa
