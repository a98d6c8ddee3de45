// The LSE merge of split-KV partials, shared by the dense decode kernel
// (decode.cu) and the paged decode kernel (paged_decode.cu).
//
// Launch 1 of either writes, per (batch, KV head, split, packed row), fp32
// partials normalised by their own l (o_part [B, Hkv, splits, R, Dv]) and
// lse_s = m + log l (lse_part [B, Hkv, splits, R]; -inf for a split that
// attended nothing). This launch, grid (ceil(Dv / 128), R, B * Hkv), merges
// them: lse = log sum exp(lse_s), o = sum exp(lse_s - lse) * o_s; a row whose
// splits are all -inf gives o = 0 and lse = -inf.
#pragma once

#include "common.cuh"

namespace ffpa {

constexpr int MERGE_THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS)
    split_merge_kernel(const float* __restrict__ o_part, const float* __restrict__ lse_part,
                       T* __restrict__ o, float* __restrict__ lse, int R, int splits, int Dv) {
  extern __shared__ float w[];  // [splits] merge weights
  __shared__ float lse_tot;
  const int r = blockIdx.y;
  const long long bh = blockIdx.z;
  const float* lp = lse_part + bh * splits * R + r;  // lse_s at lp[s * R]
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float mx = -INFINITY;
    for (int s = lane; s < splits; s += 32) mx = fmaxf(mx, lp[(long long)s * R]);
    mx = warp_max(mx);
    float sum = 0.f;
    if (mx != -INFINITY)
      for (int s = lane; s < splits; s += 32) sum += __expf(lp[(long long)s * R] - mx);
    sum = warp_sum(sum);
    const float tot = (mx == -INFINITY) ? -INFINITY : mx + logf(sum);
    for (int s = lane; s < splits; s += 32)
      w[s] = (mx == -INFINITY) ? 0.f : __expf(lp[(long long)s * R] - tot);
    if (lane == 0) lse_tot = tot;
  }
  __syncthreads();
  const int col = blockIdx.x * MERGE_THREADS + threadIdx.x;
  if (col < Dv) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s)
      acc += w[s] * o_part[((bh * splits + s) * R + r) * Dv + col];
    o[(bh * R + r) * Dv + col] = from_float<T>(acc);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) lse[bh * R + r] = lse_tot;
}

// Merge the partials of B * Hkv (batch, KV head) pairs of R rows each.
template <typename T>
cudaError_t launch_split_merge(const float* o_part, const float* lse_part, void* o, float* lse,
                               int R, int splits, int Dv, int bh, cudaStream_t st) {
  const dim3 grid((Dv + MERGE_THREADS - 1) / MERGE_THREADS, R, bh);
  const size_t smem = (size_t)splits * sizeof(float);
  split_merge_kernel<T><<<grid, MERGE_THREADS, smem, st>>>(o_part, lse_part, static_cast<T*>(o),
                                                           lse, R, splits, Dv);
  return cudaGetLastError();
}

}  // namespace ffpa
