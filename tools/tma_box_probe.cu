// Does TMA's 128 B swizzle follow the shared address, or the row within the
// box? Paged decode (ffpa_attn_tpu_torch/csrc/paged_decode.cu) lands a stage
// of 64 cache rows as boxes of box_rows rows (the largest power of two
// dividing the page and 64), box i at byte 128 * box_rows * i of a 1024 B
// aligned stage, and its wgmma descriptors read the stage as one 64-row box
// in the 128 B swizzle. Below 8 rows a box starts inside a 1024 B swizzle
// atom, so the stage is only right if TMA swizzles by the address.
//
// ffpa_tma_box_probe loads rows [0, 64) of a paged bf16 pool [pages, page,
// 64] (cache row pos is row pos % page of page pos / page) into one stage
// as boxes of box_rows rows through the same 3-D map the kernel encodes,
// and copies the stage's bytes out unchanged: tools/torch_tma_box_probe.py
// compares them with the swizzled image of the 64 rows. Built by that
// script with nvcc (-I ffpa_attn_tpu_torch/csrc); no PyTorch headers.
#include <string.h>

#include "sm90.cuh"

using namespace ffpa::sm90;

__global__ void box_probe_kernel(const __grid_constant__ CUtensorMap map, unsigned char* out,
                                 int page, int box_rows) {
  extern __shared__ unsigned char smem_raw[];  // 1024 B alignment + the stage + its barrier
  unsigned char* stage = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t& full = *reinterpret_cast<uint64_t*>(stage + 64 * 128);
  if (threadIdx.x == 0) {
    mbar_init(&full, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&full, 64 * 128);
    for (int bx = 0; bx < 64 / box_rows; ++bx) {
      const int pos = bx * box_rows;
      tma_load_3d(stage + bx * box_rows * 128, &map, &full, 0, pos % page, pos / page);
    }
  }
  mbar_wait(&full, 0);
  for (int i = threadIdx.x; i < 64 * 128; i += blockDim.x) out[i] = stage[i];
}

// pool: [pages, page, 64] bf16 on the card; out: 8192 bytes on the card.
extern "C" int ffpa_tma_box_probe(const void* pool, int pages, int page, int box_rows,
                                  void* out) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  const cuuint64_t dims[3] = {64, (cuuint64_t)page, (cuuint64_t)pages};
  const cuuint64_t strides[2] = {128, (cuuint64_t)page * 128};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(pool), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  box_probe_kernel<<<1, 128, 1024 + 64 * 128 + 8>>>(map, static_cast<unsigned char*>(out), page,
                                                    box_rows);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}
