// K1 for Hopper: the replica-set vote.
//
// Replaces the Pallas TPU kernel coast_tpu/ops/pallas_voters.py
// `_vote_kernel` (launched by `_vote_pallas`).  It computes what that
// kernel computes, for a whole campaign batch in one launch:
//
//   TMR (n = 3): voted = (l0 == l1) ? l0 : l2,
//                mis   = any(l0 != l1) || any(l1 != l2)
//   DWC (n = 2): voted = l0,  mis = any(l0 != l1)
//
// over a replica set of R batch rows x n lanes x W 32-bit words.  Compares
// are in the leaf's type (vote_word.cuh): one instantiation compares as
// float (IEEE: +0 == -0, NaN != NaN, subnormal operands read as zero, as
// the reference's XLA compare does), one as int32 (int32 and uint32
// leaves); the voted word is always copied as raw bits.
//
// What bounds it: bytes.  It reads R*n*W*4 bytes and writes R*W*4 + 4*R;
// it does no arithmetic worth counting, so its least time on an H100 is
// those bytes / 3.35 TB/s.  The design follows from that:
//   * each thread moves 4 consecutive words with one 16-byte load per lane
//     and one 16-byte store when the window is 16-byte aligned, neighbouring
//     threads on neighbouring addresses (a scalar tail otherwise);
//   * grid = (ceil(W / (threads*4)), R): the whole batch is one launch, the
//     batch axis the TPU kernel got from vmap is written out;
//   * the miscompare flag: the TPU kernel writes an (8,128) flag block per
//     grid step and the host ORs them, because its grid runs in order on
//     one core.  Here blocks run in parallel in no order, so each block
//     reduces its flag with __syncthreads_or and issues at most one
//     atomicOr(&mis[r], 1) -- no order between blocks is needed;
//   * a lane stride and an optional per-row word offset let the store-slice
//     vote read its window results[b, :, start_b : start_b + W] in place,
//     with no gather before the vote.  A start clamps into
//     [0, lane_stride - W], so no offset can read outside its lane.
//
// C interface for ctypes (no PyTorch headers, so nvcc builds it in
// seconds).  The caller allocates `voted` [R, W] and zeroes `mis` [R], and
// keeps W <= lane_stride when it passes offsets.
// Returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vote_word.cuh"

namespace {

using coast::vote_word;

template <bool IS_FLOAT, int N>
__global__ void vote_kernel(const uint32_t* __restrict__ src,
                            uint32_t* __restrict__ voted,
                            int* __restrict__ mis, int rows, long long width,
                            long long lane_stride, long long row_stride,
                            const int* __restrict__ offsets) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    long long off = 0;
    if (offsets) {
      off = offsets[r] < 0 ? 0 : offsets[r];
      if (off > lane_stride - width) off = lane_stride - width;
    }
    const uint32_t* l0 = src + static_cast<long long>(r) * row_stride + off;
    const uint32_t* l1 = l0 + lane_stride;
    const uint32_t* l2 = N == 3 ? l1 + lane_stride : l1;
    uint32_t* out = voted + static_cast<long long>(r) * width;
    bool bad = false;
    const uintptr_t addr = reinterpret_cast<uintptr_t>(l0 + i0) |
                           reinterpret_cast<uintptr_t>(l1 + i0) |
                           reinterpret_cast<uintptr_t>(l2 + i0) |
                           reinterpret_cast<uintptr_t>(out + i0);
    if (i0 + 4 <= width && (addr & 15) == 0) {
      const uint4 a = *reinterpret_cast<const uint4*>(l0 + i0);
      const uint4 b = *reinterpret_cast<const uint4*>(l1 + i0);
      const uint4 c = N == 3 ? *reinterpret_cast<const uint4*>(l2 + i0) : b;
      uint4 v;
      v.x = vote_word<IS_FLOAT, N>(a.x, b.x, c.x, bad);
      v.y = vote_word<IS_FLOAT, N>(a.y, b.y, c.y, bad);
      v.z = vote_word<IS_FLOAT, N>(a.z, b.z, c.z, bad);
      v.w = vote_word<IS_FLOAT, N>(a.w, b.w, c.w, bad);
      *reinterpret_cast<uint4*>(out + i0) = v;
    } else {
      for (int j = 0; j < 4; ++j) {
        const long long i = i0 + j;
        if (i < width) {
          const uint32_t b = l1[i];
          const uint32_t c = N == 3 ? l2[i] : b;
          out[i] = vote_word<IS_FLOAT, N>(l0[i], b, c, bad);
        }
      }
    }
    // Every thread of the block reaches this (the row loop is uniform).
    if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(mis + r, 1);
  }
}

template <bool IS_FLOAT>
void launch(int n_lanes, dim3 grid, int threads, cudaStream_t stream,
            const uint32_t* src, uint32_t* voted, int* mis, int rows,
            long long width, long long lane_stride, long long row_stride,
            const int* offsets) {
  if (n_lanes == 3)
    vote_kernel<IS_FLOAT, 3><<<grid, threads, 0, stream>>>(
        src, voted, mis, rows, width, lane_stride, row_stride, offsets);
  else
    vote_kernel<IS_FLOAT, 2><<<grid, threads, 0, stream>>>(
        src, voted, mis, rows, width, lane_stride, row_stride, offsets);
}

}  // namespace

extern "C" int coast_vote(const void* src, void* voted, int* mis, int rows,
                          int n_lanes, long long width, long long lane_stride,
                          long long row_stride, const int* offsets,
                          int is_float, int device, void* stream) {
  if (rows <= 0 || width <= 0 || (n_lanes != 2 && n_lanes != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Small windows (the scalar control words) get a narrow block; large
  // ones 256 threads x 4 words.
  int threads = 32;
  while (threads < 256 && static_cast<long long>(threads) * 4 < width)
    threads *= 2;
  const long long per_block = static_cast<long long>(threads) * 4;
  const long long bx = (width + per_block - 1) / per_block;
  if (bx > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(bx),
                  static_cast<unsigned>(rows < 65535 ? rows : 65535));
  const auto* s = static_cast<const uint32_t*>(src);
  auto* v = static_cast<uint32_t*>(voted);
  auto st = static_cast<cudaStream_t>(stream);
  if (is_float)
    launch<true>(n_lanes, grid, threads, st, s, v, mis, rows, width,
                 lane_stride, row_stride, offsets);
  else
    launch<false>(n_lanes, grid, threads, st, s, v, mis, rows, width,
                  lane_stride, row_stride, offsets);
  return static_cast<int>(cudaGetLastError());
}
