// K2 for Hopper: the fused commit -- flip, vote, repair in one pass.
//
// Replaces the Pallas TPU kernel coast_tpu/ops/fused_step.py
// `_commit_kernel` (launched by `_vote_flip_call`).  It computes what that
// kernel computes, for a whole campaign batch in one launch, over a replica
// set of R batch rows x n lanes x W 32-bit words and an optional flip mask
// of the same shape:
//
//   f = lanes ^ mask                                   (every lane)
//   TMR (n = 3): voted = (f0 == f1) ? f0 : f2,  repaired[l] = voted,
//                mis   = any(f0 != f1) || any(f1 != f2)
//   DWC (n = 2): voted = f0,  repaired = f,  mis = any(f0 != f1)
//
// Compares are those of K1 (vote_word.cuh): float32 as IEEE floats with
// subnormal operands read as zero, int words as integers; every output word
// is raw bits.
//
// What bounds it: bytes.  Without a mask it reads n*W words and writes
// (n + 1)*W per row (TMR: 3W in, 4W out), with a mask it reads 2n*W; it does
// no arithmetic worth counting, so its least time on an H100 is those bytes
// / 3.35 TB/s.  The design follows from that:
//   * each thread moves 4 consecutive words of every lane with 16-byte
//     loads and stores when they are 16-byte aligned, neighbouring threads on
//     neighbouring addresses (a scalar tail otherwise), so the voted value is
//     written to all n lanes and to `voted` from registers: the repair
//     broadcast costs no second read;
//   * grid = (ceil(W / (threads*4)), R): the whole batch is one launch, the
//     batch axis the TPU kernel got from vmap is written out;
//   * the miscompare flag: the TPU kernel writes an (8,128) flag block per
//     grid step and the host ORs them.  Here blocks run in parallel in no
//     order, so each block reduces its flag with __syncthreads_or and issues
//     at most one atomicOr(&mis[r], 1);
//   * HAS_MASK is a template flag: the engine flips sparsely before the
//     step and calls K2 with no mask, and that instantiation reads no mask
//     bytes;
//   * no shape gate: any W runs (the engine's leaves are 1 to 81 words).
//
// `repaired` is a buffer of its own, never the input: the engine keeps the
// pre-step image to freeze halted rows, and a later in-place flip must hit
// one lane only.
//
// C interface for ctypes (no PyTorch headers, so nvcc builds it in
// seconds).  The caller allocates `repaired` [R, n, W] and `voted` [R, W],
// and zeroes `mis` [R].  Returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vote_word.cuh"

namespace {

using coast::vote_word;

__device__ __forceinline__ uint4 load4(const uint32_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void store4(uint32_t* p, uint4 v) {
  *reinterpret_cast<uint4*>(p) = v;
}

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

template <bool IS_FLOAT, int N, bool HAS_MASK>
__global__ void commit_kernel(const uint32_t* __restrict__ src,
                              const uint32_t* __restrict__ masks,
                              uint32_t* __restrict__ repaired,
                              uint32_t* __restrict__ voted,
                              int* __restrict__ mis, int rows,
                              long long width) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const long long base = static_cast<long long>(r) * N * width;
    const uint32_t* l0 = src + base;
    const uint32_t* l1 = l0 + width;
    const uint32_t* l2 = N == 3 ? l1 + width : l1;
    const uint32_t* m0 = HAS_MASK ? masks + base : nullptr;
    uint32_t* o0 = repaired + base;
    uint32_t* out = voted + static_cast<long long>(r) * width;
    bool bad = false;
    // The lanes of a row lie width words apart, and so do the masks' and
    // the outputs': every pointer below is aligned when these are and
    // width is a multiple of 4.
    const uintptr_t addr = reinterpret_cast<uintptr_t>(l0 + i0) |
                           reinterpret_cast<uintptr_t>(o0 + i0) |
                           reinterpret_cast<uintptr_t>(out + i0) |
                           (HAS_MASK ? reinterpret_cast<uintptr_t>(m0 + i0)
                                     : 0) |
                           static_cast<uintptr_t>(width * 4);
    if (i0 + 4 <= width && (addr & 15) == 0) {
      uint4 a = load4(l0 + i0);
      uint4 b = load4(l1 + i0);
      uint4 c = N == 3 ? load4(l2 + i0) : b;
      if (HAS_MASK) {
        a = xor4(a, load4(m0 + i0));
        b = xor4(b, load4(m0 + width + i0));
        if (N == 3) c = xor4(c, load4(m0 + 2 * width + i0));
      }
      uint4 v;
      v.x = vote_word<IS_FLOAT, N>(a.x, b.x, c.x, bad);
      v.y = vote_word<IS_FLOAT, N>(a.y, b.y, c.y, bad);
      v.z = vote_word<IS_FLOAT, N>(a.z, b.z, c.z, bad);
      v.w = vote_word<IS_FLOAT, N>(a.w, b.w, c.w, bad);
      store4(out + i0, v);
      if (N == 3) {
        store4(o0 + i0, v);
        store4(o0 + width + i0, v);
        store4(o0 + 2 * width + i0, v);
      } else {
        store4(o0 + i0, a);
        store4(o0 + width + i0, b);
      }
    } else {
      for (int j = 0; j < 4; ++j) {
        const long long i = i0 + j;
        if (i < width) {
          uint32_t a = l0[i];
          uint32_t b = l1[i];
          uint32_t c = N == 3 ? l2[i] : b;
          if (HAS_MASK) {
            a ^= m0[i];
            b ^= m0[width + i];
            if (N == 3) c ^= m0[2 * width + i];
          }
          const uint32_t v = vote_word<IS_FLOAT, N>(a, b, c, bad);
          out[i] = v;
          if (N == 3) {
            o0[i] = v;
            o0[width + i] = v;
            o0[2 * width + i] = v;
          } else {
            o0[i] = a;
            o0[width + i] = b;
          }
        }
      }
    }
    // Every thread of the block reaches this (the row loop is uniform).
    if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(mis + r, 1);
  }
}

template <bool IS_FLOAT, int N>
void launch_n(bool has_mask, dim3 grid, int threads, cudaStream_t stream,
              const uint32_t* src, const uint32_t* masks, uint32_t* repaired,
              uint32_t* voted, int* mis, int rows, long long width) {
  if (has_mask)
    commit_kernel<IS_FLOAT, N, true><<<grid, threads, 0, stream>>>(
        src, masks, repaired, voted, mis, rows, width);
  else
    commit_kernel<IS_FLOAT, N, false><<<grid, threads, 0, stream>>>(
        src, nullptr, repaired, voted, mis, rows, width);
}

template <bool IS_FLOAT>
void launch(int n_lanes, bool has_mask, dim3 grid, int threads,
            cudaStream_t stream, const uint32_t* src, const uint32_t* masks,
            uint32_t* repaired, uint32_t* voted, int* mis, int rows,
            long long width) {
  if (n_lanes == 3)
    launch_n<IS_FLOAT, 3>(has_mask, grid, threads, stream, src, masks,
                          repaired, voted, mis, rows, width);
  else
    launch_n<IS_FLOAT, 2>(has_mask, grid, threads, stream, src, masks,
                          repaired, voted, mis, rows, width);
}

}  // namespace

extern "C" int coast_commit(const void* src, const void* masks,
                            void* repaired, void* voted, int* mis, int rows,
                            int n_lanes, long long width, int is_float,
                            int device, void* stream) {
  if (rows <= 0 || width <= 0 || (n_lanes != 2 && n_lanes != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Small leaves (the scalar control words, the 81-word results) get a
  // narrow block; large ones 256 threads x 4 words.
  int threads = 32;
  while (threads < 256 && static_cast<long long>(threads) * 4 < width)
    threads *= 2;
  const long long per_block = static_cast<long long>(threads) * 4;
  const long long bx = (width + per_block - 1) / per_block;
  if (bx > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(bx),
                  static_cast<unsigned>(rows < 65535 ? rows : 65535));
  const auto* s = static_cast<const uint32_t*>(src);
  const auto* m = static_cast<const uint32_t*>(masks);
  auto* rep = static_cast<uint32_t*>(repaired);
  auto* v = static_cast<uint32_t*>(voted);
  auto st = static_cast<cudaStream_t>(stream);
  if (is_float)
    launch<true>(n_lanes, m != nullptr, grid, threads, st, s, m, rep, v, mis,
                 rows, width);
  else
    launch<false>(n_lanes, m != nullptr, grid, threads, st, s, m, rep, v, mis,
                  rows, width);
  return static_cast<int>(cudaGetLastError());
}
