// K1 for Hopper: the replica-set vote, one grouped launch per sync point.
//
// Replaces the Pallas TPU kernel coast_tpu/ops/pallas_voters.py
// `_vote_kernel` (launched by `_vote_pallas`).  It computes what that
// kernel computes, for a whole campaign batch and for every replica set
// ("site") of one engine sync point in one launch:
//
//   TMR (n = 3): voted = (l0 == l1) ? l0 : l2,
//                mis   = any(l0 != l1) || any(l1 != l2)
//   DWC (n = 2): voted = l0,  mis = any(l0 != l1)
//
// over each site's R batch rows x n lanes x W 32-bit words.  Compares are
// in the site's type (vote_word.cuh): as float (IEEE: +0 == -0, NaN != NaN,
// subnormal operands read as zero, as the reference's XLA compare does) or
// as int32 (int32 and uint32 leaves); the voted word is copied as raw bits.
// Sites of one launch may differ in width, type and window.
//
// What bounds it: bytes.  A site reads R*n*W*4 bytes and writes R*W*4
// voted bytes (none for a flags-only site) and 4*R flag bytes; it does no
// arithmetic worth counting, so its least time on an H100 is those bytes /
// 3.35 TB/s.  At the engine's shapes most sites are small (scalar control
// words, 81-word leaves, batch 4096), where a launch per site and its host
// work cost far more than the bytes.  The design follows from that:
//   * one launch per sync point: a table of up to 16 sites passed by value,
//     walked by a flat block index, with the row-group path for small sites
//     and the 16-byte tile path for wide ones (vote_word.cuh);
//   * flags are written by the kernel as a 0/1 int32 [S, R] block: a plain
//     store per row on the row-group path; on the tile path an atomicOr per
//     block into words the launcher zeroes with one cudaMemsetAsync;
//   * a site with a null `voted` is a flags-only check: DWC reads two lanes
//     and writes only flags (the caller takes lane 0 as the voted view);
//   * a lane stride and an optional per-row word offset let the store-slice
//     vote read its window results[b, :, start_b : start_b + W] in place,
//     with no gather before the vote.  A start clamps into
//     [0, lane_stride - W], so no offset can read outside its lane.
//
// C interface for ctypes (no PyTorch headers, so nvcc builds it in
// seconds): coast_vote_sites(sites, count, rows, n, device, stream) takes a
// host array of coast::Site (mask and out unused), the caller's outputs
// already allocated.  Returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vote_word.cuh"

namespace {

using coast::Site;
using coast::Table;
using coast::kThreads;
using coast::vote_word;

template <bool IS_FLOAT, int N>
__device__ void vote_rows(const Site& s, long long lb, int rows) {
  const long long r = coast::group_row(s, lb);
  bool bad = false;
  if (r < rows) {
    const uint32_t* l0 = s.src + r * s.row_stride + coast::row_offset(s, r);
    const uint32_t* l1 = l0 + s.lane_stride;
    const uint32_t* l2 = N == 3 ? l1 + s.lane_stride : l1;
    uint32_t* out = s.voted ? s.voted + r * s.width : nullptr;
    for (long long i = threadIdx.x & (s.group - 1); i < s.width;
         i += s.group) {
      const uint32_t b = l1[i];
      const uint32_t c = N == 3 ? l2[i] : b;
      const uint32_t v = vote_word<IS_FLOAT, N>(l0[i], b, c, bad);
      if (out) out[i] = v;
    }
  }
  coast::store_group_flag(s, r, rows, bad);
}

template <bool IS_FLOAT, int N>
__device__ void vote_tile(const Site& s, long long lb) {
  long long r, i0;
  coast::tile_of(s, lb, r, i0);
  const uint32_t* l0 = s.src + r * s.row_stride + coast::row_offset(s, r);
  const uint32_t* l1 = l0 + s.lane_stride;
  const uint32_t* l2 = N == 3 ? l1 + s.lane_stride : l1;
  uint32_t* out = s.voted ? s.voted + r * s.width : nullptr;
  bool bad = false;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(l0 + i0) |
                         reinterpret_cast<uintptr_t>(l1 + i0) |
                         reinterpret_cast<uintptr_t>(l2 + i0) |
                         (out ? reinterpret_cast<uintptr_t>(out + i0) : 0);
  if (i0 + 4 <= s.width && (addr & 15) == 0) {
    const uint4 a = *reinterpret_cast<const uint4*>(l0 + i0);
    const uint4 b = *reinterpret_cast<const uint4*>(l1 + i0);
    const uint4 c = N == 3 ? *reinterpret_cast<const uint4*>(l2 + i0) : b;
    uint4 v;
    v.x = vote_word<IS_FLOAT, N>(a.x, b.x, c.x, bad);
    v.y = vote_word<IS_FLOAT, N>(a.y, b.y, c.y, bad);
    v.z = vote_word<IS_FLOAT, N>(a.z, b.z, c.z, bad);
    v.w = vote_word<IS_FLOAT, N>(a.w, b.w, c.w, bad);
    if (out) *reinterpret_cast<uint4*>(out + i0) = v;
  } else {
    for (int j = 0; j < 4; ++j) {
      const long long i = i0 + j;
      if (i < s.width) {
        const uint32_t b = l1[i];
        const uint32_t c = N == 3 ? l2[i] : b;
        const uint32_t v = vote_word<IS_FLOAT, N>(l0[i], b, c, bad);
        if (out) out[i] = v;
      }
    }
  }
  // The whole block works on this site (block-uniform branch).
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(s.flag + r, 1);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    vote_kernel(const __grid_constant__ Table t) {
  const long long b = blockIdx.x;
  const Site& s = coast::site_of(t, b);
  const long long lb = b - s.first_block;
  if (s.group) {
    if (s.is_float)
      vote_rows<true, N>(s, lb, t.rows);
    else
      vote_rows<false, N>(s, lb, t.rows);
  } else if (s.is_float) {
    vote_tile<true, N>(s, lb);
  } else {
    vote_tile<false, N>(s, lb);
  }
}

}  // namespace

extern "C" int coast_vote_sites(const Site* sites, int count, int rows,
                                int n_lanes, int device, void* stream) {
  if (n_lanes != 2 && n_lanes != 3)
    return static_cast<int>(cudaErrorInvalidValue);
  Table t;
  long long blocks = 0;
  auto st = static_cast<cudaStream_t>(stream);
  const int err = coast::prepare(sites, count, rows, device, st, &t, &blocks);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (n_lanes == 3)
    vote_kernel<3><<<grid, kThreads, 0, st>>>(t);
  else
    vote_kernel<2><<<grid, kThreads, 0, st>>>(t);
  return static_cast<int>(cudaGetLastError());
}
