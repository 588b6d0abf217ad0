// K2 for Hopper: the fused commit -- flip, vote, repair in one pass, one
// grouped launch per sync point.
//
// Replaces the Pallas TPU kernel coast_tpu/ops/fused_step.py
// `_commit_kernel` (launched by `_vote_flip_call`).  It computes what that
// kernel computes, for a whole campaign batch and for every replica set
// ("site") of one engine sync point in one launch, over each site's R batch
// rows x n lanes x W 32-bit words and an optional flip mask of the same
// shape:
//
//   f = lanes ^ mask                                   (every lane)
//   TMR (n = 3): voted = (f0 == f1) ? f0 : f2,  repaired[l] = voted,
//                mis   = any(f0 != f1) || any(f1 != f2)
//   DWC (n = 2): voted = f0,  repaired = f,  mis = any(f0 != f1)
//
// Compares are those of K1 (vote_word.cuh): float32 as IEEE floats with
// subnormal operands read as zero, int words as integers; every output word
// is raw bits.  Sites of one launch may differ in width, type and mask.
//
// What bounds it: bytes.  Without a mask a site reads n*W words and writes
// (n + 1)*W per row (TMR: 3W in, 4W out) and a flag word; a mask adds n*W
// words read.  It does no arithmetic worth counting, so its least time on
// an H100 is those bytes / 3.35 TB/s.  At the fused engine's shapes the
// sites are small (an 81-word leaf and scalar control words at batch 4096),
// where a launch per site and its host work cost far more than the bytes.
// The design follows from that:
//   * one launch per sync point: a table of up to 16 sites passed by value,
//     walked by a flat block index, with the row-group path for small sites
//     and the 16-byte tile path for wide ones (vote_word.cuh);
//   * flags are written by the kernel as a 0/1 int32 [S, R] block: a plain
//     store per row on the row-group path; on the tile path an atomicOr per
//     block into words the launcher zeroes with one cudaMemsetAsync;
//   * each thread holds the voted words in registers and stores them to
//     every lane and to `voted`: the repair broadcast costs no second read;
//   * HAS_MASK is chosen per site: the engine flips sparsely before the step
//     and commits with no mask, and that path reads no mask bytes.
//
// `out` (the repaired lanes) is a buffer of its own, never the input: the
// engine keeps the pre-step image to freeze halted rows, and a later
// in-place flip must hit one lane only.
//
// C interface for ctypes (no PyTorch headers, so nvcc builds it in
// seconds): coast_commit_sites(sites, count, rows, n, device, stream) takes
// a host array of coast::Site with dense lanes (lane_stride = W, row_stride
// = n*W, no offsets), `out` and `voted` already allocated.  Returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vote_word.cuh"

namespace {

using coast::Site;
using coast::Table;
using coast::kThreads;
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

// One word i of row r: flip, vote, write voted and the repaired lanes.
template <bool IS_FLOAT, int N, bool HAS_MASK>
__device__ __forceinline__ void commit_word(const uint32_t* l0,
                                            const uint32_t* m0, uint32_t* o0,
                                            uint32_t* out, long long w,
                                            long long i, bool& bad) {
  uint32_t a = l0[i];
  uint32_t b = l0[w + i];
  uint32_t c = N == 3 ? l0[2 * w + i] : b;
  if (HAS_MASK) {
    a ^= m0[i];
    b ^= m0[w + i];
    if (N == 3) c ^= m0[2 * w + i];
  }
  const uint32_t v = vote_word<IS_FLOAT, N>(a, b, c, bad);
  out[i] = v;
  if (N == 3) {
    o0[i] = v;
    o0[w + i] = v;
    o0[2 * w + i] = v;
  } else {
    o0[i] = a;
    o0[w + i] = b;
  }
}

template <bool IS_FLOAT, int N, bool HAS_MASK>
__device__ void commit_rows(const Site& s, long long lb, int rows) {
  const long long r = coast::group_row(s, lb);
  const long long w = s.width;
  bool bad = false;
  if (r < rows) {
    const long long base = r * N * w;
    const uint32_t* m0 = HAS_MASK ? s.mask + base : nullptr;
    for (long long i = threadIdx.x & (s.group - 1); i < w; i += s.group)
      commit_word<IS_FLOAT, N, HAS_MASK>(s.src + base, m0, s.out + base,
                                         s.voted + r * w, w, i, bad);
  }
  coast::store_group_flag(s, r, rows, bad);
}

template <bool IS_FLOAT, int N, bool HAS_MASK>
__device__ void commit_tile(const Site& s, long long lb) {
  long long r, i0;
  coast::tile_of(s, lb, r, i0);
  const long long w = s.width;
  const long long base = r * N * w;
  const uint32_t* l0 = s.src + base;
  const uint32_t* m0 = HAS_MASK ? s.mask + base : nullptr;
  uint32_t* o0 = s.out + base;
  uint32_t* out = s.voted + r * w;
  bool bad = false;
  // The lanes of a row lie w words apart, and so do the masks' and the
  // outputs': every pointer below is aligned when these are and w is a
  // multiple of 4.
  const uintptr_t addr = reinterpret_cast<uintptr_t>(l0 + i0) |
                         reinterpret_cast<uintptr_t>(o0 + i0) |
                         reinterpret_cast<uintptr_t>(out + i0) |
                         (HAS_MASK ? reinterpret_cast<uintptr_t>(m0 + i0)
                                   : 0) |
                         static_cast<uintptr_t>(w * 4);
  if (i0 + 4 <= w && (addr & 15) == 0) {
    uint4 a = load4(l0 + i0);
    uint4 b = load4(l0 + w + i0);
    uint4 c = N == 3 ? load4(l0 + 2 * w + i0) : b;
    if (HAS_MASK) {
      a = xor4(a, load4(m0 + i0));
      b = xor4(b, load4(m0 + w + i0));
      if (N == 3) c = xor4(c, load4(m0 + 2 * w + i0));
    }
    uint4 v;
    v.x = vote_word<IS_FLOAT, N>(a.x, b.x, c.x, bad);
    v.y = vote_word<IS_FLOAT, N>(a.y, b.y, c.y, bad);
    v.z = vote_word<IS_FLOAT, N>(a.z, b.z, c.z, bad);
    v.w = vote_word<IS_FLOAT, N>(a.w, b.w, c.w, bad);
    store4(out + i0, v);
    if (N == 3) {
      store4(o0 + i0, v);
      store4(o0 + w + i0, v);
      store4(o0 + 2 * w + i0, v);
    } else {
      store4(o0 + i0, a);
      store4(o0 + w + i0, b);
    }
  } else {
    for (long long i = i0; i < i0 + 4 && i < w; ++i)
      commit_word<IS_FLOAT, N, HAS_MASK>(l0, m0, o0, out, w, i, bad);
  }
  // The whole block works on this site (block-uniform branch).
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(s.flag + r, 1);
}

template <bool IS_FLOAT, int N, bool HAS_MASK>
__device__ __forceinline__ void commit_site(const Site& s, long long lb,
                                            int rows) {
  if (s.group)
    commit_rows<IS_FLOAT, N, HAS_MASK>(s, lb, rows);
  else
    commit_tile<IS_FLOAT, N, HAS_MASK>(s, lb);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    commit_kernel(const __grid_constant__ Table t) {
  const long long b = blockIdx.x;
  const Site& s = coast::site_of(t, b);
  const long long lb = b - s.first_block;
  if (s.is_float) {
    if (s.mask)
      commit_site<true, N, true>(s, lb, t.rows);
    else
      commit_site<true, N, false>(s, lb, t.rows);
  } else if (s.mask) {
    commit_site<false, N, true>(s, lb, t.rows);
  } else {
    commit_site<false, N, false>(s, lb, t.rows);
  }
}

}  // namespace

extern "C" int coast_commit_sites(const Site* sites, int count, int rows,
                                  int n_lanes, int device, void* stream) {
  if ((n_lanes != 2 && n_lanes != 3) || count <= 0 ||
      count > coast::kMaxSites)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < count; ++i) {
    const Site& s = sites[i];
    if (!s.out || !s.voted || s.offsets || s.lane_stride != s.width ||
        s.row_stride != n_lanes * s.width)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  Table t;
  long long blocks = 0;
  auto st = static_cast<cudaStream_t>(stream);
  const int err = coast::prepare(sites, count, rows, device, st, &t, &blocks);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(blocks));
  if (n_lanes == 3)
    commit_kernel<3><<<grid, kThreads, 0, st>>>(t);
  else
    commit_kernel<2><<<grid, kThreads, 0, st>>>(t);
  return static_cast<int>(cudaGetLastError());
}
