// What K1 (vote.cu) and K2 (commit.cu) share: the word-level compare and
// vote, the site table of a grouped launch and its scheduling rule.
//
// Compares are in the leaf's type.  IS_FLOAT compares as float32 (IEEE:
// +0 == -0, NaN != NaN) with subnormal operands read as zero, as the
// reference's compare does (XLA flushes subnormals on the CPU and the TPU);
// otherwise as 32-bit integers (int32 and uint32 leaves).  The voted word is
// always a lane's raw bits.
//
// A grouped launch covers up to kMaxSites replica sets ("sites") of one
// sync point, all with the same R batch rows and n lanes.  The table of
// sites is a kernel parameter passed by value (__grid_constant__, read in
// place from the parameter bank): no host-to-device copy, no device
// allocation.  A flat block index walks the (site, row-group or tile)
// tiles of every site in table order:
//   * a site of at most kRowGroupWords words a lane takes the row-group
//     path: a power-of-two group of g <= 32 threads (the smallest that
//     covers the width) takes one row, thread t of the group reads words
//     t, t+g, ... of every lane (coalesced whatever the alignment), the
//     row's flag is reduced with a warp ballot and one thread stores it as
//     a 0/1 int32.  A block of kThreads threads takes kThreads / g rows, so
//     4096 scalar rows are 16 blocks.  No atomics, no flag fill.
//   * a wider site takes the tile path: kThreads threads x 4 words a tile,
//     16-byte loads and stores where aligned, ceil(W / 1024) tiles a row;
//     each block reduces its flag with __syncthreads_or and makes at most
//     one atomicOr into its row's flag word, which the launcher zeroes
//     first with one cudaMemsetAsync over the tile-path sites' flag words
//     (only when such a site is present).
// The launcher lays the tile-path sites out first and the row-group sites
// after them: blocks are issued roughly in index order, so the short
// row-group blocks fill the tail of the wide sites' tiles instead of
// waiting behind them or leaving SMs idle at the end.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace coast {

constexpr int kMaxSites = 16;
constexpr int kThreads = 256;
// Widest lane (in words) the row-group path takes: a full warp then does at
// most 4 words a lane, like a thread of the tile path.
constexpr long long kRowGroupWords = 128;

// One replica set of a grouped launch.  Row r, lane l, word i of the source
// is src[r * row_stride + l * lane_stride + off_r + i], where off_r is
// offsets[r] clamped into [0, lane_stride - width] (0 without offsets).
// ops/site_table.py packs this layout (96 bytes, no padding); the launcher
// fills tiles, first_block and group.
struct Site {
  const uint32_t* src;
  const uint32_t* mask;     // K2: flip masks laid out as src, or null
  uint32_t* out;            // K2: repaired lanes, dense [R, n, width]
  uint32_t* voted;          // [R, width], or null (flags only)
  const int* offsets;       // [R] per-row word offsets, or null
  int* flag;                // [R] 0/1 miscompare flags of this site
  long long width;
  long long lane_stride;
  long long row_stride;
  long long tiles;          // tile path: tiles a row (launcher)
  long long first_block;    // first block of this site (launcher)
  int is_float;
  int group;                // row-group threads a row, 0: tile path (launcher)
};
static_assert(sizeof(Site) == 96, "Site is packed by ops/site_table.py");

struct Table {
  Site site[kMaxSites];
  int count;
  int rows;
};

// -- device side --------------------------------------------------------------

__device__ __forceinline__ uint32_t flush_subnormal(uint32_t w) {
  return (w & 0x7f800000u) ? w : 0u;
}

template <bool IS_FLOAT>
__device__ __forceinline__ bool same(uint32_t a, uint32_t b) {
  if (IS_FLOAT)
    return __uint_as_float(flush_subnormal(a)) ==
           __uint_as_float(flush_subnormal(b));
  return a == b;
}

// TMR (N = 3): (a == b) ? a : c, bad when a != b or b != c.
// DWC (N = 2): a, bad when a != b (c is not read).
template <bool IS_FLOAT, int N>
__device__ __forceinline__ uint32_t vote_word(uint32_t a, uint32_t b,
                                              uint32_t c, bool& bad) {
  const bool ab = same<IS_FLOAT>(a, b);
  if (N == 3) {
    bad |= !ab || !same<IS_FLOAT>(b, c);
    return ab ? a : c;
  }
  bad |= !ab;
  return a;
}

// The site that owns block b (the table is in block order).
__device__ __forceinline__ const Site& site_of(const Table& t, long long b) {
  int s = 0;
  while (s + 1 < t.count && b >= t.site[s + 1].first_block) ++s;
  return t.site[s];
}

// Row r's word offset into each lane, clamped so the window fits.
__device__ __forceinline__ long long row_offset(const Site& s, long long r) {
  if (!s.offsets) return 0;
  long long off = s.offsets[r] < 0 ? 0 : s.offsets[r];
  const long long hi = s.lane_stride - s.width;
  return off > hi ? hi : off;
}

// Row-group path: the row this thread works on.
__device__ __forceinline__ long long group_row(const Site& s, long long lb) {
  return lb * (kThreads / s.group) + threadIdx.x / s.group;
}

// Row-group path: OR `bad` over each group of the warp and store it as the
// group's row flag.  Every thread of the warp must reach this.
__device__ __forceinline__ void store_group_flag(const Site& s, long long r,
                                                 int rows, bool bad) {
  const unsigned ballot = __ballot_sync(0xffffffffu, bad);
  const int lane = threadIdx.x & 31;
  if ((lane & (s.group - 1)) == 0 && r < rows) {
    const unsigned mine =
        s.group == 32 ? ballot : (ballot >> lane) & ((1u << s.group) - 1u);
    s.flag[r] = mine != 0u;
  }
}

// Tile path: the block's row and its first word.
__device__ __forceinline__ void tile_of(const Site& s, long long lb,
                                        long long& r, long long& i0) {
  r = lb / s.tiles;
  i0 = ((lb - r * s.tiles) * kThreads + threadIdx.x) * 4;
}

// -- host side ----------------------------------------------------------------

// Checks the sites, chooses each one's path, lays the table out (tile-path
// sites first), zeroes the tile-path flag words on `stream` and makes the
// launch's device current.  Returns a cudaError_t; *blocks is the grid.
inline int prepare(const Site* sites, int count, int rows, int device,
                   cudaStream_t stream, Table* t, long long* blocks) {
  if (count <= 0 || count > kMaxSites || rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Every site's flags are one row of one [count, rows] block, so the
  // memset below stays inside it.
  int* base = sites[0].flag;
  for (int i = 1; i < count; ++i)
    if (sites[i].flag < base) base = sites[i].flag;
  for (int i = 0; i < count; ++i) {
    const long long d = sites[i].flag - base;
    if (!sites[i].flag || d % rows != 0 || d / rows >= count)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  t->count = count;
  t->rows = rows;
  int* zero_lo = nullptr;
  int* zero_hi = nullptr;
  long long next = 0;
  int k = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = 0; i < count; ++i) {
      Site s = sites[i];
      if (!s.src || !s.flag || s.width <= 0 || s.lane_stride < s.width ||
          s.row_stride < 0)
        return static_cast<int>(cudaErrorInvalidValue);
      const bool grouped = s.width <= kRowGroupWords;
      if (grouped != (pass == 1)) continue;
      long long n;
      if (grouped) {
        s.group = 1;
        while (s.group < 32 && s.group < s.width) s.group *= 2;
        s.tiles = 0;
        const long long per_block = kThreads / s.group;
        n = (rows + per_block - 1) / per_block;
      } else {
        s.group = 0;
        s.tiles = (s.width + kThreads * 4 - 1) / (kThreads * 4);
        n = s.tiles * rows;
        if (!zero_lo || s.flag < zero_lo) zero_lo = s.flag;
        if (!zero_hi || s.flag > zero_hi) zero_hi = s.flag;
      }
      s.first_block = next;
      next += n;
      if (next > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
      t->site[k++] = s;
    }
  }
  if (zero_lo) {
    const size_t words = static_cast<size_t>(zero_hi - zero_lo) + rows;
    err = cudaMemsetAsync(zero_lo, 0, words * sizeof(int), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *blocks = next;
  return static_cast<int>(cudaSuccess);
}

}  // namespace coast
