// The gradient of the fused render (render_fused.cu) with respect to the
// MPI planes, in two kernels:
//
//   d planes = warp^T( composite_vjp( warp(planes), g ) )
//
// Replaces the four backward TPU kernels of mpi_vision_tpu/kernels/
// render_pallas_bwd.py and the XLA composite VJP between them:
//   kernel A (rewarp_composite_vjp_kernel) <- _warp_sep_kernel and
//     _warp_shr_kernel (the re-warp) fused with _composite_bwd;
//   kernel B (adjoint_warp_kernel) <- _adjoint_sep_kernel and
//     _adjoint_shr_kernel (the warp transpose).
// The TPU versions need planners, tap-fan caps, gather windows and an XLA
// fallback because a lane gather reaches one 128-lane window; the banded
// tier has no Pallas backward at all. A Hopper thread gathers from anywhere,
// so these two kernels take every pose, with no plan and no fallback.
//
// Kernel A, one thread per target pixel (x, y) of view v. Re-samples every
// plane exactly as the forward does (render_sample.cuh), then runs the
// over-composite's VJP from the front plane to the back:
//   d rgb_p = g * a_p
//   d a_p   = sum_c g_c * (rgb_p,c - below_p,c)    (below_p: planes 0..p-1
//                                                   composited)
//   g       = g * (1 - a_p)
//   plane 0: d rgb_0 = g, d a_0 = 0.
// below_p comes from the forward pass over the planes, never from dividing
// by 1 - a (alphas reach 1). The forward pass keeps a record (rgb_p -
// below_p, a_p) of each plane p >= 1 for the reverse pass. The plane count
// picks where the records live, one path each (rewarp_launch below makes
// the choice and mpi_rewarp_launch_shape reports it; render_fused_bwd.py's
// rewarp_launch_shape mirrors it, held to the report on the card; no path
// falls back to another):
//   registers, P <= kRegPlanes (16): one thread per pixel, a kernel per
//     bucket of 4 planes with both loops unrolled to the bucket, so each
//     record is a named register (0 bytes of stack; a runtime index would
//     put the array in local memory, which lives in HBM); the taps of the
//     next kAhead planes come into shared memory by cp.async while one
//     plane is composited, so they cost no registers (sample_plane's two
//     halves, tap_point and blend_taps, run either side of the copy);
//   shared, P <= kSmemPlanes (64): a block of 256 threads stages a 32 x 2
//     tile's samples in shared memory, [plane][pixel] float4, all threads
//     sampling; one thread per pixel then overwrites its samples with its
//     records and those with their gradients, and all threads store them.
//     1 KiB a plane and the maps a block (33.9 KB at 32 planes, six blocks
//     an SM); past 48 KB the launch opts in, and its error is returned;
//   global, past the cap: the kernel's first design, which parks each
//     record in the thread's own slot of dwarped and overwrites it in the
//     reverse pass.
// The first two write nothing to global memory but dwarped, streamed past
// L2 (st.global.cs), and walk (view, tile) items with the views of a tile
// adjacent, so that with one shared scene the views after the first find
// its taps in L2. One thread per pixel cannot hold 32 planes' records and
// keep enough loads in flight (it measured no faster than the global path
// at 1080p x 32): the shared path gets its loads in flight from all the
// block's threads instead.
//
// Kernel B is the warp transpose in gather form:
//   d plane(x, y) = sum_v sum_{(i, j)} dwarped[v, p, i, j]
//                   * k_y(py(j, i), y) * k_x(px(j, i), x)
// over the target pixels (j, i) whose forward sample point (px, py) - the
// forward kernel's own f32 expression, its d == 0 nudge and its reach guard
// - puts source pixel (x, y) among its four bilinear taps, with k the tap's
// forward weight (1 - frac or frac). Each source pixel sums its hits in
// ascending (view, i, j), so the gradient is deterministic: no global and
// no shared-memory atomics. With one scene shared by all views (view stride
// 0, the training path at batch 1) the views sum into one gradient;
// otherwise each view's scene gets its own.
//
// Kernel B's design. One block is one 64 x 16 source tile of one plane:
// 256 threads, one per column, each summing four rows. It loops over the
// views in order and works out each view's geometry once for the tile:
//   1. Warp 0 maps the tile's corners +- 1 through the inverse map in
//      double (one adjugate entry and one corner per lane) and takes the
//      integer bounding box of the result, widened to floor/ceil (which
//      absorbs the forward's f32 rounding) and clamped to the image: the
//      tile's preimage. Where the inverse denominator is not one-signed
//      over the tile's box (the plane crosses the camera's plane there and
//      the preimage is unbounded) the box is the whole image: slow, and
//      right.
//   2. The preimage is staged in shared memory in chunks of row segments
//      taken in ascending (i, j): a row wider than kSegMax is cut into
//      equal segments, so a magnified or whole-image preimage goes through
//      the same ~40 KB in more chunks. For each staged target one thread
//      evaluates warp_point once and keeps its sample point (kNoTap out of
//      reach); its dwarped value comes in by cp.async, coalesced 16-byte
//      copies along the row. dwarped is read once per tile plus a halo.
//   3. One warp per segment scans the running max of the tap origins x0
//      from the left and their running min from the right. Both are
//      monotone whatever the f32 rounding did to x0, so for each tile
//      column x the targets with x0 in {x - 1, x} lie in one span of the
//      segment; the warp writes every column's span into a byte table, and
//      the segment's y0 range.
//   4. Each thread skips the segments whose y0 range misses its rows and
//      reads each entry of its column's span once for its four rows.
// The hits, their order and their expressions are the per-pixel scan's,
// so the kernel equals plain_adjoint_warp (which scans each pixel's own
// candidate box) to the bit: non-hits add nothing. render_fused_bwd.py's
// tile_boxes / tile_chunks / tile_scan are the plain mirror of steps 1-4.
//
// What bounds it. Its bytes (dwarped in, d planes out) take ~0.63 ms at
// 1080p x 32; it runs at ~3.5x that. Each phase is a dependent chain
// (the box's divisions, warp_point's four IEEE divisions before the copy,
// the warp scans, the span reads) between barriers, and five blocks of
// eight warps an SM (48 registers, with spills) do not hide it all.
//
// Layouts (float32): planes [P, H, W, 4] shared, or [V, P, H, W, 4] at
// `view_stride` floats per view; homs [V, P, 3, 3] target -> source pixels;
// g [V, H, W, 3]; dwarped [V, P, H, W, 4]; dplanes like planes.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32), 1080p x 32 planes, one
// view: A reads the planes (1.06 GB) and g (25 MB) and writes dwarped
// (1.06 GB); B reads dwarped and writes d planes (1.06 GB each). Together
// ~4.25 GB, ~1.27 ms. A's arithmetic is the forward's 67 operations per
// pixel and plane plus 15 for the VJP, B's ~57 per target sample it
// transposes: each is far under its byte time, so both are bandwidth bound.
// A's registers and shared paths move only the bound's bytes (at V views
// of one scene, the scene once if L2 serves the other views' taps); its
// global path also writes and reads back its parked records (~1 GB more
// at 32 planes). B spends bytes on the preimage's halo (~1.4 targets
// staged per source pixel near the identity). PERF.md has the measured
// times beside the bounds.

#include <cuda_runtime.h>

#include <climits>
#include <math.h>

#include "render_sample.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// Kernel A's global path (more than kSmemPlanes planes): one thread per
// target pixel of a 32 x 8 tile, one view per blockIdx.z, each record
// parked in the thread's own slot of dwarped.
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__global__ void __launch_bounds__(kBlockX * kBlockY)
rewarp_composite_vjp_kernel_global(const float4* __restrict__ planes,
                                   const float* __restrict__ homs,
                                   const float* __restrict__ g,
                                   float4* __restrict__ dwarped,
                                   int num_planes, int height, int width,
                                   long long view_stride4) {
  extern __shared__ float sh_homs[];  // [num_planes * 9]
  const int view = blockIdx.z;
  const float* view_homs = homs + static_cast<long long>(view) * num_planes * 9;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < num_planes * 9; i += blockDim.x * blockDim.y) {
    sh_homs[i] = view_homs[i];
  }
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;

  const float ox = static_cast<float>(x);
  const float oy = static_cast<float>(y);
  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(height);
  const long long plane_size = static_cast<long long>(height) * width;
  const float4* scene = planes + view_stride4 * view;
  const long long pixel = static_cast<long long>(y) * width + x;
  float4* out = dwarped + static_cast<long long>(view) * num_planes * plane_size
                + pixel;

  // Forward: the composite below each plane, and what the VJP needs of it.
  float cr = 0.f, cg = 0.f, cb = 0.f;
  for (int p = 0; p < num_planes; ++p) {
    float px, py;
    warp_point(sh_homs + p * 9, ox, oy, fw, fh, &px, &py);
    const float4 s = sample_plane(scene + plane_size * p, px, py, width,
                                  height);
    if (p == 0) {  // farthest plane: alpha ignored
      cr = s.x;
      cg = s.y;
      cb = s.z;
    } else {
      out[plane_size * p] = make_float4(s.x - cr, s.y - cg, s.z - cb, s.w);
      const float keep = 1.f - s.w;
      cr = s.x * s.w + cr * keep;
      cg = s.y * s.w + cg * keep;
      cb = s.z * s.w + cb * keep;
    }
  }

  // Reverse: front to back.
  const float* gp = g + (static_cast<long long>(view) * plane_size + pixel) * 3;
  float g0 = gp[0], g1 = gp[1], g2 = gp[2];
  for (int p = num_planes - 1; p >= 1; --p) {
    const float4 rec = out[plane_size * p];  // (rgb - below, alpha)
    const float a = rec.w;
    const float da = g0 * rec.x + g1 * rec.y + g2 * rec.z;
    out[plane_size * p] = make_float4(g0 * a, g1 * a, g2 * a, da);
    const float keep = 1.f - a;
    g0 = g0 * keep;
    g1 = g1 * keep;
    g2 = g2 * keep;
  }
  out[0] = make_float4(g0, g1, g2, 0.f);
}

// Kernel A's on-chip paths take (view, tile) items of 32 x 2 target pixels
// from a 1-D grid, the views of a tile adjacent: with one shared scene
// (view_stride4 == 0) the views after the first find its taps in L2.
constexpr int kTileAX = 32;
constexpr int kTileAY = 2;
constexpr int kTilePixels = kTileAX * kTileAY;
constexpr int kRegPlanes = 16;  // the registers path, in buckets of 4
constexpr int kRegBucket = 4;
constexpr int kSmemPlanes = 64;  // the shared path, from kRegPlanes + 1
constexpr int kSharedThreads = 256;
// Six blocks an SM: at most 40 registers a thread.
constexpr int kSharedBlocks = 6;

struct Item {
  int view, x_lo, y_lo;
};

// Item `item`'s view and tile; stages the view's P x 9 maps in sh_homs,
// behind a barrier on each side (the last item's readers, this item's).
__device__ __forceinline__ Item open_item(long long item, int views,
                                          int tiles_x, const float* homs,
                                          int num_planes, float* sh_homs,
                                          int threads) {
  Item it;
  it.view = static_cast<int>(item % views);
  const long long tile = item / views;
  it.x_lo = static_cast<int>(tile % tiles_x) * kTileAX;
  it.y_lo = static_cast<int>(tile / tiles_x) * kTileAY;
  __syncthreads();
  const float* view_homs =
      homs + static_cast<long long>(it.view) * num_planes * 9;
  for (int i = threadIdx.x; i < num_planes * 9; i += threads) {
    sh_homs[i] = view_homs[i];
  }
  __syncthreads();
  return it;
}

// -- The registers path: one thread per target pixel. ------------------

// Planes whose taps are in flight while one plane is composited.
constexpr int kAhead = 4;

// 16 bytes from global to shared memory without a register (cp.async,
// cached in L1: neighbouring pixels share taps); `valid` false writes
// zeros and reads nothing. The "memory" clobbers keep the compiler from
// moving shared-memory reads of a slot past the copy that refills it.
__device__ __forceinline__ void tap_async(float4* smem_dst,
                                          const float4* gmem_src,
                                          bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem_src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit_taps() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// sample_plane's first half (render_sample.cuh): plane `plane`'s four taps
// at target pixel (ox, oy) copied asynchronously into taps[0..3] (stride
// kTilePixels), each zero outside the image, all four zero out of reach.
// Returns the fractions (wx, wy), zero out of reach, and commits one
// cp.async group.
__device__ __forceinline__ float2 fetch_taps(const float4* __restrict__ plane,
                                             const float* h, float ox,
                                             float oy, float fw, float fh,
                                             int width, int height,
                                             float4* taps) {
  float px, py;
  warp_point(h, ox, oy, fw, fh, &px, &py);
  const bool reach = in_reach(px, py, fw, fh);
  TapPoint t = {0, 0, 0.f, 0.f};
  if (reach) t = tap_point(px, py);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int x = t.x0 + (k & 1);
    const int y = t.y0 + (k >> 1);
    const bool ok = reach && x >= 0 && x < width && y >= 0 && y < height;
    tap_async(taps + k * kTilePixels, plane + (ok ? y * width + x : 0), ok);
  }
  commit_taps();
  return make_float2(t.wx, t.wy);
}

// Its second half: sample_plane's blend of the staged taps. Out of reach
// the zero taps and fractions give +0, as sample_plane's early return.
__device__ __forceinline__ float4 blend_staged(const float4* taps, float2 f) {
  return blend_taps(taps[0], taps[kTilePixels], taps[2 * kTilePixels],
                    taps[3 * kTilePixels], f.x, f.y);
}

// Up to kBucket planes, both loops unrolled to kBucket (p < num_planes
// guards the tail), so every index is a constant and plane p's record
// rec[p] a named register. The taps wait in shared memory, not in
// registers: plane p's in ring slot p % kAhead, refilled with plane p +
// kAhead once p is blended, one cp.async group a plane (an empty one past
// the last plane, so that waiting for all but the kAhead - 1 newest
// groups always means plane p's).
template <int kBucket>
__global__ void __launch_bounds__(kTilePixels)
rewarp_composite_vjp_kernel_registers(const float4* __restrict__ planes,
                                      const float* __restrict__ homs,
                                      const float* __restrict__ g,
                                      float4* __restrict__ dwarped, int views,
                                      int num_planes, int height, int width,
                                      long long view_stride4,
                                      long long items) {
  __shared__ float sh_homs[kBucket * 9];
  __shared__ float4 sh_taps[kAhead][4][kTilePixels];  // [slot][tap][thread]
  const int tid = threadIdx.x;
  const int tiles_x = (width + kTileAX - 1) / kTileAX;
  const long long plane_size = static_cast<long long>(height) * width;
  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(height);
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const Item it = open_item(item, views, tiles_x, homs, num_planes,
                              sh_homs, kTilePixels);
    const int x = it.x_lo + tid % kTileAX;
    const int y = it.y_lo + tid / kTileAX;
    if (x >= width || y >= height) continue;
    const float ox = static_cast<float>(x);
    const float oy = static_cast<float>(y);
    const long long pixel = static_cast<long long>(y) * width + x;
    const float4* scene = planes + view_stride4 * it.view;

    // Forward.
    float2 frac[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (i < num_planes) {
        frac[i] = fetch_taps(scene + plane_size * i, sh_homs + i * 9, ox, oy,
                             fw, fh, width, height, &sh_taps[i][0][tid]);
      } else {
        commit_taps();
      }
    }
    float4 rec[kBucket];
    float cr = 0.f, cg = 0.f, cb = 0.f;
#pragma unroll
    for (int p = 0; p < kBucket; ++p) {
      if (p >= num_planes) break;
      constexpr int kWait = kAhead - 1;
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kWait) : "memory");
      const int slot = p % kAhead;
      const float4 s = blend_staged(&sh_taps[slot][0][tid], frac[slot]);
      const int q = p + kAhead;
      if (q < num_planes) {
        frac[slot] = fetch_taps(scene + plane_size * q, sh_homs + q * 9, ox,
                                oy, fw, fh, width, height,
                                &sh_taps[slot][0][tid]);
      } else {
        commit_taps();
      }
      if (p == 0) {  // farthest plane: alpha ignored
        cr = s.x;
        cg = s.y;
        cb = s.z;
      } else {
        rec[p] = make_float4(s.x - cr, s.y - cg, s.z - cb, s.w);
        const float keep = 1.f - s.w;
        cr = s.x * s.w + cr * keep;
        cg = s.y * s.w + cg * keep;
        cb = s.z * s.w + cb * keep;
      }
    }

    // Reverse: front to back; dwarped is written once, streamed past L2.
    const float* gp =
        g + (static_cast<long long>(it.view) * plane_size + pixel) * 3;
    float4* out = dwarped
        + static_cast<long long>(it.view) * num_planes * plane_size + pixel;
    float g0 = gp[0], g1 = gp[1], g2 = gp[2];
#pragma unroll
    for (int p = kBucket - 1; p >= 1; --p) {
      if (p >= num_planes) continue;
      const float4 r = rec[p];  // (rgb - below, alpha)
      const float a = r.w;
      const float da = g0 * r.x + g1 * r.y + g2 * r.z;
      __stcs(out + plane_size * p, make_float4(g0 * a, g1 * a, g2 * a, da));
      const float keep = 1.f - a;
      g0 = g0 * keep;
      g1 = g1 * keep;
      g2 = g2 * keep;
    }
    __stcs(out, make_float4(g0, g1, g2, 0.f));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// -- The shared path: a tile's samples staged in shared memory. ----------
//
// One thread per target pixel holds too many records for enough threads
// to keep HBM busy. So a block of kSharedThreads works on one tile in
// three phases, with a [plane][pixel] float4 slot per sample:
//   1. every thread samples (plane, pixel) pairs, a warp one plane of a
//      tile row: loads from many threads in flight, coalesced;
//   2. one thread per pixel composites front to back over its slots,
//      overwriting each sample with its record, then runs the VJP back
//      over them, overwriting each record with its gradient;
//   3. every thread stores the slots to dwarped, a warp 512 contiguous
//      bytes of one plane's row.
__global__ void __launch_bounds__(kSharedThreads, kSharedBlocks)
rewarp_composite_vjp_kernel_shared(const float4* __restrict__ planes,
                                   const float* __restrict__ homs,
                                   const float* __restrict__ g,
                                   float4* __restrict__ dwarped, int views,
                                   int num_planes, int height, int width,
                                   long long view_stride4, long long items) {
  extern __shared__ __align__(16) unsigned char smem_a[];
  float4* slots = reinterpret_cast<float4*>(smem_a);  // [P][kTilePixels]
  float* sh_homs = reinterpret_cast<float*>(slots + num_planes * kTilePixels);
  const int tid = threadIdx.x;
  const int tiles_x = (width + kTileAX - 1) / kTileAX;
  const long long plane_size = static_cast<long long>(height) * width;
  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(height);
  const int n = num_planes * kTilePixels;
  for (long long item = blockIdx.x; item < items; item += gridDim.x) {
    const Item it = open_item(item, views, tiles_x, homs, num_planes,
                              sh_homs, kSharedThreads);
    const float4* scene = planes + view_stride4 * it.view;
    // 1. Sample.
    for (int k = tid; k < n; k += kSharedThreads) {
      const int p = k / kTilePixels;
      const int x = it.x_lo + k % kTileAX;
      const int y = it.y_lo + (k % kTilePixels) / kTileAX;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      if (x < width && y < height) {
        float px, py;
        warp_point(sh_homs + p * 9, static_cast<float>(x),
                   static_cast<float>(y), fw, fh, &px, &py);
        s = sample_plane(scene + plane_size * p, px, py, width, height);
      }
      slots[k] = s;
    }
    __syncthreads();
    // 2. Composite and VJP, in place.
    const int x = it.x_lo + tid % kTileAX;
    const int y = it.y_lo + tid / kTileAX;
    if (tid < kTilePixels && x < width && y < height) {
      float4* mine = slots + tid;
      float4 s = mine[0];  // farthest plane: alpha ignored
      float cr = s.x, cg = s.y, cb = s.z;
      for (int p = 1; p < num_planes; ++p) {
        s = mine[p * kTilePixels];
        mine[p * kTilePixels] =
            make_float4(s.x - cr, s.y - cg, s.z - cb, s.w);
        const float keep = 1.f - s.w;
        cr = s.x * s.w + cr * keep;
        cg = s.y * s.w + cg * keep;
        cb = s.z * s.w + cb * keep;
      }
      const float* gp = g + (static_cast<long long>(it.view) * plane_size
                             + static_cast<long long>(y) * width + x) * 3;
      float g0 = gp[0], g1 = gp[1], g2 = gp[2];
      for (int p = num_planes - 1; p >= 1; --p) {
        const float4 r = mine[p * kTilePixels];  // (rgb - below, alpha)
        const float a = r.w;
        const float da = g0 * r.x + g1 * r.y + g2 * r.z;
        mine[p * kTilePixels] = make_float4(g0 * a, g1 * a, g2 * a, da);
        const float keep = 1.f - a;
        g0 = g0 * keep;
        g1 = g1 * keep;
        g2 = g2 * keep;
      }
      mine[0] = make_float4(g0, g1, g2, 0.f);
    }
    __syncthreads();
    // 3. Store, streamed past L2.
    float4* out =
        dwarped + static_cast<long long>(it.view) * num_planes * plane_size;
    for (int k = tid; k < n; k += kSharedThreads) {
      const int p = k / kTilePixels;
      const int xs = it.x_lo + k % kTileAX;
      const int ys = it.y_lo + (k % kTilePixels) / kTileAX;
      if (xs < width && ys < height) {
        __stcs(out + plane_size * p + static_cast<long long>(ys) * width + xs,
               slots[k]);
      }
    }
  }
}

// Warp 0 of a block maps the corners (cx_lo | cx_hi, cy_lo | cy_hi) of a
// source box through the inverse of the row-major 3x3 `hv` (float, target
// -> source pixels) in double, and lane 0 writes box = {i_lo, i_hi, j_lo,
// j_hi}: the target pixels that can sample a source pixel of the box's
// interior. The corners' integer bounding box, widened to floor/ceil and
// clamped to the image; the whole image where the inverse denominator is
// not one-signed over the corners (or anything is non-finite); lo > hi
// where the box maps outside the image. Lane t < 9 divides one adjugate
// entry by the determinant, lanes 4k + c map corner c, so the chain is two
// divisions deep. Also copies the map to sh_h. render_fused_bwd.py's
// preimage_boxes is its plain mirror.
__device__ void preimage_box(const float* __restrict__ hv, int lane,
                             double cx_lo, double cx_hi, double cy_lo,
                             double cy_hi, int width, int height, float* sh_h,
                             int* box) {
  double m[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) m[c] = __ldg(hv + c);
  if (lane < 9) sh_h[lane] = hv[lane];
  const double c00 = m[4] * m[8] - m[5] * m[7];
  const double c01 = m[5] * m[6] - m[3] * m[8];
  const double c02 = m[3] * m[7] - m[4] * m[6];
  const double det = m[0] * c00 + m[1] * c01 + m[2] * c02;
  const double adj[9] = {c00, m[2] * m[7] - m[1] * m[8],
                         m[1] * m[5] - m[2] * m[4], c01,
                         m[0] * m[8] - m[2] * m[6], m[2] * m[3] - m[0] * m[5],
                         c02, m[1] * m[6] - m[0] * m[7],
                         m[0] * m[4] - m[1] * m[3]};
  double mine = 0.0;
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    if (lane % 9 == c) mine = adj[c];
  }
  mine = mine / det;
  double hi[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) hi[c] = __shfl_sync(kFullMask, mine, c);
  const int corner = lane & 3;
  const double cx = (corner & 1) ? cx_hi : cx_lo;
  const double cy = (corner & 2) ? cy_hi : cy_lo;
  const double e = hi[6] * cx + hi[7] * cy + hi[8];
  const double tol =
      1e-7 * (fabs(hi[6] * cx) + fabs(hi[7] * cy) + fabs(hi[8]));
  double jmin = (hi[0] * cx + hi[1] * cy + hi[2]) / e;
  double imin = (hi[3] * cx + hi[4] * cy + hi[5]) / e;
  double jmax = jmin, imax = imin;
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    jmin = fmin(jmin, __shfl_xor_sync(kFullMask, jmin, o));
    jmax = fmax(jmax, __shfl_xor_sync(kFullMask, jmax, o));
    imin = fmin(imin, __shfl_xor_sync(kFullMask, imin, o));
    imax = fmax(imax, __shfl_xor_sync(kFullMask, imax, o));
  }
  const bool pos = (__ballot_sync(kFullMask, e > tol) & 0xfu) == 0xfu;
  const bool neg = (__ballot_sync(kFullMask, e < -tol) & 0xfu) == 0xfu;
  if (lane != 0) return;
  if (!(pos || neg) || !isfinite(jmin) || !isfinite(jmax) ||
      !isfinite(imin) || !isfinite(imax)) {
    box[0] = 0;
    box[1] = height - 1;
    box[2] = 0;
    box[3] = width - 1;
    return;
  }
  if (jmax < 0.0 || jmin > width - 1.0 || imax < 0.0 ||
      imin > height - 1.0) {
    box[0] = 1;
    box[1] = 0;
    box[2] = 1;
    box[3] = 0;
    return;
  }
  box[0] = static_cast<int>(fmax(floor(imin), 0.0));
  box[1] = static_cast<int>(fmin(ceil(imax), height - 1.0));
  box[2] = static_cast<int>(fmax(floor(jmin), 0.0));
  box[3] = static_cast<int>(fmin(ceil(jmax), width - 1.0));
}

constexpr int kTileX = 64;  // source columns of a tile (threads)
constexpr int kRows = 4;    // source rows per thread
constexpr int kThreadsY = 4;
constexpr int kTileY = kThreadsY * kRows;
constexpr int kTileThreads = kTileX * kThreadsY;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kChunk = 1536;  // staged targets per chunk
constexpr int kMaxSegs = 32;  // staged row segments per chunk
constexpr int kSegMax = 240;  // widest row segment (spans fit a byte)
// Five blocks to an SM (a chunk is ~40 KB): at most 51 registers.
constexpr int kMinBlocks = 5;
constexpr int kNoTap = -2;  // tap origin of a target out of reach: a
                            // reachable one is >= -1, so none matches it

// One chunk of a tile's preimage, in dynamic shared memory.
struct Staged {
  float4 dw[kChunk];  // dwarped of the target
  float2 pt[kChunk];  // its sample point (px, py); (kNoTap, kNoTap) out of
                      // reach, so its tap origin floors to kNoTap
  int2 yrange[kMaxSegs];  // the segment's (min, max) y0 over reachable taps
  // Per segment and tile column x: the span [lo, hi) of the segment holding
  // every target with x0 in {x - 1, x}.
  unsigned char lo[kMaxSegs][kTileX];
  unsigned char hi[kMaxSegs][kTileX];
};

// The tap origin (x0, y0) of a staged sample point.
__device__ __forceinline__ int2 tap_of(float2 pt) {
  return make_int2(static_cast<int>(floorf(pt.x)),
                   static_cast<int>(floorf(pt.y)));
}

// 16 bytes from global to shared memory without a register round trip
// (cp.async); `valid` false writes zeros and reads nothing.
__device__ __forceinline__ void copy16_async(void* smem_dst,
                                             const void* gmem_src,
                                             bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem_src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ int warp_scan_max(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFullMask, v, o);
    if (lane >= o) v = max(v, n);
  }
  return v;
}

__device__ __forceinline__ int warp_scan_min(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFullMask, v, o);
    if (lane >= o) v = min(v, n);
  }
  return v;
}

// Sets table[col - x_lo] = value for the tile columns col in [a, b]. The
// bounds reach INT_MIN and INT_MAX: clamp before subtracting.
__device__ __forceinline__ void fill_span(unsigned char* table, int x_lo,
                                          int a, int b, int value) {
  const int to = min(b, x_lo + kTileX - 1);
  for (int col = max(a, x_lo); col <= to; ++col) {
    table[col - x_lo] = static_cast<unsigned char>(value);
  }
}

__global__ void __launch_bounds__(kTileThreads, kMinBlocks)
adjoint_warp_kernel(const float4* __restrict__ dwarped,
                    const float* __restrict__ homs,
                    float4* __restrict__ dplanes, int views, int num_planes,
                    int height, int width, int shared) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Staged& st = *reinterpret_cast<Staged*>(smem_raw);
  __shared__ float sh_h[9];
  __shared__ int sh_box[4];
  const int p = blockIdx.z % num_planes;
  const int scene = blockIdx.z / num_planes;
  const int v_begin = shared ? 0 : scene;
  const int nv = shared ? views : 1;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int x_lo = blockIdx.x * kTileX;
  const int y_lo = blockIdx.y * kTileY;
  const int x = x_lo + threadIdx.x;
  const int xc = threadIdx.x;
  const int y_a = y_lo + threadIdx.y * kRows;  // this thread's first row
  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(height);
  const long long plane_size = static_cast<long long>(height) * width;

  float4 acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < nv; ++k) {
    const int v = v_begin + k;
    if (warp == 0) {
      preimage_box(homs + (static_cast<long long>(v) * num_planes + p) * 9,
                   lane, x_lo - 1.0, min(x_lo + kTileX - 1, width - 1) + 1.0,
                   y_lo - 1.0, min(y_lo + kTileY - 1, height - 1) + 1.0,
                   width, height, sh_h, sh_box);
    }
    __syncthreads();
    const int i_lo = sh_box[0], i_hi = sh_box[1];
    const int j_lo = sh_box[2], j_hi = sh_box[3];
    const float4* dw =
        dwarped + (static_cast<long long>(v) * num_planes + p) * plane_size;
    // Row segments in ascending (i, j): `pieces` equal segments per row.
    const int box_w = j_hi - j_lo + 1;
    const int rows = i_hi - i_lo + 1;
    const int pieces = max(1, (box_w + kSegMax - 1) / kSegMax);
    const int seg_w = max(1, (box_w + pieces - 1) / pieces);
    const int segs = (rows > 0 && box_w > 0) ? rows * pieces : 0;
    const int per_chunk = min(kMaxSegs, kChunk / seg_w);
    const int step_s = kTileThreads / seg_w;
    const int step_c = kTileThreads - step_s * seg_w;
    for (int s0 = 0; s0 < segs; s0 += per_chunk) {
      const int ns = min(per_chunk, segs - s0);
      // 1. Stage: warp_point once per target, its dwarped copied to shared
      // memory asynchronously (coalesced 16-byte copies along the row).
      // Entry e is column c of segment s; (s, c) steps by kTileThreads
      // without a division.
      int s = tid / seg_w;
      int c = tid - s * seg_w;
      for (int e = tid; e < ns * seg_w; e += kTileThreads) {
        const int gs = s0 + s;
        const int i = i_lo + (pieces == 1 ? gs : gs / pieces);
        const int j = j_lo + (pieces == 1 ? 0 : (gs % pieces) * seg_w) + c;
        float2 pt = make_float2(kNoTap, kNoTap);
        bool reach = false;
        if (j <= j_hi) {
          float px, py;
          warp_point(sh_h, static_cast<float>(j), static_cast<float>(i), fw,
                     fh, &px, &py);
          reach = in_reach(px, py, fw, fh);
          if (reach) pt = make_float2(px, py);
        }
        copy16_async(&st.dw[e], dw + (reach ? i * width + j : 0), reach);
        st.pt[e] = pt;
        s += step_s;
        c += step_c;
        if (c >= seg_w) {
          c -= seg_w;
          ++s;
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      // 2. Spans, one warp per segment. pmax (max of x0 from the left) and
      // smin (min of x0 from the right) are monotone, so for each column x
      // the targets with x0 in {x - 1, x} lie in
      //   [lo, hi) = [first c with pmax >= x - 1, first c with smin > x).
      // Entry c owns the columns whose lo is c (x - 1 in (pmax[c-1],
      // pmax[c]]) and whose hi is c + 1 (x in [smin[c], smin[c+1])): short
      // ranges, one or two columns near the identity. The long ranges at
      // either end (below the first reachable target's x0, above the
      // largest; below the smallest x0, from the last reachable target's
      // on) are filled by the whole warp. Every column is written once.
      for (int seg = warp; seg < ns; seg += kTileWarps) {
        const int base = seg * seg_w;
        unsigned char* lo_row = st.lo[seg];
        unsigned char* hi_row = st.hi[seg];
        int run = INT_MIN, ymn = INT_MAX, ymx = INT_MIN;
        int first = seg_w, first_x0 = 0;  // first reachable target
        for (int c0 = 0; c0 < seg_w; c0 += 32) {
          const int cc = c0 + lane;
          const int2 t = cc < seg_w ? tap_of(st.pt[base + cc])
                                    : make_int2(kNoTap, kNoTap);
          const bool ok = t.x != kNoTap;
          if (ok) {
            ymn = min(ymn, t.y);
            ymx = max(ymx, t.y);
          }
          const unsigned hits = __ballot_sync(kFullMask, ok);
          if (first == seg_w && hits != 0u) {
            const int src = __ffs(hits) - 1;
            first = c0 + src;
            first_x0 = __shfl_sync(kFullMask, t.x, src);
          }
          const int m = max(warp_scan_max(ok ? t.x : INT_MIN, lane), run);
          int prev = __shfl_up_sync(kFullMask, m, 1);
          if (lane == 0) prev = run;
          if (cc < seg_w && prev != INT_MIN) {
            fill_span(lo_row, x_lo, prev + 2, m + 1, cc);
          }
          run = __shfl_sync(kFullMask, m, 31);
        }
        const int last_max = run;  // INT_MIN: nothing reachable
        run = INT_MAX;
        int last = -1, last_x0 = 0;  // last reachable target
        for (int c0 = 0; c0 < seg_w; c0 += 32) {
          const int cc = seg_w - 1 - (c0 + lane);  // from the segment's end
          const int tx = cc >= 0 ? tap_of(st.pt[base + cc]).x : kNoTap;
          const unsigned hits = __ballot_sync(kFullMask, tx != kNoTap);
          if (last < 0 && hits != 0u) {
            const int src = __ffs(hits) - 1;
            last = seg_w - 1 - (c0 + src);
            last_x0 = __shfl_sync(kFullMask, tx, src);
          }
          const int m =
              min(warp_scan_min(tx != kNoTap ? tx : INT_MAX, lane), run);
          int next = __shfl_up_sync(kFullMask, m, 1);  // smin[cc + 1]
          if (lane == 0) next = run;
          if (cc >= 0 && next != INT_MAX) {
            fill_span(hi_row, x_lo, m, next - 1, cc + 1);
          }
          run = __shfl_sync(kFullMask, m, 31);
        }
        const int first_min = run;
        for (int col = lane; col < kTileX; col += 32) {
          const int x_col = x_lo + col;
          if (last < 0) {  // nothing reachable: an empty span
            lo_row[col] = 0;
            hi_row[col] = 0;
            continue;
          }
          if (x_col - 1 <= first_x0) lo_row[col] = first;
          if (x_col - 1 > last_max) lo_row[col] = seg_w;
          if (x_col < first_min) hi_row[col] = 0;
          if (x_col >= last_x0) hi_row[col] = last + 1;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          ymn = min(ymn, __shfl_xor_sync(kFullMask, ymn, o));
          ymx = max(ymx, __shfl_xor_sync(kFullMask, ymx, o));
        }
        if (lane == 0) st.yrange[seg] = make_int2(ymn, ymx);
      }
      __syncthreads();
      // 3. Sums: the thread's column x, rows y_a .. y_a + kRows - 1; each
      // span entry read once for all of them.
      for (int seg = 0; seg < ns; ++seg) {
        const int2 yr = st.yrange[seg];
        if (yr.y < y_a - 1 || yr.x > y_a + kRows - 1) continue;
        const int base = seg * seg_w;
        const int end = base + st.hi[seg][xc];
        for (int e = base + st.lo[seg][xc]; e < end; ++e) {
          // The tap origin and fractions, as the forward computes them.
          const float2 q = st.pt[e];
          const float x0f = floorf(q.x);
          const int2 t = make_int2(static_cast<int>(x0f),
                                   static_cast<int>(floorf(q.y)));
          if (t.x != x && t.x + 1 != x) continue;
          const float2 f = make_float2(q.x - x0f, q.y - floorf(q.y));
          const float kx = t.x == x ? 1.f - f.x : f.x;
          const float4 d = st.dw[e];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const int y = y_a + r;
            if (t.y == y || t.y + 1 == y) {
              const float ky = t.y == y ? 1.f - f.y : f.y;
              const float kk = ky * kx;
              acc[r].x = acc[r].x + d.x * kk;
              acc[r].y = acc[r].y + d.y * kk;
              acc[r].z = acc[r].z + d.z * kk;
              acc[r].w = acc[r].w + d.w * kk;
            }
          }
        }
      }
      __syncthreads();
    }
    // An empty preimage skips the chunk loop and its barriers: hold warp 0
    // back from the next view's map until every thread has read the box.
    __syncthreads();
  }
  if (x < width) {
    float4* out = dplanes
        + (static_cast<long long>(scene) * num_planes + p) * plane_size + x;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (y_a + r < height) {
        out[static_cast<long long>(y_a + r) * width] = acc[r];
      }
    }
  }
}

// Kernel A's paths, the values of RewarpLaunch::path.
enum RewarpPath { kPathRegisters = 0, kPathShared = 1, kPathGlobal = 2 };

// Kernel A's launch at a shape, chosen by the plane count alone.
struct RewarpLaunch {
  int path;
  int bucket;       // planes unrolled on the registers path, else 0
  dim3 block, grid;
  long long items;  // (view, tile) items the 1-D grid walks, else 0
  size_t smem;      // dynamic shared bytes
};

RewarpLaunch rewarp_launch(int views, int num_planes, int height,
                           int width) {
  RewarpLaunch l{};
  const size_t homs_bytes = static_cast<size_t>(num_planes) * 9 * sizeof(float);
  if (num_planes > kSmemPlanes) {
    l.path = kPathGlobal;
    l.block = dim3(kBlockX, kBlockY, 1);
    l.grid = dim3((width + kBlockX - 1) / kBlockX,
                  (height + kBlockY - 1) / kBlockY, views);
    l.smem = homs_bytes;
    return l;
  }
  l.items = static_cast<long long>((width + kTileAX - 1) / kTileAX) *
            ((height + kTileAY - 1) / kTileAY) * views;
  l.grid = dim3(static_cast<unsigned>(l.items < INT_MAX ? l.items : INT_MAX),
                1, 1);
  if (num_planes > kRegPlanes) {
    l.path = kPathShared;
    l.block = dim3(kSharedThreads, 1, 1);
    l.smem = static_cast<size_t>(num_planes) * kTilePixels * sizeof(float4) +
             homs_bytes;
    return l;
  }
  l.path = kPathRegisters;
  l.bucket = (num_planes + kRegBucket - 1) / kRegBucket * kRegBucket;
  l.block = dim3(kTilePixels, 1, 1);
  return l;
}

}  // namespace

// Kernel A's launch at this shape, as mpi_rewarp_composite_vjp makes it:
// out[0..9] = path (0 registers, 1 shared, 2 global), bucket (0 off the
// registers path), block x, y, z, grid x, y, z, items (0 on the global
// path) and dynamic shared bytes. render_fused_bwd.py holds its mirror,
// rewarp_launch_shape, to this.
extern "C" void mpi_rewarp_launch_shape(int views, int num_planes, int height,
                                        int width, long long* out) {
  const RewarpLaunch l = rewarp_launch(views, num_planes, height, width);
  const long long fields[10] = {l.path,   l.bucket, l.block.x, l.block.y,
                                l.block.z, l.grid.x, l.grid.y,  l.grid.z,
                                l.items,  static_cast<long long>(l.smem)};
  for (int i = 0; i < 10; ++i) out[i] = fields[i];
}

// Kernel A on `stream` for `views` views, launched as rewarp_launch picks
// for the shape. Returns the CUDA error code of the shared-memory opt-in or
// the launch (0 on success); the caller raises on anything else.
extern "C" int mpi_rewarp_composite_vjp(const void* planes, const void* homs,
                                        const void* g, void* dwarped,
                                        int views, int num_planes, int height,
                                        int width, long long view_stride,
                                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* in = static_cast<const float4*>(planes);
  const auto* h = static_cast<const float*>(homs);
  const auto* gg = static_cast<const float*>(g);
  auto* out = static_cast<float4*>(dwarped);
  const auto s = static_cast<cudaStream_t>(stream);
  const RewarpLaunch l = rewarp_launch(views, num_planes, height, width);
  if (l.path == kPathGlobal) {
    rewarp_composite_vjp_kernel_global<<<l.grid, l.block, l.smem, s>>>(
        in, h, gg, out, num_planes, height, width, view_stride / 4);
  } else if (l.path == kPathShared) {
    if (l.smem > 48 * 1024) {
      // One value for every plane count, so that concurrent launches never
      // lower each other's limit.
      err = cudaFuncSetAttribute(
          rewarp_composite_vjp_kernel_shared,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kSmemPlanes * (kTilePixels * sizeof(float4) +
                                          9 * sizeof(float))));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    rewarp_composite_vjp_kernel_shared<<<l.grid, l.block, l.smem, s>>>(
        in, h, gg, out, views, num_planes, height, width, view_stride / 4,
        l.items);
  } else {
    auto kernel = l.bucket == 4    ? rewarp_composite_vjp_kernel_registers<4>
                  : l.bucket == 8  ? rewarp_composite_vjp_kernel_registers<8>
                  : l.bucket == 12 ? rewarp_composite_vjp_kernel_registers<12>
                                   : rewarp_composite_vjp_kernel_registers<16>;
    kernel<<<l.grid, l.block, l.smem, s>>>(in, h, gg, out, views, num_planes,
                                           height, width, view_stride / 4,
                                           l.items);
  }
  return static_cast<int>(cudaGetLastError());
}

// Kernel B on `stream`: `shared` != 0 sums all `views` into one scene's
// gradient [P, H, W, 4]; otherwise each view's scene gets its own
// [V, P, H, W, 4]. Returns the launch's CUDA error code.
extern "C" int mpi_adjoint_warp(const void* dwarped, const void* homs,
                                void* dplanes, int views, int num_planes,
                                int height, int width, int shared, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int scenes = shared ? 1 : views;
  const dim3 block(kTileX, kThreadsY, 1);
  const dim3 grid((width + kTileX - 1) / kTileX,
                  (height + kTileY - 1) / kTileY, scenes * num_planes);
  const size_t smem = sizeof(Staged);  // ~40 KB: no opt-in needed
  adjoint_warp_kernel<<<grid, block, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(dwarped), static_cast<const float*>(homs),
      static_cast<float4*>(dplanes), views, num_planes, height, width,
      shared);
  return static_cast<int>(cudaGetLastError());
}
