// Fused homography warp + bilinear sample + back-to-front over-composite.
//
// Replaces the three forward TPU kernels of mpi_vision_tpu/kernels/
// render_pallas.py: _separable_kernel (axis-aligned poses), _shared_kernel
// (rotations inside the SHARED_LEVELS ladder) and _banded_kernel (rotations
// past it). Those three, their tables, planners and the XLA fallback behind
// them exist because a TPU lane gather reaches one 128-lane window, so every
// tier must prove its taps fall inside the windows it loads. A Hopper thread
// gathers from anywhere in device memory, so this one kernel renders every
// pose: no envelope, no plan, no fallback.
//
// What it computes, per view v and output pixel (x, y):
//   for each plane p, back (0) to front (P-1):
//     d      = h6*x + h7*y + h8         (exact zero nudged by 1e-8)
//     (u, w) = ((h0*x + h1*y + h2) / d, (h3*x + h4*y + h5) / d)
//     sample = bilinear tap of plane p at pixel (u, w), each of the four
//              taps zeroed on its own outside [0, W) x [0, H)
//     out    = plane 0 ? sample.rgb
//                      : sample.rgb * sample.a + out * (1 - sample.a)
//   and writes out as [V, H, W, 3] float32.
// The source coordinate goes through the sampler's normalised space
// (c = (u + 0.5) / W, then u' = c * W - 0.5) exactly as the plain PyTorch
// version (kernels/render_fused.py: plain_render) and the JAX reference_render
// do, and the library is built with -fmad=false so no multiply-add is
// contracted: every operation rounds where the plain version's does, and the
// kernel agrees with it to the last bit rather than to a tolerance.
//
// Layout: planes [P, H, W, 4] float32 (RGBA last, so one tap is one 16-byte
// load), one scene per view at `view_stride` floats apart; a stride of 0
// renders V views of one resident scene without copying it. Homographies
// [V, P, 3, 3] float32 map target pixels to source pixels.
//
// Bound on an H100 SXM (3.35 TB/s HBM, 67 TFLOP/s f32 without tensor cores),
// 1080p x 32 planes. One view has to read every plane once, 1920*1080*32*16 B
// = 1.06 GB: at least ~0.32 ms, bandwidth bound. Its arithmetic is 67 f32
// operations per pixel and plane (warp 15, floor and fractions 6, bilinear
// blend 36, composite 10; the 8 spent on the sampler's round trip are not
// needed and not counted), ~4.4 GFLOP a view. Eight views of one resident
// scene still need one scene read (~0.38 ms with the frames) but ~36 GFLOP
// (~0.53 ms): at V = 8 operations bound it.
//
// Design. One thread per output pixel of a 32 x 8 tile; one block renders
// that tile for a chunk of up to kViewChunk = 4 views of one scene
// (blockIdx.z is the chunk), each thread keeping one running composite per
// view in registers. Planes are the outer loop and views the inner one, so
// plane p's neighbourhood of the tile is fetched from HBM once per chunk and
// the chunk's other views find it in L1/L2 moments later: an 8-view flight
// reads the scene twice, not eight times. One scene per view (view_stride
// != 0) and V = 1 take a kernel built for chunks of one. The chunk's P x 9
// maps per view sit in shared memory. A sample whose four taps all lie
// inside the image takes one bounds test and 32-bit offsets from one row
// base (render_sample.cuh); the plane offset stays 64-bit. At V = 8 issue
// slots set the pace (~120 instructions a sample, with four IEEE divisions
// and an unfused blend), so occupancy decides: the chunk of 4 under a
// 48-register cap (five blocks an SM, 8 bytes of spill) beat chunks of 8
// (80-94 registers, or spills at 64) and one view per block with the view
// fastest in the grid, timed on an H100 (PERF.md). A view's
// pixels do not depend on its chunk or its neighbours: each view's
// composite is the same expression sequence whatever else the block
// renders.

#include <cuda_runtime.h>

#include "render_sample.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kViewChunk = 4;  // views per block of a shared scene
// Five blocks of 256 threads to an SM: at most 48 registers a thread.
constexpr int kMinBlocks = 5;

// kNV: the most views a block renders. A chunk of one keeps one composite
// in registers, not kViewChunk of them.
template <int kNV>
__global__ void __launch_bounds__(kBlockX * kBlockY, kMinBlocks)
render_fused_kernel(const float4* __restrict__ planes,
                    const float* __restrict__ homs,
                    float* __restrict__ out, int views, int view_chunk,
                    int num_planes, int height, int width,
                    long long view_stride4) {
  extern __shared__ float sh_homs[];  // [nv, num_planes, 9]
  const int v0 = blockIdx.z * view_chunk;
  const int nv = min(view_chunk, views - v0);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const float* chunk_homs = homs + static_cast<long long>(v0) * num_planes * 9;
  for (int i = tid; i < nv * num_planes * 9; i += blockDim.x * blockDim.y) {
    sh_homs[i] = chunk_homs[i];
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
  // With a stride, the chunk is one view and this is its scene.
  const float4* scene = planes + view_stride4 * v0;

  float r[kNV], g[kNV], b[kNV];
  for (int p = 0; p < num_planes; ++p) {
    const float4* plane = scene + plane_size * p;
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      if (k < nv) {
        float px, py;
        warp_point(sh_homs + (k * num_planes + p) * 9, ox, oy, fw, fh, &px,
                   &py);
        const float4 s = sample_plane(plane, px, py, width, height);
        if (p == 0) {  // farthest plane: alpha ignored
          r[k] = s.x;
          g[k] = s.y;
          b[k] = s.z;
        } else {
          const float keep = 1.f - s.w;
          r[k] = s.x * s.w + r[k] * keep;
          g[k] = s.y * s.w + g[k] * keep;
          b[k] = s.z * s.w + b[k] * keep;
        }
      }
    }
  }
  const long long pixel = static_cast<long long>(y) * width + x;
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
    if (k < nv) {
      float* dst = out + ((v0 + k) * plane_size + pixel) * 3;
      dst[0] = r[k];
      dst[1] = g[k];
      dst[2] = b[k];
    }
  }
}

}  // namespace

// Launches the kernel on `stream` for `views` views. Returns the CUDA error
// code of the launch (0 on success); the caller raises on anything else.
extern "C" int mpi_render_fused(const void* planes, const void* homs,
                                void* out, int views, int num_planes,
                                int height, int width, long long view_stride,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunk =
      view_stride != 0 ? 1 : (views < kViewChunk ? views : kViewChunk);
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (height + kBlockY - 1) / kBlockY,
                  (views + chunk - 1) / chunk);
  const dim3 block(kBlockX, kBlockY, 1);
  const size_t smem =
      static_cast<size_t>(chunk) * num_planes * 9 * sizeof(float);
  auto kernel = chunk == 1 ? render_fused_kernel<1>
                           : render_fused_kernel<kViewChunk>;
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(planes), static_cast<const float*>(homs),
      static_cast<float*>(out), views, chunk, num_planes, height, width,
      view_stride / 4);
  return static_cast<int>(cudaGetLastError());
}
