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
// = 1.06 GB, so it costs at least ~0.32 ms and is bandwidth bound. Its
// arithmetic is 67 f32 operations per pixel and plane (warp 15, floor and
// fractions 6, bilinear blend 36, composite 10; the 8 spent on the sampler's
// round trip above are not needed and not counted), ~4.4 GFLOP a view
// (~0.07 ms). Eight views of one resident scene still need only one scene
// read (~0.38 ms with the frames), but ~36 GFLOP (~0.53 ms): at V = 8 the
// bound is set by operations. The simple design here reads the scene once
// per view and nothing more: one pass, one thread per output pixel, the
// running composite in registers, no warped-plane stack in device memory,
// and the view's P x 9 homography in shared memory. Neighbouring threads
// read neighbouring source pixels for any smooth warp, so the taps coalesce;
// the bilinear footprint re-reads each source pixel ~4 times from L1/L2, not
// HBM. Reusing one plane read across views (one pass over the scene for a
// whole batch) is the next step and is not done here.

#include <cuda_runtime.h>

#include "render_sample.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__global__ void __launch_bounds__(kBlockX * kBlockY)
render_fused_kernel(const float4* __restrict__ planes,
                    const float* __restrict__ homs,
                    float* __restrict__ out, int num_planes, int height,
                    int width, long long view_stride4) {
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

  float r = 0.f, g = 0.f, b = 0.f;
  for (int p = 0; p < num_planes; ++p) {
    float px, py;
    warp_point(sh_homs + p * 9, ox, oy, fw, fh, &px, &py);
    const float4 s = sample_plane(scene + plane_size * p, px, py, width,
                                  height);
    if (p == 0) {  // farthest plane: alpha ignored
      r = s.x;
      g = s.y;
      b = s.z;
    } else {
      const float keep = 1.f - s.w;
      r = s.x * s.w + r * keep;
      g = s.y * s.w + g * keep;
      b = s.z * s.w + b * keep;
    }
  }
  float* dst = out + ((static_cast<long long>(view) * height + y) * width + x) * 3;
  dst[0] = r;
  dst[1] = g;
  dst[2] = b;
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
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (height + kBlockY - 1) / kBlockY, views);
  const size_t smem = static_cast<size_t>(num_planes) * 9 * sizeof(float);
  render_fused_kernel<<<grid, block, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(planes), static_cast<const float*>(homs),
      static_cast<float*>(out), num_planes, height, width, view_stride / 4);
  return static_cast<int>(cudaGetLastError());
}
