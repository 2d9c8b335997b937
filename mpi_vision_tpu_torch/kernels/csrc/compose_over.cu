// Back-to-front "over" compositing of a warped MPI stack.
//
// Replaces the TPU kernel mpi_vision_tpu/kernels/compose_pallas.py:
// _composite_kernel (launched by _composite_planar_call). There, a planar
// [B, P, 4, H, W] stack streams HBM -> VMEM one (8k, 128k) tile and one
// plane per grid step, P innermost, while the running composite sits in a
// VMEM f32 scratch. The planar layout exists to fill the TPU's 128 lanes;
// a Hopper thread wants its pixel's four channels in one load instead, so
// this kernel reads the channels-last stack the port's warp writes.
//
// What it computes, per pixel i of N (every pixel of every leading index):
//   for each plane p, back (0) to front (P-1):
//     s   = planes[p, i, 0:4]
//     out = p == 0 ? s.rgb                                (alpha ignored)
//                  : s.rgb * s.a + out * (1 - s.a)
//   and writes out as [N, 3] in the input's type.
// One thread per pixel loops over P with the composite in f32 registers.
// Each operation rounds where the plain PyTorch version's does
// (kernels/compose_over.py: plain_composite, the scan of core/compose.py):
// the library is built with -fmad=false, so no multiply-add is contracted
// and the kernel equals its plain version to the bit.
//
// bf16 input is upcast on load, accumulated in f32 and rounded once on
// store, to nearest even (__float2bfloat16_rn, as torch's .to(bfloat16)),
// which is the TPU kernel's contract (f32 accumulator, output cast).
//
// Layout: planes [P, N, 4] with the [N, 4] block contiguous and planes
// `plane_stride` elements apart; one pixel's four channels are one 16-byte
// (f32) or 8-byte (bf16) load, and neighbouring threads read neighbouring
// pixels. Offsets are 64-bit: 1080p x 32 planes x 8 views is 2.12e9 floats,
// just under 2^31, and one more view passes it.
//
// Bound on an H100 SXM (3.35 TB/s HBM): every plane read once and the frame
// written once. At 1080p x 32 planes, f32, one view moves 1.087 GB
// (0.324 ms) and eight 8.7 GB (2.595 ms); bf16 halves that. About 10 f32
// operations per plane and pixel (~0.02 ms a view at 67 TFLOP/s): the
// kernel is bound by bytes. The design reads each input byte once and
// keeps the composite out of device memory, so it is one streaming pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;

struct Rgba {
  float r, g, b, a;
};

__device__ __forceinline__ Rgba load(const float* planes, long long off) {
  const float4 v = *reinterpret_cast<const float4*>(planes + off);
  return {v.x, v.y, v.z, v.w};
}

__device__ __forceinline__ Rgba load(const __nv_bfloat16* planes,
                                     long long off) {
  const uint2 raw = *reinterpret_cast<const uint2*>(planes + off);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return {__low2float(lo), __high2float(lo), __low2float(hi),
          __high2float(hi)};
}

__device__ __forceinline__ void store(float* dst, float v) { *dst = v; }

__device__ __forceinline__ void store(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
compose_over_kernel(const T* __restrict__ planes, T* __restrict__ out,
                    int num_planes, long long pixels,
                    long long plane_stride) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= pixels) return;
  const T* src = planes + i * 4;
  Rgba s = load(src, 0);
  float r = s.r, g = s.g, b = s.b;  // farthest plane: alpha ignored
  for (int p = 1; p < num_planes; ++p) {
    s = load(src, plane_stride * p);
    const float keep = 1.f - s.a;
    r = s.r * s.a + r * keep;
    g = s.g * s.a + g * keep;
    b = s.b * s.a + b * keep;
  }
  T* dst = out + i * 3;
  store(dst, r);
  store(dst + 1, g);
  store(dst + 2, b);
}

}  // namespace

// Launches the kernel on `stream`: `dtype` 0 is float32, 1 bfloat16;
// `plane_stride` counts elements. Returns the CUDA error code of the launch
// (0 on success, -1 for an unknown dtype); the caller raises on anything
// else.
extern "C" int mpi_compose_over(const void* planes, void* out, int dtype,
                                int num_planes, long long pixels,
                                long long plane_stride, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (pixels + kBlock - 1) / kBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    compose_over_kernel<float><<<static_cast<unsigned>(blocks), kBlock, 0,
                                 s>>>(
        static_cast<const float*>(planes), static_cast<float*>(out),
        num_planes, pixels, plane_stride);
  } else if (dtype == 1) {
    compose_over_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(
            static_cast<const __nv_bfloat16*>(planes),
            static_cast<__nv_bfloat16*>(out), num_planes, pixels,
            plane_stride);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
