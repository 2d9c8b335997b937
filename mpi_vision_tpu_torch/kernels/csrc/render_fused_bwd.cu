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
// by 1 - a (alphas reach 1). The forward pass parks (rgb_p - below_p, a_p)
// in the thread's own slot of the output, dwarped[v, p, y, x], and the
// reverse pass reads it back and overwrites it with the gradient: no
// scratch allocation and no warped stack beyond the output itself.
//
// Kernel B, one thread per source pixel (x, y) of plane p (of one scene),
// is the warp transpose in gather form:
//   d plane(x, y) = sum_v sum_{(j, i)} dwarped[v, p, i, j]
//                   * k_y(py(j, i), y) * k_x(px(j, i), x)
// over the target pixels whose forward sample point (px, py) - the forward
// kernel's own f32 expression, its d == 0 nudge and its reach guard - puts
// (x, y) among its four bilinear taps, with k the tap's forward weight
// (1 - frac or frac). Candidates come from the preimage of the box
// (x +- 1, y +- 1): its corners mapped through the inverse homography (in
// double), their integer bounding box widened to floor/ceil and clamped to
// the image. Where the inverse denominator is not one-signed over the box
// (the plane crosses the camera's plane there, so the preimage is
// unbounded), the thread scans the whole image: slow, and right. Each
// thread sums its views and candidates in a fixed order (views, rows,
// columns), so the gradient is deterministic, with no atomics and no
// scatter. With one scene shared by all views (view stride 0, the training
// path at batch 1) the views sum into one gradient; otherwise each view's
// scene gets its own.
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
// This simple design spends bytes beyond the bound on A's parked records
// (written and read back once) and on B's candidate taps (re-read from L1/
// L2, and ~2-4x more candidates evaluated than hit).

#include <cuda_runtime.h>

#include <math.h>

#include "render_sample.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__global__ void __launch_bounds__(kBlockX * kBlockY)
rewarp_composite_vjp_kernel(const float4* __restrict__ planes,
                            const float* __restrict__ homs,
                            const float* __restrict__ g,
                            float4* __restrict__ dwarped, int num_planes,
                            int height, int width, long long view_stride4) {
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

// Inverse of the row-major 3x3 `h` (float) into `inv` (double): adjugate
// over determinant. A singular map gives non-finite entries, which send
// candidate_box to the whole image.
__device__ void invert3x3(const float* h, double* inv) {
  const double m0 = h[0], m1 = h[1], m2 = h[2], m3 = h[3], m4 = h[4],
               m5 = h[5], m6 = h[6], m7 = h[7], m8 = h[8];
  const double c00 = m4 * m8 - m5 * m7;
  const double c01 = m5 * m6 - m3 * m8;
  const double c02 = m3 * m7 - m4 * m6;
  const double det = m0 * c00 + m1 * c01 + m2 * c02;
  inv[0] = c00 / det;
  inv[1] = (m2 * m7 - m1 * m8) / det;
  inv[2] = (m1 * m5 - m2 * m4) / det;
  inv[3] = c01 / det;
  inv[4] = (m0 * m8 - m2 * m6) / det;
  inv[5] = (m2 * m3 - m0 * m5) / det;
  inv[6] = c02 / det;
  inv[7] = (m1 * m6 - m0 * m7) / det;
  inv[8] = (m0 * m4 - m1 * m3) / det;
}

// Target pixels [i_lo, i_hi] x [j_lo, j_hi] that can sample source pixel
// (x, y): the bounding box of the box (x +- 1, y +- 1) mapped through the
// inverse map `hi`, widened to floor/ceil (which absorbs the forward's f32
// rounding) and clamped to the image. The whole image where the inverse
// denominator is not one-signed over the box (or anything is non-finite).
// An empty box comes back with lo > hi.
__device__ void candidate_box(const double* hi, int x, int y, int width,
                              int height, int* i_lo, int* i_hi, int* j_lo,
                              int* j_hi) {
  double jmin = INFINITY, jmax = -INFINITY, imin = INFINITY, imax = -INFINITY;
  bool pos = true, neg = true;
  for (int c = 0; c < 4; ++c) {
    const double cx = x + ((c & 1) ? 1.0 : -1.0);
    const double cy = y + ((c & 2) ? 1.0 : -1.0);
    const double e = hi[6] * cx + hi[7] * cy + hi[8];
    const double tol =
        1e-7 * (fabs(hi[6] * cx) + fabs(hi[7] * cy) + fabs(hi[8]));
    pos = pos && e > tol;
    neg = neg && e < -tol;
    const double jc = (hi[0] * cx + hi[1] * cy + hi[2]) / e;
    const double ic = (hi[3] * cx + hi[4] * cy + hi[5]) / e;
    jmin = fmin(jmin, jc);
    jmax = fmax(jmax, jc);
    imin = fmin(imin, ic);
    imax = fmax(imax, ic);
  }
  if (!(pos || neg) || !isfinite(jmin) || !isfinite(jmax) ||
      !isfinite(imin) || !isfinite(imax)) {
    *i_lo = 0;
    *i_hi = height - 1;
    *j_lo = 0;
    *j_hi = width - 1;
    return;
  }
  if (jmax < 0.0 || jmin > width - 1.0 || imax < 0.0 ||
      imin > height - 1.0) {
    *i_lo = 1;
    *i_hi = 0;
    *j_lo = 1;
    *j_hi = 0;
    return;
  }
  *j_lo = static_cast<int>(fmax(floor(jmin), 0.0));
  *j_hi = static_cast<int>(fmin(ceil(jmax), width - 1.0));
  *i_lo = static_cast<int>(fmax(floor(imin), 0.0));
  *i_hi = static_cast<int>(fmin(ceil(imax), height - 1.0));
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
adjoint_warp_kernel(const float4* __restrict__ dwarped,
                    const float* __restrict__ homs,
                    float4* __restrict__ dplanes, int views, int num_planes,
                    int height, int width, int shared) {
  // [nv * 9] inverse maps (double), then [nv * 9] forward maps (float).
  extern __shared__ double sh_inv[];
  const int p = blockIdx.z % num_planes;
  const int scene = blockIdx.z / num_planes;
  const int v_begin = shared ? 0 : scene;
  const int nv = shared ? views : 1;
  float* sh_homs = reinterpret_cast<float*>(sh_inv + nv * 9);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < nv * 9; i += nthreads) {
    sh_homs[i] = homs[(static_cast<long long>(v_begin + i / 9) * num_planes + p)
                      * 9 + i % 9];
  }
  __syncthreads();
  for (int k = tid; k < nv; k += nthreads) {
    invert3x3(sh_homs + k * 9, sh_inv + k * 9);
  }
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;

  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(height);
  const long long plane_size = static_cast<long long>(height) * width;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < nv; ++k) {
    const float* h = sh_homs + k * 9;
    const float4* dw = dwarped
        + (static_cast<long long>(v_begin + k) * num_planes + p) * plane_size;
    int i_lo, i_hi, j_lo, j_hi;
    candidate_box(sh_inv + k * 9, x, y, width, height, &i_lo, &i_hi, &j_lo,
                  &j_hi);
    for (int i = i_lo; i <= i_hi; ++i) {
      for (int j = j_lo; j <= j_hi; ++j) {
        float px, py;
        warp_point(h, static_cast<float>(j), static_cast<float>(i), fw, fh,
                   &px, &py);
        if (!in_reach(px, py, fw, fh)) continue;
        const float x0f = floorf(px);
        const float y0f = floorf(py);
        const int x0 = static_cast<int>(x0f);
        const int y0 = static_cast<int>(y0f);
        if ((x0 != x && x0 + 1 != x) || (y0 != y && y0 + 1 != y)) continue;
        const float wx = px - x0f;
        const float wy = py - y0f;
        const float kx = x0 == x ? 1.f - wx : wx;
        const float ky = y0 == y ? 1.f - wy : wy;
        const float kk = ky * kx;
        const float4 d = __ldg(dw + static_cast<long long>(i) * width + j);
        acc.x = acc.x + d.x * kk;
        acc.y = acc.y + d.y * kk;
        acc.z = acc.z + d.z * kk;
        acc.w = acc.w + d.w * kk;
      }
    }
  }
  dplanes[(static_cast<long long>(scene) * num_planes + p) * plane_size
          + static_cast<long long>(y) * width + x] = acc;
}

}  // namespace

// Kernel A on `stream` for `views` views. Returns the CUDA error code of the
// launch (0 on success); the caller raises on anything else.
extern "C" int mpi_rewarp_composite_vjp(const void* planes, const void* homs,
                                        const void* g, void* dwarped,
                                        int views, int num_planes, int height,
                                        int width, long long view_stride,
                                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (height + kBlockY - 1) / kBlockY, views);
  const size_t smem = static_cast<size_t>(num_planes) * 9 * sizeof(float);
  rewarp_composite_vjp_kernel<<<grid, block, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(planes), static_cast<const float*>(homs),
      static_cast<const float*>(g), static_cast<float4*>(dwarped), num_planes,
      height, width, view_stride / 4);
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
  const int nv = shared ? views : 1;
  const dim3 block(kBlockX, kBlockY, 1);
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (height + kBlockY - 1) / kBlockY, scenes * num_planes);
  const size_t smem =
      static_cast<size_t>(nv) * 9 * (sizeof(double) + sizeof(float));
  adjoint_warp_kernel<<<grid, block, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(dwarped), static_cast<const float*>(homs),
      static_cast<float4*>(dplanes), views, num_planes, height, width,
      shared);
  return static_cast<int>(cudaGetLastError());
}
