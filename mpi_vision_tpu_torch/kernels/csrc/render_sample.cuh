// The forward sample of one MPI plane at one target pixel, shared by
// render_fused.cu (the render) and render_fused_bwd.cu (its gradient), so
// the backward re-warps and transposes exactly what was rendered. The
// backward's registers path runs sample_plane's two halves, tap_point and
// blend_taps, with its taps copied into shared memory between them.
//
// Every expression rounds where the plain PyTorch versions' do
// (kernels/render_fused.py: plain_render, kernels/render_fused_bwd.py); the
// libraries are built with -fmad=false so no multiply-add is contracted.

#pragma once

#include <cuda_runtime.h>

// One tap of `plane` ([H, W] float4), zero outside the image. Offsets inside
// a plane are 32-bit: the wrappers refuse planes of 2^31 pixels or more.
__device__ __forceinline__ float4 load_tap(const float4* __restrict__ plane,
                                           int x, int y, int width,
                                           int height) {
  if (x < 0 || x >= width || y < 0 || y >= height) {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  return __ldg(plane + (y * width + x));
}

// Source pixel (px, py) of target pixel (ox, oy) under the 3x3 map h
// (row-major, target pixels -> source pixels): an exact zero denominator is
// nudged by 1e-8, and the coordinate goes through the sampler's normalised
// space (c = (u + 0.5) / W) and back (u' = c * W - 0.5) as the plain
// version computes it.
__device__ __forceinline__ void warp_point(const float* h, float ox, float oy,
                                           float fw, float fh, float* px,
                                           float* py) {
  float d = h[6] * ox + h[7] * oy + h[8];
  if (d == 0.f) d = d + 1e-8f;
  const float u = (h[0] * ox + h[1] * oy + h[2]) / d;
  const float w = (h[3] * ox + h[4] * oy + h[5]) / d;
  *px = ((u + 0.5f) / fw) * fw - 0.5f;
  *py = ((w + 0.5f) / fh) * fh - 0.5f;
}

// Whether any bilinear tap of (px, py) can lie in the image. Outside this
// range all four taps are out of the image (and NaN fails it), so the sample
// is the zeros padding; inside it, floor() fits an int.
__device__ __forceinline__ bool in_reach(float px, float py, float fw,
                                         float fh) {
  return px >= -1.f && px < fw && py >= -1.f && py < fh;
}

// The bilinear footprint of an in-reach point (px, py): its top-left tap
// (x0, y0) and the fractions (wx, wy) toward the other three.
struct TapPoint {
  int x0, y0;
  float wx, wy;
};

__device__ __forceinline__ TapPoint tap_point(float px, float py) {
  const float x0f = floorf(px);
  const float y0f = floorf(py);
  TapPoint t;
  t.wx = px - x0f;
  t.wy = py - y0f;
  t.x0 = static_cast<int>(x0f);
  t.y0 = static_cast<int>(y0f);
  return t;
}

// The bilinear blend of the taps v00 (x0, y0), v01 (x0 + 1, y0), v10 (x0,
// y0 + 1) and v11 with the fractions (wx, wy). Zero taps and fractions give
// +0 in every channel.
__device__ __forceinline__ float4 blend_taps(float4 v00, float4 v01,
                                             float4 v10, float4 v11, float wx,
                                             float wy) {
  const float ax = 1.f - wx;
  const float ay = 1.f - wy;
  float4 s;
  s.x = (v00.x * ax + v01.x * wx) * ay + (v10.x * ax + v11.x * wx) * wy;
  s.y = (v00.y * ax + v01.y * wx) * ay + (v10.y * ax + v11.y * wx) * wy;
  s.z = (v00.z * ax + v01.z * wx) * ay + (v10.z * ax + v11.z * wx) * wy;
  s.w = (v00.w * ax + v01.w * wx) * ay + (v10.w * ax + v11.w * wx) * wy;
  return s;
}

// Bilinear sample of `plane` ([H, W] float4 RGBA) at (px, py), each of the
// four taps zeroed on its own outside [0, W) x [0, H).
__device__ __forceinline__ float4 sample_plane(const float4* __restrict__ plane,
                                               float px, float py, int width,
                                               int height) {
  if (!in_reach(px, py, static_cast<float>(width),
                static_cast<float>(height))) {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const TapPoint t = tap_point(px, py);
  const int x0 = t.x0;
  const int y0 = t.y0;
  float4 v00, v01, v10, v11;
  if (x0 >= 0 && x0 + 1 < width && y0 >= 0 && y0 + 1 < height) {
    // All four taps inside: one bounds test, one 32-bit row base.
    const float4* row = plane + (y0 * width + x0);
    v00 = __ldg(row);
    v01 = __ldg(row + 1);
    v10 = __ldg(row + width);
    v11 = __ldg(row + width + 1);
  } else {  // the image's edge: each tap zeroed on its own
    v00 = load_tap(plane, x0, y0, width, height);
    v01 = load_tap(plane, x0 + 1, y0, width, height);
    v10 = load_tap(plane, x0, y0 + 1, width, height);
    v11 = load_tap(plane, x0 + 1, y0 + 1, width, height);
  }
  return blend_taps(v00, v01, v10, v11, t.wx, t.wy);
}
