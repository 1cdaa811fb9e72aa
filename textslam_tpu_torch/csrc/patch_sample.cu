// Grouped bilinear region sampling of a channel-interleaved image stack, for
// Hopper (sm_90a).
//
// Replaces textslam_tpu/ops/pallas_kernels.py::patch_sample_grouped (body
// _patch_sample_kernel; wrapper grouped_bilinear_stack). Each group g is one
// (text object, target keyframe) pair with Q sample positions that cluster
// inside one RH x RW region of image k = meta[g, 0] whose origin is
// (oy, ox) = (meta[g, 1], meta[g, 2]). For every sample, with the TPU
// kernel's formula,
//   u = clip(u_abs - ox, 0, RW-1), u0 = clip(floor(u), 0, RW-2), du = u - u0
//   v = clip(v_abs - oy, 0, RH-1), v0 = clip(floor(v), 0, RH-2), dv = v - v0
//   out[g, q, c] = (1-dv) ((1-du) I[y0, x0, c] + du I[y0, x0+1, c])
//                +   dv  ((1-du) I[y0+1, x0, c] + du I[y0+1, x0+1, c])
// with (y0, x0) = (oy + v0, ox + u0), and 0 where mask[g, q] is false.
//
// The TPU kernel DMAs each region into VMEM and contracts one-hot weight
// matrices on the MXU because it cannot gather. Here the four corners are
// read straight from global memory (L2-resident: a group's samples share a
// few KB of its region), so there is no region copy and no padding of the
// stack. The TPU pads the stack to 8-row / 128-px tiles and reads zeros past
// the image; this kernel guards those reads instead (they always carry a zero
// weight, but an unguarded read of whatever lies past the row could be NaN).
//
// Layout: imgs is [K, H, W, 3] float32 with the 3 channels of a pixel and the
// pixels of a row contiguous; the image and row strides are arguments, so a
// level slice of a packed pyramid is read in place. uv [G, Q, 2] float32,
// mask [G, Q] bool, meta [G, 3] int32, out [G, Q, 3] float32 (the layout the
// solver consumes, so nothing is transposed afterwards).
//
// What bounds it on the H100: at the path's shapes (G = 8..640 groups,
// Q = 512) a call moves from ~100 KB to ~10 MB, a few microseconds at
// 3.35 TB/s, so it is bound by launch and memory latency, not by bandwidth
// or arithmetic. One thread per sample, the weights computed once, the 3
// channels read at the four corners. Staging each region in shared memory
// with TMA is the next step if the sampler ever shows in a profile.
//
// Built by textslam_tpu_torch/ops/cuda_lib.py into a shared library with a
// plain C interface and called through ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int C = 3;  // (intensity, sobel-x, sobel-y)

__global__ void __launch_bounds__(kThreads)
patch_sample_kernel(const float* __restrict__ imgs, long long img_stride,
                    long long row_stride, const int32_t* __restrict__ meta,
                    const float* __restrict__ uv, const uint8_t* __restrict__ mask,
                    float* __restrict__ out, int Q, int H, int W, int RH, int RW) {
  const int g = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= Q) return;
  const size_t gq = (size_t)g * Q + q;
  float* o = out + gq * C;
  if (!mask[gq]) {
    o[0] = o[1] = o[2] = 0.f;
    return;
  }
  const int k = meta[3 * g], oy = meta[3 * g + 1], ox = meta[3 * g + 2];
  const float u = fminf(fmaxf(uv[2 * gq] - (float)ox, 0.f), (float)(RW - 1));
  const float v = fminf(fmaxf(uv[2 * gq + 1] - (float)oy, 0.f), (float)(RH - 1));
  const int u0 = min(max((int)floorf(u), 0), RW - 2);
  const int v0 = min(max((int)floorf(v), 0), RH - 2);
  const float du = u - (float)u0, dv = v - (float)v0;
  const int x0 = ox + u0, y0 = oy + v0;
  const bool x1_in = x0 + 1 < W, y1_in = y0 + 1 < H;
  const float* p00 = imgs + (long long)k * img_stride + (long long)y0 * row_stride +
                     (long long)x0 * C;
  const float* p10 = p00 + row_stride;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float i00 = p00[c];
    const float i01 = x1_in ? p00[C + c] : 0.f;
    const float i10 = y1_in ? p10[c] : 0.f;
    const float i11 = (x1_in && y1_in) ? p10[C + c] : 0.f;
    const float top = (1.f - du) * i00 + du * i01;
    const float bot = (1.f - du) * i10 + du * i11;
    o[c] = (1.f - dv) * top + dv * bot;
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as an opaque pointer). Returns
// cudaGetLastError() as an int: 0 on success; cudaErrorInvalidValue for a
// shape the kernel does not take.
extern "C" int patch_sample_launch(const void* imgs, long long img_stride,
                                   long long row_stride, const void* meta,
                                   const void* uv, const void* mask, void* out,
                                   int G, int Q, int H, int W, int RH, int RW,
                                   void* stream) {
  if (G <= 0 || Q <= 0) return 0;
  if (G > 65535 || RH < 2 || RW < 2) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Q + kThreads - 1) / kThreads, G);
  patch_sample_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(imgs), img_stride, row_stride,
      static_cast<const int32_t*>(meta), static_cast<const float*>(uv),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), Q, H, W, RH, RW);
  return static_cast<int>(cudaGetLastError());
}
