// Grouped bilinear region sampling of a channel-interleaved image stack, for
// Hopper (sm_90a): region origins, mask and samples in one launch.
//
// Replaces textslam_tpu/ops/pallas_kernels.py::patch_sample_grouped (body
// _patch_sample_kernel) together with the region arithmetic of its wrapper
// grouped_bilinear_stack. Each group g is one (text object, target keyframe)
// pair with Q sample positions uv[g, q] = (u, v) that cluster inside one
// RH x RW region of image k = group_k[g]. Block g computes, as the wrapper
// does,
//   (u, v)  <- nan_to_num: NaN -> -1e6, +inf -> 1e6, -inf -> -1e6
//   in_img  = 0 <= u <= W-1 and 0 <= v <= H-1
//   ox      = 0 for a full-width level, else
//             clip(floor(min in-image u) // 128 * 128, 0, W128-RW)
//   oy      = 0 for a full-height level, else
//             clip(floor(min in-image v) // 8 * 8, 0, H8-RH)
//             (a group with no in-image sample takes origin 0)
//   mask    = in_img and ox <= u <= ox+RW-1 and oy <= v <= oy+RH-1
// and then, for every kept sample, the TPU kernel's formula
//   u' = clip(u - ox, 0, RW-1), u0 = clip(floor(u'), 0, RW-2), du = u' - u0
//   v' = clip(v - oy, 0, RH-1), v0 = clip(floor(v'), 0, RH-2), dv = v' - v0
//   out[g, q, c] = (1-dv) ((1-du) I[y0, x0, c] + du I[y0, x0+1, c])
//                +   dv  ((1-du) I[y0+1, x0, c] + du I[y0+1, x0+1, c])
// with (y0, x0) = (oy + v0, ox + u0); 0 where the mask is false. Keep the
// per-sample expressions and their order: the text run's results on the card
// depend on the sampled values bit for bit (it is deterministic).
//
// Why the origins moved into the kernel: the TPU kernel needs them as scalar
// prefetch to drive its region DMAs, so its wrapper computes them in XLA,
// where they fuse into the jitted LM scan. In eager PyTorch that split cost
// ~15 small ATen launches and host dispatches per call (nan_to_num, two
// masked minima, floor, snap, four comparisons, stack, cast), 0.25-0.95 ms
// of host time against a ~2 us kernel. Here one block per group reduces its
// samples' minima with warp shuffles and one shared-memory pass, then
// samples: one launch per call and nothing around it.
//
// What bounds it on the H100: the bytes (uv read, samples and mask written,
// each corner pixel read once) are ~0.15 us at G = 16, Q = 512 and 3.35
// TB/s; the real limit at the path's shapes (G = 4..32) is latency: the
// launch, the uv read, the block reduction, then the dependent corner reads,
// ~4 us of device time against that bound. So the design
// keeps one sample per thread (up to 512 threads, the path's Q), keeps it in
// registers between the two steps and reads the image index first.
// Why no region is staged in shared memory or by TMA: a group's 512
// samples touch a few KB of L2-resident pixels once each, so staging a
// 160 x 384 x 3 region (737 KB, more than a block's 227 KB of shared memory)
// or even its touched part would add a round trip, not remove one. The four
// corners are read straight from global memory; reads past the image (which
// the TPU's zero padding answers, always with weight 0) are guarded.
//
// Layout: imgs is [K, H, W, 3] float32 with the 3 channels of a pixel and the
// pixels of a row contiguous; the image and row strides are arguments, so a
// level slice of a packed pyramid is read in place. group_k [G] int64 is
// read through its element stride, so a strided view needs no copy. uv
// [G, Q, 2] float32 contiguous; out [G, Q, 3] float32 and mask [G, Q] bool
// (one byte) are written, in the layout the solver consumes.
//
// Built by textslam_tpu_torch/ops/cuda_lib.py into a shared library with a
// plain C interface and called through ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;  // the path's Q: one sample per thread
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int C = 3;  // (intensity, sobel-x, sobel-y)
constexpr int kAlignY = 8, kAlignX = 128;  // the TPU's tile: origins snap to it

// torch.nan_to_num(x, nan=-1e6, posinf=1e6, neginf=-1e6)
__device__ __forceinline__ float nan_to_num(float x) {
  if (isnan(x)) return -1e6f;
  if (isinf(x)) return x > 0.f ? 1e6f : -1e6f;
  return x;
}

// floor(lo) // align * align, clipped to [0, hi]; lo is +inf when the group
// has no in-image sample, which takes origin 0. An in-image lo is >= 0, so
// C's integer division is the floor division.
__device__ __forceinline__ int snap(float lo, int align, int hi) {
  if (isinf(lo)) return 0;
  return min(max((int)floorf(lo) / align * align, 0), hi);
}

__global__ void __launch_bounds__(kMaxThreads)
region_sample_kernel(const float* __restrict__ imgs, const int64_t* __restrict__ group_k,
                     const float* __restrict__ uv, float* __restrict__ out,
                     uint8_t* __restrict__ mask, long long img_stride, long long row_stride,
                     long long k_stride, int Q, int H, int W, int RH, int RW, int H8,
                     int W128, int full_h, int full_w) {
  __shared__ float s_min[2][kMaxWarps];
  const int g = blockIdx.x;
  const float* uv_g = uv + (size_t)g * Q * 2;
  const float u_hi = (float)(W - 1), v_hi = (float)(H - 1);
  // read first: nothing before the corner reads depends on it
  const float* img = imgs + group_k[(long long)g * k_stride] * img_stride;

  // 1. the group's minimum in-image u and v (a minimum is exact in any
  // order); each thread keeps its first sample (its only one when Q <=
  // blockDim.x) in registers for step 3
  const int q0 = threadIdx.x;
  float u_q0 = 0.f, v_q0 = 0.f;
  float min_u = INFINITY, min_v = INFINITY;
  for (int q = q0; q < Q; q += blockDim.x) {
    const float u = nan_to_num(uv_g[2 * q]), v = nan_to_num(uv_g[2 * q + 1]);
    if (q == q0) {
      u_q0 = u;
      v_q0 = v;
    }
    if (u >= 0.f && u <= u_hi && v >= 0.f && v <= v_hi) {
      min_u = fminf(min_u, u);
      min_v = fminf(min_v, v);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    min_u = fminf(min_u, __shfl_xor_sync(0xffffffffu, min_u, off));
    min_v = fminf(min_v, __shfl_xor_sync(0xffffffffu, min_v, off));
  }
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_min[0][warp] = min_u;
    s_min[1][warp] = min_v;
  }
  __syncthreads();
  min_u = s_min[0][0];
  min_v = s_min[1][0];
  for (int w = 1; w < n_warps; ++w) {
    min_u = fminf(min_u, s_min[0][w]);
    min_v = fminf(min_v, s_min[1][w]);
  }

  // 2. the region origin, snapped to the TPU's tiles
  const int ox = full_w ? 0 : snap(min_u, kAlignX, W128 - RW);
  const int oy = full_h ? 0 : snap(min_v, kAlignY, H8 - RH);
  const float ox_lo = (float)ox, ox_hi = (float)(ox + RW - 1);
  const float oy_lo = (float)oy, oy_hi = (float)(oy + RH - 1);

  // 3. mask and bilinear samples
  for (int q = q0; q < Q; q += blockDim.x) {
    const size_t gq = (size_t)g * Q + q;
    const float ua = q == q0 ? u_q0 : nan_to_num(uv_g[2 * q]);
    const float va = q == q0 ? v_q0 : nan_to_num(uv_g[2 * q + 1]);
    const bool keep = ua >= 0.f && ua <= u_hi && va >= 0.f && va <= v_hi &&
                      ua >= ox_lo && ua <= ox_hi && va >= oy_lo && va <= oy_hi;
    mask[gq] = keep;
    float* o = out + gq * C;
    if (!keep) {
      o[0] = o[1] = o[2] = 0.f;
      continue;
    }
    const float u = fminf(fmaxf(ua - (float)ox, 0.f), (float)(RW - 1));
    const float v = fminf(fmaxf(va - (float)oy, 0.f), (float)(RH - 1));
    const int u0 = min(max((int)floorf(u), 0), RW - 2);
    const int v0 = min(max((int)floorf(v), 0), RH - 2);
    const float du = u - (float)u0, dv = v - (float)v0;
    const int x0 = ox + u0, y0 = oy + v0;
    const bool x1_in = x0 + 1 < W, y1_in = y0 + 1 < H;
    const float* p00 = img + (long long)y0 * row_stride + (long long)x0 * C;
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
}

// The scalar arguments, packed on the host by ops/patch_sample.py (LaunchArgs,
// struct format "=3q10i"): one pointer through ctypes instead of 13
// converted integers. full_h / full_w say that the level's padded extent
// (H8, W128) fits the region (RH = H8 / RW = W128).
struct LaunchArgs {
  long long img_stride, row_stride, k_stride;
  int G, Q, H, W, RH, RW, H8, W128, full_h, full_w;
};
static_assert(sizeof(LaunchArgs) == 64, "LaunchArgs must match the host's packing");

}  // namespace

// One block per group (G on grid.x, so up to 2^31 - 1 groups), Q rounded up
// to whole warps and capped at kMaxThreads threads, launched on `stream` (a
// cudaStream_t passed as an opaque pointer). Returns cudaGetLastError() as an
// int: 0 on success; cudaErrorInvalidValue for a shape the kernel does not
// take.
extern "C" int patch_sample_launch(const void* imgs, const void* group_k, const void* uv,
                                   void* out, void* mask, const void* args, void* stream) {
  const LaunchArgs a = *static_cast<const LaunchArgs*>(args);
  if (a.G <= 0 || a.Q <= 0) return 0;
  if (a.H < 2 || a.W < 2 || a.RH < 2 || a.RW < 2 || a.RH > a.H8 || a.RW > a.W128)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = min(kMaxThreads, (a.Q + 31) / 32 * 32);
  region_sample_kernel<<<a.G, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(imgs), static_cast<const int64_t*>(group_k),
      static_cast<const float*>(uv), static_cast<float*>(out), static_cast<uint8_t*>(mask),
      a.img_stride, a.row_stride, a.k_stride, a.Q, a.H, a.W, a.RH, a.RW, a.H8, a.W128,
      a.full_h, a.full_w);
  return static_cast<int>(cudaGetLastError());
}
