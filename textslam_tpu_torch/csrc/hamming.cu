// Pairwise Hamming distances between 256-bit ORB descriptors, for Hopper
// (sm_90a).
//
// Replaces textslam_tpu/ops/pallas_kernels.py::hamming_matrix_pallas (body
// _hamming_kernel): out[i, j] = sum_w popc(d1[i, w] ^ d2[j, w]) over the 8
// 32-bit words of a descriptor. d1 [N1, 8] and d2 [N2, 8] hold the bits of
// the descriptors (int32 in PyTorch, read here as uint32); out [N1, N2] is
// int32, row-major.
//
// What bounds it on the H100: each output costs 8 XOR + 8 POPC + 8 adds on
// 32-bit lanes, but writes 4 bytes. At the tracking shape [32768, 1000] that
// is 131 MB of stores against ~0.26 G integer operations, so the kernel is
// bound by the 4 * N1 * N2 bytes it writes, not by arithmetic. Its design
// therefore cares about store coalescing only: each block stages a TM-row
// tile of d1 and a TN-column tile of d2 in shared memory, every thread keeps
// the 8 words of its TN/32 columns in registers and walks its rows, and the
// 32 lanes of a warp write 32 neighbouring j of one output row. Ragged edges
// are masked in the kernel, so no padding is allocated. A fused mask + best-2
// variant that never writes [N1, N2] is the way past the store bound (later
// work).
//
// Built by textslam_tpu_torch/ops/cuda_lib.py into a shared library with a
// plain C interface and called through ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;   // 256-bit descriptor
constexpr int kBX = 32;     // threads along j (one warp)
constexpr int kBY = 8;      // threads along i
constexpr int kTN = 128;    // output columns per block
constexpr int kTM = 64;     // output rows per block
constexpr int kCols = kTN / kBX;  // columns per thread
constexpr int kRows = kTM / kBY;  // rows per thread

__global__ void __launch_bounds__(kBX * kBY)
hamming_kernel(const uint32_t* __restrict__ d1, const uint32_t* __restrict__ d2,
               int32_t* __restrict__ out, int n1, int n2) {
  __shared__ uint32_t s1[kTM][kWords];
  __shared__ uint32_t s2[kTN][kWords + 1];  // +1: conflict-free column reads

  const int i0 = blockIdx.y * kTM;
  const int j0 = blockIdx.x * kTN;
  const int tid = threadIdx.y * kBX + threadIdx.x;

  // coalesced staging: consecutive threads read consecutive words
  for (int k = tid; k < kTM * kWords; k += kBX * kBY) {
    const int r = k / kWords, w = k % kWords, i = i0 + r;
    s1[r][w] = i < n1 ? d1[(size_t)i * kWords + w] : 0u;
  }
  for (int k = tid; k < kTN * kWords; k += kBX * kBY) {
    const int r = k / kWords, w = k % kWords, j = j0 + r;
    s2[r][w] = j < n2 ? d2[(size_t)j * kWords + w] : 0u;
  }
  __syncthreads();

  uint32_t b[kCols][kWords];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int w = 0; w < kWords; ++w) b[c][w] = s2[threadIdx.x + kBX * c][w];

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int ii = threadIdx.y + kBY * r;
    const int i = i0 + ii;
    if (i >= n1) break;
    uint32_t a[kWords];
#pragma unroll
    for (int w = 0; w < kWords; ++w) a[w] = s1[ii][w];  // warp broadcast
    int32_t* row = out + (size_t)i * n2;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = j0 + threadIdx.x + kBX * c;
      if (j < n2) {
        int acc = 0;
#pragma unroll
        for (int w = 0; w < kWords; ++w) acc += __popc(a[w] ^ b[c][w]);
        row[j] = acc;
      }
    }
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as an opaque pointer). Returns
// cudaGetLastError() as an int: 0 on success.
extern "C" int hamming_matrix_launch(const void* d1, const void* d2, void* out,
                                     int n1, int n2, void* stream) {
  if (n1 <= 0 || n2 <= 0) return 0;
  const dim3 grid((n2 + kTN - 1) / kTN, (n1 + kTM - 1) / kTM);
  const dim3 block(kBX, kBY);
  hamming_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(d1), static_cast<const uint32_t*>(d2),
      static_cast<int32_t*>(out), n1, n2);
  return static_cast<int>(cudaGetLastError());
}
