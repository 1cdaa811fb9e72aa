// Pairwise Hamming distances between 256-bit ORB descriptors on Hopper's
// tensor cores (sm_90a), optionally the minimum over two row sets.
//
// Replaces textslam_tpu/ops/pallas_kernels.py::hamming_matrix_pallas (body
// _hamming_kernel): out[i, j] = sum_w popc(d1[i, w] ^ d2[j, w]) over the 8
// 32-bit words of a descriptor. d1 [N1, 8] and d2 [N2, 8] hold the bits of
// the descriptors (int32 in PyTorch, read here as uint32); out [N1, N2] is
// int32, row-major. With d1_alt [N1, 8] it writes
// min(H(d1[i], d2[j]), H(d1_alt[i], d2[j])), the matcher's alternate-
// descriptor minimum, in the same launch.
//
// What bounds it on the H100. A CUDA-core version (XOR + __popc per word) is
// bound by the popcount issue rate, not by its stores: 8 popc per entry at 16
// results per clock per SM (the CUDA programming guide's throughput table for
// compute capability 9.0) take ~63 us at [32768, 1000] on 132 SMs at
// 1.98 GHz, where the 4-byte stores allow ~39 us. Here a 256-bit descriptor
// is one k = 256 fragment of the binary MMA: mma.m16n8k256.b1.and.popc gives
// popc(a AND b) for a 16x8 tile in one instruction, and
//     H = popc(a) + popc(b) - 2 popc(a AND b)
// exactly, with popc(a) and popc(b) computed once per descriptor when its
// tile is staged. What is left is the 4 * N1 * N2 bytes of the int32 matrix, so the
// design is about the stores: the block stages its output tile in shared
// memory and writes each row segment with 16-byte vector stores (scalar,
// still coalesced, where a row of out is not 16-byte aligned, e.g. N2 = 999).
// No streaming or evict-first hint: at the tracking shape the 16 MB matrix
// fits the 50 MB L2, and the matcher's next op reads it from there.
//
// Tiles: a block of 8 warps owns 64 rows x 128 columns. Each warp computes a
// 16 x 64 strip as eight 16x8 MMA tiles (two with d1_alt). At the path shape
// [4096, 1000] that is 64 x 8 = 512 blocks with 44 KB of shared memory each
// (47 KB with d1_alt, under the 48 KB of static shared memory): 4 blocks fit
// an SM, so the 528 slots of the 132 SMs hold all 512 blocks at once, with no
// second, mostly empty wave; 1000 columns take 8 tiles, the last 104/128
// full.
//
// Built by textslam_tpu_torch/ops/cuda_lib.py into a shared library with a
// plain C interface and called through ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;       // 256-bit descriptor
constexpr int kTM = 64;         // rows per block
constexpr int kTN = 128;        // columns per block
constexpr int kWarpsM = kTM / 16;
constexpr int kWarpsN = 2;
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kWarpN = kTN / kWarpsN;  // columns per warp
// Descriptor rows in shared memory are padded to 12 words: the 8 rows x 4
// words a fragment load touches then fall on 32 distinct banks.
constexpr int kDescStride = 12;
// Output rows padded by 8 words: the 8-byte accumulator writes of a half
// warp (4 rows x 4 lanes) fall on 32 distinct banks, and rows stay 16-byte
// aligned for the vector reads of the store phase.
constexpr int kOutStride = kTN + 8;
static_assert(kTN == 32 * 4, "the store phase writes a row segment as one int4 per lane");

// D = popc(A AND B) over k = 256 for a 16x8 tile (PTX ISA, mma.m16n8k256 with
// .b1 operands). Fragments, with g = lane / 4 and t = lane % 4: A holds
// rows g and g+8, words t and t+4 of each (a0: row g word t, a1: row g+8
// word t, a2: row g word t+4, a3: row g+8 word t+4); B holds column g, words
// t and t+4; D holds rows g and g+8, columns 2t and 2t+1.
__device__ __forceinline__ void mma_and_popc(const uint32_t (&a)[4], uint32_t b0, uint32_t b1,
                                             int (&d)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0), "r"(0), "r"(0),
        "r"(0));
}

// One descriptor from global memory (two 16-byte loads) into a padded shared
// row (zeros past the edge), returning its popcount.
__device__ __forceinline__ int stage(const uint32_t* __restrict__ src, bool ok,
                                     uint32_t* __restrict__ dst) {
  uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
  if (ok) {
    lo = __ldg(reinterpret_cast<const uint4*>(src));
    hi = __ldg(reinterpret_cast<const uint4*>(src) + 1);
  }
  reinterpret_cast<uint4*>(dst)[0] = lo;
  reinterpret_cast<uint4*>(dst)[1] = hi;
  return __popc(lo.x) + __popc(lo.y) + __popc(lo.z) + __popc(lo.w) + __popc(hi.x) +
         __popc(hi.y) + __popc(hi.z) + __popc(hi.w);
}

template <bool kAlt>
__global__ void __launch_bounds__(kThreads)
hamming_mma_kernel(const uint32_t* __restrict__ d1, const uint32_t* __restrict__ d1_alt,
                   const uint32_t* __restrict__ d2, int32_t* __restrict__ out, int n1, int n2) {
  constexpr int kSets = kAlt ? 2 : 1;
  __shared__ __align__(16) uint32_t sa[kSets][kTM][kDescStride];
  __shared__ __align__(16) uint32_t sb[kTN][kDescStride];
  __shared__ int pa[kSets][kTM], pb[kTN];
  __shared__ __align__(16) int32_t so[kTM][kOutStride];

  const int i0 = blockIdx.y * kTM;
  const int j0 = blockIdx.x * kTN;
  const int tid = threadIdx.x;

  // staging: one descriptor per thread, its popcount computed on the way
  for (int k = tid; k < kTN + kSets * kTM; k += kThreads) {
    if (k < kTN) {
      const int j = j0 + k;
      pb[k] = stage(d2 + (size_t)j * kWords, j < n2, sb[k]);
    } else {
      const int set = (k - kTN) / kTM, r = (k - kTN) % kTM, i = i0 + r;
      pa[set][r] = stage((set == 0 ? d1 : d1_alt) + (size_t)i * kWords, i < n1, sa[set][r]);
    }
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = (warp % kWarpsM) * 16;  // the warp's first row in the tile
  const int wc = (warp / kWarpsM) * kWarpN;

  uint32_t a[kSets][4];
  int pr[kSets][2];
#pragma unroll
  for (int s = 0; s < kSets; ++s) {
    a[s][0] = sa[s][wr + g][t];
    a[s][1] = sa[s][wr + g + 8][t];
    a[s][2] = sa[s][wr + g][t + 4];
    a[s][3] = sa[s][wr + g + 8][t + 4];
    pr[s][0] = pa[s][wr + g];
    pr[s][1] = pa[s][wr + g + 8];
  }

#pragma unroll
  for (int nt = 0; nt < kWarpN / 8; ++nt) {
    const int c = wc + nt * 8;
    const uint32_t b0 = sb[c + g][t], b1 = sb[c + g][t + 4];
    const int pc0 = pb[c + 2 * t], pc1 = pb[c + 2 * t + 1];
    int h[4];
    {
      int d[4];
      mma_and_popc(a[0], b0, b1, d);
      h[0] = pr[0][0] + pc0 - 2 * d[0];
      h[1] = pr[0][0] + pc1 - 2 * d[1];
      h[2] = pr[0][1] + pc0 - 2 * d[2];
      h[3] = pr[0][1] + pc1 - 2 * d[3];
    }
    if constexpr (kAlt) {
      int d[4];
      mma_and_popc(a[1], b0, b1, d);
      h[0] = min(h[0], pr[1][0] + pc0 - 2 * d[0]);
      h[1] = min(h[1], pr[1][0] + pc1 - 2 * d[1]);
      h[2] = min(h[2], pr[1][1] + pc0 - 2 * d[2]);
      h[3] = min(h[3], pr[1][1] + pc1 - 2 * d[3]);
    }
    *reinterpret_cast<int2*>(&so[wr + g][c + 2 * t]) = make_int2(h[0], h[1]);
    *reinterpret_cast<int2*>(&so[wr + g + 8][c + 2 * t]) = make_int2(h[2], h[3]);
  }
  __syncthreads();

  // stores: a warp writes one row segment of 128 columns per step, as 32
  // 16-byte vectors where the row is 16-byte aligned and full, else as four
  // coalesced passes of scalar stores
  const int rows = min(kTM, n1 - i0), cols = min(kTN, n2 - j0);
  for (int r = warp; r < rows; r += kThreads / 32) {
    int32_t* dst = out + (size_t)(i0 + r) * n2 + j0;
    if (cols == kTN && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      reinterpret_cast<int4*>(dst)[lane] = reinterpret_cast<const int4*>(so[r])[lane];
    } else {
#pragma unroll
      for (int k = 0; k < kTN / 32; ++k) {
        const int c = lane + 32 * k;
        if (c < cols) dst[c] = so[r][c];
      }
    }
  }
}

}  // namespace

// out = H(d1, d2), or min(H(d1, d2), H(d1_alt, d2)) when d1_alt is not null,
// launched on `stream` (a cudaStream_t passed as an opaque pointer). d1,
// d1_alt and d2 must be 16-byte aligned (the wrapper checks). Returns
// cudaGetLastError() as an int: 0 on success.
extern "C" int hamming_matrix_launch(const void* d1, const void* d1_alt, const void* d2,
                                     void* out, int n1, int n2, void* stream) {
  if (n1 <= 0 || n2 <= 0) return 0;
  const dim3 grid((n2 + kTN - 1) / kTN, (n1 + kTM - 1) / kTM);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto a = static_cast<const uint32_t*>(d1);
  const auto b = static_cast<const uint32_t*>(d2);
  const auto alt = static_cast<const uint32_t*>(d1_alt);
  const auto o = static_cast<int32_t*>(out);
  if (alt != nullptr)
    hamming_mma_kernel<true><<<grid, kThreads, 0, s>>>(a, alt, b, o, n1, n2);
  else
    hamming_mma_kernel<false><<<grid, kThreads, 0, s>>>(a, nullptr, b, o, n1, n2);
  return static_cast<int>(cudaGetLastError());
}
