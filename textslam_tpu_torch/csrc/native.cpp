// Host routines of the port's native module (textslam_tpu_torch/native.py),
// the counterparts of textslam_tpu/native/_native.cpp: plain C entry points,
// built with the host C++ compiler at first use (ops/cuda_lib.py) and called
// through ctypes, which releases the interpreter lock for the call.
//
//  - levenshtein_batch: all-pairs edit distance over padded codepoint rows,
//    for loop detection when a call's strings are longer than the device
//    DP's cap (loop/closing.py). One thread per hardware thread; each takes
//    the next query row from a shared counter.
//  - covis_product: the covisibility counts inc @ inc^T (zero diagonal) of
//    a [K, P] 0/1 incidence, for SlamMap's M1/M2 rebuilds. The rows are
//    packed to 64-bit words first (threaded over rows), then each thread
//    takes the next row a and counts popcount(row_a AND row_b) for every
//    b > a, writing both halves of the symmetric result. Packing cuts the
//    work per pair from P byte operations to P/64 word operations.
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <system_error>
#include <thread>
#include <vector>

namespace {

template <class F>
void run_rows(int64_t rows, F&& body) {
    const int64_t nt = std::max<int64_t>(
        1, std::min<int64_t>(std::thread::hardware_concurrency(), rows));
    std::atomic<int64_t> next{0};
    auto worker = [&]() {
        for (int64_t r = next++; r < rows; r = next++) body(r);
    };
    std::vector<std::thread> threads;
    try {
        for (int64_t k = 1; k < nt; ++k) threads.emplace_back(worker);
    } catch (const std::system_error&) {
        // no more threads to be had: the threads started and this one share the rows
    }
    worker();
    for (auto& th : threads) th.join();
}

}  // namespace

// a [Q, L], b [T, L] int32 codepoints with lengths alen [Q], blen [T]
// (each <= L); out [Q, T] int32 distances. Returns 0.
extern "C" int levenshtein_batch(const int32_t* a, const int32_t* alen, const int32_t* b,
                                 const int32_t* blen, int64_t Q, int64_t T, int64_t L,
                                 int32_t* out) {
    run_rows(Q, [&](int64_t q) {
        std::vector<int32_t> dp(static_cast<size_t>(L) + 1);
        const int32_t* aw = a + q * L;
        const int32_t la = alen[q];
        for (int64_t t = 0; t < T; ++t) {
            const int32_t* bw = b + t * L;
            const int32_t lb = blen[t];
            for (int32_t j = 0; j <= lb; ++j) dp[j] = j;
            for (int32_t i = 1; i <= la; ++i) {
                int32_t diag = dp[0];
                dp[0] = i;
                for (int32_t j = 1; j <= lb; ++j) {
                    const int32_t up = dp[j];
                    dp[j] = std::min(diag + (aw[i - 1] != bw[j - 1]),
                                     std::min(up, dp[j - 1]) + 1);
                    diag = up;
                }
            }
            out[q * T + t] = dp[lb];
        }
    });
    return 0;
}

// inc [K, P] uint8, each 0 or 1; out [K, K] int32, written whole (zero
// diagonal). Returns 0.
extern "C" int covis_product(const uint8_t* inc, int64_t K, int64_t P, int32_t* out) {
    const int64_t words = (P + 63) / 64;
    std::vector<uint64_t> bits(static_cast<size_t>(K * words), 0);
    run_rows(K, [&](int64_t k) {
        const uint8_t* row = inc + k * P;
        uint64_t* w = bits.data() + k * words;
        for (int64_t p = 0; p < P; ++p) w[p >> 6] |= static_cast<uint64_t>(row[p] & 1) << (p & 63);
        out[k * K + k] = 0;
    });
    run_rows(K, [&](int64_t i) {
        const uint64_t* wi = bits.data() + i * words;
        for (int64_t j = i + 1; j < K; ++j) {
            const uint64_t* wj = bits.data() + j * words;
            int64_t s = 0;
            for (int64_t w = 0; w < words; ++w) s += __builtin_popcountll(wi[w] & wj[w]);
            out[i * K + j] = static_cast<int32_t>(s);
            out[j * K + i] = static_cast<int32_t>(s);
        }
    });
    return 0;
}
