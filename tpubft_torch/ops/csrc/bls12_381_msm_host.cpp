// Host build of bls12_381_msm.cu's arithmetic for the CPU tests: the same
// field, curve and lane functions, compiled by g++ with BLS_HOST, run lane
// by lane. bls_host_msm repeats the reduce kernel's order of additions:
// thread t of T = reduce_threads(K) adds lanes t, t + T, ..., then the
// tree over the T partial sums.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libbls_msm_host.so
//       bls12_381_msm_host.cpp
#define BLS_HOST
#include "bls12_381_msm.cu"

#include <vector>

extern "C" {

int bls_host_mul(const int64_t* words, const int64_t* px, const int64_t* py,
                 const uint8_t* inf, int64_t* ox, int64_t* oy, int64_t* oz,
                 long long N) {
    for (long long n = 0; n < N; ++n) {
        pt acc;
        ladder_lane(acc, words, px, py, inf, n, N);
        store_pt(ox, oy, oz, N, n, acc);
    }
    return 0;
}

int bls_host_msm(const int64_t* words, const int64_t* px, const int64_t* py,
                 const uint8_t* inf, int64_t* ox, int64_t* oy, int64_t* oz,
                 int S, int K) {
    const long long N = (long long)S * K;
    std::vector<pt> lanes(N);
    for (long long n = 0; n < N; ++n)
        ladder_lane(lanes[n], words, px, py, inf, n, N);
    const int T = reduce_threads(K);
    std::vector<pt> sh(T);
    for (int s = 0; s < S; ++s) {
        for (int t = 0; t < T; ++t) {
            pt_identity(sh[t]);
            for (int k = t; k < K; k += T)
                pt_add(sh[t], sh[t], lanes[(long long)s * K + k]);
        }
        for (int stride = T / 2; stride > 0; stride >>= 1)
            for (int t = 0; t < stride; ++t)
                pt_add(sh[t], sh[t], sh[t + stride]);
        store_pt(ox, oy, oz, S, s, sh[0]);
    }
    return 0;
}

}  // extern "C"
