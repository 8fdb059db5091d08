// Host build of bls12_381_msm.cu's arithmetic, for a check of the kernel's
// own code away from the card (tests/test_torch_bls_msm.py):
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libbls_msm_host.so
//       bls12_381_msm_host.cpp
//
// The .cu compiles as plain C++ with BLS_HOST: the field, curve, scalar
// and chain functions and the launch plan. A group's L lanes run as L
// coroutines on one thread; bls_host_shfl stores the lane's
// value in a slot, passes to the next lane until all L have stored, reads
// the source lane's slot and passes on again until all L have read, so
// the lanes run in lock-step at every shuffle (bls_host_ballot likewise).
// The carry flag of the PTX chains is one variable: no chain spans a
// shuffle. bls_host_msm repeats the launch: the plan's CTAs one after
// another, in each the chains group by group, the tree level by level,
// then the second launch's sums where a segment has several pieces (the
// kernels' additions into spare slots, which keep a warp's groups in
// lock-step, change no result and are left out).
#include <stdint.h>

#include <functional>
#include <vector>

// The lanes' contexts. On x86-64 a switch is six pushes, a stack swap and
// six pops (bh_switch: glibc's swapcontext also saves the signal mask, a
// system call a switch, which made the group designs' tests minutes
// long); elsewhere ucontext.
static int bh_lanes = 1, bh_lane = 0;
static uint32_t bh_slot[4];
static const std::function<void(int)>* bh_fn;

static void bh_entry() {
    (*bh_fn)(bh_lane);
    // the last pass of the group has run: hand over to the next lane,
    // which ends too, and after the last lane to the caller
    extern void bh_done();
    bh_done();
}

#if defined(__x86_64__)
extern "C" void bh_switch(void** from, void* to);
asm(R"(
    .text
    .p2align 4
    .hidden bh_switch
    .globl bh_switch
    .type bh_switch, @function
bh_switch:
    pushq %rbp
    pushq %rbx
    pushq %r12
    pushq %r13
    pushq %r14
    pushq %r15
    movq %rsp, (%rdi)
    movq %rsi, %rsp
    popq %r15
    popq %r14
    popq %r13
    popq %r12
    popq %rbx
    popq %rbp
    ret
    .size bh_switch, .-bh_switch
)");

static void* bh_sp[4];
static void* bh_main_sp;

static void bh_to(int from, int to) {
    bh_lane = to;
    bh_switch(&bh_sp[from], bh_sp[to]);
}

void bh_done() {
    const int me = bh_lane;
    if (me + 1 < bh_lanes) {
        bh_lane = me + 1;
        bh_switch(&bh_sp[me], bh_sp[me + 1]);
    } else {
        bh_switch(&bh_sp[me], bh_main_sp);
    }
}

// a fresh stack whose first switch "returns" into bh_entry, as a call
static void bh_start(int c, char* stack, size_t size) {
    uintptr_t top = ((uintptr_t)(stack + size)) & ~(uintptr_t)15;
    void** sp = (void**)(top - 64);
    for (int i = 0; i < 6; ++i) sp[i] = nullptr;
    sp[6] = (void*)bh_entry;
    sp[7] = nullptr;
    bh_sp[c] = sp;
}

static void bh_run(int) { bh_switch(&bh_main_sp, bh_sp[0]); }
#else
#include <ucontext.h>

static ucontext_t bh_ctx[4], bh_main;

static void bh_to(int from, int to) {
    bh_lane = to;
    swapcontext(&bh_ctx[from], &bh_ctx[to]);
}

void bh_done() {
    const int me = bh_lane;
    bh_lane = me + 1;
    setcontext(me + 1 < bh_lanes ? &bh_ctx[me + 1] : &bh_main);
}

static void bh_start(int c, char* stack, size_t size) {
    getcontext(&bh_ctx[c]);
    bh_ctx[c].uc_stack.ss_sp = stack;
    bh_ctx[c].uc_stack.ss_size = size;
    bh_ctx[c].uc_link = nullptr;
    makecontext(&bh_ctx[c], bh_entry, 0);
}

static void bh_run(int) { swapcontext(&bh_main, &bh_ctx[0]); }
#endif

static void bh_pass() {
    if (bh_lanes == 1) return;
    bh_to(bh_lane, (bh_lane + 1) % bh_lanes);
}

static uint32_t bls_host_shfl(uint32_t v, int src) {
    bh_slot[bh_lane] = v;
    bh_pass();
    const uint32_t got = bh_slot[src];
    bh_pass();
    return got;
}

static uint32_t bls_host_ballot(bool pred) {
    bh_slot[bh_lane] = pred ? 1u : 0u;
    bh_pass();
    uint32_t bits = 0;
    for (int i = 0; i < bh_lanes; ++i) bits |= bh_slot[i] << i;
    bh_pass();
    return bits;
}

#define BLS_HOST
#include "bls12_381_msm.cu"

// fn(c) for c = 0..L-1 in lock-step: lane 0 starts; when a lane ends the
// next resumes, and after the last the caller
static void run_group(int L, const std::function<void(int)>& fn) {
    bh_lanes = L;
    bh_lane = 0;
    if (L == 1) {
        fn(0);
        return;
    }
    static std::vector<char> stacks(4 << 20);
    bh_fn = &fn;
    for (int c = 0; c < L; ++c)
        bh_start(c, stacks.data() + (size_t)c * (1 << 20), 1 << 20);
    bh_run(0);
}

template <int L>
static void host_msm(const int64_t* words, const int64_t* px,
                     const int64_t* py, const uint8_t* inf, int64_t* ox,
                     int64_t* oy, int64_t* oz, int S, int K, int sms) {
    const BlsPlan pl = bls_plan(S, K, L, sms);
    const long long N = (long long)S * K;
    const int width = 2 * pl.piece;
    std::vector<uint32_t> partial((size_t)S * pl.pps * PTW);
    for (int b = 0; b < pl.ctas; ++b) {
        std::vector<uint32_t> sh((size_t)pl.chains * SLOTS * PTW);
        auto slot = [&](int gid) { return sh.data() + (size_t)gid * SLOTS * PTW; };
        auto piece_of = [&](int gid) {
            return (long long)b * pl.spc + gid / width;
        };
        auto live_piece = [&](int gid) {
            return piece_of(gid) < (long long)S * pl.pps;
        };
        for (int gid = 0; gid < pl.chains; ++gid) {
            const long long q = piece_of(gid);
            const int gi = gid % width;
            const long long s = live_piece(gid) ? q / pl.pps : 0;
            const int kk =
                (int)(live_piece(gid) ? q % pl.pps : 0) * pl.piece + gi / 2;
            const long long n = s * K + kk;
            const bool live = live_piece(gid) && kk < K && !inf[n];
            run_group(L, [&](int c) {
                chain<L>(slot(gid), c, 0, live, words, px, py, n, N, gi & 1);
            });
        }
        for (int stride = 1; stride < width; stride *= 2)
            for (int gid = 0; gid < pl.chains; ++gid) {
                const int gi = gid % width;
                if (live_piece(gid) && gi % (2 * stride) == 0 &&
                    gi + stride < width)
                    run_group(L, [&](int c) {
                        pt_add<L>(slot(gid), slot(gid), slot(gid + stride), 0,
                                  c, 0);
                    });
            }
        for (int gid = 0; gid < pl.chains; gid += width) {
            if (!live_piece(gid)) continue;
            const long long q = piece_of(gid);
            if (pl.pps == 1)
                run_group(L, [&](int c) {
                    store_final<L>(slot(gid), c, 0, true, ox, oy, oz, S, q);
                });
            else
                for (int w = 0; w < PTW; ++w)
                    partial[(size_t)q * PTW + w] = slot(gid)[w];
        }
    }
    if (pl.pps == 1) return;
    const int G = pl.reduce_groups;
    for (int s = 0; s < S; ++s) {
        std::vector<uint32_t> sh((size_t)G * PTW);
        for (int gid = 0; gid < G; ++gid)
            run_group(L, [&](int c) {
                uint32_t* slot = sh.data() + (size_t)gid * PTW;
                st_identity(grp<L>(c, 0), slot);
                for (int j = gid; j < pl.pps; j += G)
                    pt_add<L>(slot, slot,
                              partial.data() + ((size_t)s * pl.pps + j) * PTW,
                              0, c, 0);
            });
        for (int stride = 1; stride < G; stride *= 2)
            for (int gid = 0; gid < G; ++gid)
                if (gid % (2 * stride) == 0 && gid + stride < G)
                    run_group(L, [&](int c) {
                        uint32_t* slot = sh.data() + (size_t)gid * PTW;
                        pt_add<L>(slot, slot, slot + stride * PTW, 0, c, 0);
                    });
        run_group(L, [&](int c) {
            store_final<L>(sh.data(), c, 0, true, ox, oy, oz, S, s);
        });
    }
}

template <int L>
static void host_field(int op, const uint32_t* a, const uint32_t* b,
                       uint32_t* out) {
    run_group(L, [&](int c) {
        const Grp<L> g = grp<L>(c, 0);
        const Fe<L> x = ld_fe(g, a), y = ld_fe(g, b);
        const Fe<L> r = op == 0 ? f_mul(g, x, y)
                        : op == 1 ? f_add(g, x, y)
                                  : f_sub(g, x, y);
        st_fe(g, out, r);
    });
}

extern "C" {

// S sums of K lanes (the kernel's contract; [k_i] P_i is S = B, K = 1) on
// `lanes` lanes an element, planned for `sms` SMs. Returns 0, or -1 for
// another lane count. Not reentrant.
int bls_host_msm(const int64_t* words, const int64_t* px, const int64_t* py,
                 const uint8_t* inf, int64_t* ox, int64_t* oy, int64_t* oz,
                 int S, int K, int lanes, int sms) {
    switch (lanes) {
        case 1: host_msm<1>(words, px, py, inf, ox, oy, oz, S, K, sms); return 0;
        case 2: host_msm<2>(words, px, py, inf, ox, oy, oz, S, K, sms); return 0;
        case 4: host_msm<4>(words, px, py, inf, ox, oy, oz, S, K, sms); return 0;
    }
    return -1;
}

// one field operation on 12-word elements below 2p: op 0 the Montgomery
// product, 1 the sum, 2 the difference, each loose in [0, 2p)
int bls_host_field(int op, int lanes, const uint32_t* a, const uint32_t* b,
                   uint32_t* out) {
    switch (lanes) {
        case 1: host_field<1>(op, a, b, out); return 0;
        case 2: host_field<2>(op, a, b, out); return 0;
        case 4: host_field<4>(op, a, b, out); return 0;
    }
    return -1;
}

// the scalar prologue of one lane: k (8 words, < r) -> out[0..4) k1,
// out[4..8) k2, out[8] the sign, out[9..14) k1 + 0x88..8, out[14..19)
// k2 + 0x88..8 (digit j of a half: nibble j - 8)
int bls_host_glv(const uint32_t* k, uint32_t* out) {
    uint32_t neg;
    glv_split(k, out, out + 4, neg);
    out[8] = neg;
    recode(out, out + 9);
    recode(out + 4, out + 14);
    return 0;
}

}  // extern "C"
