// Host build of fe_inv.cu's arithmetic, for a check of the kernel's own code
// away from the card (tests/test_torch_fe_inv.py):
//
//   g++ -std=c++20 -O2 -shared -fPIC -x c++
//       -o libfe_inv_host.so fe_inv_host.cpp
//
// ed25519_field.cuh and fe_inv.cu compile as plain C++ without __CUDACC__.
// A group's four lanes run as four coroutines (ucontext) on one thread;
// ed_shfl (the header's ED_SHFL in host mode) stores the lane's value in a
// slot, passes to the next lane until all four have stored, reads the
// source lane's slot and passes on again until all four have read, so the
// lanes run in lock-step at every shuffle. ed_shfl_xor serves only the
// verify kernel's point formulas, which this build does not call: it
// aborts.
#include <stdint.h>
#include <ucontext.h>

#include <cstdlib>
#include <vector>

static ucontext_t fi_ctx[4], fi_main;
static int fi_lane = 0;
static uint32_t fi_slots[4];

static void fi_pass() {
  const int me = fi_lane;
  fi_lane = (me + 1) & 3;
  swapcontext(&fi_ctx[me], &fi_ctx[fi_lane]);
}

static int32_t ed_shfl(int32_t v, int src) {
  fi_slots[fi_lane] = (uint32_t)v;
  fi_pass();
  const int32_t got = (int32_t)fi_slots[src & 3];
  fi_pass();
  return got;
}
static uint32_t ed_shfl(uint32_t v, int src) {
  return (uint32_t)ed_shfl((int32_t)v, src);
}
static int32_t ed_shfl_xor(int32_t, int) { std::abort(); }

#include "fe_inv.cu"

struct FiJob { const int32_t* a; int32_t* out; int n; };
static FiJob fi_job;

// lane c's whole run; when it ends the next lane resumes (uc_link), and
// after lane 3 the caller
static void fi_lane_main(int c) {
  for (int i = 0; i < fi_job.n; i++)
    fe_inv_group(c, fi_job.a + i, fi_job.out + i, fi_job.n, true, nullptr);
}

// (24, n) tight canonical limbs -> canonical limbs of a^(p-2), with
// `lanes` 1 (fe_inv_one) or 4 (fe_inv_group). Returns 0, or -1 for another
// lane count. Not reentrant.
extern "C" int fe_inv_host(const int32_t* a, int32_t* out, int n,
                           int lanes) {
  if (lanes == 1) {
    for (int i = 0; i < n; i++) fe_inv_one(a + i, out + i, n, nullptr);
    return 0;
  }
  if (lanes != 4) return -1;
  fi_job = FiJob{a, out, n};
  std::vector<char> stacks(4 << 20);
  for (int c = 0; c < 4; c++) {
    getcontext(&fi_ctx[c]);
    fi_ctx[c].uc_stack.ss_sp = stacks.data() + (size_t)c * (1 << 20);
    fi_ctx[c].uc_stack.ss_size = 1 << 20;
    fi_ctx[c].uc_link = c < 3 ? &fi_ctx[c + 1] : &fi_main;
    makecontext(&fi_ctx[c], (void (*)())fi_lane_main, 1, c);
  }
  fi_lane = 0;
  swapcontext(&fi_main, &fi_ctx[0]);
  return 0;
}
