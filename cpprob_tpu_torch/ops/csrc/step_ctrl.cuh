// The one-step launch's resample control, shared by the kernels that carry
// it (csrc/fused_lg.cu: K6 and lg_init_kernel; csrc/user_chunk.cuh: the
// user-physics one-step launch): the flag of the step in, and the ESS and
// the next step's flag out, combined from the launch's per-CTA records by
// its last CTA.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "block_reduce.cuh"

namespace {

// The step's resample control: flag (int32, in), ticket (one int, zero
// before the launch and left zero by the last CTA), ess (float64, out) and
// next (int32, out: ess < thresh).
struct StepCtrl {
  const int* flag;
  int* ticket;
  double* ess;
  int* next;
  double thresh;
};

// After the CTA's record (max w, sum e, sum e^2) is written to rec: the
// last CTA to finish (sc.ticket) combines every record in float64 into the
// ESS and the flag ess < thresh, and clears the ticket.  Every thread of a
// kThreads-thread CTA calls it; redd, bcastd and last_s are shared.
template <int kThreads>
__device__ __forceinline__ void last_cta_combine(const float* rec,
                                                 const StepCtrl& sc,
                                                 float* red, float* bcast,
                                                 double* redd, double* bcastd,
                                                 int* last_s) {
  if (threadIdx.x == 0) {
    __threadfence();
    *last_s = atomicAdd(sc.ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!*last_s) return;
  __threadfence();
  // stats_from_partials on the records, by CTA index, read past L1: the
  // largest max, then sum e and sum e^2 rescaled to it
  const int n_rec = (int)gridDim.x;
  float mr = -INFINITY;
  for (int b = threadIdx.x; b < n_rec; b += kThreads)
    mr = fmaxf(mr, __ldcg(rec + 3LL * b));
  mr = block_max<kThreads>(mr, red, bcast);
  double s[2] = {0.0, 0.0};
  for (int b = threadIdx.x; b < n_rec; b += kThreads) {
    const double scale = exp((double)__ldcg(rec + 3LL * b) - (double)mr);
    s[0] += (double)__ldcg(rec + 3LL * b + 1) * scale;
    s[1] += (double)__ldcg(rec + 3LL * b + 2) * scale * scale;
  }
  block_sum<kThreads, 2>(s, redd, bcastd);
  if (threadIdx.x == 0) {
    const double ess = s[0] * s[0] / fmax(s[1], 1e-300);
    *sc.ess = ess;
    *sc.next = ess < sc.thresh;
    *sc.ticket = 0;
  }
}

}  // namespace
