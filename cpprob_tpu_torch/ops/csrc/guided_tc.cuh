// K12's tensor-core twin: the guided scalar chunk kernel with the proposal
// net's hidden->hidden layers on mma.sync TF32 in 3xTF32.
// Replaces _make_guided_scalar_chunk_kernel_mxu
// (cpprob_tpu/ops/pallas_ssm.py:948-1037), the reference's default
// (attach_fused_guided_scalar_kernels(..., mxu=True), pallas_ssm.py:1093).
//
// The body of the kernel is fixed; cpprob_tpu_torch/ops/guided_tc.py
// generates one source per pair of densities and set of layer sizes that
// defines, before it includes this header, in namespace guided_tc_model:
//   constexpr int kLayers;               // weight layers, >= 2
//   constexpr int kWidths[kLayers + 1];  // {3, H_1, .., H_{L-1}, 2}, each
//                                        // hidden width a multiple of 8
//   __device__ float trans_logpdf_elem(float x, float nx, float t);
//   __device__ float obs_logpdf_elem(float nx, float y, float t);
// The weights come as one packed float32 buffer (guided_tc.py
// pack_weights), so a newly trained net of the same sizes needs no build.
//
// Per particle-step: the Box-Muller eps of absolute step t (Philox counter
// (particle, t / 2, 0): its cos half at even t, its sin half at odd t, as in
// K7 and K12), the net's (mean, raw), the move nx = mean + std
// eps with std = softplus(raw) + 1e-6, and the weight log_w +=
// trans(x, nx, t) + obs(nx, y, t) - log q(nx).  Records: one (max, sum e,
// sum e^2) per CTA.  The key: two device words (philox.cuh LaunchKey, what
// a replayed CUDA graph of a sweep reads).
//
// Layout.  A warp takes 32 particles a group as two m16 row tiles; lane
// (g = lane / 4, t = lane % 4) holds rows g and g + 8 of each tile in its
// fragments, so the quad g holds four particles, and thread t owns one of
// them (tile t / 2, row g + 8 (t % 2)) for the per-particle work: draw,
// softplus, move, densities, weight, and its x, log_w and spare normal in
// registers across the chunk.  The first layer h = relu(x w_x + c) (c =
// w_y y + w_t t / T + b, once a step; one fused multiply-add a unit) is
// formed on the FMA pipe directly in the C fragment's positions: lane
// (g, t) computes units 2t and 2t + 1 of every block of 8 for rows g and
// g + 8, from the quad's four x values (four shuffles).  A layer's C
// fragment (columns 2t, 2t + 1) is the next layer's A fragment (k
// positions t, t + 4) as it stands, because the host permutes the rows of
// every weight matrix within each block of 8 (k position t <-> unit 2t,
// t + 4 <-> 2t + 1); the bias is the first product's C operand, and ReLU
// acts on the accumulators in registers.  The output layer (H -> 2) runs
// on the FMA pipe (output_fma): partial sums over each lane's columns and a
// reduce-scatter across the quad in six shuffles.  Padded to n = 8 on the
// tensor cores it took 1.12 times as long at [3,16,16,2], and a thread
// taking one or four particles (kGroups) was slower than two (PERF.md §6).
//
// The wide layout (kWide: a hidden layer wider than 32, up to 64, the width
// the trainer gives by default).  At width 64 one layer's activations and
// the next one's accumulators are 128 floats a particle-tile pair: two
// groups of them do not fit in a thread's registers.  So the first layer is
// never held: forward_wide forms each block of 8 first-layer units in the
// A fragment's positions just before the tensor cores take that block
// (the same fused multiply-add, the same c) and splits it at once, so a
// [3, H, H', 2] net holds only the accumulators of its one hidden->hidden
// layer, and a thread keeps two particles (kWideGroups: 255 registers and
// no local memory at [3,64,64,2]; one particle took 136 registers and
// ran 1.08 times as long, PERF.md §6).  A deeper wide net holds a later
// layer's activations and accumulators both and takes one particle a
// thread.  The products, their order and the packed buffer are those of
// the narrow layout, whose machine code this leaves as it was.
//
// Precision.  Each operand is split into hi = tf32(v) and lo = v - hi
// (split() below; the weights on the host, once, lo rounded to TF32 too);
// each product is a_lo b_hi + a_hi b_lo + a_hi b_hi accumulated in
// float32, the smallest terms first, as CUTLASS's 3xTF32: float32-level
// accuracy.  The per-particle work rounds as the plain version does
// (round-to-nearest intrinsics, precise expf / logf / log1pf); only the
// net takes its own rounding (the first layer's fused multiply-add, the
// products' splits and another order of summation).  One (mean, std) both
// samples and scores each move, so the weight stays the exact
// Radon-Nikodym weight whatever the rounding.
//
// What bounds it on an H100: per particle-step 3 sum(H_l H_{l+1}) TF32
// multiply-adds of the hidden->hidden layers on the tensor cores; the
// first layer, ReLU, the output layer and the tail on the FMA pipe; half a
// Box-Muller pair and an exp + log1p pair (util/roofline.py guided_tc_ops,
// which leaves out the splits and the quad's adds: work of this design, not
// of the function, about 3 operations an activation).  No one of them: the
// kernel is bound by instruction issue.  Issuing every mma.sync twice
// added about a fifth to its time, taking the draws or the tail's
// transcendentals out saved a fifth and an eighth (util/guided_tc_parts.py
// on an H100 80GB HBM3 at 700 W), so the FMA and ALU work of the net and
// the tail, not the tensor cores, comes first.  The weights are read
// through the read-only cache at each use (any depth fits) and the
// particles move 16 B each per launch.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "block_reduce.cuh"
#include "philox.cuh"

namespace guided_tc {

using namespace guided_tc_model;

constexpr int kThreads = 256;

// the widest hidden layer of the net
__host__ __device__ constexpr int widest_hidden() {
  int w = 0;
  for (int l = 1; l < kLayers; ++l) w = kWidths[l] > w ? kWidths[l] : w;
  return w;
}
// a net with a hidden layer wider than 32 takes the wide layout
constexpr bool kWide = widest_hidden() > 32;
// particles a thread in the wide layout: two where one hidden->hidden layer
// takes the fused first layer (the accumulators alone are held: 255
// registers at [3,64,64,2], no local memory), one for deeper nets, whose
// later layers hold activations and accumulators both
constexpr int kWideGroups = kLayers == 3 ? 2 : 1;
// the wide layout forms the first layer inside the first hidden->hidden one
constexpr bool kFusedFirst = kWide && kLayers > 2;
// particles a thread (32 a warp each): at two no net up to [3,32,32,32,2]
// touches local memory; at one some did (a 32-byte stack frame)
constexpr int kGroups = kWide ? kWideGroups : 2;
constexpr int kBlock = kThreads * kGroups;  // particles per CTA
constexpr float kHalfLog2Pi = 0.91893853320467274f;

// Floats of weight layer l >= 1 in the packed buffer.  A hidden->hidden
// layer: its kWidths[l + 1] biases and its B fragments, (kWidths[l] / 8) x
// (kWidths[l + 1] / 8) blocks x 32 lanes x (hi b0, hi b1, lo b0, lo b1).
// The output layer: (b_mean, b_raw, 0, 0), then per block of 8 rows and per
// t the rows 2t and 2t + 1, (w_mean, w_raw) each.
__host__ __device__ constexpr int layer_floats(int l) {
  return l == kLayers - 1 ? 4 + 2 * kWidths[l]
                          : kWidths[l + 1] + 2 * kWidths[l] * kWidths[l + 1];
}

// Offset (floats) of weight layer l >= 1: the first layer comes first,
// (w_x, w_y, w_t, b) a unit.
__host__ __device__ constexpr int offset(int l) {
  int off = 4 * kWidths[1];
  for (int i = 1; i < l; ++i) off += layer_floats(i);
  return off;
}

// v = hi + lo: hi is v rounded to TF32 (to nearest, ties away from zero, as
// cvt.rna.tf32.f32, in two integer operations: cvt.rna itself compiles to
// a longer sequence), lo = v - hi exactly; lo goes to the tensor cores as
// it stands, and they read its top 19 bits (they ignore a TF32 operand's
// low 13 bits), a truncation of at most 2^-10 |lo| <= 2^-21 |v|.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi)));
}

// d = a (16x8, row) b (8x8, col) + c, TF32 operands, float32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1,
                                         const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// The output layer on the FMA pipe: each lane sums its columns (2t, 2t + 1
// of every block) of the four rows of its quad, then the quad adds the
// partial sums in two shuffles, across the tiles (lanes t, t ^ 2) and then
// across the rows (t, t ^ 1), so that each owner ends with its particle's
// (mean, raw).
template <int K>
__device__ __forceinline__ void output_fma(const float (&in)[kGroups][2][K / 8][4],
                                           const float* __restrict__ wl, int lane,
                                           float (&mr)[kGroups][2]) {
  const int t = lane & 3;
  const bool s1 = (t >> 1) != 0, r1 = (t & 1) != 0;
  const float4 bias = __ldg(reinterpret_cast<const float4*>(wl));
  const float4* w4 = reinterpret_cast<const float4*>(wl + 4);
  float part[kGroups][2][2][2];  // [group][tile][row g, g + 8][mean, raw]
#pragma unroll
  for (int p = 0; p < kGroups; ++p)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int r = 0; r < 2; ++r) part[p][s][r][0] = part[p][s][r][1] = 0.f;
#pragma unroll
  for (int kb = 0; kb < K / 8; ++kb) {
    // rows 8 kb + 2t and 8 kb + 2t + 1: (w_mean, w_raw) each
    const float4 w = __ldg(w4 + 4 * kb + t);
#pragma unroll
    for (int p = 0; p < kGroups; ++p)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float c0 = in[p][s][kb][2 * r], c1 = in[p][s][kb][2 * r + 1];
          part[p][s][r][0] = __fmaf_rn(c1, w.z, __fmaf_rn(c0, w.x, part[p][s][r][0]));
          part[p][s][r][1] = __fmaf_rn(c1, w.w, __fmaf_rn(c0, w.y, part[p][s][r][1]));
        }
  }
#pragma unroll
  for (int p = 0; p < kGroups; ++p) {
    float keep[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const float mine = s1 ? part[p][1][r][o] : part[p][0][r][o];
        const float other = s1 ? part[p][0][r][o] : part[p][1][r][o];
        keep[r][o] = __fadd_rn(mine, __shfl_xor_sync(0xffffffffu, other, 2));
      }
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const float mine = r1 ? keep[1][o] : keep[0][o];
      const float other = r1 ? keep[0][o] : keep[1][o];
      mr[p][o] = __fadd_rn(__fadd_rn(mine, __shfl_xor_sync(0xffffffffu, other, 1)),
                           o ? bias.y : bias.x);
    }
  }
}

// Weight layer L >= 1 and the layers after it: `in` holds the previous
// layer's activations in C fragments (kGroups x 2 tiles x blocks of 8
// columns); `mr` gets each owner's (mean, raw).  A hidden->hidden layer
// runs on the tensor cores, ReLU on its accumulators.
template <int L>
__device__ __forceinline__ void forward(
    const float (&in)[kGroups][2][kWidths[L] / 8][4],
    const float* __restrict__ wts, int lane, float (&mr)[kGroups][2]) {
  if constexpr (L == kLayers - 1) {
    output_fma<kWidths[L]>(in, wts + offset(L), lane, mr);
  } else {
    constexpr int KB = kWidths[L] / 8, NB = kWidths[L + 1] / 8;
    constexpr int kOffset = offset(L), kCols = kWidths[L + 1];
    const float* wl = wts + kOffset;
    const float4* frag = reinterpret_cast<const float4*>(wl + kCols);
    const int t = lane & 3;
    // the bias of columns (2t, 2t + 1), rows g and g + 8: the first
    // product's C operand
    float bias[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(wl + 8 * nb + 2 * t));
      bias[nb][0] = b.x;
      bias[nb][1] = b.y;
      bias[nb][2] = b.x;
      bias[nb][3] = b.y;
    }
    float acc[kGroups][2][NB][4];
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      // C -> A: (row g, col 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1)
      uint32_t hi[kGroups][2][4], lo[kGroups][2][4];
#pragma unroll
      for (int p = 0; p < kGroups; ++p)
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          split(in[p][s][kb][0], hi[p][s][0], lo[p][s][0]);
          split(in[p][s][kb][2], hi[p][s][1], lo[p][s][1]);
          split(in[p][s][kb][1], hi[p][s][2], lo[p][s][2]);
          split(in[p][s][kb][3], hi[p][s][3], lo[p][s][3]);
        }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float4 b = __ldg(frag + (kb * NB + nb) * 32 + lane);
        const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
        const uint32_t bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
#pragma unroll
        for (int p = 0; p < kGroups; ++p)
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            if (kb == 0) {
              mma_tf32(acc[p][s][nb], lo[p][s], bh0, bh1, bias[nb]);
            } else {
              mma_tf32(acc[p][s][nb], lo[p][s], bh0, bh1, acc[p][s][nb]);
            }
            mma_tf32(acc[p][s][nb], hi[p][s], bl0, bl1, acc[p][s][nb]);
            mma_tf32(acc[p][s][nb], hi[p][s], bh0, bh1, acc[p][s][nb]);
          }
      }
    }
#pragma unroll
    for (int p = 0; p < kGroups; ++p)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[p][s][nb][i] = fmaxf(acc[p][s][nb][i], 0.f);
    forward<L + 1>(acc, wts, lane, mr);
  }
}

// The wide layout's first two weight layers: the first layer's units of
// block kb are formed on the FMA pipe in the A fragment's positions just
// before the tensor cores take them (c of each unit as the narrow layout
// forms it, once a step), so that no layer of first-layer activations is
// ever held; the hidden->hidden products, their order and ReLU are those of
// forward<1>.  xq: each group's quad of particles, [tile][row g, g + 8].
// L = 1, the first hidden->hidden weight layer; a net without one (a
// [3, H, 2] head) never gets here, and the guard keeps it from compiling
// the body.
template <int L>
__device__ __forceinline__ void forward_wide(const float (&xq)[kGroups][2][2],
                                             float y, float tf,
                                             const float* __restrict__ wts,
                                             int lane, float (&mr)[kGroups][2]) {
  if constexpr (L < kLayers - 1) {
    constexpr int KB = kWidths[L] / 8, NB = kWidths[L + 1] / 8;
    constexpr int kOffset = offset(L), kCols = kWidths[L + 1];
    const float* wl = wts + kOffset;
    const float4* frag = reinterpret_cast<const float4*>(wl + kCols);
    const int t = lane & 3;
    float bias[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(wl + 8 * nb + 2 * t));
      bias[nb][0] = b.x;
      bias[nb][1] = b.y;
      bias[nb][2] = b.x;
      bias[nb][3] = b.y;
    }
    float acc[kGroups][2][NB][4];
#pragma unroll
    for (int kb = 0; kb < KB; ++kb) {
      // units 8 kb + 2t + j of the first layer, rows g and g + 8, in C
      // positions (row r, column j) -> 2r + j
      float a[kGroups][2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 w1 = __ldg(reinterpret_cast<const float4*>(wts) + 8 * kb + 2 * t + j);
        const float c = __fadd_rn(__fadd_rn(__fmul_rn(w1.y, y), __fmul_rn(w1.z, tf)), w1.w);
#pragma unroll
        for (int p = 0; p < kGroups; ++p)
#pragma unroll
          for (int tile = 0; tile < 2; ++tile)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              a[p][tile][2 * r + j] = fmaxf(__fmaf_rn(xq[p][tile][r], w1.x, c), 0.f);
      }
      // C -> A: (row g, col 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1)
      uint32_t hi[kGroups][2][4], lo[kGroups][2][4];
#pragma unroll
      for (int p = 0; p < kGroups; ++p)
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          split(a[p][s][0], hi[p][s][0], lo[p][s][0]);
          split(a[p][s][2], hi[p][s][1], lo[p][s][1]);
          split(a[p][s][1], hi[p][s][2], lo[p][s][2]);
          split(a[p][s][3], hi[p][s][3], lo[p][s][3]);
        }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float4 b = __ldg(frag + (kb * NB + nb) * 32 + lane);
        const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
        const uint32_t bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
#pragma unroll
        for (int p = 0; p < kGroups; ++p)
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            if (kb == 0) {
              mma_tf32(acc[p][s][nb], lo[p][s], bh0, bh1, bias[nb]);
            } else {
              mma_tf32(acc[p][s][nb], lo[p][s], bh0, bh1, acc[p][s][nb]);
            }
            mma_tf32(acc[p][s][nb], hi[p][s], bl0, bl1, acc[p][s][nb]);
            mma_tf32(acc[p][s][nb], hi[p][s], bh0, bh1, acc[p][s][nb]);
          }
      }
    }
#pragma unroll
    for (int p = 0; p < kGroups; ++p)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[p][s][nb][i] = fmaxf(acc[p][s][nb][i], 0.f);
    forward<L + 1>(acc, wts, lane, mr);
  }
}

// nv: int32 [n_valid] (steps at and after it leave the particle as it is);
// T: the model's horizon (the net's time feature is t / T).
__global__ void __launch_bounds__(kThreads)
guided_tc_kernel(const float* __restrict__ ys, int n_steps,
                 const int* __restrict__ nv,
                 const uint32_t* __restrict__ key_dev, uint32_t t0, float T,
                 const float* __restrict__ wts, const float* __restrict__ x_in,
                 const float* __restrict__ w_in, float* __restrict__ x_out,
                 float* __restrict__ w_out, float* __restrict__ rec,
                 long long n) {
  constexpr int KB1 = kWidths[1] / 8;
  __shared__ float red[kThreads / 32 * 2];
  __shared__ float bcast[2];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & 3, quad = lane & ~3;
  // the particle this thread owns in each group: tile t / 2, row g + 8 (t % 2)
  const long long base = (long long)blockIdx.x * kBlock +
                         (long long)warp * 32 * kGroups + 16 * (t >> 1) +
                         (lane >> 2) + 8 * (t & 1);
  const int n_valid = min(*nv, n_steps);
  // the Philox key, read at each draw: at 255 registers the wide layout
  // has none to hold it across the net (held, it spills 16 B)
  __shared__ uint2 key_s;
  const LaunchKey<true> key(&key_s, key_dev);

  float x[kGroups], w[kGroups], sn[kGroups];
#pragma unroll
  for (int p = 0; p < kGroups; ++p) {
    const long long i = base + 32 * p;
    x[p] = i < n ? x_in[i] : 0.f;
    w[p] = i < n ? w_in[i] : -INFINITY;
    sn[p] = 0.f;
  }
  // this lane's first-layer units 8 kb + 2t + j: (w_x, w_y, w_t, b); the
  // fused first layer (kFusedFirst) reads them at each use instead
  float4 w1[KB1][2];
#pragma unroll
  for (int kb = 0; kb < KB1; ++kb)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      w1[kb][j] = __ldg(reinterpret_cast<const float4*>(wts) + 8 * kb + 2 * t + j);

  for (int s = 0; s < n_valid; ++s) {
    const uint32_t ta = t0 + (uint32_t)s;
    const bool even = (ta & 1u) == 0u;
    const float y = __ldg(ys + s);
    const float tt = (float)ta;
    const float tf = __fdiv_rn(tt, T);
    float mr[kGroups][2];
    if constexpr (kFusedFirst) {
      float xq[kGroups][2][2];  // the quads' particles: [tile][row g, g + 8]
#pragma unroll
      for (int p = 0; p < kGroups; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          xq[p][q >> 1][q & 1] = __shfl_sync(0xffffffffu, x[p], quad | q);
      forward_wide<1>(xq, y, tf, wts, lane, mr);
    } else {
      float c[KB1][2];
#pragma unroll
      for (int kb = 0; kb < KB1; ++kb)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          c[kb][j] = __fadd_rn(__fadd_rn(__fmul_rn(w1[kb][j].y, y),
                                         __fmul_rn(w1[kb][j].z, tf)),
                               w1[kb][j].w);

      float h[kGroups][2][KB1][4];
#pragma unroll
      for (int p = 0; p < kGroups; ++p) {
        float xq[2][2];  // the quad's particles: [tile][row g, row g + 8]
#pragma unroll
        for (int q = 0; q < 4; ++q)
          xq[q >> 1][q & 1] = __shfl_sync(0xffffffffu, x[p], quad | q);
#pragma unroll
        for (int tile = 0; tile < 2; ++tile)
#pragma unroll
          for (int kb = 0; kb < KB1; ++kb)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int r = 0; r < 2; ++r)
                h[p][tile][kb][2 * r + j] =
                    fmaxf(__fmaf_rn(xq[tile][r], w1[kb][j].x, c[kb][j]), 0.f);
      }
      forward<1>(h, wts, lane, mr);
    }

#pragma unroll
    for (int p = 0; p < kGroups; ++p) {
      float eps;
      if (even || s == 0) {
        const float2 pr = philox_normal_pair((uint32_t)(base + 32 * p), ta >> 1, 0u, key());
        sn[p] = pr.y;
        eps = even ? pr.x : pr.y;
      } else {
        eps = sn[p];
      }
      const float mean = mr[p][0], raw = mr[p][1];
      const float sd = __fadd_rn(
          __fadd_rn(fmaxf(raw, 0.f), log1pf(expf(-fabsf(raw)))), 1e-6f);
      const float nx = __fadd_rn(mean, __fmul_rn(sd, eps));
      const float log_q = __fsub_rn(
          __fsub_rn(__fmul_rn(__fmul_rn(-0.5f, eps), eps), logf(sd)), kHalfLog2Pi);
      const float dlw = __fsub_rn(
          __fadd_rn(trans_logpdf_elem(x[p], nx, tt), obs_logpdf_elem(nx, y, tt)),
          log_q);
      x[p] = nx;
      w[p] = __fadd_rn(w[p], dlw);
    }
  }

  float m = -INFINITY;
#pragma unroll
  for (int p = 0; p < kGroups; ++p) {
    const long long i = base + 32 * p;
    if (i < n) {
      x_out[i] = x[p];
      w_out[i] = w[p];
      m = fmaxf(m, w[p]);
    }
  }
  m = block_max<kThreads>(m, red, bcast);
  float v[2] = {0.f, 0.f};
#pragma unroll
  for (int p = 0; p < kGroups; ++p) {
    if (base + 32 * p < n) {
      const float e = expf(w[p] - m);
      v[0] += e;
      v[1] += e * e;
    }
  }
  block_sum<kThreads, 2>(v, red, bcast);
  if (threadIdx.x == 0) {
    float* r = rec + (long long)blockIdx.x * 3;
    r[0] = m;
    r[1] = v[0];
    r[2] = v[1];
  }
}

}  // namespace guided_tc

extern "C" {

int guided_tc_block() { return guided_tc::kBlock; }
int guided_tc_weights() { return guided_tc::offset(guided_tc_model::kLayers); }

// Returns cudaGetLastError() after the launch (0 = launched).  key: the
// Philox key's two words on the device (philox.cuh LaunchKey).
int guided_tc_launch(const float* ys, int n_steps, const int* nv,
                     const uint32_t* key, uint32_t t0, float T,
                     const float* wts, const float* x_in, const float* w_in,
                     float* x_out, float* w_out, float* rec, long long n,
                     void* stream) {
  const int grid = (int)((n + guided_tc::kBlock - 1) / guided_tc::kBlock);
  guided_tc::guided_tc_kernel<<<grid, guided_tc::kThreads, 0,
                                (cudaStream_t)stream>>>(
      ys, n_steps, nv, key, t0, T, wts, x_in, w_in, x_out, w_out, rec, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
