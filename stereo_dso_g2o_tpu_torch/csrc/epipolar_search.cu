// Epipolar search + Gauss-Newton refinement for immature points (sm_90a).
//
// Replaces the TPU kernel stereo_dso_g2o_tpu/ops/trace_pallas.py::
// epipolar_search, resident body `_make_kernel_resident` (trace_pallas.py
// :449-628, reached through the pallas_call at :695). It computes what that
// kernel computes, lane by lane: the 8-pixel pattern sampled bilinearly at
// pt + s*(dx, dy) for every step s < S, the Huber energy of I - (a*c + b),
// the masked argmin (ties to the lowest step), the second-best energy more
// than `radius` steps away, and <= gn_iters steps of 1-dof Gauss-Newton
// along the line. The TPU's tent-matrix matmul formulation, its slab
// padding and its bf16 split dots do not come across: each tap is read
// directly, in f32.
//
// What bounds it on the H100: gather latency from L2. A lane touches
// ~S*8*4 + gn_iters*8*12 scattered floats (about 1.8k at S = 46) and does
// a few flops per tap; the whole (H, W, 3) f32 level-0 stack is 5.1 MB at
// 1216x352 and stays resident in the 50 MB L2 across all lanes, so DRAM
// bandwidth is not the limit, the latency of dependent-free L2 gathers is.
// The design answers with memory-level parallelism: one warp per lane,
// the 32 threads each own up to 4 search steps and issue their 8x4 taps
// independently, so a warp keeps ~100 loads in flight; neighbouring steps
// of a lane touch neighbouring pixels, so a warp's taps fall on a few
// cache lines. The argmin and second-best are warp shuffles; the GN step
// spreads the 8 pattern samples over 8 threads and sums them in pattern
// order. Nothing is staged in shared memory, nothing is allocated, and the
// launch does not synchronize.
//
// Sampling rules (they follow the JAX "xla" backend):
//   edge == 0 (temporal search): coordinates clamped to [0, size - 1.001],
//     weights ((1-fx)(1-fy), fx(1-fy), (1-fx)fy, fx fy);
//   edge == 1 (static-stereo search): integer columns floor(ptx) + s*dx +
//     pattern_x, rows floor(pty) + pattern_y, zeros outside the image,
//     vertical lerp then horizontal lerp (needs dx = +-1, dy = 0);
//   Gauss-Newton: interp.bilinear (clamped) on all three channels.
// Compile with -fmad=false so products and sums round as in PyTorch/XLA.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kStepsPerThread = 4;  // S <= 128
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float finite_or_zero(float x) {
  return isfinite(x) ? x : 0.f;
}

__device__ __forceinline__ float huber_w(float r, float th) {
  float ar = fabsf(r);
  return ar < th ? 1.f : th / fmaxf(ar, 1e-12f);
}

// _pattern_energy's bilinear sample of channel 0, clamped coordinates.
__device__ __forceinline__ float sample_clamped(const float* __restrict__ dI,
                                                int H, int W, float xmax,
                                                float ymax, float px, float py) {
  float x = fminf(fmaxf(px, 0.f), xmax);
  float y = fminf(fmaxf(py, 0.f), ymax);
  float xf = floorf(x), yf = floorf(y);
  int ix = (int)xf, iy = (int)yf;
  float fx = x - xf, fy = y - yf;
  const float* p = dI + ((size_t)iy * W + ix) * 3;
  float i00 = __ldg(p), i01 = __ldg(p + 3);
  float i10 = __ldg(p + (size_t)W * 3), i11 = __ldg(p + (size_t)W * 3 + 3);
  float v = (1.f - fx) * (1.f - fy) * i00;
  v = v + fx * (1.f - fy) * i01;
  v = v + (1.f - fx) * fy * i10;
  v = v + fx * fy * i11;
  return v;
}

__device__ __forceinline__ float tap_zero(const float* __restrict__ dI, int H,
                                          int W, int r, int c) {
  return ((unsigned)r < (unsigned)H && (unsigned)c < (unsigned)W)
             ? __ldg(dI + ((size_t)r * W + c) * 3)
             : 0.f;
}

// interp.bilinear on channels (0, 1, 2).
__device__ __forceinline__ void sample3(const float* __restrict__ dI, int H,
                                        int W, float xmax, float ymax,
                                        float px, float py, float out[3]) {
  float x = fminf(fmaxf(px, 0.f), xmax);
  float y = fminf(fmaxf(py, 0.f), ymax);
  float xf = floorf(x), yf = floorf(y);
  int ix = (int)xf, iy = (int)yf;
  float dx = x - xf, dy = y - yf;
  float dxdy = dx * dy;
  float w11 = dxdy, w10 = dy - dxdy, w01 = dx - dxdy;
  float w00 = 1.f - dx - dy + dxdy;
  const float* p00 = dI + ((size_t)iy * W + ix) * 3;
  const float* p10 = p00 + (size_t)W * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = w11 * __ldg(p10 + 3 + c);
    v = v + w10 * __ldg(p10 + c);
    v = v + w01 * __ldg(p00 + 3 + c);
    v = v + w00 * __ldg(p00 + c);
    out[c] = v;
  }
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
epipolar_search_kernel(const float* __restrict__ dI,
                       const float* __restrict__ scal,
                       const float* __restrict__ color,
                       const float* __restrict__ weights,
                       const float* __restrict__ patx,
                       const float* __restrict__ paty,
                       float* __restrict__ out, int H, int W, int N, int S,
                       float huber_th, int gn_iters, float gn_threshold,
                       int radius, int edge) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= N) return;  // whole warps exit together

  const float* sc = scal + (size_t)i * 8;
  const float ptx = finite_or_zero(sc[0]);
  const float pty = finite_or_zero(sc[1]);
  const float dx = finite_or_zero(sc[2]);
  const float dy = finite_or_zero(sc[3]);
  const float nsteps = sc[4];
  const float aff_a = sc[5];
  const float aff_b = sc[6];
  float pcx[8], pcy[8], ref[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    pcx[p] = patx[(size_t)i * 8 + p];
    pcy[p] = paty[(size_t)i * 8 + p];
    ref[p] = aff_a * color[(size_t)i * 8 + p] + aff_b;
  }
  const float xmax = (float)(W - 1.001);
  const float ymax = (float)(H - 1.001);

  // zero-edge (stereo) integer anchors, clamped far enough out that every
  // tap of a clamped lane still lands outside the image
  const float lim = (float)(S + 16);
  const float xc = fminf(fmaxf(ptx, -lim), (float)W + lim);
  const float yc = fminf(fmaxf(pty, -8.f), (float)H + 8.f);
  const float xcf = floorf(xc), ycf = floorf(yc);
  const int ix0 = (int)xcf, iy0 = (int)ycf;
  const float fu = xc - xcf, fv = yc - ycf;
  const int dirx = (int)rintf(dx);

  // ---- discrete search: this thread's steps ----
  float e_m[kStepsPerThread];
  float best = INFINITY;
  int bidx = S;
#pragma unroll
  for (int k = 0; k < kStepsPerThread; ++k) {
    const int s = lane + 32 * k;
    e_m[k] = INFINITY;
    if (s >= S) continue;
    const float sf = (float)s;
    float e = 0.f;
    if (edge == 0) {
      const float sx = ptx + sf * dx;
      const float sy = pty + sf * dy;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        float hit = sample_clamped(dI, H, W, xmax, ymax, sx + pcx[p], sy + pcy[p]);
        float r = hit - ref[p];
        float hw = huber_w(r, huber_th);
        e = e + hw * r * r * (2.f - hw);
      }
    } else {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int c = ix0 + s * dirx + (int)rintf(pcx[p]);
        const int r0 = iy0 + (int)rintf(pcy[p]);
        float row0 = (1.f - fv) * tap_zero(dI, H, W, r0, c) + fv * tap_zero(dI, H, W, r0 + 1, c);
        float row1 = (1.f - fv) * tap_zero(dI, H, W, r0, c + 1) +
                     fv * tap_zero(dI, H, W, r0 + 1, c + 1);
        float val = (1.f - fu) * row0 + fu * row1;
        float r = val - ref[p];
        float hw = huber_w(r, huber_th);
        e = e + hw * r * r * (2.f - hw);
      }
    }
    if (sf < nsteps) e_m[k] = e;
    if (e_m[k] < best || (e_m[k] == best && s < bidx)) {
      best = e_m[k];
      bidx = s;
    }
  }
  // warp argmin, lowest step wins ties
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ob = __shfl_xor_sync(kFull, best, off);
    int oi = __shfl_xor_sync(kFull, bidx, off);
    if (ob < best || (ob == best && oi < bidx)) {
      best = ob;
      bidx = oi;
    }
  }
  // second best more than `radius` steps from the winner
  float second = INFINITY;
#pragma unroll
  for (int k = 0; k < kStepsPerThread; ++k) {
    const int s = lane + 32 * k;
    if (s < S && abs(s - bidx) > radius) second = fminf(second, e_m[k]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    second = fminf(second, __shfl_xor_sync(kFull, second, off));

  const float bidx_f = (float)bidx;
  float bu = ptx + bidx_f * dx;
  float bv = pty + bidx_f * dy;
  float e_gn = best;

  // ---- Gauss-Newton along the line: thread p < 8 samples pattern pixel p ----
  if (gn_iters > 0) {
    const int p = lane & 7;
    const float wp = weights[(size_t)i * 8 + p];
    float ubak = bu, vbak = bv, step_back = 0.f, be = 1e5f;
    bool done = false;
    for (int it = 0; it < gn_iters; ++it) {
      float hit[3];
      sample3(dI, H, W, xmax, ymax, bu + pcx[p], bv + pcy[p], hit);
      float r = hit[0] - ref[p];
      float d_res = dx * hit[1] + dy * hit[2];
      float hw = huber_w(r, huber_th);
      float hh = hw * d_res * d_res;
      float bb = hw * r * d_res;
      float ee = wp * wp * hw * r * r * (2.f - hw);
      float hs = 0.f, bs = 0.f, es = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {  // pattern order, identical on all threads
        hs = hs + __shfl_sync(kFull, hh, q);
        bs = bs + __shfl_sync(kFull, bb, q);
        es = es + __shfl_sync(kFull, ee, q);
      }
      const float Hgn = 1.f + hs;
      const bool worse = es > be;
      const float sb_worse = step_back * 0.5f;
      const float u_worse = ubak + sb_worse * dx;
      const float v_worse = vbak + sb_worse * dy;
      float step = -bs / Hgn;
      step = isnan(step) ? 0.f : fminf(fmaxf(step, -0.5f), 0.5f);
      const float u_better = bu + step * dx;
      const float v_better = bv + step * dy;
      const float new_u = done ? bu : (worse ? u_worse : u_better);
      const float new_v = done ? bv : (worse ? v_worse : v_better);
      if (!(done || worse)) {
        ubak = bu;
        vbak = bv;
        be = es;
      }
      if (!done) step_back = worse ? sb_worse : step;
      done = done || (fabsf(step_back) < gn_threshold);
      bu = new_u;
      bv = new_v;
    }
    e_gn = be;
  }

  if (lane == 0) {
    float* o = out + (size_t)i * 8;
    o[0] = bu;
    o[1] = bv;
    o[2] = best;
    o[3] = second;
    o[4] = e_gn;
    o[5] = bidx_f;
    o[6] = 0.f;
    o[7] = 0.f;
  }
}

}  // namespace

extern "C" int sdso_epipolar_search(const float* dI, const float* scal,
                                    const float* color, const float* weights,
                                    const float* patx, const float* paty,
                                    float* out, int H, int W, int N, int S,
                                    float huber_th, int gn_iters,
                                    float gn_threshold, int radius, int edge,
                                    cudaStream_t stream) {
  if (N <= 0) return 0;
  const int blocks = (N + kWarpsPerBlock - 1) / kWarpsPerBlock;
  epipolar_search_kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      dI, scal, color, weights, patx, paty, out, H, W, N, S, huber_th,
      gn_iters, gn_threshold, radius, edge);
  return (int)cudaGetLastError();
}
