// The epipolar search that both kernels run (epipolar_search.cu and
// epipolar_search_slab.cu include this file): one warp per lane, the
// discrete search over the lane's valid steps, the argmin with its second
// best, and the Gauss-Newton refinement. A kernel supplies a `Tap`: where
// the 2x2 pixels of a bilinear sample come from (`quad` for pixels inside
// the image, `quad_zero` for the stereo rule of zeros outside it) and how
// Gauss-Newton samples (I, dI/dx, dI/dy) (`sample3`). Everything that rounds
// lives here, once, so the two kernels give the same bits on the same lane.
// A Tap's loads carry no branch, so that the compiler can start the taps of
// several steps before it needs the first.
//
// Layout of a warp's work. A work item is a (step, pattern pixel) pair;
// item k belongs to thread k % 32, so a thread always holds pattern pixel
// p = thread & 7 (its pattern offset and reference colour stay in
// registers) and the steps 4*j + (thread >> 3). Only steps s with
// (float)s < num_steps are sampled: n_valid = ceil(min(num_steps, S)), 0
// for a NaN or non-positive num_steps. Four rounds (16 steps, 16 taps per
// thread) are started before their energies are summed, so a warp keeps
// ~500 independent loads in flight (a thread past the last valid step
// samples that step again, so no branch splits the loads). A step's energy is the sum of its 8
// pixel energies in pattern order, taken by ordered shuffles inside the
// 8-thread group that holds them, and written to the warp's `e_step` row
// in shared memory; the argmin and the second best then read that row.
// A lane with no valid step skips all of it.
//
// NaN follows the plain PyTorch version: clamps pass NaN on, a NaN energy
// wins the argmin (lowest such step) and makes the second best NaN.
// Compile with -fmad=false so products and sums round as in PyTorch/XLA.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace sdso {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRounds = 4;  // rounds of 4 steps started before their sums

__device__ __forceinline__ float finite_or_zero(float x) {
  return isfinite(x) ? x : 0.f;
}

// torch.clamp: NaN stays NaN
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float huber_w(float r, float th) {
  float ar = fabsf(r);
  return ar < th ? 1.f : th / fmaxf(ar, 1e-12f);
}

__device__ __forceinline__ float huber_energy(float r, float th) {
  float hw = huber_w(r, th);
  return hw * r * r * (2.f - hw);
}

// torch.min's order on (energy, step): NaN before everything, then the
// lower energy, then the lower step.
__device__ __forceinline__ bool wins(float ea, int ia, float eb, int ib) {
  const bool na = isnan(ea), nb = isnan(eb);
  if (na != nb) return na;
  if (na) return ia < ib;
  return ea < eb || (ea == eb && ia < ib);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}

// What one thread of the warp knows of its lane.
struct Lane {
  float ptx, pty, dx, dy;  // non-finite read as 0
  float aff_a, aff_b;
  int n_valid;             // steps s < S with (float)s < num_steps
  float pcx, pcy, ref;     // pattern pixel p = thread & 7
};

// `patx` / `paty` are (N, 8) views with element strides (ps0, ps1): a
// rotated pattern sliced out of (N, 8, 2), or one pattern broadcast to all
// lanes (ps0 == 0), is read in place.
__device__ __forceinline__ Lane load_lane(const float* __restrict__ scal,
                                          const float* __restrict__ color,
                                          const float* __restrict__ patx,
                                          const float* __restrict__ paty,
                                          long long ps0, long long ps1, int i,
                                          int S) {
  Lane L;
  const float* sc = scal + (size_t)i * 8;
  L.ptx = finite_or_zero(sc[0]);
  L.pty = finite_or_zero(sc[1]);
  L.dx = finite_or_zero(sc[2]);
  L.dy = finite_or_zero(sc[3]);
  const float nsteps = sc[4];
  L.aff_a = sc[5];
  L.aff_b = sc[6];
  L.n_valid = 0;
  if (nsteps > 0.f) L.n_valid = (int)ceilf(fminf(nsteps, (float)S));
  const int p = threadIdx.x & 7;
  L.pcx = patx[(long long)i * ps0 + p * ps1];
  L.pcy = paty[(long long)i * ps0 + p * ps1];
  L.ref = L.aff_a * color[(size_t)i * 8 + p] + L.aff_b;
  return L;
}

// _pattern_energy's bilinear sample of the intensity, clamped coordinates.
template <class Tap>
__device__ __forceinline__ float sample_clamped(const Tap& g, float xmax,
                                                float ymax, float px, float py) {
  float x = clampf(px, 0.f, xmax);
  float y = clampf(py, 0.f, ymax);
  float xf = floorf(x), yf = floorf(y);
  int ix = (int)xf, iy = (int)yf;  // NaN -> 0, the value stays NaN
  float fx = x - xf, fy = y - yf;
  float i00, i01, i10, i11;
  g.quad(iy, ix, i00, i01, i10, i11);
  float v = (1.f - fx) * (1.f - fy) * i00;
  v = v + fx * (1.f - fy) * i01;
  v = v + (1.f - fx) * fy * i10;
  v = v + fx * fy * i11;
  return v;
}

// The discrete search of one lane: the energies of steps 0 .. n_valid-1
// into `e_step`. kEdge: 0 clamped coordinates, 1 zeros outside the image.
// A thread whose step lies past the last valid one samples that last one
// again and drops the result: no branch stands between the loads.
template <int kEdge, class Tap>
__device__ __forceinline__ void search_steps(const Tap& g, const Lane& L,
                                             float* e_step, int H, int W, int S,
                                             float huber_th) {
  const int lane = threadIdx.x & 31;
  const int sub = lane >> 3;   // which of the round's 4 steps
  const int grp = lane & ~7;   // first thread of this step's 8
  const float xmax = (float)(W - 1.001);
  const float ymax = (float)(H - 1.001);
  // zero-edge (stereo) integer anchors, clamped far enough out that every
  // tap of a clamped lane still lands outside the image
  const float lim = (float)(S + 16);
  const float xc = fminf(fmaxf(L.ptx, -lim), (float)W + lim);
  const float yc = fminf(fmaxf(L.pty, -8.f), (float)H + 8.f);
  const float xcf = floorf(xc), ycf = floorf(yc);
  const int ix0 = (int)xcf, iy0 = (int)ycf;
  const float fu = xc - xcf, fv = yc - ycf;
  const int dirx = (int)rintf(L.dx);
  const int pxi = (int)rintf(L.pcx), pyi = (int)rintf(L.pcy);

  for (int base = 0; base < L.n_valid; base += 4 * kRounds) {
    float e[kRounds];
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const int s = min(base + 4 * u + sub, L.n_valid - 1);
      float val;
      if (kEdge == 0) {
        const float sf = (float)s;
        const float sx = L.ptx + sf * L.dx;
        const float sy = L.pty + sf * L.dy;
        val = sample_clamped(g, xmax, ymax, sx + L.pcx, sy + L.pcy);
      } else {
        const int c = ix0 + s * dirx + pxi;
        const int r0 = iy0 + pyi;
        float i00, i01, i10, i11;
        g.quad_zero(r0, c, i00, i01, i10, i11);
        float row0 = (1.f - fv) * i00 + fv * i10;
        float row1 = (1.f - fv) * i01 + fv * i11;
        val = (1.f - fu) * row0 + fu * row1;
      }
      e[u] = huber_energy(val - L.ref, huber_th);
    }
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q)  // pattern order
        sum = sum + __shfl_sync(kFull, e[u], grp + q);
      const int s = base + 4 * u + sub;
      if (lane == grp && s < L.n_valid) e_step[s] = sum;
    }
  }
}

// The whole search of one lane by one warp. `e_step`: this warp's S floats
// of shared memory. Writes out[0..7] from thread 0.
template <class Tap>
__device__ __forceinline__ void search_and_refine(
    const Tap& g, const Lane& L, const float* __restrict__ weights, int i,
    float* e_step, float* __restrict__ out, int H, int W, int S, float huber_th,
    int gn_iters, float gn_threshold, int radius, int edge) {
  const int lane = threadIdx.x & 31;
  const float xmax = (float)(W - 1.001);
  const float ymax = (float)(H - 1.001);

  float best = INFINITY, second = INFINITY;
  int bidx = 0;  // a lane with no valid step reports step 0

  if (L.n_valid > 0) {
    if (edge == 0)
      search_steps<0>(g, L, e_step, H, W, S, huber_th);
    else
      search_steps<1>(g, L, e_step, H, W, S, huber_th);
    __syncwarp();

    // ---- argmin (NaN first, then ties to the lowest step) ----
    bidx = S;
    for (int s = lane; s < S; s += 32) {
      const float e = s < L.n_valid ? e_step[s] : INFINITY;
      if (wins(e, s, best, bidx)) {
        best = e;
        bidx = s;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, off);
      const int oi = __shfl_xor_sync(kFull, bidx, off);
      if (wins(ob, oi, best, bidx)) {
        best = ob;
        bidx = oi;
      }
    }
    // second best more than `radius` steps from the winner
    for (int s = lane; s < L.n_valid; s += 32)
      if (abs(s - bidx) > radius) second = min_nan(second, e_step[s]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      second = min_nan(second, __shfl_xor_sync(kFull, second, off));
  }

  const float bidx_f = (float)bidx;
  float bu = L.ptx + bidx_f * L.dx;
  float bv = L.pty + bidx_f * L.dy;
  float e_gn = best;

  // ---- Gauss-Newton along the line: every thread samples its pattern
  // pixel (4 copies of each), the sums run over threads 0..7 in order ----
  if (gn_iters > 0) {
    const float wp = weights[(size_t)i * 8 + (lane & 7)];
    float ubak = bu, vbak = bv, step_back = 0.f, be = 1e5f;
    bool done = false;
    for (int it = 0; it < gn_iters; ++it) {
      float hit[3];
      g.sample3(xmax, ymax, bu + L.pcx, bv + L.pcy, hit);
      const float r = hit[0] - L.ref;
      const float d_res = L.dx * hit[1] + L.dy * hit[2];
      const float hw = huber_w(r, huber_th);
      const float hh = hw * d_res * d_res;
      const float bb = hw * r * d_res;
      const float ee = wp * wp * hw * r * r * (2.f - hw);
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
      const float u_worse = ubak + sb_worse * L.dx;
      const float v_worse = vbak + sb_worse * L.dy;
      float step = -bs / Hgn;
      step = isnan(step) ? 0.f : fminf(fmaxf(step, -0.5f), 0.5f);
      const float u_better = bu + step * L.dx;
      const float v_better = bv + step * L.dy;
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

}  // namespace sdso
