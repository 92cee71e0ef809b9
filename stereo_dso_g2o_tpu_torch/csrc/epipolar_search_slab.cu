// Epipolar search + Gauss-Newton refinement for immature points, with each
// lane's image window staged in shared memory (sm_90a).
//
// Replaces the TPU kernel stereo_dso_g2o_tpu/ops/trace_pallas.py::
// epipolar_search, slab body `_make_kernel` (trace_pallas.py:194-446,
// reached through the pallas_call at :728): the body the JAX package takes
// when the padded image exceeds 6 MB. It computes the function of
// epipolar_search.cu (same operands, same (N, 8) output lanes, same edge
// rules) and differs from it as the slab body differs from the resident
// one: it reads the intensity plane only, copies each lane's window of it
// into fast memory once, and takes the Gauss-Newton gradients by central
// differences of that window instead of reading gradient channels. The
// TPU's 64x256 slab with (8, 128) alignment, its padded image, its slab
// origins, its tent-weight matmuls and its bf16 split dots do not come
// across: the window here is the lane's own bounding box, sized from S.
//
// What bounds it on the H100: not bytes (the (H, W) plane is read once,
// 8.4 MB at 2048x1024, ~3 us at 3.35 TB/s) and not flops, but latency: a
// lane makes S*8*4 dependent-free taps and then <= gn_iters sequential GN
// steps of 8*12 taps. The design answers with one thread block per lane:
// 128 threads copy the window from global to dynamic shared memory row by
// row (coalesced, each pixel once), then stride over (step, pattern pixel)
// pairs, so every tap of the search and of GN is a shared-memory read and
// the image leaves L2/HBM once per lane, a third of the bytes the
// three-channel kernel gathers. The per-pixel energies stay in shared
// memory (S*8 floats), per-step sums are taken in pattern order, the
// argmin and second best are warp shuffles on (energy, index) in warp 0,
// and GN runs on 8 threads of warp 0 as in epipolar_search.cu. A tap that
// falls outside the staged window (a lane whose box exceeds the launch's
// window size, or float rounding at its rim) reads global memory instead,
// so the answer never depends on the box. Nothing is allocated and the
// launch does not synchronize.
//
// Sampling rules, identical to epipolar_search.cu:
//   edge == 0: coordinates clamped to [0, size - 1.001];
//   edge == 1: integer columns floor(ptx) + s*dx + pattern_x, rows
//     floor(pty) + pattern_y, zeros outside the image, vertical lerp then
//     horizontal lerp (needs dx = +-1, dy = 0);
//   Gauss-Newton: clamped bilinear sample of (I, dI/dx, dI/dy) with
//     dI/dx(x, y) = 0.5 * (I(x+1, y) - I(x-1, y)), zero on the image's
//     first and last column (rows likewise): the pyramid's rule, so the
//     values equal the gradient channels the other kernel reads.
// Compile with -fmad=false so products and sums round as in PyTorch/XLA.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

struct Window {
  const float* img;  // (H, W) plane in global memory
  const float* win;  // staged rows [y0, y0+h) x cols [x0, x0+w), pitch w
  int H, W, y0, x0, h, w;
};

__device__ __forceinline__ float finite_or_zero(float x) {
  return isfinite(x) ? x : 0.f;
}

__device__ __forceinline__ float huber_w(float r, float th) {
  float ar = fabsf(r);
  return ar < th ? 1.f : th / fmaxf(ar, 1e-12f);
}

// Pixel (r, c), inside the image: from the window, else from global memory.
__device__ __forceinline__ float pix(const Window& g, int r, int c) {
  const unsigned wr = (unsigned)(r - g.y0), wc = (unsigned)(c - g.x0);
  return (wr < (unsigned)g.h && wc < (unsigned)g.w)
             ? g.win[wr * (unsigned)g.w + wc]
             : __ldg(g.img + (size_t)r * g.W + c);
}

__device__ __forceinline__ float pix_zero(const Window& g, int r, int c) {
  return ((unsigned)r < (unsigned)g.H && (unsigned)c < (unsigned)g.W)
             ? pix(g, r, c)
             : 0.f;
}

__device__ __forceinline__ float grad_x(const Window& g, int r, int c) {
  return (c >= 1 && c <= g.W - 2) ? 0.5f * (pix(g, r, c + 1) - pix(g, r, c - 1))
                                  : 0.f;
}

__device__ __forceinline__ float grad_y(const Window& g, int r, int c) {
  return (r >= 1 && r <= g.H - 2) ? 0.5f * (pix(g, r + 1, c) - pix(g, r - 1, c))
                                  : 0.f;
}

// _pattern_energy's bilinear sample of the intensity, clamped coordinates.
__device__ __forceinline__ float sample_clamped(const Window& g, float xmax,
                                                float ymax, float px, float py) {
  float x = fminf(fmaxf(px, 0.f), xmax);
  float y = fminf(fmaxf(py, 0.f), ymax);
  float xf = floorf(x), yf = floorf(y);
  int ix = (int)xf, iy = (int)yf;
  float fx = x - xf, fy = y - yf;
  float v = (1.f - fx) * (1.f - fy) * pix(g, iy, ix);
  v = v + fx * (1.f - fy) * pix(g, iy, ix + 1);
  v = v + (1.f - fx) * fy * pix(g, iy + 1, ix);
  v = v + fx * fy * pix(g, iy + 1, ix + 1);
  return v;
}

// interp.bilinear of (I, dI/dx, dI/dy), the gradients differenced here.
__device__ __forceinline__ void sample3(const Window& g, float xmax, float ymax,
                                        float px, float py, float out[3]) {
  float x = fminf(fmaxf(px, 0.f), xmax);
  float y = fminf(fmaxf(py, 0.f), ymax);
  float xf = floorf(x), yf = floorf(y);
  int ix = (int)xf, iy = (int)yf;
  float dx = x - xf, dy = y - yf;
  float dxdy = dx * dy;
  float w11 = dxdy, w10 = dy - dxdy, w01 = dx - dxdy;
  float w00 = 1.f - dx - dy + dxdy;
  float v = w11 * pix(g, iy + 1, ix + 1);
  v = v + w10 * pix(g, iy + 1, ix);
  v = v + w01 * pix(g, iy, ix + 1);
  v = v + w00 * pix(g, iy, ix);
  out[0] = v;
  v = w11 * grad_x(g, iy + 1, ix + 1);
  v = v + w10 * grad_x(g, iy + 1, ix);
  v = v + w01 * grad_x(g, iy, ix + 1);
  v = v + w00 * grad_x(g, iy, ix);
  out[1] = v;
  v = w11 * grad_y(g, iy + 1, ix + 1);
  v = v + w10 * grad_y(g, iy + 1, ix);
  v = v + w01 * grad_y(g, iy, ix + 1);
  v = v + w00 * grad_y(g, iy, ix);
  out[2] = v;
}

// One block per lane. Dynamic shared memory: the window (cap_rows *
// cap_cols floats), the per-(step, pixel) energies (S * 8), the per-step
// energies (S).
__global__ void __launch_bounds__(kThreads)
epipolar_search_slab_kernel(const float* __restrict__ img,
                            const float* __restrict__ scal,
                            const float* __restrict__ color,
                            const float* __restrict__ weights,
                            const float* __restrict__ patx,
                            const float* __restrict__ paty,
                            float* __restrict__ out, int H, int W, int S,
                            float huber_th, int gn_iters, float gn_threshold,
                            int radius, int edge, int cap_rows, int cap_cols) {
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  extern __shared__ float smem[];
  __shared__ float s_pcx[8], s_pcy[8], s_ref[8];
  float* win = smem;
  float* e_pix = smem + cap_rows * cap_cols;
  float* e_step = e_pix + S * 8;

  const float* sc = scal + (size_t)i * 8;
  const float ptx = finite_or_zero(sc[0]);
  const float pty = finite_or_zero(sc[1]);
  const float dx = finite_or_zero(sc[2]);
  const float dy = finite_or_zero(sc[3]);
  const float nsteps = sc[4];
  const float aff_a = sc[5];
  const float aff_b = sc[6];
  const float xmax = (float)(W - 1.001);
  const float ymax = (float)(H - 1.001);

  // steps s with (float)s < nsteps, s < S
  int n_valid = 0;
  if (nsteps > 0.f) n_valid = (int)ceilf(fminf(nsteps, (float)S));

  // pattern extent (every thread reads the same 16 floats: one broadcast)
  float pminx = INFINITY, pmaxx = -INFINITY, pminy = INFINITY, pmaxy = -INFINITY;
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const float px = patx[(size_t)i * 8 + p], py = paty[(size_t)i * 8 + p];
    pminx = fminf(pminx, px);
    pmaxx = fmaxf(pmaxx, px);
    pminy = fminf(pminy, py);
    pmaxy = fmaxf(pmaxy, py);
  }
  if (tid < 8) {
    s_pcx[tid] = patx[(size_t)i * 8 + tid];
    s_pcy[tid] = paty[(size_t)i * 8 + tid];
    s_ref[tid] = aff_a * color[(size_t)i * 8 + tid] + aff_b;
  }

  // ---- the lane's window: the segment over the valid steps and the GN
  // travel (<= 0.5 step per iteration), the pattern's extent, +1 px of
  // bilinear support, +1 px for the gradient taps, +1 px against rounding;
  // clipped to the image and to the launch's window size ----
  Window g;
  g.img = img;
  g.win = win;
  g.H = H;
  g.W = W;
  g.y0 = g.x0 = g.h = g.w = 0;
  if (n_valid > 0 && isfinite(pminx) && isfinite(pmaxx) && isfinite(pminy) &&
      isfinite(pmaxy)) {
    const float half = 0.5f * (float)gn_iters;
    const float s_lo = -half, s_hi = (float)(n_valid - 1) + half;
    const float xa = ptx + s_lo * dx, xb = ptx + s_hi * dx;
    const float ya = pty + s_lo * dy, yb = pty + s_hi * dy;
    const float xlo = fminf(fmaxf(fminf(xa, xb) + pminx, 0.f), (float)(W - 1));
    const float xhi = fminf(fmaxf(fmaxf(xa, xb) + pmaxx, 0.f), (float)(W - 1));
    const float ylo = fminf(fmaxf(fminf(ya, yb) + pminy, 0.f), (float)(H - 1));
    const float yhi = fminf(fmaxf(fmaxf(ya, yb) + pmaxy, 0.f), (float)(H - 1));
    g.x0 = max((int)floorf(xlo) - 2, 0);
    g.y0 = max((int)floorf(ylo) - 2, 0);
    g.w = min(min((int)floorf(xhi) + 3, W - 1) - g.x0 + 1, cap_cols);
    g.h = min(min((int)floorf(yhi) + 3, H - 1) - g.y0 + 1, cap_rows);
  }
  const int n_win = g.h * g.w;
  for (int k = tid; k < n_win; k += kThreads) {
    const int r = k / g.w, c = k - r * g.w;
    win[k] = __ldg(img + (size_t)(g.y0 + r) * W + g.x0 + c);
  }
  for (int s = tid; s < S; s += kThreads) e_step[s] = INFINITY;
  __syncthreads();

  // zero-edge (stereo) integer anchors, clamped far enough out that every
  // tap of a clamped lane still lands outside the image
  const float lim = (float)(S + 16);
  const float xc = fminf(fmaxf(ptx, -lim), (float)W + lim);
  const float yc = fminf(fmaxf(pty, -8.f), (float)H + 8.f);
  const float xcf = floorf(xc), ycf = floorf(yc);
  const int ix0 = (int)xcf, iy0 = (int)ycf;
  const float fu = xc - xcf, fv = yc - ycf;
  const int dirx = (int)rintf(dx);

  // ---- discrete search: threads stride over (step, pattern pixel) ----
  for (int k = tid; k < n_valid * 8; k += kThreads) {
    const int s = k >> 3, p = k & 7;
    float val;
    if (edge == 0) {
      const float sf = (float)s;
      const float sx = ptx + sf * dx;
      const float sy = pty + sf * dy;
      val = sample_clamped(g, xmax, ymax, sx + s_pcx[p], sy + s_pcy[p]);
    } else {
      const int c = ix0 + s * dirx + (int)rintf(s_pcx[p]);
      const int r0 = iy0 + (int)rintf(s_pcy[p]);
      float row0 = (1.f - fv) * pix_zero(g, r0, c) + fv * pix_zero(g, r0 + 1, c);
      float row1 = (1.f - fv) * pix_zero(g, r0, c + 1) + fv * pix_zero(g, r0 + 1, c + 1);
      val = (1.f - fu) * row0 + fu * row1;
    }
    const float r = val - s_ref[p];
    const float hw = huber_w(r, huber_th);
    e_pix[k] = hw * r * r * (2.f - hw);
  }
  __syncthreads();
  for (int s = tid; s < n_valid; s += kThreads) {
    float e = 0.f;
#pragma unroll
    for (int p = 0; p < 8; ++p) e = e + e_pix[s * 8 + p];  // pattern order
    e_step[s] = e;
  }
  __syncthreads();
  if (tid >= 32) return;  // warp 0 finishes the lane; no block sync follows

  // ---- argmin, lowest step wins ties (all-masked lanes give step 0) ----
  const int lane = tid;
  float best = INFINITY;
  int bidx = S;
  for (int s = lane; s < S; s += 32) {
    const float e = e_step[s];
    if (e < best || (e == best && s < bidx)) {
      best = e;
      bidx = s;
    }
  }
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
  for (int s = lane; s < S; s += 32)
    if (abs(s - bidx) > radius) second = fminf(second, e_step[s]);
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
    const float pcx = s_pcx[p], pcy = s_pcy[p], ref = s_ref[p];
    float ubak = bu, vbak = bv, step_back = 0.f, be = 1e5f;
    bool done = false;
    for (int it = 0; it < gn_iters; ++it) {
      float hit[3];
      sample3(g, xmax, ymax, bu + pcx, bv + pcy, hit);
      float r = hit[0] - ref;
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

// `img` is the (H, W) intensity plane; `rows` x `cols` is the per-lane
// window the launch reserves and `smem_bytes` the dynamic shared memory of
// one block: 4 * (rows * cols + 9 * S).
extern "C" int sdso_epipolar_search_slab(const float* img, const float* scal,
                                         const float* color, const float* weights,
                                         const float* patx, const float* paty,
                                         float* out, int H, int W, int N, int S,
                                         float huber_th, int gn_iters,
                                         float gn_threshold, int radius, int edge,
                                         int rows, int cols, int smem_bytes,
                                         cudaStream_t stream) {
  if (N <= 0) return 0;
  if (smem_bytes < 4 * (rows * cols + 9 * S)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      epipolar_search_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  epipolar_search_slab_kernel<<<N, kThreads, smem_bytes, stream>>>(
      img, scal, color, weights, patx, paty, out, H, W, S, huber_th, gn_iters,
      gn_threshold, radius, edge, rows, cols);
  return (int)cudaGetLastError();
}
