// Epipolar search + Gauss-Newton refinement for immature points, with each
// lane's band of the image staged in shared memory (sm_90a).
//
// Replaces the TPU kernel stereo_dso_g2o_tpu/ops/trace_pallas.py::
// epipolar_search, slab body `_make_kernel` (trace_pallas.py:194-446,
// reached through the pallas_call at :728): the body the JAX package takes
// when the padded image exceeds 6 MB. It computes the function of
// epipolar_search.cu (same operands, same (N, 8) output lanes, same edge
// rules; the search itself is the shared epipolar_common.cuh) and differs
// from it as the slab body differs from the resident one: it reads the
// intensity plane only, copies what the lane needs of it into fast memory
// once, and takes the Gauss-Newton gradients by central differences of
// that copy instead of reading gradient channels. The TPU's 64x256 slab
// with (8, 128) alignment, its padded image, its slab origins, its
// tent-weight matmuls and its bf16 split dots do not come across.
//
// What bounds it on the H100: not bytes (the (H, W) plane is read once,
// 8.4 MB at 2048x1024, ~3 us at 3.35 TB/s) and not flops, but instruction
// throughput: the image sits in L2 and a lane's taps hit L1, so a staged copy
// saves no time on the loads themselves; it pays only where it makes a tap
// cheaper to address than a global load, and it costs its copy. The design:
//   - a band, not a box. Along the line's major axis (x when |dx| >= |dy|,
//     else y) it spans the valid steps, the Gauss-Newton travel and the
//     pattern's extent; across, at each major coordinate j, up to
//     kBandCross = 16 pixels from floor(c0 + slope * j): the pattern's
//     cross extent plus bilinear, gradient and rounding margins. 16 x
//     (S + 20) floats, 6.9 KB at S = 86, where the bounding box of a
//     diagonal line took 44.7 KB: the copy shrinks with it;
//   - a warp per lane, the caller picks the lanes of a block
//     (ops/trace_cuda.py: 4; 8 measured 3-8 % slower), each
//     warp with its own band in dynamic shared memory: no block-wide
//     barrier, nobody idles while one warp runs its Gauss-Newton tail, 7
//     blocks an SM at S = 86;
//   - the copy is cp.async, 16 bytes where four neighbours along the
//     memory-contiguous direction share an image row and the address is
//     aligned (always on a horizontal stereo lane), 4 bytes elsewhere; the
//     warp waits once for its own copies. The other warps of the SM cover
//     that wait, so the copy is not split into groups;
//   - three kinds of lane, told apart once per warp. A lane whose band was
//     cut by nothing (not by the image, not by the launch's sizes; nearly
//     all real lanes) can touch no pixel outside it, so its taps carry no
//     test: FlatTap when the line is horizontal or vertical (the band is a
//     rectangle, a tap is one index: cheaper than the global load's own
//     address and bounds test, which is why the stereo lanes gain most),
//     SlopedTap otherwise (two base() evaluations per 2x2 sample). Every
//     other lane (at the image's border, longer than the launch's band, a
//     NaN pattern) takes BandTap: each tap picks band or global memory by
//     address and loads once, so the answer never depends on the band, and
//     no branch splits the loads.
// A TMA tile load with zero fill would serve the horizontal stereo lanes
// (a fixed 16 x (S + 20) tile); it needs a tensor map per plane made with
// cuTensorMapEncodeTiled and a 128-byte-aligned destination per warp. It was not
// built: measured against the same kernel with a band of 4 pixels, the
// whole cp.async copy of a stereo lane is already the smaller part of what
// the band saves, and on this card the image it copies from sits in L2.
// Nothing is allocated and the launch does not synchronize.
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

#include "epipolar_common.cuh"

namespace {

using namespace sdso;

constexpr int kMaxWarpsPerBlock = 4;
constexpr int kBandCross = 16;  // pixels staged across the line

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// interp.bilinear of (I, dI/dx, dI/dy), the gradients differenced here
// from the 12 pixels around the sample: rows iy, iy+1 at columns ix-1 ..
// ix+2, and rows iy-1, iy+2 at columns ix, ix+1. A gradient on the
// image's first or last column (row) is zero; its taps are then read at
// clamped positions and not used.
template <class Tap>
__device__ __forceinline__ void sample3_plane(const Tap& t, int H, int W, float xmax,
                                            float ymax, float px, float py,
                                            float out[3]) {
  float x = clampf(px, 0.f, xmax);
  float y = clampf(py, 0.f, ymax);
  float xf = floorf(x), yf = floorf(y);
  int ix = (int)xf, iy = (int)yf;
  float dx = x - xf, dy = y - yf;
  float dxdy = dx * dy;
  float w11 = dxdy, w10 = dy - dxdy, w01 = dx - dxdy;
  float w00 = 1.f - dx - dy + dxdy;
  const int xm = max(ix - 1, 0), xp = min(ix + 2, W - 1);
  const int ym = max(iy - 1, 0), yp = min(iy + 2, H - 1);
  float a[2][4], top[2], bot[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    a[rr][0] = t.pix(iy + rr, xm);
    a[rr][1] = t.pix(iy + rr, ix);
    a[rr][2] = t.pix(iy + rr, ix + 1);
    a[rr][3] = t.pix(iy + rr, xp);
    top[rr] = t.pix(ym, ix + rr);  // rr counts columns here
    bot[rr] = t.pix(yp, ix + rr);
  }
  float v = w11 * a[1][2];
  v = v + w10 * a[1][1];
  v = v + w01 * a[0][2];
  v = v + w00 * a[0][1];
  out[0] = v;
  const bool gx0 = ix >= 1 && ix <= W - 2, gx1 = ix + 1 <= W - 2;  // columns ix, ix+1
  const bool gy0 = iy >= 1 && iy <= H - 2, gy1 = iy + 1 <= H - 2;  // rows iy, iy+1
  v = w11 * (gx1 ? 0.5f * (a[1][3] - a[1][1]) : 0.f);
  v = v + w10 * (gx0 ? 0.5f * (a[1][2] - a[1][0]) : 0.f);
  v = v + w01 * (gx1 ? 0.5f * (a[0][3] - a[0][1]) : 0.f);
  v = v + w00 * (gx0 ? 0.5f * (a[0][2] - a[0][0]) : 0.f);
  out[1] = v;
  v = w11 * (gy1 ? 0.5f * (bot[1] - a[0][2]) : 0.f);
  v = v + w10 * (gy1 ? 0.5f * (bot[0] - a[0][1]) : 0.f);
  v = v + w01 * (gy0 ? 0.5f * (a[1][2] - top[1]) : 0.f);
  v = v + w00 * (gy0 ? 0.5f * (a[1][1] - top[0]) : 0.f);
  out[2] = v;
}

__device__ const float kZeroPixel = 0.f;  // what a stereo tap outside image and band reads

// A lane's band. Major index j = (major coordinate) - j0 in [0, len);
// cross index k = (cross coordinate) - base(j) in [0, cross), with
// base(j) = floor(c0 + slope * j), rounded down to a multiple of 4 on a
// y-major lane so that a staged row starts on a 16-byte boundary. Storage:
// band[j * sj + k * sk]; x-major (sj, sk) = (1, band_len), an image row
// contiguous along j; y-major (kBandCross, 1), contiguous along k. Band
// positions outside the image hold zeros (the stereo rule). A tap picks its
// address, band or global memory, and then loads once: no branch.
struct BandTap {
  const float* __restrict__ img;  // (H, W) plane in global memory
  const float* band;
  int H, W;
  int xmajor, j0, len, cross, sj, sk;
  float c0, slope;
  int covered;  // the band holds all the lane can touch (FlatTap, SlopedTap)

  __device__ __forceinline__ int base(int j) const {
    const int b = (int)floorf(c0 + slope * (float)j);
    return xmajor ? b : (b & ~3);
  }

  __device__ __forceinline__ bool in_image(int r, int c) const {
    return (unsigned)r < (unsigned)H && (unsigned)c < (unsigned)W;
  }

  // Where pixel (r, c) is read from: the band if it holds it, else the
  // plane (then (r, c) must lie inside the image).
  __device__ __forceinline__ const float* at(int r, int c) const {
    const int j = (xmajor ? c : r) - j0;
    const int k = (xmajor ? r : c) - base(j);
    const bool in = (unsigned)j < (unsigned)len && (unsigned)k < (unsigned)cross;
    return in ? band + j * sj + k * sk : img + (size_t)r * W + c;
  }

  __device__ __forceinline__ float pix(int r, int c) const { return *at(r, c); }

  // The 2x2 pixels at (r, c): two neighbours across the line on each of
  // two neighbouring major coordinates. From the band if it holds all
  // four, else `g00` .. `g11` say where each comes from.
  __device__ __forceinline__ void quad_from(int r, int c, const float* g00,
                                            const float* g01, const float* g10,
                                            const float* g11, float& i00, float& i01,
                                            float& i10, float& i11) const {
    const int j = (xmajor ? c : r) - j0;
    const int x = xmajor ? r : c;
    const int ka = x - base(j), kb = x - base(j + 1);
    const bool in = j >= 0 && j + 1 < len && ka >= 0 && ka + 1 < cross && kb >= 0 &&
                    kb + 1 < cross;
    const float* a0 = band + j * sj + ka * sk;  // major j: cross ka, ka + 1
    const float* b0 = a0 + sj + (kb - ka) * sk;  // major j + 1: cross kb, kb + 1
    i00 = *(in ? a0 : g00);
    i11 = *(in ? b0 + sk : g11);
    i01 = *(in ? (xmajor ? b0 : a0 + sk) : g01);
    i10 = *(in ? (xmajor ? a0 + sk : b0) : g10);
  }

  // Pixels (iy, ix), (iy, ix+1), (iy+1, ix), (iy+1, ix+1), all inside the image.
  __device__ __forceinline__ void quad(int iy, int ix, float& i00, float& i01,
                                       float& i10, float& i11) const {
    const float* g = img + (size_t)iy * W + ix;
    quad_from(iy, ix, g, g + 1, g + W, g + W + 1, i00, i01, i10, i11);
  }

  // The same four pixels, zero where outside the image.
  __device__ __forceinline__ void quad_zero(int r, int c, float& i00, float& i01,
                                            float& i10, float& i11) const {
    const float* g = img + (ptrdiff_t)r * W + c;  // not read where outside
    quad_from(r, c, in_image(r, c) ? g : &kZeroPixel,
              in_image(r, c + 1) ? g + 1 : &kZeroPixel,
              in_image(r + 1, c) ? g + W : &kZeroPixel,
              in_image(r + 1, c + 1) ? g + W + 1 : &kZeroPixel, i00, i01, i10, i11);
  }

  __device__ __forceinline__ void sample3(float xmax, float ymax, float px,
                                          float py, float out[3]) const {
    sample3_plane(*this, H, W, xmax, ymax, px, py, out);
  }
};

// A band that is a plain rectangle of the image (a horizontal or vertical
// line) and holds, with room to spare, every pixel its lane can touch
// (band_geometry's `covered`): a tap is one index, no test. Rows [r0, ..),
// columns [c0, ..), row pitch rp.
struct FlatTap {
  const float* band;
  int H, W, r0, c0, rp;

  __device__ __forceinline__ float pix(int r, int c) const {
    return band[(r - r0) * rp + (c - c0)];
  }

  __device__ __forceinline__ void quad(int iy, int ix, float& i00, float& i01,
                                       float& i10, float& i11) const {
    const float* p = band + (iy - r0) * rp + (ix - c0);
    i00 = p[0];
    i01 = p[1];
    i10 = p[rp];
    i11 = p[rp + 1];
  }

  // the lane is interior: no tap leaves the image
  __device__ __forceinline__ void quad_zero(int r, int c, float& i00, float& i01,
                                            float& i10, float& i11) const {
    quad(r, c, i00, i01, i10, i11);
  }

  __device__ __forceinline__ void sample3(float xmax, float ymax, float px,
                                          float py, float out[3]) const {
    sample3_plane(*this, H, W, xmax, ymax, px, py, out);
  }
};

// A band that follows a sloped line and holds, with room to spare, every
// pixel its lane can touch: a tap is its column's base and one index, no
// test and no second source. Same storage as BandTap.
struct SlopedTap {
  const float* band;
  int H, W, xmajor, j0, sj, sk;
  float c0, slope;

  __device__ __forceinline__ int base(int j) const {
    const int b = (int)floorf(c0 + slope * (float)j);
    return xmajor ? b : (b & ~3);
  }

  __device__ __forceinline__ float pix(int r, int c) const {
    const int j = (xmajor ? c : r) - j0;
    return band[j * sj + ((xmajor ? r : c) - base(j)) * sk];
  }

  __device__ __forceinline__ void quad(int iy, int ix, float& i00, float& i01,
                                       float& i10, float& i11) const {
    const int j = (xmajor ? ix : iy) - j0;
    const int x = xmajor ? iy : ix;
    const float* a0 = band + j * sj + (x - base(j)) * sk;
    const float* b0 = band + (j + 1) * sj + (x - base(j + 1)) * sk;
    i00 = a0[0];
    i11 = b0[sk];
    i01 = xmajor ? b0[0] : a0[sk];
    i10 = xmajor ? a0[sk] : b0[0];
  }

  __device__ __forceinline__ void quad_zero(int r, int c, float& i00, float& i01,
                                            float& i10, float& i11) const {
    quad(r, c, i00, i01, i10, i11);  // the lane is interior
  }

  __device__ __forceinline__ void sample3(float xmax, float ymax, float px,
                                          float py, float out[3]) const {
    sample3_plane(*this, H, W, xmax, ymax, px, py, out);
  }
};

__device__ __forceinline__ float group_min(float v) {  // over the 8 pattern pixels
  v = fminf(v, __shfl_xor_sync(kFull, v, 1));
  v = fminf(v, __shfl_xor_sync(kFull, v, 2));
  return fminf(v, __shfl_xor_sync(kFull, v, 4));
}

__device__ __forceinline__ float group_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 2));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 4));
}

// The lane's band geometry. Along the line: the segment over the valid
// steps and the GN travel (<= 0.5 step per iteration), the pattern's
// extent, +1 px of bilinear support, +1 px for the gradient taps, +1 px
// against rounding. Across it, from 3 px under the pattern's lowest cross
// offset (gradient tap, rounding, and one more because the base is taken at
// an integer major coordinate up to a pixel from the tap's own) to 5 px
// over its highest (those three, the bilinear neighbour and one to spare),
// at most kBandCross. Clipped to the image and to the launch's band length.
__device__ __forceinline__ void band_geometry(BandTap& g, const Lane& L,
                                              int gn_iters, int band_len) {
  g.xmajor = fabsf(L.dx) >= fabsf(L.dy);
  g.sj = g.xmajor ? 1 : kBandCross;
  g.sk = g.xmajor ? band_len : 1;
  g.j0 = 0;
  g.len = 0;
  g.cross = 0;
  g.c0 = 0.f;
  g.slope = 0.f;
  g.covered = 0;
  const float pm = g.xmajor ? L.pcx : L.pcy;  // pattern offset along / across
  const float pc = g.xmajor ? L.pcy : L.pcx;
  const float dm = g.xmajor ? L.dx : L.dy;
  const float dc = g.xmajor ? L.dy : L.dx;
  const float ptm = g.xmajor ? L.ptx : L.pty;
  const float ptc = g.xmajor ? L.pty : L.ptx;
  const float slope = dm != 0.f ? dc / dm : 0.f;
  const float pm_min = group_min(pm), pm_max = group_max(pm);
  const float pc_min = group_min(pc - slope * pm);  // fminf skips a NaN entry
  const float pc_max = group_max(pc - slope * pm);
  // a NaN pattern entry samples pixel (0, 0), wherever the band lies
  const bool pattern_finite = __all_sync(kFull, isfinite(L.pcx) && isfinite(L.pcy));
  if (L.n_valid <= 0 || !isfinite(pm_min) || !isfinite(pm_max) || !isfinite(pc_min) ||
      !isfinite(pc_max))
    return;
  const int M = g.xmajor ? g.W : g.H;
  const float half = 0.5f * (float)gn_iters;
  const float ma = ptm - half * dm;
  const float mb = ptm + ((float)(L.n_valid - 1) + half) * dm;
  const float mlo = fminf(fmaxf(fminf(ma, mb) + pm_min, 0.f), (float)(M - 1));
  const float mhi = fminf(fmaxf(fmaxf(ma, mb) + pm_max, 0.f), (float)(M - 1));
  g.j0 = max((int)floorf(mlo) - 2, 0) & ~3;
  const int jend = min((int)floorf(mhi) + 3, M - 1);
  g.len = min((jend - g.j0 + 4) & ~3, band_len);  // a multiple of 4, as band_len is
  const int need = (int)ceilf(fminf(pc_max - pc_min, (float)kBandCross)) + 9;
  g.cross = g.xmajor ? min(need, kBandCross) : min((need + 3 + 3) & ~3, kBandCross);
  g.slope = slope;
  g.c0 = ptc + ((float)g.j0 - ptm) * slope + pc_min - 3.f;
  // A band that was cut nowhere, neither by the image nor by the launch's
  // sizes: no coordinate of the lane is ever clamped and no tap leaves the
  // band, so the taps need no test. base() is monotone: its ends bound it.
  const int C = g.xmajor ? g.H : g.W;
  const int b_lo = min(g.base(0), g.base(g.len - 1));
  const int b_hi = max(g.base(0), g.base(g.len - 1));
  g.covered = pattern_finite && mlo == fminf(ma, mb) + pm_min && mhi == fmaxf(ma, mb) + pm_max &&
              (int)floorf(mlo) - 2 >= 0 && (int)floorf(mhi) + 3 <= M - 1 &&
              ((jend - g.j0 + 4) & ~3) <= band_len &&
              (g.xmajor ? need : need + 3) <= g.cross && b_lo >= 0 && b_hi + g.cross <= C;
}

__device__ __forceinline__ void store_zero4(float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Copy the band into `band`, zeros where it leaves the image; every thread
// of the warp takes part, and waits for its own copies. `vec`: the plane's
// rows start on 16-byte boundaries.
__device__ __forceinline__ void stage_band(const BandTap& g, float* band, int vec) {
  const int lane = threadIdx.x & 31;
  if (g.xmajor) {
    for (int j = 4 * lane; j < g.len; j += 128) {
      const int col = g.j0 + j;  // a multiple of 4
      int b[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) b[e] = g.base(j + e);
      const bool quad = vec && b[0] == b[3] && col + 3 < g.W;
      for (int k = 0; k < g.cross; ++k) {
        float* dst = band + k * g.sk + j;
        if (quad) {
          const int row = b[0] + k;
          if ((unsigned)row < (unsigned)g.H)
            cp_async16(dst, g.img + (size_t)row * g.W + col);
          else
            store_zero4(dst);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = b[e] + k;
            if (g.in_image(row, col + e))
              cp_async4(dst + e, g.img + (size_t)row * g.W + col + e);
            else
              dst[e] = 0.f;
          }
        }
      }
    }
  } else {
    const int chunks = g.cross >> 2;  // 16-byte chunks of a staged row
    for (int q = lane; q < g.len * (kBandCross / 4); q += 32) {
      const int j = q >> 2, k = (q & 3) * 4;
      if ((q & 3) >= chunks) continue;
      const int row = g.j0 + j;       // may pass the last row: `len` is rounded up
      const int col = g.base(j) + k;  // a multiple of 4
      float* dst = band + j * kBandCross + k;
      const float* src = g.img + (ptrdiff_t)row * g.W + col;
      if (vec && row < g.H && col >= 0 && col + 3 < g.W) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (g.in_image(row, col + e))
            cp_async4(dst + e, src + e);
          else
            dst[e] = 0.f;
        }
      }
    }
  }
  cp_async_wait_all();
  __syncwarp();
}

// Dynamic shared memory, per warp: the band (kBandCross * band_len floats)
// and the per-step energies (S rounded up to a multiple of 4).
// blockIdx.y is the sequence: its intensity plane and its N lanes.
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
epipolar_search_slab_kernel(const float* __restrict__ img,
                            const float* __restrict__ scal,
                            const float* __restrict__ color,
                            const float* __restrict__ weights,
                            const float* __restrict__ patx,
                            const float* __restrict__ paty, long long psn,
                            long long ps0, long long ps1, float* __restrict__ out,
                            int H, int W, int N, int S, float huber_th,
                            int gn_iters, float gn_threshold, int radius,
                            int edge, int band_len, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * (blockDim.x >> 5) + warp;
  if (i >= N) return;  // whole warps exit together; no block-wide barrier follows
  const size_t n = blockIdx.y;
  const size_t lanes = n * (size_t)N * 8;
  img += n * (size_t)H * W;  // W % 4 == 0 keeps every plane 16-byte aligned (`vec`)
  scal += lanes;
  color += lanes;
  weights += lanes;
  out += lanes;
  patx += (long long)n * psn;
  paty += (long long)n * psn;
  const int per_warp = kBandCross * band_len + ((S + 3) & ~3);
  float* band = smem + warp * per_warp;
  float* e_step = band + kBandCross * band_len;

  const Lane L = load_lane(scal, color, patx, paty, ps0, ps1, i, S);
  BandTap g;
  g.img = img;
  g.band = band;
  g.H = H;
  g.W = W;
  band_geometry(g, L, gn_iters, band_len);
  if (g.len > 0) stage_band(g, band, vec);
  if (g.covered && g.slope == 0.f) {
    const int b0 = g.base(0);
    const FlatTap f{band, H, W, g.xmajor ? b0 : g.j0, g.xmajor ? g.j0 : b0,
                    g.xmajor ? band_len : kBandCross};
    search_and_refine(f, L, weights, i, e_step, out, H, W, S, huber_th, gn_iters,
                      gn_threshold, radius, edge);
  } else if (g.covered) {
    const SlopedTap t{band, H, W, g.xmajor, g.j0, g.sj, g.sk, g.c0, g.slope};
    search_and_refine(t, L, weights, i, e_step, out, H, W, S, huber_th, gn_iters,
                      gn_threshold, radius, edge);
  } else {
    search_and_refine(g, L, weights, i, e_step, out, H, W, S, huber_th, gn_iters,
                      gn_threshold, radius, edge);
  }
}

}  // namespace

// `n_seq` sequences, each an (H, W) intensity plane of `img` and N lanes of
// the contiguous (n_seq, N, 8) `scal`, `color`, `weights` and `out`;
// `band_len` (a multiple of 4) is the band length the launch reserves per
// lane and `warps` the lanes (warps) a block takes: its dynamic shared
// memory is warps * 4 * (16 * band_len + S rounded up to a multiple of 4)
// bytes. `patx`/`paty` are (n_seq, N, 8) views with element strides (psn,
// ps0, ps1).
extern "C" int sdso_epipolar_search_slab(const float* img, const float* scal,
                                         const float* color, const float* weights,
                                         const float* patx, const float* paty,
                                         long long psn, long long ps0, long long ps1,
                                         float* out, int H, int W, int N, int S,
                                         float huber_th, int gn_iters,
                                         float gn_threshold, int radius, int edge,
                                         int band_len, int n_seq, int warps,
                                         cudaStream_t stream) {
  if (N <= 0 || n_seq <= 0) return 0;
  if (S < 1 || band_len < 4 || (band_len & 3) || warps < 1 || warps > kMaxWarpsPerBlock)
    return (int)cudaErrorInvalidValue;
  if (n_seq > 65535) return (int)cudaErrorInvalidValue;
  const int smem_bytes = warps * 4 * (kBandCross * band_len + ((S + 3) & ~3));
  cudaError_t err = cudaFuncSetAttribute(
      epipolar_search_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const int vec = (W % 4 == 0) && (((size_t)img & 15) == 0);
  const dim3 grid((N + warps - 1) / warps, n_seq);
  epipolar_search_slab_kernel<<<grid, warps * 32, smem_bytes, stream>>>(
      img, scal, color, weights, patx, paty, psn, ps0, ps1, out, H, W, N, S,
      huber_th, gn_iters, gn_threshold, radius, edge, band_len, vec);
  return (int)cudaGetLastError();
}
