// Epipolar search + Gauss-Newton refinement for immature points (sm_90a),
// every tap read from global memory (L1 / L2).
//
// Replaces the TPU kernel stereo_dso_g2o_tpu/ops/trace_pallas.py::
// epipolar_search, resident body `_make_kernel_resident` (trace_pallas.py
// :449-628, reached through the pallas_call at :695). It computes what that
// kernel computes, lane by lane: the 8-pixel pattern sampled bilinearly at
// pt + s*(dx, dy) for every valid step s, the Huber energy of
// I - (a*c + b), the masked argmin (ties to the lowest step), the
// second-best energy more than `radius` steps away, and <= gn_iters steps
// of 1-dof Gauss-Newton along the line. The TPU's tent-matrix matmul
// formulation, its slab padding and its bf16 split dots do not come
// across: each tap is read directly, in f32.
//
// What bounds it on the H100: not bytes (the image is read once from HBM,
// a few microseconds, and then sits in the 50 MB L2) and, after this
// design, no longer the latency of its gathers either: at ~800 warp
// instructions a lane it is bound by instruction throughput and by a fixed
// floor (the launch, the operand loads, the three dependent Gauss-Newton
// iterations) of ~8 us that a launch of masked lanes alone still pays.
// The design (epipolar_common.cuh has the layout):
//   - only valid steps are sampled; a lane the caller masked (num_steps 0)
//     costs its operand loads and the Gauss-Newton tail, no search;
//   - a warp per lane, work items (step, pattern pixel) strided over the 32
//     threads, 16 independent taps per thread in flight per pass, no branch
//     between them;
//   - the caller picks the warps of a block (ops/trace_cuda.py: 8): lanes
//     of very different cost share a block and the block's slots free up as
//     its warps finish (4 and 16 were measured: within +-10 %, neither
//     better on every shape);
//   - taps come from channel 0 of the (H, W, 3) stack. Reading a separate
//     (H, W) intensity plane instead cuts the sectors a lane touches to a
//     third and was measured 3-7 % faster on dense lanes and equal on the
//     main path's lanes: less than the copy that makes the plane costs per
//     image, so it was left out;
//   - Gauss-Newton reads the three channels of the stack (12 loads a thread
//     and iteration; it is a latency chain either way).
//   - a batch of sequences is the grid's second dimension: block row n
//     reads image n of an (n_seq, H, W, 3) stack and lanes n of
//     (n_seq, N, 8) operands, so one launch serves every sequence of a
//     batched frame (what vmap of the TPU kernel computes), and a batch of
//     one is the single-image launch, bit for bit.
// Nothing of the image is staged in shared memory: epipolar_search_slab.cu
// is this kernel with a staged band, and it is slower on the same lanes
// (L1/L2 already serve the reuse). Nothing is allocated, and the launch
// does not synchronize.
//
// Sampling rules (they follow the JAX "xla" backend):
//   edge == 0 (temporal search): coordinates clamped to [0, size - 1.001],
//     weights ((1-fx)(1-fy), fx(1-fy), (1-fx)fy, fx fy);
//   edge == 1 (static-stereo search): integer columns floor(ptx) + s*dx +
//     pattern_x, rows floor(pty) + pattern_y, zeros outside the image,
//     vertical lerp then horizontal lerp (needs dx = +-1, dy = 0);
//   Gauss-Newton: interp.bilinear (clamped) on all three channels.
// Compile with -fmad=false so products and sums round as in PyTorch/XLA.

#include "epipolar_common.cuh"

namespace {

using namespace sdso;

constexpr int kMaxWarpsPerBlock = 8;

struct GlobalTap {
  const float* __restrict__ dI;  // (H, W, 3) intensity and gradients
  int H, W;

  static constexpr int kStride = 3;  // the search reads channel 0 of the stack

  // Pixels (iy, ix), (iy, ix+1), (iy+1, ix), (iy+1, ix+1), all inside the image.
  __device__ __forceinline__ void quad(int iy, int ix, float& i00, float& i01,
                                       float& i10, float& i11) const {
    const float* p = dI + ((size_t)iy * W + ix) * kStride;
    i00 = __ldg(p);
    i01 = __ldg(p + kStride);
    i10 = __ldg(p + (size_t)W * kStride);
    i11 = __ldg(p + (size_t)W * kStride + kStride);
  }

  __device__ __forceinline__ float tap_zero(int r, int c) const {
    return ((unsigned)r < (unsigned)H && (unsigned)c < (unsigned)W)
               ? __ldg(dI + ((size_t)r * W + c) * kStride)
               : 0.f;
  }

  // The same four pixels, zero where outside the image.
  __device__ __forceinline__ void quad_zero(int r, int c, float& i00, float& i01,
                                            float& i10, float& i11) const {
    i00 = tap_zero(r, c);
    i01 = tap_zero(r, c + 1);
    i10 = tap_zero(r + 1, c);
    i11 = tap_zero(r + 1, c + 1);
  }

  // interp.bilinear on channels (0, 1, 2).
  __device__ __forceinline__ void sample3(float xmax, float ymax, float px,
                                          float py, float out[3]) const {
    float x = clampf(px, 0.f, xmax);
    float y = clampf(py, 0.f, ymax);
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
};

// Dynamic shared memory: S floats (the per-step energies) for each warp.
// blockIdx.y is the sequence: its image and its N lanes.
__global__ void __launch_bounds__(kMaxWarpsPerBlock * 32)
epipolar_search_kernel(const float* __restrict__ dI,
                       const float* __restrict__ scal,
                       const float* __restrict__ color,
                       const float* __restrict__ weights,
                       const float* __restrict__ patx,
                       const float* __restrict__ paty, long long psn,
                       long long ps0, long long ps1, float* __restrict__ out,
                       int H, int W, int N, int S, float huber_th,
                       int gn_iters, float gn_threshold, int radius, int edge) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * (blockDim.x >> 5) + warp;
  if (i >= N) return;  // whole warps exit together; no block-wide barrier follows
  const size_t n = blockIdx.y;
  const size_t lanes = n * (size_t)N * 8;
  dI += n * (size_t)H * W * 3;
  scal += lanes;
  color += lanes;
  weights += lanes;
  out += lanes;
  patx += (long long)n * psn;
  paty += (long long)n * psn;
  const Lane L = load_lane(scal, color, patx, paty, ps0, ps1, i, S);
  const GlobalTap g{dI, H, W};
  search_and_refine(g, L, weights, i, smem + warp * S, out, H, W, S, huber_th,
                    gn_iters, gn_threshold, radius, edge);
}

}  // namespace

// `n_seq` sequences, each an (H, W, 3) image of `dI` and N lanes of the
// contiguous (n_seq, N, 8) `scal`, `color`, `weights` and `out`.
// `patx`/`paty` are (n_seq, N, 8) views with element strides (psn, ps0,
// ps1); `warps` is the number of lanes (warps) a block takes.
extern "C" int sdso_epipolar_search(const float* dI, const float* scal,
                                    const float* color, const float* weights,
                                    const float* patx, const float* paty,
                                    long long psn, long long ps0, long long ps1,
                                    float* out, int H, int W, int N, int S,
                                    float huber_th, int gn_iters,
                                    float gn_threshold, int radius, int edge,
                                    int n_seq, int warps, cudaStream_t stream) {
  if (N <= 0 || n_seq <= 0) return 0;
  if (warps < 1 || warps > kMaxWarpsPerBlock) return (int)cudaErrorInvalidValue;
  if (n_seq > 65535) return (int)cudaErrorInvalidValue;
  const int smem_bytes = warps * S * (int)sizeof(float);
  if (S < 1 || smem_bytes > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + warps - 1) / warps, n_seq);
  epipolar_search_kernel<<<grid, warps * 32, smem_bytes, stream>>>(
      dI, scal, color, weights, patx, paty, psn, ps0, ps1, out, H, W, N, S,
      huber_th, gn_iters, gn_threshold, radius, edge);
  return (int)cudaGetLastError();
}
