// One LM trip of the coarse tracker for every row of a level (sm_90a):
// tracker_ops.lm_trip on CUDA tensors, one launch a trip.
//
// Replaces no TPU kernel. The JAX package runs this loop body in XLA
// (stereo_dso_g2o_tpu/ops/tracker_ops.py, lm_level's while_loop body) and
// the port's plain version, tracker_ops.lm_trip_ref, is some 740 small
// PyTorch kernels a trip: an 8x8 Cholesky chain written one scalar op at a
// time, the warp and residual pass, the normal equations, the seven passes
// of the cutoff repeat, the row selects. Captured into a WHILE node's body
// each of them is a graph node of ~1.4 us, so a trip cost ~1 ms of launch
// latency for a few microseconds of work.
//
// What bounds it on the H100: not bytes (a trip reads < 3 MB, most of it
// from L2: about a microsecond at 3.35 TB/s) and not operations (~250 f32
// operations a point-row, 10 MFLOP at the largest level), but the launch
// and the chain inside one block: the damped solve, one pass over the
// row's points, a block reduction of 45 sums, and, on a row whose cutoff
// repeats, two more short passes. The design:
//   - one block per row b = n * rows_per_seq + k (sequence n, hypothesis
//     k); a row that is done returns at once and its carry stays as it was
//     bit for bit (a vmapped while_loop's semantics);
//   - thread 0 solves the damped system (_lm_solve: the same damping, the
//     1e-30 pivot clamp, the affine modes' 8, 7, 6 and stitched 7
//     unknowns, extrapolation, preconditioner scale, finite check), then
//     se3_exp(inc[:6]) @ T, aff + inc[6:8] and the affine transfer; the
//     solve is a dependent chain of ~200 operations, unrolled in
//     registers for the mode;
//   - one pass over the points computes calc_res and calc_gs together:
//     the warp (Ku = fma(fx, u_n, cx) rounded once, as calc_res rounds
//     it), the bilinear (I, gx, gy) sample with _bilinear3's clamps and
//     NaN handling, residual, Huber weight, energy, in-bounds and good
//     counts, and the 36 + 8 sums of [J | r]^T W [J | r] over good points;
//     a point that is not good adds 0 there, or NaN to each sum that one
//     of its non-finite Jacobian entries touches, as the plain version's
//     J * 0 does. |r| and the in-bounds flag wait in shared memory until
//     the step is accepted;
//   - every sum is a fixed order: each thread over its points in order
//     (i = tid, tid + T, ...), a warp's tree, then the warps in order. T
//     depends on P alone, so a row of a batched launch rounds as the
//     sequence launched alone, and no atomic is used;
//   - the cutoff repeat's seven doubling passes become one pass counting
//     |r| > th * 2^j for j = 0..6 (the doubling reads only those counts),
//     then the energy at the new cutoff; both run only in a row whose
//     repeat is due (a branch uniform over the block);
//   - thread 0 writes every carry field in place; block 0's thread 0 adds
//     one to the launch counter the wrapper hands in (null eagerly: the
//     host counts those), so a launch captured in a graph counts each
//     time it runs, adding no node.
// Arithmetic follows the plain version op by op (no contraction:
// -fmad=false; a Python scalar is rounded to float as PyTorch rounds it,
// `x / c` by a scalar is x * (1 / c) and `c / x` is (1 / x) * c, as
// PyTorch computes them on the card); sums and 3x3 / 4x4 products are in
// another order than cuBLAS's, so the two agree to f32 rounding.

#include <cuda_runtime.h>

namespace sdso {

// The C entry's argument (tracker_ops.TripArgs): outside the unnamed
// namespace, so that the entry keeps its external linkage.
struct LmArgs {
  // the level's problem (read only): n_seq sequences of P points
  const float* pc_u;
  const float* pc_v;
  const float* pc_idepth;
  const float* pc_color;
  const unsigned char* pc_ok;
  const float* dI;            // (n_seq, H, W, 3)
  const float* K;             // (n_seq, 4): fx fy cx cy
  const float* ref_aff;       // (n_seq, 2)
  const float* ref_exposure;  // (n_seq,)
  const float* new_exposure;  // (n_seq,)
  // the carry, n_seq * rows_per_seq rows, updated in place
  long long* it;
  long long* total;
  float* T;  // (rows, 4, 4)
  float* aff;
  float* E_old;
  long long* n_old;
  float* lam;
  float* Hm;  // (rows, 8, 8)
  float* bv;  // (rows, 8)
  float* cutoff;
  float* ar;            // (rows, P), strides ar_stride
  unsigned char* inb;   // (rows, P), the same strides
  unsigned char* rep_pending;
  unsigned char* done;
  unsigned long long* launches;  // null: counted by the caller
  int n_seq, rows_per_seq, P, H, W;
  int opt_a, opt_b, max_iterations;
  float huber_th, two_huber_th, huber_th_sq, cutoff_th;
  float scale[8];
  long long ar_stride[3];  // elements: sequence, hypothesis, point
};

}  // namespace sdso

namespace {

using sdso::LmArgs;

constexpr int kSums = 45;  // the lower triangle of H (36), b (8), the energy

__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
  return x != x ? x : (x < lo ? lo : x);
}

// _huber_w: 1 below the threshold, else th / max(|r|, 1e-12) as PyTorch
// computes a scalar over a tensor: reciprocal, then the product.
__device__ __forceinline__ float huber_w(float a, float th) {
  return a < th ? 1.f : (1.f / clamp_min_nan(a, (float)1e-12)) * th;
}

__device__ __forceinline__ bool finite(float x) { return x - x == 0.f; }

// Unknowns of the damped solve per affine mode: 0 both (8), 1 neither
// (6), 2 a only (7), 3 b only (7, the stitch: unknowns 0-5 and 7).
template <int MODE>
struct Unknowns {
  static constexpr int n = MODE == 0 ? 8 : (MODE == 1 ? 6 : 7);
  __device__ static constexpr int at(int i) { return MODE == 3 && i == 6 ? 7 : i; }
};

// utils/smalls.cholesky_solve_small of the damped system, its unknowns
// gathered for the mode; inc (8) gets zeros where the mode keeps a value.
template <int MODE>
__device__ void damped_solve(const float* Hm, const float* bv, float lam, float inc[8]) {
  constexpr int n = Unknowns<MODE>::n;
  float L[n][n];
  float y[n], x[n];
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const int aj = Unknowns<MODE>::at(j);
    const float hjj = Hm[aj * 8 + aj];
    float s = hjj + hjj * lam;
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    const float d = sqrtf(clamp_min_nan(s, (float)1e-30));
    L[j][j] = d;
    const float inv_d = 1.f / d;
#pragma unroll
    for (int i = j + 1; i < n; ++i) {
      // Hm + diag(Hm) * lam off the diagonal: Hm_ij + 0 * lam
      float t = Hm[Unknowns<MODE>::at(i) * 8 + aj] + 0.f * lam;
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t * inv_d;
    }
  }
#pragma unroll
  for (int i = 0; i < n; ++i) {
    float s = -bv[Unknowns<MODE>::at(i)];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = n - 1; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < n; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) inc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < n; ++i) inc[Unknowns<MODE>::at(i)] = x[i];
}

// utils/se3.se3_exp of the twist (rho, w) times T (4 x 4): out = exp @ T.
__device__ void se3_exp_times(const float xi[6], const float* T, float out[16]) {
  const float r0 = xi[0], r1 = xi[1], r2 = xi[2];
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float eps2 = (float)(1e-8 * 1e-8);
  const float theta2 = (w0 * w0 + w1 * w1) + w2 * w2;
  const float theta = sqrtf(theta2 + eps2);
  const float W[3][3] = {{0.f, -w2, w1}, {w2, 0.f, -w0}, {-w1, w0, 0.f}};
  float W2[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      W2[i][j] = (W[i][0] * W[0][j] + W[i][1] * W[1][j]) + W[i][2] * W[2][j];
  const bool small = theta2 < (float)1e-8;
  const float A = small ? 1.f - theta2 * (1.f / 6.f) : sinf(theta) / theta;
  const float B = small ? 0.5f - theta2 * (1.f / 24.f)
                        : (1.f - cosf(theta)) / (theta2 + eps2);
  const float C = small ? (float)(1.0 / 6.0) - theta2 * (1.f / 120.f)
                        : (1.f - A) / (theta2 + eps2);
  float E[4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float V[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.f : 0.f;
      E[i][j] = (eye + A * W[i][j]) + B * W2[i][j];
      V[j] = (eye + B * W[i][j]) + C * W2[i][j];
    }
    E[i][3] = (V[0] * r0 + V[1] * r1) + V[2] * r2;
  }
  E[3][0] = E[3][1] = E[3][2] = 0.f;
  E[3][3] = 1.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[i * 4 + j] = ((E[i][0] * T[j] + E[i][1] * T[4 + j]) + E[i][2] * T[8 + j]) +
                       E[i][3] * T[12 + j];
}

// What thread 0 hands the block.
struct RowShared {
  float T_new[16];
  float aff_new[2];
  float a, b;  // the transferred affine of aff_new
  int accept, do_rep;
  float cutoff2, e2;
  float sums[kSums];
  int counts[3];  // in-bounds, good, the non-finite mask
  int rep_counts[8];  // the repeat's |r| > th * 2^j, j = 0..6; in-bounds
};

// Block-wide sums of v[0..M) (fixed order: a warp's tree, then the warps
// in order); the result lands in out[0..M) of shared memory.
template <int THREADS, int M>
__device__ void block_sum(float (&v)[M], float* red, float* out) {
  constexpr int kWarps = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < M; ++e) {
    float x = v[e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = x + __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) red[warp * M + e] = x;
  }
  __syncthreads();
  if (threadIdx.x < M) {
    float s = red[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) s = s + red[w * M + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// Block-wide integer sums (or an OR for the entries in or_mask).
template <int THREADS, int M>
__device__ void block_count(int (&v)[M], unsigned or_mask, int* red, int* out) {
  constexpr int kWarps = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < M; ++e) {
    const int x = (or_mask >> e) & 1u ? (int)__reduce_or_sync(0xffffffffu, (unsigned)v[e])
                                      : __reduce_add_sync(0xffffffffu, v[e]);
    if (lane == 0) red[warp * M + e] = x;
  }
  __syncthreads();
  if (threadIdx.x < M) {
    int s = red[threadIdx.x];
    for (int w = 1; w < kWarps; ++w)
      s = (or_mask >> threadIdx.x) & 1u ? (s | red[w * M + threadIdx.x])
                                        : s + red[w * M + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS) lm_trip_kernel(const LmArgs a) {
  extern __shared__ float point_smem[];  // P floats |r|, then P bytes in-bounds
  __shared__ RowShared sh;
  __shared__ float red[(THREADS / 32) * kSums];
  __shared__ int redi[(THREADS / 32) * 8];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  if (b == 0 && tid == 0 && a.launches) *a.launches += 1ull;
  if (a.done[b]) return;  // uniform over the block; nothing below ran

  const int P = a.P, H = a.H, W = a.W;
  const int n = b / a.rows_per_seq;
  float* ar_s = point_smem;
  unsigned char* inb_s = reinterpret_cast<unsigned char*>(point_smem + P);
  float* T_old = a.T + (size_t)b * 16;
  const float* Hm = a.Hm + (size_t)b * 64;
  const float* bv = a.bv + (size_t)b * 8;
  const float lam = a.lam[b];
  const float cutoff = a.cutoff[b];
  const float b_ref = a.ref_aff[n * 2 + 1];

  // ---- 1. the damped solve, the pose and affine step (thread 0) ----
  float inc_raw_norm2 = 0.f;  // thread 0's only
  if (tid == 0) {
    float inc[8];
    const int mode = a.opt_a ? (a.opt_b ? 0 : 2) : (a.opt_b ? 3 : 1);
    if (mode == 0) damped_solve<0>(Hm, bv, lam, inc);
    else if (mode == 1) damped_solve<1>(Hm, bv, lam, inc);
    else if (mode == 2) damped_solve<2>(Hm, bv, lam, inc);
    else damped_solve<3>(Hm, bv, lam, inc);
    const float limit = (float)0.001;
    const float extrap =
        lam < limit ? sqrtf(sqrtf((1.f / clamp_min_nan(lam, (float)1e-12)) * limit)) : 1.f;
    float scaled[8];
    bool fin = true;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      inc[i] = inc[i] * extrap;
      scaled[i] = inc[i] * a.scale[i];
      fin = fin && finite(scaled[i]);
      inc_raw_norm2 = inc_raw_norm2 + inc[i] * inc[i];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) scaled[i] = fin ? scaled[i] : 0.f;
    se3_exp_times(scaled, T_old, sh.T_new);
    const float a0 = a.aff[b * 2] + scaled[6], b0 = a.aff[b * 2 + 1] + scaled[7];
    sh.aff_new[0] = a0;
    sh.aff_new[1] = b0;
    // _aff_transfer
    const float ta = (expf(a0 - a.ref_aff[n * 2]) * a.new_exposure[n]) / a.ref_exposure[n];
    sh.a = ta;
    sh.b = b0 - ta * a.ref_aff[n * 2 + 1];
  }
  __syncthreads();

  // ---- 2. calc_res and calc_gs in one pass over the points ----
  const float fx = a.K[n * 4], fy = a.K[n * 4 + 1], cx = a.K[n * 4 + 2], cy = a.K[n * 4 + 3];
  const float R00 = sh.T_new[0], R01 = sh.T_new[1], R02 = sh.T_new[2], t0 = sh.T_new[3];
  const float R10 = sh.T_new[4], R11 = sh.T_new[5], R12 = sh.T_new[6], t1 = sh.T_new[7];
  const float R20 = sh.T_new[8], R21 = sh.T_new[9], R22 = sh.T_new[10], t2 = sh.T_new[11];
  const float ta = sh.a, tb = sh.b;
  const float th = a.huber_th;
  const float max_e = a.two_huber_th * cutoff - a.huber_th_sq;
  const float xmax = (float)((double)W - 1.001), ymax = (float)((double)H - 1.001);
  const float u_hi = (float)(W - 3), v_hi = (float)(H - 3);
  const float* img = a.dI + (size_t)n * H * W * 3;
  const size_t pts = (size_t)n * P;
  float acc[kSums];
#pragma unroll
  for (int e = 0; e < kSums; ++e) acc[e] = 0.f;
  int n_inb = 0, n_good = 0, bad = 0;
  for (int i = tid; i < P; i += THREADS) {
    const float pu = a.pc_u[pts + i], pv = a.pc_v[pts + i];
    const float pid = a.pc_idepth[pts + i], col = a.pc_color[pts + i];
    const bool ok = a.pc_ok[pts + i] != 0;
    const float xn = (pu - cx) / fx, yn = (pv - cy) / fy;
    const float p0 = ((xn * R00 + yn * R01) + R02) + t0 * pid;
    const float p1 = ((xn * R10 + yn * R11) + R12) + t1 * pid;
    const float p2 = ((xn * R20 + yn * R21) + R22) + t2 * pid;
    const float un = p0 / p2, vn = p1 / p2;
    // utils/smalls.fma: one rounding (the double product of floats is exact)
    const float Ku = (float)((double)fx * (double)un + (double)cx);
    const float Kv = (float)((double)fy * (double)vn + (double)cy);
    const float nid = pid / p2;
    const bool in = ok && Ku > 2.f && Kv > 2.f && Ku < u_hi && Kv < v_hi && nid > 0.f;
    // _bilinear3
    const float x = clamp_nan(Ku, 0.f, xmax), y = clamp_nan(Kv, 0.f, ymax);
    const float xf = floorf(x), yf = floorf(y);
    const int ix = xf != xf ? 0 : (int)xf, iy = yf != yf ? 0 : (int)yf;
    const float wx = x - xf, wy = y - yf;
    const float* q00 = img + ((size_t)iy * W + ix) * 3;
    const float* q10 = q00 + (size_t)W * 3;
    float hit[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float top = (1.f - wx) * __ldg(q00 + c) + wx * __ldg(q00 + 3 + c);
      const float bot = (1.f - wx) * __ldg(q10 + c) + wx * __ldg(q10 + 3 + c);
      hit[c] = (1.f - wy) * top + wy * bot;
    }
    const float r = hit[0] - (ta * col + tb);
    const float abs_r = fabsf(r);
    const float hw = huber_w(abs_r, th);
    const bool sat = in && abs_r > cutoff;
    const bool good = in && !sat;
    acc[kSums - 1] = acc[kSums - 1] + (good ? ((hw * r) * r) * (2.f - hw) : (sat ? max_e : 0.f));
    n_inb += in;
    n_good += good;
    ar_s[i] = abs_r;
    inb_s[i] = in;
    // calc_gs's Jacobian row
    const float dxk = hit[1] * fx, dyk = hit[2] * fy;
    const float uv = un * vn;
    float J[9];
    J[0] = nid * dxk;
    J[1] = nid * dyk;
    J[2] = (-nid) * ((un * dxk) + (vn * dyk));
    J[3] = -((uv * dxk) + (dyk * (1.f + (vn * vn))));
    J[4] = (uv * dyk) + (dxk * (1.f + (un * un)));
    J[5] = (un * dyk) - (vn * dxk);
    J[6] = ta * (b_ref - col);
    J[7] = -1.f;
    J[8] = r;
    if (good) {
      float Jw[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) Jw[k] = J[k] * hw;
      int e = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
#pragma unroll
        for (int j = 0; j <= k; ++j, ++e) acc[e] = acc[e] + Jw[k] * J[j];
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[36 + k] = acc[36 + k] + Jw[k] * J[8];
    } else {
#pragma unroll
      for (int k = 0; k < 9; ++k) bad |= finite(J[k]) ? 0 : (1 << k);
    }
  }
  block_sum<THREADS>(acc, red, sh.sums);
  {
    int cnt[3] = {n_inb, n_good, bad};
    block_count<THREADS>(cnt, 4u, redi, sh.counts);
  }


  // ---- 3. accept, the step's values, the end of a pass (thread 0) ----
  const long long it1 = a.it[b] + 1;
  const long long total1 = a.total[b] + 1;
  float E_out = 0.f, lam_out = 0.f;  // thread 0's
  long long n_out = 0;
  bool pass_end = false;
  if (tid == 0) {
    const long long num_terms = sh.counts[0];
    const float energy = sh.sums[kSums - 1];
    const long long n_old = a.n_old[b];
    const float E_old = a.E_old[b];
    const bool accept = energy / (float)(num_terms > 1 ? num_terms : 1) <
                        E_old / (float)(n_old > 1 ? n_old : 1);
    E_out = accept ? energy : E_old;
    n_out = accept ? num_terms : n_old;
    lam_out = accept ? lam * 0.5f : clamp_min_nan(lam * 4.f, (float)0.001);
    if (accept) {
      // calc_gs: the sums over max(good, 1), times the preconditioner
      // scales; a non-finite Jacobian entry of a point that is not good
      // makes NaN of every sum it touches (J * 0)
      const float ng = (float)(sh.counts[1] > 1 ? sh.counts[1] : 1);
      const int bad = sh.counts[2];
      const float nan = __int_as_float(0x7fc00000);
      float* Hn = a.Hm + (size_t)b * 64;
      float* bn = a.bv + (size_t)b * 8;
      int e = 0;
      for (int k = 0; k < 8; ++k) {
        for (int j = 0; j <= k; ++j, ++e) {
          const float q = (((bad >> k) | (bad >> j)) & 1 ? nan : sh.sums[e]) / ng;
          Hn[k * 8 + j] = (q * a.scale[k]) * a.scale[j];
          Hn[j * 8 + k] = (q * a.scale[j]) * a.scale[k];
        }
      }
      for (int k = 0; k < 8; ++k)
        bn[k] = ((((bad >> k) | (bad >> 8)) & 1 ? nan : sh.sums[36 + k]) / ng) * a.scale[k];
      for (int i = 0; i < 16; ++i) T_old[i] = sh.T_new[i];
      a.aff[b * 2] = sh.aff_new[0];
      a.aff[b * 2 + 1] = sh.aff_new[1];
    }
    sh.accept = accept;
    pass_end = sqrtf(inc_raw_norm2) <= (float)1e-3 || it1 >= (long long)a.max_iterations;
    sh.do_rep = pass_end && a.rep_pending[b] != 0;
  }
  __syncthreads();
  const bool accept = sh.accept, do_rep = sh.do_rep;
  // the plain version's layout of |r| and the flags (its sums leave the
  // point axis outermost)
  const long long row_at = n * a.ar_stride[0] + (b - n * a.rows_per_seq) * a.ar_stride[1];
  const long long ps = a.ar_stride[2];
  float* ar_row = a.ar + row_at;
  unsigned char* inb_row = a.inb + row_at;
  if (accept) {
    for (int i = tid; i < P; i += THREADS) {
      ar_row[i * ps] = ar_s[i];
      inb_row[i * ps] = inb_s[i];
    }
  }

  // ---- 4. the cutoff repeat, in a row whose repeat is due ----
  if (do_rep) {
    // |r| and the flags of the pose the row keeps
    const float* ar_src = accept ? ar_s : ar_row;
    const unsigned char* inb_src = accept ? inb_s : inb_row;
    const long long step = accept ? 1 : ps;
    int cnt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int i = tid; i < P; i += THREADS) {
      const float v = ar_src[i * step];
      const int in = inb_src[i * step] != 0;
      cnt[7] += in;
      float thr = a.cutoff_th;
#pragma unroll
      for (int j = 0; j < 7; ++j, thr = thr * 2.f) cnt[j] += in && v > thr;
    }
    block_count<THREADS>(cnt, 0u, redi, sh.rep_counts);
    if (tid == 0) {
      // _cutoff_rep_of: seven times, double while more than 60 % of the
      // in-bounds points saturate and rep < 50
      const float nf = (float)(sh.rep_counts[7] > 1 ? sh.rep_counts[7] : 1);
      int m = 0;
      float rep = 1.f;
      for (int j = 0; j < 7; ++j) {
        if ((float)sh.rep_counts[m] / nf > (float)0.6 && rep < 50.f) {
          rep = rep * 2.f;
          ++m;
        }
      }
      sh.cutoff2 = a.cutoff_th * rep;
    }
    __syncthreads();
    // _energy_at_cutoff
    const float cut2 = sh.cutoff2;
    const float max_e2 = a.two_huber_th * cut2 - a.huber_th_sq;
    float e2[1] = {0.f};
    for (int i = tid; i < P; i += THREADS) {
      const float v = ar_src[i * step];
      const bool in = inb_src[i * step] != 0;
      const float hw = huber_w(v, th);
      const bool sat = in && v > cut2;
      e2[0] = e2[0] + (in && !sat ? ((hw * v) * v) * (2.f - hw) : (sat ? max_e2 : 0.f));
    }
    block_sum<THREADS>(e2, red, &sh.e2);
  }

  // ---- 5. the rest of the carry, in place (thread 0) ----
  if (tid == 0) {
    a.it[b] = do_rep ? 0 : it1;
    a.total[b] = total1;
    a.lam[b] = do_rep ? (float)0.01 : lam_out;
    a.cutoff[b] = do_rep ? sh.cutoff2 : cutoff;
    a.E_old[b] = do_rep ? sh.e2 : E_out;
    a.n_old[b] = do_rep ? (long long)sh.rep_counts[7] : n_out;
    a.rep_pending[b] = a.rep_pending[b] != 0 && !do_rep;
    a.done[b] = (pass_end && !do_rep) || total1 >= 2 * (long long)a.max_iterations + 2;
  }
}

template <int THREADS>
int launch(const LmArgs& a, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lm_trip_kernel<THREADS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  lm_trip_kernel<THREADS><<<a.n_seq * a.rows_per_seq, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One trip of every row: `args` (host memory) points at the problem and
// the carry (tracker_ops.lm_trip's layout: every operand contiguous but
// |r| and the flags, which come with their strides), the
// launch counter or null, and gives the shapes and settings. A block of
// 128, 256 or 512 threads per row, by P alone.
extern "C" int sdso_lm_trip(const sdso::LmArgs* args, cudaStream_t stream) {
  const LmArgs a = *args;
  const long long rows = (long long)a.n_seq * a.rows_per_seq;
  if (rows <= 0) return 0;
  if (rows > 2147483647LL || a.P <= 0 || a.H < 2 || a.W < 2) return (int)cudaErrorInvalidValue;
  const long long smem = ((long long)a.P * 5 + 15) / 16 * 16;  // |r| and in-bounds
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  if (a.P <= 512) return launch<128>(a, (int)smem, stream);
  if (a.P <= 2048) return launch<256>(a, (int)smem, stream);
  return launch<512>(a, (int)smem, stream);
}
