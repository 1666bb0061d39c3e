// K8: per-voxel symmetric 3x3 eigendecomposition (cyclic Jacobi, 5 sweeps)
// fused with the DT scalar maps FA, MD, AD, RD, azimuth, inclination, RGB.
//
// Replaces unet_bssfp_tpu/ops/pallas/scalar_maps_kernel.py:scalar_maps_planar
// (_kernel). The TPU kernel took the volume relaid out as (6, R, 128) planes
// and gave (9, R, 128) planes back, so its caller transposed and padded on
// both sides. Here the kernel reads the caller's channels-last S + (6,) f32
// tensor as it is (24 bytes per voxel) and writes the layout ScalarMaps
// holds: six planes of V voxels (fa, md, ad, rd, azimuth, inclination) and
// rgb as (V, 3). Any V is taken.
//
// What bounds it on an H100: not the bytes (24 B in and 36 B out per voxel)
// but the special-function unit and the length of each voxel's chain. 15
// Jacobi rotations each hold two IEEE divisions (one a correctly rounded
// reciprocal), a square root and a reciprocal square root, each at least one
// MUFU instruction (16 per clock per SM), and each rotation waits on the one
// before it. Design: one voxel a thread (two or four interleaved voxels a
// thread took more registers, fewer resident warps, and ran 1.03x and
// 1.3x as long: PERF.md, F2), no shared memory, no reduction, a fixed trip
// count (the three rotations unrolled, the five sweeps a loop, which
// measured as fast or faster than unrolling them and fetches a fifth of the
// code). Voxel blockIdx.x * THREADS + threadIdx.x, so the loads and stores
// are coalesced across the warp; voxels past V are computed on voxel V - 1
// and not stored (no branch around the chain).
//
// Numerics: the arithmetic is ops/eig3.py and the plain version in
// ops/kernels/scalar_maps.py step for step, with correctly rounded division
// and square root, but a*b + c may contract into one FMA and
// 1/sqrt(t^2 + 1) is one correctly rounded reciprocal square root
// (__frsqrt_rn): both round fewer times than the plain version, so the two
// are no longer bit-equal; they stay within the bound two f32
// implementations obey (ops/scalar_maps_check.py). No approximate
// intrinsic is used. The JAX reference's rules are kept: sign(0) = 0, then
// theta == 0 gives t = 1 and apq == 0 gives t = 0 (last wins); scaling
// multiplies by 1/scale, with scale 0 taken as 1; the sorting network swaps
// on strict >; the first of x, y, z whose |.| is the largest leads the
// eigenvector's sign, and only a lead < 0 flips it. Angles use
// atan2f/acosf (the TPU kernel's polynomial atan2 existed only because
// Mosaic had none).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int N_SWEEPS = 5;
constexpr float SQRT_1_5 = 1.22474487139158904909f;
constexpr float RAD2DEG = 57.2957795130823208768f;  // 180 / pi

struct Voxel {
  float a00, a01, a02, a11, a12, a22;
  float v[9];
};

// The correctly rounded division, square root and reciprocal take a slow
// path (a called subroutine) for a zero, infinite, huge or denormal operand.
// Where the IEEE result of such a case is known exactly it is selected, and
// the operation runs on a harmless operand instead: the results are those of
// the plain operations, bit for bit.

// a / b for b > 0: a zero dividend gives a itself
__device__ __forceinline__ float div_pos(float a, float b) {
  const float q = (a == 0.0f ? 1.0f : a) / b;
  return a == 0.0f ? a : q;
}

// sqrt(v) for v ≥ 0: a zero gives v itself
__device__ __forceinline__ float sqrt_nonneg(float v) {
  const float r = sqrtf(v == 0.0f ? 1.0f : v);
  return v == 0.0f ? v : r;
}

// eig3.py:_jacobi_rotation on (app, aqq, apq) → (c, s, t). sgn / d with
// sgn in {-1, 0, 1} is sgn times the correctly rounded 1/d: the IEEE
// quotient exactly, for one division less. Two cases skip the division, the
// square root and the reciprocal: aqq − app = 0 (theta = ±0, so t = 1 by
// the rule), and |theta| ≥ 2^64 (a nearly converged pair: |aqq − app| ≥
// 2^64·|2·apq|, an exact test), where theta² + 1 overflows, so sqrt, the sum
// and 1/inf give t = sgn·0.
__device__ __forceinline__ void jacobi_rotation(float app, float aqq, float apq, float& c,
                                                float& s, float& t) {
  const float safe_apq = apq == 0.0f ? 1.0f : apq;
  const float d = aqq - app, den = 2.0f * safe_apq;
  const bool big = fabsf(d) >= 0x1p64f * fabsf(den);
  const bool skip = big || d == 0.0f;
  const float q = (skip ? 1.0f : d) / (skip ? 1.0f : den);
  const float theta = d == 0.0f ? 0.0f : q;
  const float sgn = big ? ((d < 0.0f) != (den < 0.0f) ? -1.0f : 1.0f)
                        : (theta > 0.0f ? 1.0f : (theta < 0.0f ? -1.0f : 0.0f));
  const float th = skip ? 0.0f : theta;
  t = skip ? sgn * 0.0f : sgn * __frcp_rn(fabsf(th) + sqrtf(th * th + 1.0f));
  if (!big && theta == 0.0f) t = 1.0f;
  if (apq == 0.0f) t = 0.0f;
  c = __frsqrt_rn(t * t + 1.0f);
  s = t * c;
}

// V <- V @ G(p, q, c, s) on the row-major 3x3 v
template <int P, int Q>
__device__ __forceinline__ void rotate_vecs(float (&v)[9], float c, float s) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float vp = v[3 * r + P], vq = v[3 * r + Q];
    v[3 * r + P] = c * vp - s * vq;
    v[3 * r + Q] = s * vp + c * vq;
  }
}

// One rotation of the cyclic sweep: annihilate a_pq, update the other two
// off-diagonal entries (named by the pair) and the eigenvectors.
template <int PAIR>
__device__ __forceinline__ void rotate(Voxel& m) {
  float c, s, t;
  if (PAIR == 0) {  // (0, 1)
    jacobi_rotation(m.a00, m.a11, m.a01, c, s, t);
    const float n00 = m.a00 - t * m.a01, n11 = m.a11 + t * m.a01;
    const float n02 = c * m.a02 - s * m.a12, n12 = s * m.a02 + c * m.a12;
    m.a00 = n00; m.a11 = n11; m.a02 = n02; m.a12 = n12; m.a01 = 0.0f;
    rotate_vecs<0, 1>(m.v, c, s);
  } else if (PAIR == 1) {  // (0, 2)
    jacobi_rotation(m.a00, m.a22, m.a02, c, s, t);
    const float n00 = m.a00 - t * m.a02, n22 = m.a22 + t * m.a02;
    const float n01 = c * m.a01 - s * m.a12, n12 = s * m.a01 + c * m.a12;
    m.a00 = n00; m.a22 = n22; m.a01 = n01; m.a12 = n12; m.a02 = 0.0f;
    rotate_vecs<0, 2>(m.v, c, s);
  } else {  // (1, 2)
    jacobi_rotation(m.a11, m.a22, m.a12, c, s, t);
    const float n11 = m.a11 - t * m.a12, n22 = m.a22 + t * m.a12;
    const float n01 = c * m.a01 - s * m.a02, n02 = s * m.a01 + c * m.a02;
    m.a11 = n11; m.a22 = n22; m.a01 = n01; m.a02 = n02; m.a12 = 0.0f;
    rotate_vecs<1, 2>(m.v, c, s);
  }
}

__device__ __forceinline__ void cswap(float& wi, float& wj, int& ci, int& cj) {
  if (wi > wj) {
    const float w = wi;
    wi = wj;
    wj = w;
    const int c = ci;
    ci = cj;
    cj = c;
  }
}

// The maps of one voxel from its rotated matrix, unscaled by `scale`.
__device__ __forceinline__ void maps(const Voxel& m, float scale, long long i, long long V,
                                     float* __restrict__ planes, float* __restrict__ rgb) {
  // eigenvalues, sorted ascending by the network (0,1), (1,2), (0,1); the
  // column index follows its eigenvalue
  float w0 = m.a00 * scale, w1 = m.a11 * scale, w2 = m.a22 * scale;
  int c0 = 0, c1 = 1, c2 = 2;
  cswap(w0, w1, c0, c1);
  cswap(w1, w2, c1, c2);
  cswap(w0, w1, c0, c1);

  // the principal eigenvector (column c2), selected without indexing v
  float vx = c2 == 0 ? m.v[0] : (c2 == 1 ? m.v[1] : m.v[2]);
  float vy = c2 == 0 ? m.v[3] : (c2 == 1 ? m.v[4] : m.v[5]);
  float vz = c2 == 0 ? m.v[6] : (c2 == 1 ? m.v[7] : m.v[8]);
  const float ax = fabsf(vx), ay = fabsf(vy), az = fabsf(vz);
  const float amax = fmaxf(fmaxf(ax, ay), az);
  const float lead = ax == amax ? vx : (ay == amax ? vy : vz);
  const float sgn = lead < 0.0f ? -1.0f : 1.0f;
  vx *= sgn;
  vy *= sgn;
  vz *= sgn;

  const float ad = w2;
  const float rd = (w0 + w1) * 0.5f;
  const float md = div_pos(w0 + w1 + w2, 3.0f);
  const float e0 = w0 - md, e1 = w1 - md, e2 = w2 - md;
  const float var = sqrt_nonneg(e0 * e0 + e1 * e1 + e2 * e2);
  const float norm = sqrt_nonneg(w0 * w0 + w1 * w1 + w2 * w2);
  const float fa = div_pos(SQRT_1_5 * var, norm == 0.0f ? 1.0f : norm);

  const float azimuth = RAD2DEG * atan2f(vy, vx);
  const float r = sqrt_nonneg(vx * vx + vy * vy + vz * vz);
  float cosi = div_pos(vz, r == 0.0f ? 1.0f : r);
  cosi = cosi < -1.0f ? -1.0f : (cosi > 1.0f ? 1.0f : cosi);
  const float inclination = RAD2DEG * acosf(cosi);

  if (i < V) {
    planes[i] = fa;
    planes[V + i] = md;
    planes[2 * V + i] = ad;
    planes[3 * V + i] = rd;
    planes[4 * V + i] = azimuth;
    planes[5 * V + i] = inclination;
    rgb[3 * i] = fa * ax;
    rgb[3 * i + 1] = fa * ay;
    rgb[3 * i + 2] = fa * az;
  }
}

__global__ void __launch_bounds__(THREADS)
scalar_maps_kernel(const float* __restrict__ d6, float* __restrict__ planes,
                   float* __restrict__ rgb, long long V) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  // 24 B per voxel: three aligned 8-byte loads
  const float2* src = reinterpret_cast<const float2*>(d6 + 6 * (i < V ? i : V - 1));
  const float2 p0 = src[0], p1 = src[1], p2 = src[2];
  const float scale = fmaxf(fabsf(p0.x), fmaxf(fabsf(p0.y), fmaxf(fabsf(p1.x),
                      fmaxf(fabsf(p1.y), fmaxf(fabsf(p2.x), fabsf(p2.y))))));
  const float inv_scale = scale == 0.0f ? 1.0f : __frcp_rn(scale);
  Voxel m;
  m.a00 = p0.x * inv_scale;
  m.a01 = p0.y * inv_scale;
  m.a02 = p1.x * inv_scale;
  m.a11 = p1.y * inv_scale;
  m.a12 = p2.x * inv_scale;
  m.a22 = p2.y * inv_scale;
#pragma unroll
  for (int e = 0; e < 9; ++e) m.v[e] = e % 4 == 0 ? 1.0f : 0.0f;
#pragma unroll 1  // the sweep's code once: a fifth of the instructions to fetch
  for (int sweep = 0; sweep < N_SWEEPS; ++sweep) {
    rotate<0>(m);
    rotate<1>(m);
    rotate<2>(m);
  }
  maps(m, scale, i, V, planes, rgb);
}

}  // namespace

extern "C" {

// d6: (V, 6) f32 contiguous, 8-byte aligned; planes: (6, V) f32; rgb: (V, 3)
// f32; `blocks` CTAs of THREADS threads, one voxel each, as
// ops/kernels/scalar_maps.py:scalar_maps_plan sets them. Returns the
// cudaError_t of the launch.
int scalar_maps(const void* d6, void* planes, void* rgb, long long V, long long blocks,
                void* stream) {
  if (V <= 0 || blocks <= 0 || blocks > 0x7fffffffLL || blocks * THREADS < V)
    return static_cast<int>(cudaErrorInvalidValue);
  scalar_maps_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d6), static_cast<float*>(planes), static_cast<float*>(rgb), V);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
