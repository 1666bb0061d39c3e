// K8: per-voxel symmetric 3x3 eigendecomposition (cyclic Jacobi, 5 sweeps)
// fused with the DT scalar maps FA, MD, AD, RD, azimuth, inclination, RGB.
//
// Replaces unet_bssfp_tpu/ops/pallas/scalar_maps_kernel.py:scalar_maps_planar
// (_kernel). The TPU kernel took the volume relaid out as (6, R, 128) planes
// and gave (9, R, 128) planes back, so its caller transposed and padded on
// both sides. Here the kernel reads the caller's channels-last S + (6,) f32
// tensor as it is (24 bytes per voxel, neighbouring threads on neighbouring
// voxels) and writes the layout ScalarMaps holds: six planes of V voxels
// (fa, md, ad, rd, azimuth, inclination) and rgb as (V, 3). Any V is taken.
//
// What bounds it on an H100: 24 B in and 36 B out per voxel, and about 680
// operations per voxel (15 Jacobi rotations of ~41 each, 45 divisions and
// square roots among them, then the maps), so at 3.35 TB/s and 67 TFLOP/s
// the bytes bound it (28 us for a 96x128x128 volume against 16 us of
// operations). Design: one thread per voxel, the whole iteration in
// registers, no shared memory, no reduction, a fixed trip count (fully
// unrolled). The division and square-root chains are long-latency, so the
// block is small (128 threads) and many blocks are resident.
//
// Numerics: the arithmetic is ops/eig3.py and the plain version in
// ops/kernels/scalar_maps.py op for op, with IEEE division and square root.
// Every product is __fmul_rn, which nvcc never contracts with an add into an
// FMA, so every step rounds where the plain PyTorch version rounds. The
// JAX reference's rules are kept: sign(0) = 0, then theta == 0 gives t = 1
// and apq == 0 gives t = 0 (last wins); scaling multiplies by 1/scale, with
// scale 0 taken as 1; the sorting network swaps on strict >; the first of
// x, y, z whose |.| is the largest leads the eigenvector's sign, and only a
// lead < 0 flips it. Angles use atan2f/acosf (the TPU kernel's polynomial
// atan2 existed only because Mosaic had none).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int N_SWEEPS = 5;
constexpr float SQRT_1_5 = 1.22474487139158904909f;
constexpr float RAD2DEG = 57.2957795130823208768f;  // 180 / pi

struct Rotation {
  float c, s, t;
};

// eig3.py:_jacobi_rotation
__device__ __forceinline__ Rotation jacobi_rotation(float app, float aqq, float apq) {
  const float safe_apq = apq == 0.0f ? 1.0f : apq;
  const float theta = (aqq - app) / __fmul_rn(2.0f, safe_apq);
  const float sgn = theta > 0.0f ? 1.0f : (theta < 0.0f ? -1.0f : 0.0f);
  float t = sgn / (fabsf(theta) + sqrtf(__fmul_rn(theta, theta) + 1.0f));
  if (theta == 0.0f) t = 1.0f;
  if (apq == 0.0f) t = 0.0f;
  const float c = 1.0f / sqrtf(__fmul_rn(t, t) + 1.0f);
  return {c, __fmul_rn(t, c), t};
}

// V <- V @ G(p, q, c, s) on the row-major 3x3 v
template <int P, int Q>
__device__ __forceinline__ void rotate_vecs(float (&v)[9], float c, float s) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float vp = v[3 * r + P], vq = v[3 * r + Q];
    v[3 * r + P] = __fmul_rn(c, vp) - __fmul_rn(s, vq);
    v[3 * r + Q] = __fmul_rn(s, vp) + __fmul_rn(c, vq);
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

__global__ void __launch_bounds__(THREADS)
scalar_maps_kernel(const float* __restrict__ d6, float* __restrict__ planes,
                   float* __restrict__ rgb, long long V) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= V) return;
  // 24 B per voxel: three aligned 8-byte loads
  const float2* src = reinterpret_cast<const float2*>(d6 + 6 * i);
  const float2 p0 = src[0], p1 = src[1], p2 = src[2];
  float a00 = p0.x, a01 = p0.y, a02 = p1.x, a11 = p1.y, a12 = p2.x, a22 = p2.y;

  const float scale = fmaxf(fabsf(a00), fmaxf(fabsf(a01), fmaxf(fabsf(a02),
                      fmaxf(fabsf(a11), fmaxf(fabsf(a12), fabsf(a22))))));
  const float inv_scale = scale == 0.0f ? 1.0f : 1.0f / scale;
  a00 = __fmul_rn(a00, inv_scale);
  a01 = __fmul_rn(a01, inv_scale);
  a02 = __fmul_rn(a02, inv_scale);
  a11 = __fmul_rn(a11, inv_scale);
  a12 = __fmul_rn(a12, inv_scale);
  a22 = __fmul_rn(a22, inv_scale);

  float v[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
#pragma unroll
  for (int sweep = 0; sweep < N_SWEEPS; ++sweep) {
    {  // (0, 1)
      const Rotation g = jacobi_rotation(a00, a11, a01);
      const float n00 = a00 - __fmul_rn(g.t, a01), n11 = a11 + __fmul_rn(g.t, a01);
      const float n02 = __fmul_rn(g.c, a02) - __fmul_rn(g.s, a12);
      const float n12 = __fmul_rn(g.s, a02) + __fmul_rn(g.c, a12);
      a00 = n00; a11 = n11; a02 = n02; a12 = n12; a01 = 0.0f;
      rotate_vecs<0, 1>(v, g.c, g.s);
    }
    {  // (0, 2)
      const Rotation g = jacobi_rotation(a00, a22, a02);
      const float n00 = a00 - __fmul_rn(g.t, a02), n22 = a22 + __fmul_rn(g.t, a02);
      const float n01 = __fmul_rn(g.c, a01) - __fmul_rn(g.s, a12);
      const float n12 = __fmul_rn(g.s, a01) + __fmul_rn(g.c, a12);
      a00 = n00; a22 = n22; a01 = n01; a12 = n12; a02 = 0.0f;
      rotate_vecs<0, 2>(v, g.c, g.s);
    }
    {  // (1, 2)
      const Rotation g = jacobi_rotation(a11, a22, a12);
      const float n11 = a11 - __fmul_rn(g.t, a12), n22 = a22 + __fmul_rn(g.t, a12);
      const float n01 = __fmul_rn(g.c, a01) - __fmul_rn(g.s, a02);
      const float n02 = __fmul_rn(g.s, a01) + __fmul_rn(g.c, a02);
      a11 = n11; a22 = n22; a01 = n01; a02 = n02; a12 = 0.0f;
      rotate_vecs<1, 2>(v, g.c, g.s);
    }
  }

  // eigenvalues, sorted ascending by the network (0,1), (1,2), (0,1); the
  // column index follows its eigenvalue
  float w0 = __fmul_rn(a00, scale), w1 = __fmul_rn(a11, scale), w2 = __fmul_rn(a22, scale);
  int c0 = 0, c1 = 1, c2 = 2;
  cswap(w0, w1, c0, c1);
  cswap(w1, w2, c1, c2);
  cswap(w0, w1, c0, c1);

  // the principal eigenvector (column c2), selected without indexing v
  float vx = c2 == 0 ? v[0] : (c2 == 1 ? v[1] : v[2]);
  float vy = c2 == 0 ? v[3] : (c2 == 1 ? v[4] : v[5]);
  float vz = c2 == 0 ? v[6] : (c2 == 1 ? v[7] : v[8]);
  const float ax = fabsf(vx), ay = fabsf(vy), az = fabsf(vz);
  const float amax = fmaxf(fmaxf(ax, ay), az);
  const float lead = ax == amax ? vx : (ay == amax ? vy : vz);
  const float sgn = lead < 0.0f ? -1.0f : 1.0f;
  vx = __fmul_rn(vx, sgn);
  vy = __fmul_rn(vy, sgn);
  vz = __fmul_rn(vz, sgn);

  const float ad = w2;
  const float rd = (w0 + w1) / 2.0f;
  const float md = (w0 + w1 + w2) / 3.0f;
  const float e0 = w0 - md, e1 = w1 - md, e2 = w2 - md;
  const float var = sqrtf(__fmul_rn(e0, e0) + __fmul_rn(e1, e1) + __fmul_rn(e2, e2));
  const float norm = sqrtf(__fmul_rn(w0, w0) + __fmul_rn(w1, w1) + __fmul_rn(w2, w2));
  const float fa = __fmul_rn(SQRT_1_5, var) / (norm == 0.0f ? 1.0f : norm);

  const float azimuth = __fmul_rn(RAD2DEG, atan2f(vy, vx));
  const float r = sqrtf(__fmul_rn(vx, vx) + __fmul_rn(vy, vy) + __fmul_rn(vz, vz));
  float cosi = vz / (r == 0.0f ? 1.0f : r);
  cosi = cosi < -1.0f ? -1.0f : (cosi > 1.0f ? 1.0f : cosi);
  const float inclination = __fmul_rn(RAD2DEG, acosf(cosi));

  planes[i] = fa;
  planes[V + i] = md;
  planes[2 * V + i] = ad;
  planes[3 * V + i] = rd;
  planes[4 * V + i] = azimuth;
  planes[5 * V + i] = inclination;
  rgb[3 * i] = __fmul_rn(fa, ax);
  rgb[3 * i + 1] = __fmul_rn(fa, ay);
  rgb[3 * i + 2] = __fmul_rn(fa, az);
}

}  // namespace

extern "C" {

// d6: (V, 6) f32 contiguous, 8-byte aligned; planes: (6, V) f32; rgb: (V, 3)
// f32. Returns the cudaError_t of the launch.
int scalar_maps(const void* d6, void* planes, void* rgb, long long V, void* stream) {
  if (V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (V + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  scalar_maps_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d6), static_cast<float*>(planes),
      static_cast<float*>(rgb), V);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
