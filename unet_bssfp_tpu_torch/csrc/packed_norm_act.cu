// K10: the packed stages' InstanceNorm(affine) → dropout → LeakyReLU or
// PReLU → guard zeroing → cast chain, forward and backward
// (ops/kernels/packed_norm_act.py).
//
// No TPU kernel is replaced: in the JAX package XLA fused this chain after
// each packed conv (unet_bssfp_tpu/models/packed_layers.py); the port ran
// it as 10 full-size ATen passes forward and 18 backward (LeakyReLU, train).
//
// Layout: x is (B, D, C, L), L = H·wdim lanes, the last wguard columns of
// every w-row zero guards. Instance (b, c) is D rows of L contiguous lanes;
// its moments count the data columns alone. The unit of work is a chunk of
// CHUNK consecutive elements of the instance's D·L (row-major over (d, l)),
// K = ceil(D·L / CHUNK) chunks an instance, one CTA a chunk: (16, 32)
// instances of 64·4096 make 16384 CTAs, the whole volume's (1, 32) of
// 96·16384 make 6144. Thread t of a CTA takes vectors t, t + THREADS, ...
// of its chunk (VEC elements each: 16-byte loads where L and the pointers
// allow).
//
// What bounds it on an H100: memory. A few operations an element, so the
// least time is the bytes at 3.35 TB/s. Forward, one C call, two launches:
// - stats: a CTA keeps its chunk in registers, sums the data elements, then
//   the squares about the chunk's own mean: (sum, M2, count) to fixed slots.
// - apply: a CTA merges its instance's K partials in a fixed order (the mean
//   from the sums, then M2 = Σ M2_k + n_k (mean_k − mean)², Chan et al.),
//   applies the affine, the dropout (the f32 draw of ATen's bernoulli_, kept
//   elements times 1/keep), the activation, zeroes the guards and stores in
//   the output dtype; where a gradient is taken, also a 1-byte mask and
//   (chunk 0) the instance's mean and rstd.
// So x is read twice (2 + 2 bytes in bf16), the draw once (4), y written
// (2) and the mask (1). Backward, two launches over x, dy and the mask:
// - sums: per chunk Σg, Σg·x̂ and PReLU's Σ g_a·u over u < 0, g the
//   gradient at the norm's output, recomputed from x, mean, rstd and the
//   mask exactly as the forward computed the activation's input.
// - dx: merges an instance's partials, dx = γ·rstd·(g − Σg/N − x̂·Σg·x̂/N),
//   zero at the guards; the CTA of chunk 0 of sample 0 of each channel sums
//   the channel's partials over the samples for dscale, dbias and dslope.
// Every sum is f32 in an order that depends on the plan alone (no atomics),
// so a rerun repeats bit for bit. At 16 × 64 × 32 × 4096 the apply passes run
// near their bytes' bound and the reduction passes (stats, sums) at about
// half of theirs: short CTAs that stop loading while they reduce. Measured
// on the H100 and dropped: loading a thread's vectors before the apply's
// merge (122–155 registers: forward 0.715 and backward 1.26 ms against
// 0.541 and 0.616); per-thread moments merged by Chan's update in the warp
// trees of the stats pass (its divisions: 0.209 against 0.162 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The plan as ops/kernels/packed_norm_act.py:PlanC lays it out.
struct PackedNormActPlanC {
  int in_bf16, out_bf16, vec, b, d, c, wdim, wguard, k, grid;
  long long lanes;
};

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 32;  // elements a thread holds in the stats pass
constexpr int CHUNK = THREADS * PER_THREAD;  // ops/kernels/packed_norm_act.py:CHUNK
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// flags (ops/kernels/packed_norm_act.py:_PRELU, ...)
constexpr int F_PRELU = 1, F_DROP = 2, F_SAVE = 4, F_DX = 8, F_PARAMS = 16;

struct Args {
  const void* x;
  const float* draw;     // (B, D, C, L) f32, 0 or 1: the forward's dropout draw
  const unsigned char* mask_in;  // the saved mask (backward)
  const float* scale;
  const float* bias;
  const float* slope;    // (C,) PReLU slope, or null: slope_const for every channel
  void* y;
  unsigned char* mask;   // the mask written (forward, F_SAVE with F_DROP)
  float* part;           // [B·C·K][3] partials
  float* mean;           // [B·C]
  float* rstd;           // [B·C]
  const void* dy;
  void* dx;
  float* dscale;
  float* dbias;
  float* dslope;
  long long lanes;
  int b, d, c, wdim, wguard, k, flags;
  float slope_const, inv_keep, eps, inv_n;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    f[0] = to_f(p[0]);
  } else {
    constexpr int N16 = VEC * static_cast<int>(sizeof(T)) / 16;
    uint4 raw[N16];
#pragma unroll
    for (int i = 0; i < N16; ++i) raw[i] = reinterpret_cast<const uint4*>(p)[i];
    const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) f[j] = to_f(e[j]);
  }
}

template <int VEC>
__device__ __forceinline__ void load_mask(const unsigned char* p, unsigned char (&m)[VEC]) {
  if constexpr (VEC == 1) {
    m[0] = p[0];
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const unsigned char* e = reinterpret_cast<const unsigned char*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) m[j] = e[j];
  }
}

template <int VEC>
__device__ __forceinline__ void store_mask(unsigned char* p, const unsigned char (&m)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = m[0];
  } else {
    uint2 raw;
    unsigned char* e = reinterpret_cast<unsigned char*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) e[j] = m[j];
    *reinterpret_cast<uint2*>(p) = raw;
  }
}

// f rounded to nearest even into T, VEC at once
template <int VEC>
__device__ __forceinline__ void store(float* p, const float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = f[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i)
      reinterpret_cast<float4*>(p)[i] = make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2], f[4 * i + 3]);
  }
}
template <int VEC>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&f)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = __float2bfloat16_rn(f[0]);
  } else {
    uint4 raw;
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC / 2; ++j) e[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// Lane 0 gets the warp's sum, in a fixed tree order.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

// Every thread gets the CTA's sums: each warp's tree, then the warps in
// order. Safe to call again right after.
template <int NQ>
__device__ __forceinline__ void block_sum(float (&q)[NQ]) {
  __shared__ float per_warp[WARPS][NQ];
  __shared__ float total[NQ];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NQ; ++i) q[i] = warp_sum(q[i]);
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) per_warp[warp][i] = q[i];
  }
  __syncthreads();
  if (threadIdx.x < NQ) {
    float t = 0.f;
    for (int w = 0; w < WARPS; ++w) t += per_warp[w][threadIdx.x];
    total[threadIdx.x] = t;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NQ; ++i) q[i] = total[i];
}

// Sum of the n values p[i·3 + q] (i < n) in a fixed order: lane-strided
// runs, then a warp's tree; every lane of the warp gets it.
__device__ __forceinline__ float warp_sum_slots(const float* p, int n, int q) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int i = lane; i < n; i += 32) s += p[3 * i + q];
  return __shfl_sync(FULL, warp_sum(s), 0);
}

struct Chunk {
  int inst, chunk, b, c;
  long long j0, total;
};

__device__ __forceinline__ Chunk chunk_of(const Args& a) {
  Chunk h;
  h.inst = blockIdx.x / a.k;
  h.chunk = blockIdx.x - h.inst * a.k;
  h.b = h.inst / a.c;
  h.c = h.inst - h.b * a.c;
  h.j0 = static_cast<long long>(h.chunk) * CHUNK;
  h.total = static_cast<long long>(a.d) * a.lanes;
  return h;
}

// Element offset of instance element jj (a vector never crosses a row: VEC
// divides L), and its lane.
__device__ __forceinline__ long long offset_of(const Args& a, const Chunk& h, long long jj,
                                               long long& lane) {
  const long long dd = jj / a.lanes;
  lane = jj - dd * a.lanes;
  return ((static_cast<long long>(h.b) * a.d + dd) * a.c + h.c) * a.lanes + lane;
}

__device__ __forceinline__ bool is_guard(const Args& a, long long lane) {
  return a.wguard && static_cast<int>(lane % a.wdim) >= a.wdim - a.wguard;
}

// The activation's input (the dropout's output) and the activation, as
// the forward and both backward passes compute them.
__device__ __forceinline__ float act(float u, float slope, bool prelu) {
  return prelu ? (u >= 0.f ? u : slope * u) : (u > 0.f ? u : u * slope);
}

template <typename IN, int VEC>
__global__ void __launch_bounds__(THREADS) norm_act_kernel_packed_stats(Args a) {
  constexpr int NV = PER_THREAD / VEC;
  const Chunk h = chunk_of(a);
  const IN* x = static_cast<const IN*>(a.x);
  float v[NV][VEC];
  unsigned valid[NV];
  float s = 0.f, n = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    valid[i] = 0;
    const long long jj = h.j0 + static_cast<long long>(i * THREADS + threadIdx.x) * VEC;
    if (jj < h.total) {
      long long lane;
      load<IN, VEC>(x + offset_of(a, h, jj, lane), v[i]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if (!is_guard(a, lane + j)) {
          valid[i] |= 1u << j;
          s += v[i][j];
          n += 1.f;
        }
      }
    }
  }
  float q[2] = {s, n};
  block_sum(q);
  const float mk = q[1] > 0.f ? q[0] / q[1] : 0.f;
  float r[1] = {0.f};
#pragma unroll
  for (int i = 0; i < NV; ++i) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (valid[i] >> j & 1u) {
        const float dv = v[i][j] - mk;
        r[0] = fmaf(dv, dv, r[0]);
      }
    }
  }
  block_sum(r);
  if (threadIdx.x == 0) {
    float* p = a.part + 3 * static_cast<long long>(blockIdx.x);
    p[0] = q[0];
    p[1] = r[0];
    p[2] = q[1];
  }
}

template <typename IN, typename OUT, int VEC>
__global__ void __launch_bounds__(THREADS) norm_act_kernel_packed_apply(Args a) {
  constexpr int NV = PER_THREAD / VEC;
  const Chunk h = chunk_of(a);
  __shared__ float moments[2];
  if (threadIdx.x < 32) {
    const float* p = a.part + 3 * static_cast<long long>(h.inst) * a.k;
    const float s = warp_sum_slots(p, a.k, 0), n = warp_sum_slots(p, a.k, 2);
    const float mean = s / n;
    float m2 = 0.f;
    for (int i = threadIdx.x; i < a.k; i += 32) {
      const float nk = p[3 * i + 2];
      if (nk > 0.f) {
        const float dm = p[3 * i] / nk - mean;
        m2 += p[3 * i + 1] + nk * dm * dm;
      }
    }
    m2 = warp_sum(m2);
    if (threadIdx.x == 0) {
      moments[0] = mean;
      moments[1] = rsqrtf(m2 / n + a.eps);
    }
  }
  __syncthreads();
  const float mean = moments[0], rstd = moments[1];
  const bool save = a.flags & F_SAVE, drop = a.flags & F_DROP, prelu = a.flags & F_PRELU;
  if (save && h.chunk == 0 && threadIdx.x == 0) {
    a.mean[h.inst] = mean;
    a.rstd[h.inst] = rstd;
  }
  const float mul = rstd * a.scale[h.c], bb = a.bias[h.c];
  const float slope = a.slope ? a.slope[h.c] : a.slope_const;
  const IN* x = static_cast<const IN*>(a.x);
  OUT* y = static_cast<OUT*>(a.y);
#pragma unroll 4
  for (int i = 0; i < NV; ++i) {
    const long long jj = h.j0 + static_cast<long long>(i * THREADS + threadIdx.x) * VEC;
    if (jj >= h.total) break;
    long long lane;
    const long long off = offset_of(a, h, jj, lane);
    float xv[VEC], r[VEC], out[VEC];
    unsigned char m[VEC];
    load<IN, VEC>(x + off, xv);
    if (drop) load<float, VEC>(a.draw + off, r);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float z = fmaf(xv[j] - mean, mul, bb);
      const bool kept = !drop || r[j] != 0.f;
      const float u = kept ? z * a.inv_keep : 0.f;
      out[j] = is_guard(a, lane + j) ? 0.f : act(u, slope, prelu);
      m[j] = kept;
    }
    store<VEC>(y + off, out);
    if (save && drop) store_mask<VEC>(a.mask + off, m);
  }
}

// g at the norm's output, and PReLU's slope term g_a·u (u < 0), of a kept
// data element whose output gradient is ga (guards and dropped ones: g = 0).
__device__ __forceinline__ void grad_at_norm(const Args& a, float xc, float mul, float bb,
                                             float slope, bool prelu, float ga, float& g,
                                             float& gslope) {
  const float u = fmaf(xc, mul, bb) * a.inv_keep;
  gslope = prelu && u < 0.f ? ga * u : 0.f;
  const float gu = (prelu ? u >= 0.f : u > 0.f) ? ga : ga * slope;
  g = gu * a.inv_keep;
}

template <typename IN, typename OUT, int VEC>
__global__ void __launch_bounds__(THREADS) norm_act_kernel_packed_bwd_sums(Args a) {
  constexpr int NV = PER_THREAD / VEC;
  const Chunk h = chunk_of(a);
  const float mean = a.mean[h.inst], rstd = a.rstd[h.inst];
  const bool drop = a.flags & F_DROP, prelu = a.flags & F_PRELU;
  const float mul = rstd * a.scale[h.c], bb = a.bias[h.c];
  const float slope = a.slope ? a.slope[h.c] : a.slope_const;
  const IN* x = static_cast<const IN*>(a.x);
  const OUT* dy = static_cast<const OUT*>(a.dy);
  float q[3] = {0.f, 0.f, 0.f};
#pragma unroll 4
  for (int i = 0; i < NV; ++i) {
    const long long jj = h.j0 + static_cast<long long>(i * THREADS + threadIdx.x) * VEC;
    if (jj >= h.total) break;
    long long lane;
    const long long off = offset_of(a, h, jj, lane);
    float xv[VEC], gv[VEC];
    unsigned char m[VEC];
    load<IN, VEC>(x + off, xv);
    load<OUT, VEC>(dy + off, gv);
    if (drop) load_mask<VEC>(a.mask_in + off, m);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (is_guard(a, lane + j) || (drop && !m[j])) continue;
      const float xc = xv[j] - mean;
      float g, gs;
      grad_at_norm(a, xc, mul, bb, slope, prelu, gv[j], g, gs);
      q[0] += g;
      q[1] = fmaf(g, xc * rstd, q[1]);
      q[2] += gs;
    }
  }
  block_sum(q);
  if (threadIdx.x == 0) {
    float* p = a.part + 3 * static_cast<long long>(blockIdx.x);
    p[0] = q[0];
    p[1] = q[1];
    p[2] = q[2];
  }
}

template <typename IN, typename OUT, int VEC>
__global__ void __launch_bounds__(THREADS) norm_act_kernel_packed_bwd_dx(Args a) {
  constexpr int NV = PER_THREAD / VEC;
  const Chunk h = chunk_of(a);
  __shared__ float sums[2];
  const int warp = threadIdx.x >> 5;
  if (warp == 0) {
    const float* p = a.part + 3 * static_cast<long long>(h.inst) * a.k;
    const float sg = warp_sum_slots(p, a.k, 0), sgx = warp_sum_slots(p, a.k, 1);
    if (threadIdx.x == 0) {
      sums[0] = sg * a.inv_n;
      sums[1] = sgx * a.inv_n;
    }
  } else if (warp == 1 && (a.flags & F_PARAMS) && h.b == 0 && h.chunk == 0) {
    // the channel's partials over every (sample, chunk), sample-major
    float s[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float t = 0.f;
      for (int i = threadIdx.x - 32; i < a.b * a.k; i += 32) {
        const int bb = i / a.k, kk = i - bb * a.k;
        t += a.part[3 * ((static_cast<long long>(bb) * a.c + h.c) * a.k + kk) + q];
      }
      s[q] = warp_sum(t);
    }
    if (threadIdx.x == 32) {
      a.dscale[h.c] = s[1];
      a.dbias[h.c] = s[0];
      if (a.dslope) a.dslope[h.c] = s[2];
    }
  }
  __syncthreads();
  if (!(a.flags & F_DX)) return;
  const float c1 = sums[0], c2 = sums[1];
  const float mean = a.mean[h.inst], rstd = a.rstd[h.inst];
  const bool drop = a.flags & F_DROP, prelu = a.flags & F_PRELU;
  const float mul = rstd * a.scale[h.c], bb = a.bias[h.c];
  const float slope = a.slope ? a.slope[h.c] : a.slope_const;
  const IN* x = static_cast<const IN*>(a.x);
  const OUT* dy = static_cast<const OUT*>(a.dy);
  IN* dx = static_cast<IN*>(a.dx);
#pragma unroll 4
  for (int i = 0; i < NV; ++i) {
    const long long jj = h.j0 + static_cast<long long>(i * THREADS + threadIdx.x) * VEC;
    if (jj >= h.total) break;
    long long lane;
    const long long off = offset_of(a, h, jj, lane);
    float xv[VEC], gv[VEC], out[VEC];
    unsigned char m[VEC];
    load<IN, VEC>(x + off, xv);
    load<OUT, VEC>(dy + off, gv);
    if (drop) load_mask<VEC>(a.mask_in + off, m);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float xc = xv[j] - mean;
      float g = 0.f, gs;
      const bool guard = is_guard(a, lane + j);
      if (!guard && (!drop || m[j])) grad_at_norm(a, xc, mul, bb, slope, prelu, gv[j], g, gs);
      out[j] = guard ? 0.f : mul * (g - c1 - xc * rstd * c2);
    }
    store<VEC>(dx + off, out);
  }
}

using Kernel = void (*)(Args);

template <typename IN>
Kernel stats_for(int vec) {
  return vec == 1 ? norm_act_kernel_packed_stats<IN, 1> : norm_act_kernel_packed_stats<IN, 8>;
}

// The kernel of one of the compiled (input, output, vec) instances: bf16 →
// bf16, f32 → f32 and bf16 → f32 (compute_dtype unset), vec 1 or 8.
#define PICK(NAME, IN_BF16, OUT_BF16, VEC)                                        \
  ((IN_BF16) ? ((OUT_BF16) ? ((VEC) == 8 ? NAME<__nv_bfloat16, __nv_bfloat16, 8>   \
                                         : NAME<__nv_bfloat16, __nv_bfloat16, 1>)  \
                           : ((VEC) == 8 ? NAME<__nv_bfloat16, float, 8>           \
                                         : NAME<__nv_bfloat16, float, 1>))         \
             : ((OUT_BF16) ? nullptr                                               \
                           : ((VEC) == 8 ? NAME<float, float, 8> : NAME<float, float, 1>)))

int check_plan(const PackedNormActPlanC* p) {
  if (p->vec != 1 && p->vec != 8) return static_cast<int>(cudaErrorInvalidValue);
  if (p->b <= 0 || p->d <= 0 || p->c <= 0 || p->lanes <= 0 || p->k <= 0 || p->wdim <= 0 ||
      p->wguard < 0 || p->wguard >= p->wdim || p->lanes % p->wdim || p->lanes % p->vec ||
      p->grid != p->b * p->c * p->k ||
      static_cast<long long>(p->k) * CHUNK < static_cast<long long>(p->d) * p->lanes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!p->in_bf16 && p->out_bf16) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

Args args_of(const PackedNormActPlanC* p, const void* scale, const void* bias, const void* slope,
             float slope_const, float inv_keep, float eps, int flags, void* part, void* mean,
             void* rstd) {
  Args a = {};
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.slope = static_cast<const float*>(slope);
  a.part = static_cast<float*>(part);
  a.mean = static_cast<float*>(mean);
  a.rstd = static_cast<float*>(rstd);
  a.lanes = p->lanes;
  a.b = p->b;
  a.d = p->d;
  a.c = p->c;
  a.wdim = p->wdim;
  a.wguard = p->wguard;
  a.k = p->k;
  a.flags = flags;
  a.slope_const = slope_const;
  a.inv_keep = inv_keep;
  a.eps = eps;
  return a;
}

}  // namespace

extern "C" {

// Forward: x (B, D, C, L) in bf16 or f32; draw: the f32 dropout draw of the
// same shape (flags F_DROP) or null; scale, bias, slope (or null): (C,)
// f32; y: (B, D, C, L) in the output dtype; with F_SAVE, mask (uint8, where
// F_DROP), mean and rstd (B·C f32) are written for the backward; part:
// 3·grid f32 of scratch. Returns the launches' cudaError_t.
int packed_norm_act_fwd(const PackedNormActPlanC* plan, const void* x, const void* draw,
                        const void* scale, const void* bias, const void* slope, float slope_const,
                        float inv_keep, float eps, int flags, void* y, void* mask, void* part,
                        void* mean, void* rstd, void* stream) {
  int rc = check_plan(plan);
  if (rc) return rc;
  Kernel apply = PICK(norm_act_kernel_packed_apply, plan->in_bf16, plan->out_bf16, plan->vec);
  Kernel stats = plan->in_bf16 ? stats_for<__nv_bfloat16>(plan->vec) : stats_for<float>(plan->vec);
  if (apply == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Args a = args_of(plan, scale, bias, slope, slope_const, inv_keep, eps, flags, part, mean, rstd);
  a.x = x;
  a.draw = static_cast<const float*>(draw);
  a.y = y;
  a.mask = static_cast<unsigned char*>(mask);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  stats<<<plan->grid, THREADS, 0, s>>>(a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  apply<<<plan->grid, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Backward: dy in the output dtype; mask, mean and rstd as the forward saved
// them; dx (F_DX) in x's dtype; dscale, dbias, dslope (F_PARAMS; dslope
// null without a slope vector): (C,) f32; part: 3·grid f32 of scratch;
// inv_n: 1 / the data elements of an instance.
int packed_norm_act_bwd(const PackedNormActPlanC* plan, const void* x, const void* dy,
                        const void* mask, const void* scale, const void* bias, const void* slope,
                        float slope_const, float inv_keep, float inv_n, int flags,
                        const void* mean, const void* rstd, void* part, void* dx, void* dscale,
                        void* dbias, void* dslope, void* stream) {
  int rc = check_plan(plan);
  if (rc) return rc;
  Kernel sums = PICK(norm_act_kernel_packed_bwd_sums, plan->in_bf16, plan->out_bf16, plan->vec);
  Kernel apply = PICK(norm_act_kernel_packed_bwd_dx, plan->in_bf16, plan->out_bf16, plan->vec);
  if (sums == nullptr || apply == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Args a = args_of(plan, scale, bias, slope, slope_const, inv_keep, 0.f, flags, part,
                   const_cast<void*>(mean), const_cast<void*>(rstd));
  a.x = x;
  a.dy = dy;
  a.mask_in = static_cast<const unsigned char*>(mask);
  a.dx = dx;
  a.dscale = static_cast<float*>(dscale);
  a.dbias = static_cast<float*>(dbias);
  a.dslope = static_cast<float*>(dslope);
  a.inv_n = inv_n;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  sums<<<plan->grid, THREADS, 0, s>>>(a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc) return rc;
  apply<<<plan->grid, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
