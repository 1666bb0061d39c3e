// K4: fused InstanceNorm(affine) + LeakyReLU on NDHWC, one cooperative
// launch.
//
// Replaces unet_bssfp_tpu/ops/pallas/fused_norm_act.py:
// fused_instance_norm_leaky_relu (_kernel). Per (n, c): the mean over the S
// spatial rows in f32, the centred second moment sum((x - mean)^2) / S
// (biased, as the reference computes it), then
//   y = leaky_relu((x - mean) * rsqrt(var + eps) * scale + bias)
// cast back to x's dtype (f32 or bf16).
//
// What bounds it on an H100: memory. It does a few operations per element,
// so the least time is one read of x and one write of y at 3.35 TB/s. The
// TPU kernel held one (sample, channel block) volume in VMEM; a Hopper block
// holds at most 227 KB, and blocks cannot hand sums to one another, so:
// - The grid is every CTA the card can hold at once (cooperative launch),
//   and each CTA owns tiles of whole rows of one sample and one channel
//   group (ops/kernels/norm_act.py:norm_plan). Thread (lane, col) of a CTA
//   walks rows lane, lane + lanes, ... of column col: neighbouring threads
//   on neighbouring addresses, one 16-byte vector each where C and the
//   pointers allow.
// - Phase 1 loads a CTA's tiles once, keeps as many rows as fit in dynamic
//   shared memory, sums each channel in f32 and writes the CTA's partials to
//   fixed slots of a workspace. grid.sync().
// - Phase 2 merges the partials of its channels in a fixed order (chunk 0,
//   1, ...) into the mean, sums (x - mean)^2 over the tile it holds (rows
//   that did not fit are read again, mostly from L2), and writes those
//   partials. grid.sync().
// - Phase 3 merges both, applies the affine and the LeakyReLU to the tile
//   (the rows that did not fit first, while L2 still holds them) and writes
//   y.
// So device memory sees one read and one write, apart from the rows that
// did not fit in shared memory. Every sum runs in an order that depends
// only on the plan, so a rerun is bit for bit the same. The stores of y run
// at about half the card's fill rate and take most of phase 3
// (scripts/torch_port_norm_ablation.py). Measured on the H100 and dropped:
// one barrier, each tile centred on its own mean and the tiles merged by
// Chan et al.'s update (the second merge's work moved behind the barrier
// and the kernel spilled); the merge spread over G threads per channel;
// tiles interleaved across CTAs; 1024-thread CTAs (they spill);
// evict-first stores.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// The plan as ops/kernels/norm_act.py:NormPlanC lays it out (outside the
// unnamed namespace: the exported entry point takes it).
struct NormPlanC {
  int bf16, vec, n, c, cg, ncg, cols, lanes, lanes_p2, threads, k, items, grid;
  int smem_rows, smem_bytes, scratch_bytes;
  long long s;
};

namespace {

constexpr int MAX_THREADS = 512;  // ops/kernels/norm_act.py:THREADS and MAX_COLS
constexpr int UNROLL = 4;         // rows in flight per thread (as fast as 8 or faster)
constexpr int MAX_DEVICES = 64;

struct Params {
  const void* x;
  void* y;
  const float* scale;
  const float* bias;
  float* part;  // [2][n * k][c]: the sums, then the centred second moments
  long long s;
  int n, c, cg, ncg, cols, lanes, lanes_p2, k, items, smem_rows, scratch_bytes;
  float slope, eps;
};

template <typename Raw, int VEC>
struct alignas(sizeof(Raw) * VEC) Pack {
  Raw v[VEC];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}
// f → the output's elements, each rounded to nearest even; bf16 in pairs
// (one conversion instruction per two elements)
template <int VEC>
__device__ __forceinline__ void pack(const float (&f)[VEC], Pack<float, VEC>& out) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) out.v[j] = f[j];
}
template <int VEC>
__device__ __forceinline__ void pack(const float (&f)[VEC], Pack<unsigned short, VEC>& out) {
  if constexpr (VEC == 1) {
    out.v[0] = __bfloat16_as_ushort(__float2bfloat16_rn(f[0]));
  } else {
#pragma unroll
    for (int j = 0; j < VEC; j += 2) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(f[j], f[j + 1]);
      out.v[j] = __bfloat16_as_ushort(b.x);
      out.v[j + 1] = __bfloat16_as_ushort(b.y);
    }
  }
}

// One tile: rows [r0, r0 + rows) of sample n, channels [c0, c0 + width).
struct Item {
  long long base;  // element offset of (n, r0, c0)
  int n, chunk, c0, width, rows;
};

__device__ __forceinline__ Item item_of(const Params& p, int it) {
  Item m;
  m.chunk = it % p.k;
  const int g = (it / p.k) % p.ncg;
  m.n = it / (p.k * p.ncg);
  const long long r0 = p.s * m.chunk / p.k;
  m.rows = static_cast<int>(p.s * (m.chunk + 1) / p.k - r0);
  m.c0 = g * p.cg;
  m.width = min(p.cg, p.c - m.c0);
  m.base = (static_cast<long long>(m.n) * p.s + r0) * p.c + m.c0;
  return m;
}

// Sum acc over the CTA's lanes (a tree on shared memory, fixed order) and
// let lane 0 write the group's partials to dst[0 .. width).
template <int VEC>
__device__ __forceinline__ void reduce_lanes(const Params& p, float (&acc)[VEC], float* scratch,
                                             int lane, int col, bool active, float* dst) {
  const int t = threadIdx.x;
  __syncthreads();  // scratch is free
#pragma unroll
  for (int j = 0; j < VEC; ++j) scratch[t * VEC + j] = acc[j];
  __syncthreads();
  for (int st = p.lanes_p2 >> 1; st > 0; st >>= 1) {
    if (lane < st && lane + st < p.lanes) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) scratch[t * VEC + j] += scratch[(t + st * p.cols) * VEC + j];
    }
    __syncthreads();
  }
  if (lane == 0 && active) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[col * VEC + j] = scratch[col * VEC + j];
  }
}

// dst[j] = (sum over chunks 0 .. k-1 of src[(n * k + chunk) * c + c0 + j]) / s,
// for the item's channels and for each of the NSRC sources, in that order.
// The partials were written by other CTAs before the last grid.sync(): read
// them from L2, not L1, MERGE_BATCH chunks of every source at a time (the
// loads unconditional, on a clamped chunk, so that they are all in flight
// together; the adds in order).
constexpr int MERGE_BATCH = 16;

template <int NSRC>
__device__ __forceinline__ void merge(const Params& p, const float* const (&src)[NSRC],
                                      const Item& m, float* const (&dst)[NSRC]) {
  for (int j = threadIdx.x; j < m.width; j += blockDim.x) {
    const long long first = static_cast<long long>(m.n) * p.k * p.c + m.c0 + j;
    float a[NSRC];
#pragma unroll
    for (int q = 0; q < NSRC; ++q) a[q] = 0.0f;
    for (int k0 = 0; k0 < p.k; k0 += MERGE_BATCH) {
      float v[NSRC][MERGE_BATCH];
#pragma unroll
      for (int q = 0; q < NSRC; ++q) {
#pragma unroll
        for (int u = 0; u < MERGE_BATCH; ++u)
          v[q][u] = __ldcg(src[q] + first + static_cast<long long>(min(k0 + u, p.k - 1)) * p.c);
      }
#pragma unroll
      for (int q = 0; q < NSRC; ++q) {
#pragma unroll
        for (int u = 0; u < MERGE_BATCH; ++u)
          if (k0 + u < p.k) a[q] += v[q][u];
      }
    }
#pragma unroll
    for (int q = 0; q < NSRC; ++q) dst[q][j] = a[q] / static_cast<float>(p.s);
  }
}

template <int VEC, typename P>
__device__ __forceinline__ void add_sums(float (&acc)[VEC], P v) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] += to_f(v.v[j]);
}

template <int VEC, typename P>
__device__ __forceinline__ void add_m2(float (&acc)[VEC], P v, const float (&mean)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float d = to_f(v.v[j]) - mean[j];
    acc[j] = __fmaf_rn(d, d, acc[j]);
  }
}

template <int VEC, typename P>
__device__ __forceinline__ P apply(P v, const float (&mean)[VEC], const float (&mul)[VEC],
                                   const float (&add)[VEC], float slope) {
  float f[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    f[j] = __fmaf_rn(to_f(v.v[j]) - mean[j], mul[j], add[j]);
    f[j] = f[j] >= 0.0f ? f[j] : slope * f[j];
  }
  P out;
  pack(f, out);
  return out;
}

// Each phase walks a thread's rows r = lane, lane + lanes, ... of a tile in
// that order, in batches of UNROLL whose loads are issued before any is
// used: rows r < keep from the CTA's shared memory (kept[r * cols]), the
// rest from device memory (g[r * c / VEC]), each part in its own loop, with
// no choice of source inside a batch. The first of the thread's rows at or
// past keep:
__device__ __forceinline__ int first_global(int keep, int lane, int lanes) {
  return keep <= lane ? lane : lane + (keep - lane + lanes - 1) / lanes * lanes;
}

template <typename Raw, int VEC>
__global__ void __launch_bounds__(MAX_THREADS, 1) norm_act_kernel(const Params p) {
  using P = Pack<Raw, VEC>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* scratch = reinterpret_cast<float*>(smem);
  P* store = reinterpret_cast<P*>(smem + p.scratch_bytes);
  const Raw* __restrict__ x = static_cast<const Raw*>(p.x);
  Raw* __restrict__ y = static_cast<Raw*>(p.y);
  const int col = threadIdx.x % p.cols, lane = threadIdx.x / p.cols;
  const int step = UNROLL * p.lanes;
  const long long cvec = p.c / VEC;  // a row, in vectors
  const long long nk = static_cast<long long>(p.n) * p.k;
  float* part_sum = p.part;
  float* part_m2 = p.part + nk * p.c;
  cg::grid_group grid = cg::this_grid();

  // Phase 1: load, keep, sum.
  int slot = 0;  // the current tile's first row in shared memory
  for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
    const Item m = item_of(p, it);
    const bool active = col * VEC < m.width;
    const int keep = max(0, min(p.smem_rows - slot, m.rows));
    P* kept = store + slot * p.cols + col;
    const P* g = reinterpret_cast<const P*>(x + m.base + col * VEC);
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
    if (active) {
      for (int r = lane; r < m.rows; r += step) {
        P v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int rr = r + u * p.lanes;
          if (rr < m.rows) v[u] = g[rr * cvec];
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int rr = r + u * p.lanes;
          if (rr < m.rows) {
            if (rr < keep) kept[rr * p.cols] = v[u];
            add_sums<VEC>(acc, v[u]);
          }
        }
      }
    }
    reduce_lanes<VEC>(p, acc, scratch, lane, col, active,
                      part_sum + (static_cast<long long>(m.n) * p.k + m.chunk) * p.c + m.c0);
    slot += m.rows;
  }
  grid.sync();

  // Phase 2: the mean from the merged sums, then the centred second moment.
  slot = 0;
  for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
    const Item m = item_of(p, it);
    const bool active = col * VEC < m.width;
    const int keep = max(0, min(p.smem_rows - slot, m.rows));
    const P* kept = store + slot * p.cols + col;
    const P* g = reinterpret_cast<const P*>(x + m.base + col * VEC);
    __syncthreads();  // scratch is free
    {
      const float* const src[1] = {part_sum};
      float* const dst[1] = {scratch};
      merge<1>(p, src, m, dst);
    }
    __syncthreads();
    float mean[VEC], acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      mean[j] = active ? scratch[col * VEC + j] : 0.0f;
      acc[j] = 0.0f;
    }
    if (active) {
      for (int r = lane; r < keep; r += step) {
        P v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int rr = r + u * p.lanes;
          if (rr < keep) v[u] = kept[rr * p.cols];
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (r + u * p.lanes < keep) add_m2<VEC>(acc, v[u], mean);
      }
      for (int r = first_global(keep, lane, p.lanes); r < m.rows; r += step) {
        P v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int rr = r + u * p.lanes;
          if (rr < m.rows) v[u] = g[rr * cvec];
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          if (r + u * p.lanes < m.rows) add_m2<VEC>(acc, v[u], mean);
      }
    }
    reduce_lanes<VEC>(p, acc, scratch, lane, col, active,
                      part_m2 + (static_cast<long long>(m.n) * p.k + m.chunk) * p.c + m.c0);
    slot += m.rows;
  }
  grid.sync();

  // Phase 3: mean and variance from the merged partials; affine, LeakyReLU,
  // store.
  slot = 0;
  for (int it = blockIdx.x; it < p.items; it += gridDim.x) {
    const Item m = item_of(p, it);
    const bool active = col * VEC < m.width;
    const int keep = max(0, min(p.smem_rows - slot, m.rows));
    const P* kept = store + slot * p.cols + col;
    const P* g = reinterpret_cast<const P*>(x + m.base + col * VEC);
    P* out = reinterpret_cast<P*>(y + m.base + col * VEC);
    __syncthreads();  // scratch is free
    {
      const float* const src[2] = {part_sum, part_m2};
      float* const dst[2] = {scratch, scratch + p.cg};
      merge<2>(p, src, m, dst);
    }
    __syncthreads();
    if (active) {
      float mean[VEC], mul[VEC], add[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int ch = m.c0 + col * VEC + j;
        mean[j] = scratch[col * VEC + j];
        mul[j] = rsqrtf(scratch[p.cg + col * VEC + j] + p.eps) * p.scale[ch];
        add[j] = p.bias[ch];
      }
      // the rows read again first: the last ones phase 2 read, likely still in L2
      for (int r = first_global(keep, lane, p.lanes); r < m.rows; r += step) {
        P v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int rr = r + u * p.lanes;
          if (rr < m.rows) v[u] = g[rr * cvec];
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int rr = r + u * p.lanes;
          if (rr < m.rows) out[rr * cvec] = apply<VEC>(v[u], mean, mul, add, p.slope);
        }
      }
      for (int r = lane; r < keep; r += step) {
        P v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int rr = r + u * p.lanes;
          if (rr < keep) v[u] = kept[rr * p.cols];
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int rr = r + u * p.lanes;
          if (rr < keep) out[rr * cvec] = apply<VEC>(v[u], mean, mul, add, p.slope);
        }
      }
    }
    slot += m.rows;
  }
}

// The instances: f32 at 1, 2, 4 elements a vector, bf16 at 1, 2, 4, 8.
const void* kernel_for(int bf16, int vec) {
  if (bf16) {
    switch (vec) {
      case 1: return reinterpret_cast<const void*>(&norm_act_kernel<unsigned short, 1>);
      case 2: return reinterpret_cast<const void*>(&norm_act_kernel<unsigned short, 2>);
      case 4: return reinterpret_cast<const void*>(&norm_act_kernel<unsigned short, 4>);
      case 8: return reinterpret_cast<const void*>(&norm_act_kernel<unsigned short, 8>);
      default: return nullptr;
    }
  }
  switch (vec) {
    case 1: return reinterpret_cast<const void*>(&norm_act_kernel<float, 1>);
    case 2: return reinterpret_cast<const void*>(&norm_act_kernel<float, 2>);
    case 4: return reinterpret_cast<const void*>(&norm_act_kernel<float, 4>);
    default: return nullptr;
  }
}

// Allow a kernel the device's whole opt-in shared memory, once per device.
int configure(const void* fn, int bf16, int vec) {
  static bool done[2][9][MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < MAX_DEVICES && done[bf16][vec][dev]) return 0;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < MAX_DEVICES) done[bf16][vec][dev] = true;
  return 0;
}

}  // namespace

extern "C" {

// The current device's SM count, opt-in shared memory per block and whether
// it takes cooperative launches.
int norm_act_device(int* sms, int* smem_optin, int* cooperative) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(cooperative, cudaDevAttrCooperativeLaunch, dev);
  return static_cast<int>(err);
}

// CTAs of the (bf16, vec) instance that one SM holds at once with `threads`
// threads and `smem_bytes` of dynamic shared memory.
int norm_act_blocks_per_sm(int bf16, int vec, int threads, int smem_bytes, int* blocks) {
  const void* fn = kernel_for(bf16, vec);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int rc = configure(fn, bf16, vec);
  if (rc != 0) return rc;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, threads, smem_bytes));
}

// x, y: (n, s, c) contiguous, f32 or bf16 as plan->bf16 says, aligned to
// plan->vec elements; scale, bias: (c,) f32; part: 2 * n * k * c f32 of
// scratch (no initial value needed). Returns the cudaError_t of the launch
// (cudaErrorCooperativeLaunchTooLarge where the grid does not fit at once).
int norm_act(const NormPlanC* plan, const void* x, const void* scale, const void* bias,
             void* y, void* part, float slope, float eps, void* stream) {
  const void* fn = kernel_for(plan->bf16, plan->vec);
  if (fn == nullptr || plan->threads > MAX_THREADS || plan->threads != plan->cols * plan->lanes ||
      plan->items <= 0 || plan->grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rc = configure(fn, plan->bf16, plan->vec);
  if (rc != 0) return rc;
  Params p;
  p.x = x;
  p.y = y;
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.part = static_cast<float*>(part);
  p.s = plan->s;
  p.n = plan->n;
  p.c = plan->c;
  p.cg = plan->cg;
  p.ncg = plan->ncg;
  p.cols = plan->cols;
  p.lanes = plan->lanes;
  p.lanes_p2 = plan->lanes_p2;
  p.k = plan->k;
  p.items = plan->items;
  p.smem_rows = plan->smem_rows;
  p.scratch_bytes = plan->scratch_bytes;
  p.slope = slope;
  p.eps = eps;
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      fn, dim3(plan->grid), dim3(plan->threads), args, plan->smem_bytes,
      static_cast<cudaStream_t>(stream)));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
