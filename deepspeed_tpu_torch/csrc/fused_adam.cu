// Fused AdamW and LAMB over a list of tensors in one launch, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernels of deepspeed_tpu/ops/fused_adam.py:
//  - _adam_kernel (fused_adamw_flat / fused_adamw_tree): m and v updated,
//    the bias-corrected update m^ / (sqrt(v^) + eps), decoupled weight decay,
//    p, m and v written, on a flat f32 shard with f32 or bf16 grads;
//  - _lamb_stage1_kernel (fused_lamb_flat) and the trust ratio and apply
//    that the JAX function computes outside its kernel: the direction
//    u = m^ / (sqrt(v^) + eps) + wd * p, the per-tensor ratio ||p|| / ||u||
//    (1 when either norm is 0, optionally clamped), p - lr * trust * u.
// The TPU kernels ran one pallas_call per leaf over 2D tiles; here one
// launch walks every leaf of the list, in the manner of the reference's
// multi_tensor_apply: a by-value table of pointers, sizes and per-leaf
// weight decays (the decay mask) goes in the kernel's parameters, so the
// launch needs no device copy and no host sync.
//
// What bounds it on the card: HBM bytes. AdamW reads p, g, m, v and writes
// p, m, v once (28 B a parameter with f32 grads) and does ~15 flops a
// parameter. LAMB needs the norms of the whole tensor before any p can be
// written, so it takes two launches: stage 1 reads p, g, m, v, writes m, v
// and each block's partial sums of p^2 and u^2; stage 2 sums each tensor's
// partials, forms the trust ratio, recomputes u from the new m, v and p
// (bit for bit the u of stage 1: the same operations on the same values)
// and writes p. That is 40 B a parameter against the 28 B bound; writing u
// in stage 1 and reading it in stage 2 moves 40 B too and needs a
// parameter-sized buffer, so u is recomputed.
//
// The design, simple first:
//  - the grid is one block per chunk of kChunk elements of some tensor;
//    a block finds its tensor in the table's prefix sums of chunks;
//  - a tensor whose p, g, m and v are all 16-byte aligned (g: 4 elements)
//    is read and written as float4 (4 bf16/f16 grads as 8 bytes), kILP
//    vectors in flight a thread, with a scalar tail for the last n % 4
//    elements; any other tensor (an unaligned view) goes element by element;
//  - the arithmetic is f32 with explicit round-to-nearest operations
//    (no contraction into FMAs), in the order of the plain PyTorch version,
//    so the AdamW kernel and the plain version on the card agree bit for
//    bit;
//  - LAMB's partial sums are doubles, reduced in a fixed order (per thread,
//    a shuffle tree per warp, the warps in order; stage 2 sums a tensor's
//    partials the same way), with no atomics: a run repeats bit for bit.
// What it does not do yet: a persistent grid, TMA, fusing the gradient
// clipping and unscaling passes that run before it.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTensors = 48;       // leaves a launch takes (the table is ~2.6 KB)
constexpr int kThreads = 256;
constexpr int kILP = 4;               // float4 vectors in flight a thread
constexpr long long kChunk = 65536;   // elements a block updates (a multiple of 4)

enum Mode { kNoDecay = 0, kDecoupled = 1, kL2 = 2 };

struct Table {
  float* p[kMaxTensors];
  const void* g[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  long long n[kMaxTensors];
  float wd[kMaxTensors];
  int vec[kMaxTensors];                // 1: every operand 16-byte aligned
  int chunk_start[kMaxTensors + 1];    // prefix sums of the tensors' chunks
};

struct Scalars {
  float lr, b1, b2, one_minus_b1, one_minus_b2, eps, bc1, bc2;
  float min_trust, max_trust;  // LAMB's clamp; [0, inf] is none
  int mode;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// 4 grads at g (16-byte aligned for f32, 8-byte for 16-bit types)
template <typename TG>
__device__ __forceinline__ void load4(const TG* g, float (&x)[4]) {
  if constexpr (sizeof(TG) == 4) {
    float4 t = *reinterpret_cast<const float4*>(g);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    uint2 buf = *reinterpret_cast<const uint2*>(g);
    const TG* t = reinterpret_cast<const TG*>(&buf);
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = to_float(t[j]);
  }
}

__device__ __forceinline__ int find_tensor(const Table& t, int count, int chunk) {
  int ti = 0;
  while (ti + 1 < count && chunk >= t.chunk_start[ti + 1]) ++ti;
  return ti;
}

// m and v updated in place; → the Adam direction m^ / (sqrt(v^) + eps), in
// the plain version's order: mu * b1 + g * (1 - b1); nu * b2 + (g * g) * (1 - b2)
__device__ __forceinline__ float moments(float g, float& m, float& v, const Scalars& s) {
  m = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(g, s.one_minus_b1));
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(__fmul_rn(g, g), s.one_minus_b2));
  return __fdiv_rn(__fdiv_rn(m, s.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps));
}

__device__ __forceinline__ void adam_elem(float& p, float g, float& m, float& v, float wd,
                                          const Scalars& s) {
  if (s.mode == kL2) g = __fadd_rn(g, __fmul_rn(wd, p));
  float u = moments(g, m, v, s);
  if (s.mode == kDecoupled) u = __fadd_rn(u, __fmul_rn(wd, p));
  p = __fadd_rn(p, __fmul_rn(u, -s.lr));
}

// LAMB's direction from the new m, v: m^ / (sqrt(v^) + eps) + wd * p
__device__ __forceinline__ float lamb_dir(float p, float m, float v, float wd, const Scalars& s) {
  float a = __fdiv_rn(__fdiv_rn(m, s.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps));
  return __fadd_rn(a, __fmul_rn(wd, p));
}

// a block's sum of two doubles in a fixed order; every thread gets it
__device__ __forceinline__ double2 block_sum(double a, double b) {
  __shared__ double2 warp_part[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = make_double2(a, b);
  __syncthreads();
  double2 t = make_double2(0.0, 0.0);
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    t.x += warp_part[w].x;
    t.y += warp_part[w].y;
  }
  __syncthreads();
  return t;
}

template <typename TG>
__global__ void __launch_bounds__(kThreads) adam_kernel(Table t, int count, Scalars s) {
  const int chunk = blockIdx.x;
  const int ti = find_tensor(t, count, chunk);
  const long long n = t.n[ti];
  const long long begin = (long long)(chunk - t.chunk_start[ti]) * kChunk;
  const long long end = begin + kChunk < n ? begin + kChunk : n;
  float* __restrict__ P = t.p[ti];
  const TG* __restrict__ G = reinterpret_cast<const TG*>(t.g[ti]);
  float* __restrict__ M = t.m[ti];
  float* __restrict__ V = t.v[ti];
  const float wd = t.wd[ti];
  long long i0 = begin;  // first element of the scalar part
  if (t.vec[ti]) {
    const long long nvec = (end - begin) / 4;
    for (long long j0 = threadIdx.x; j0 < nvec; j0 += (long long)kThreads * kILP) {
      float4 p[kILP], m[kILP], v[kILP];
      float g[kILP][4];
#pragma unroll
      for (int u = 0; u < kILP; ++u) {
        const long long e = begin + 4 * (j0 + (long long)u * kThreads);
        if (j0 + (long long)u * kThreads < nvec) {
          p[u] = *reinterpret_cast<const float4*>(P + e);
          m[u] = *reinterpret_cast<const float4*>(M + e);
          v[u] = *reinterpret_cast<const float4*>(V + e);
          load4<TG>(G + e, g[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kILP; ++u) {
        const long long e = begin + 4 * (j0 + (long long)u * kThreads);
        if (j0 + (long long)u * kThreads < nvec) {
          adam_elem(p[u].x, g[u][0], m[u].x, v[u].x, wd, s);
          adam_elem(p[u].y, g[u][1], m[u].y, v[u].y, wd, s);
          adam_elem(p[u].z, g[u][2], m[u].z, v[u].z, wd, s);
          adam_elem(p[u].w, g[u][3], m[u].w, v[u].w, wd, s);
          *reinterpret_cast<float4*>(P + e) = p[u];
          *reinterpret_cast<float4*>(M + e) = m[u];
          *reinterpret_cast<float4*>(V + e) = v[u];
        }
      }
    }
    i0 = begin + 4 * nvec;
  }
  for (long long i = i0 + threadIdx.x; i < end; i += kThreads) {
    float p = P[i], m = M[i], v = V[i];
    adam_elem(p, to_float(G[i]), m, v, wd, s);
    P[i] = p;
    M[i] = m;
    V[i] = v;
  }
}

// stage 1: m, v updated and written; the block's sums of p^2 and u^2 into
// partials[chunk]
template <typename TG>
__global__ void __launch_bounds__(kThreads)
lamb_stage1_kernel(Table t, int count, Scalars s, double2* __restrict__ partials) {
  const int chunk = blockIdx.x;
  const int ti = find_tensor(t, count, chunk);
  const long long n = t.n[ti];
  const long long begin = (long long)(chunk - t.chunk_start[ti]) * kChunk;
  const long long end = begin + kChunk < n ? begin + kChunk : n;
  const float* __restrict__ P = t.p[ti];
  const TG* __restrict__ G = reinterpret_cast<const TG*>(t.g[ti]);
  float* __restrict__ M = t.m[ti];
  float* __restrict__ V = t.v[ti];
  const float wd = t.wd[ti];
  double psq = 0.0, usq = 0.0;
  long long i0 = begin;
  if (t.vec[ti]) {
    const long long nvec = (end - begin) / 4;
    for (long long j0 = threadIdx.x; j0 < nvec; j0 += (long long)kThreads * kILP) {
      float4 p[kILP], m[kILP], v[kILP];
      float g[kILP][4];
#pragma unroll
      for (int u = 0; u < kILP; ++u) {
        const long long e = begin + 4 * (j0 + (long long)u * kThreads);
        if (j0 + (long long)u * kThreads < nvec) {
          p[u] = *reinterpret_cast<const float4*>(P + e);
          m[u] = *reinterpret_cast<const float4*>(M + e);
          v[u] = *reinterpret_cast<const float4*>(V + e);
          load4<TG>(G + e, g[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kILP; ++u) {
        const long long e = begin + 4 * (j0 + (long long)u * kThreads);
        if (j0 + (long long)u * kThreads < nvec) {
          float pa[4] = {p[u].x, p[u].y, p[u].z, p[u].w};
          float ma[4] = {m[u].x, m[u].y, m[u].z, m[u].w};
          float va[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            moments(g[u][j], ma[j], va[j], s);
            const float d = lamb_dir(pa[j], ma[j], va[j], wd, s);
            psq += (double)pa[j] * (double)pa[j];
            usq += (double)d * (double)d;
          }
          *reinterpret_cast<float4*>(M + e) = make_float4(ma[0], ma[1], ma[2], ma[3]);
          *reinterpret_cast<float4*>(V + e) = make_float4(va[0], va[1], va[2], va[3]);
        }
      }
    }
    i0 = begin + 4 * nvec;
  }
  for (long long i = i0 + threadIdx.x; i < end; i += kThreads) {
    const float p = P[i];
    float m = M[i], v = V[i];
    moments(to_float(G[i]), m, v, s);
    const float d = lamb_dir(p, m, v, wd, s);
    psq += (double)p * (double)p;
    usq += (double)d * (double)d;
    M[i] = m;
    V[i] = v;
  }
  const double2 tot = block_sum(psq, usq);
  if (threadIdx.x == 0) partials[chunk] = tot;
}

// stage 2: each block sums its tensor's partials (a fixed order), forms the
// trust ratio and writes p - lr * trust * u
__global__ void __launch_bounds__(kThreads)
lamb_stage2_kernel(Table t, int count, Scalars s, const double2* __restrict__ partials) {
  const int chunk = blockIdx.x;
  const int ti = find_tensor(t, count, chunk);
  double a = 0.0, b = 0.0;
  for (int c = t.chunk_start[ti] + threadIdx.x; c < t.chunk_start[ti + 1]; c += kThreads) {
    a += partials[c].x;
    b += partials[c].y;
  }
  const double2 tot = block_sum(a, b);
  const double pn = sqrt(tot.x), un = sqrt(tot.y);
  float trust = 1.0f;
  if (pn > 0.0 && un > 0.0) trust = fminf(fmaxf((float)(pn / un), s.min_trust), s.max_trust);
  const float neg_lr = -s.lr;

  const long long n = t.n[ti];
  const long long begin = (long long)(chunk - t.chunk_start[ti]) * kChunk;
  const long long end = begin + kChunk < n ? begin + kChunk : n;
  float* __restrict__ P = t.p[ti];
  const float* __restrict__ M = t.m[ti];
  const float* __restrict__ V = t.v[ti];
  const float wd = t.wd[ti];
  long long i0 = begin;
  if (t.vec[ti]) {
    const long long nvec = (end - begin) / 4;
    for (long long j0 = threadIdx.x; j0 < nvec; j0 += (long long)kThreads * kILP) {
      float4 p[kILP], m[kILP], v[kILP];
#pragma unroll
      for (int u = 0; u < kILP; ++u) {
        const long long e = begin + 4 * (j0 + (long long)u * kThreads);
        if (j0 + (long long)u * kThreads < nvec) {
          p[u] = *reinterpret_cast<const float4*>(P + e);
          m[u] = *reinterpret_cast<const float4*>(M + e);
          v[u] = *reinterpret_cast<const float4*>(V + e);
        }
      }
#pragma unroll
      for (int u = 0; u < kILP; ++u) {
        const long long e = begin + 4 * (j0 + (long long)u * kThreads);
        if (j0 + (long long)u * kThreads < nvec) {
          float4 r;
          r.x = __fadd_rn(p[u].x, __fmul_rn(__fmul_rn(lamb_dir(p[u].x, m[u].x, v[u].x, wd, s), trust), neg_lr));
          r.y = __fadd_rn(p[u].y, __fmul_rn(__fmul_rn(lamb_dir(p[u].y, m[u].y, v[u].y, wd, s), trust), neg_lr));
          r.z = __fadd_rn(p[u].z, __fmul_rn(__fmul_rn(lamb_dir(p[u].z, m[u].z, v[u].z, wd, s), trust), neg_lr));
          r.w = __fadd_rn(p[u].w, __fmul_rn(__fmul_rn(lamb_dir(p[u].w, m[u].w, v[u].w, wd, s), trust), neg_lr));
          *reinterpret_cast<float4*>(P + e) = r;
        }
      }
    }
    i0 = begin + 4 * nvec;
  }
  for (long long i = i0 + threadIdx.x; i < end; i += kThreads) {
    const float p = P[i];
    P[i] = __fadd_rn(p, __fmul_rn(__fmul_rn(lamb_dir(p, M[i], V[i], wd, s), trust), neg_lr));
  }
}

bool aligned(const void* ptr, int bytes) { return ((uintptr_t)ptr % bytes) == 0; }

// Fills the table; → the number of chunks (blocks), or -1 on a bad argument.
int fill_table(Table& t, void* const* p, const void* const* g, void* const* m, void* const* v,
               const long long* n, const float* wd, int count, int g_bytes) {
  if (count < 1 || count > kMaxTensors) return -1;
  long long chunks = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] < 0) return -1;
    t.p[i] = static_cast<float*>(p[i]);
    t.g[i] = g[i];
    t.m[i] = static_cast<float*>(m[i]);
    t.v[i] = static_cast<float*>(v[i]);
    t.n[i] = n[i];
    t.wd[i] = wd[i];
    t.vec[i] = aligned(p[i], 16) && aligned(m[i], 16) && aligned(v[i], 16) &&
               aligned(g[i], 4 * g_bytes);
    t.chunk_start[i] = (int)chunks;
    chunks += (n[i] + kChunk - 1) / kChunk;
    if (chunks > 0x7fffffffLL) return -1;
  }
  t.chunk_start[count] = (int)chunks;
  for (int i = count + 1; i <= kMaxTensors; ++i) t.chunk_start[i] = (int)chunks;
  return (int)chunks;
}

int grad_bytes(int g_dtype) { return g_dtype == 0 ? 4 : (g_dtype == 1 || g_dtype == 2) ? 2 : 0; }

}  // namespace

// AdamW (mode 1: decoupled decay), Adam with L2 decay folded into the
// gradient (mode 2) or without decay (mode 0) over `count` (<= 48) f32
// tensors p, m, v and grads g of dtype g_dtype (0 f32, 1 f16, 2 bf16), n[i]
// elements each (contiguous), weight decay wd[i] per tensor: one launch,
// in place. bc1 / bc2 are 1 - b1^t / 1 - b2^t. Returns the CUDA error of
// the launch (0 on success), cudaErrorInvalidValue for arguments it does
// not take. The launch is asynchronous on `stream`.
extern "C" int fused_adam_launch(void* const* p, const void* const* g, void* const* m,
                                 void* const* v, const long long* n, const float* wd, int count,
                                 int g_dtype, int mode, float lr, float b1, float b2,
                                 float one_minus_b1, float one_minus_b2, float eps, float bc1,
                                 float bc2, void* stream) {
  const int gb = grad_bytes(g_dtype);
  if (gb == 0 || mode < kNoDecay || mode > kL2) return (int)cudaErrorInvalidValue;
  Table t;
  const int chunks = fill_table(t, p, g, m, v, n, wd, count, gb);
  if (chunks < 0) return (int)cudaErrorInvalidValue;
  if (chunks == 0) return 0;
  Scalars s{lr, b1, b2, one_minus_b1, one_minus_b2, eps, bc1, bc2, 0.f, 0.f, mode};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (g_dtype) {
    case 0: adam_kernel<float><<<chunks, kThreads, 0, st>>>(t, count, s); break;
    case 1: adam_kernel<__half><<<chunks, kThreads, 0, st>>>(t, count, s); break;
    default: adam_kernel<__nv_bfloat16><<<chunks, kThreads, 0, st>>>(t, count, s); break;
  }
  return (int)cudaGetLastError();
}

// LAMB (decoupled decay wd[i] per tensor) over the same table: stage 1 and
// stage 2, two launches. `workspace` holds at least `workspace_chunks`
// double2 (one per chunk of kChunk elements of every tensor); the trust
// ratio is clamped to [min_trust, max_trust] ([0, inf] for none). Returns
// the first CUDA error of the two launches (0 on success).
extern "C" int fused_lamb_launch(void* const* p, const void* const* g, void* const* m,
                                 void* const* v, const long long* n, const float* wd, int count,
                                 int g_dtype, float lr, float b1, float b2, float one_minus_b1,
                                 float one_minus_b2, float eps, float bc1, float bc2,
                                 float min_trust, float max_trust, void* workspace,
                                 long long workspace_chunks, void* stream) {
  const int gb = grad_bytes(g_dtype);
  if (gb == 0) return (int)cudaErrorInvalidValue;
  Table t;
  const int chunks = fill_table(t, p, g, m, v, n, wd, count, gb);
  if (chunks < 0 || chunks > workspace_chunks) return (int)cudaErrorInvalidValue;
  if (chunks == 0) return 0;
  Scalars s{lr, b1, b2, one_minus_b1, one_minus_b2, eps, bc1, bc2, min_trust, max_trust,
            kDecoupled};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  double2* part = static_cast<double2*>(workspace);
  switch (g_dtype) {
    case 0: lamb_stage1_kernel<float><<<chunks, kThreads, 0, st>>>(t, count, s, part); break;
    case 1: lamb_stage1_kernel<__half><<<chunks, kThreads, 0, st>>>(t, count, s, part); break;
    default: lamb_stage1_kernel<__nv_bfloat16><<<chunks, kThreads, 0, st>>>(t, count, s, part); break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lamb_stage2_kernel<<<chunks, kThreads, 0, st>>>(t, count, s, part);
  return (int)cudaGetLastError();
}
