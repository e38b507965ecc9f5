// JAX's threefry2x32 random bits, drawn where they are used, for Hopper
// (sm_90a): GPT-2's dropout and the samplers' uniforms.
//
// The JAX package has no Pallas kernel for this. XLA fuses each
// jax.random draw into whatever consumes it:
//  - deepspeed_tpu/models/gpt2.py:251-256 _dropout:
//    keep = jax.random.bernoulli(rng, 1 - rate, x.shape), then
//    where(keep, x / (1 - rate), 0);
//  - deepspeed_tpu/ops/sampling.py:70 jax.random.categorical, whose
//    gumbel noise is -log(-log(uniform(key, [tiny, 1)))).
// In eager PyTorch the same draw is a chain of ~120 int64 elementwise
// launches, each moving the whole shape, so the draw gets one kernel here.
//
// Two entries over one device function, threefry_bits:
//  - threefry_dropout: y[i] = keep ? x[i] / c : 0, keep = u < p, where u is
//    the uniform of element i's bits, p = f32(1 - rate) and c the dtype's
//    1 - rate (jax turns the Python float into x's dtype before the
//    division, so bf16 divides by 0.8984375 at rate 0.1). The division is
//    IEEE round-to-nearest in f32 and the quotient rounds to the dtype,
//    which is what a correctly rounded bf16/fp16 division gives (f32 has
//    more than twice their precision plus 2 bits). Its VJP
//    where(keep, dy / c, 0) is the same launch on dy: no mask is stored.
//  - threefry_uniform_rows: out[r, j] = uniform(keys[r], (n,))[j], f32,
//    scaled to [minval, maxval) as jax does with XLA's fused multiply-add.
//    A generate step's draw is R = 1, n = B * V; a serving step's, R = B
//    slots, n = V.
// The bits of element i (jax _threefry_random_bits_partitionable with
// jax_threefry_partitionable = True): the counter pair (hi32(i), lo32(i))
// of the 64-bit flat index through threefry2x32 under the key, then
// x0 ^ x1. The uniform: (bits >> 9) | 0x3F800000 as a float in [1, 2),
// minus 1 (exact).
//
// What bounds it on the card: instructions, not bytes. The hash of element
// i needs 68: 20 rounds of add, rotate (one funnel shift) and xor (60), the
// counter's add (x0's folds into round 1's add as a three-input IADD3), 6
// key-injection adds (the 4 into x0 before a round fold into its add) and
// the final xor. Dropout adds the keep test, the quotient and the select
// (71), a uniform the mantissa, the subtract, the fma and the max (72).
// At the card's issue ceiling, 128 thread instructions a clock an SM
// (132 SMs x ~1.98 GHz, ~3.35e13/s), 71 take ~2.1e-12 s an element,
// against ~1.2e-12 s for its 4 bytes (bf16 read and written) at 3.35 TB/s.
// ptxas adds the loop, the addressing and the conversions
// (deepspeed_tpu_torch/tools/threefry_sass.py counts what it emits). So
// the hash is the work, and the
// design keeps it lean: the key words and the constants arrive by value
// (no loads), a rotate is one __funnelshift_l, one thread per element (a
// grid-stride loop past 8448 blocks) with 64-bit indexing, no shared
// memory.
// What it does not do yet: draw several elements a thread from one
// counter's pair of outputs (jax uses x0 ^ x1 for one element, so that
// cannot halve the hash), vector loads of x.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32 (jax _src/prng.py _threefry2x32_lowering) of the counter
// pair (hi32(i), lo32(i)), returned as x0 ^ x1
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint64_t i) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = static_cast<uint32_t>(i >> 32) + k0;
  uint32_t x1 = static_cast<uint32_t>(i) + k1;
#define TF_ROUND(r) x0 += x1; x1 = rotl(x1, r); x1 ^= x0;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef TF_ROUND
  return x0 ^ x1;
}

// f32 in [0, 1) from 32 random bits: the top 23 as the mantissa of [1, 2)
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n, uint32_t k0,
               uint32_t k1, float p, float c) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float u = unit_float(threefry_bits(k0, k1, static_cast<uint64_t>(i)));
    const float q = __fdiv_rn(to_float(x[i]), c);
    y[i] = from_float<T>(u < p ? q : 0.0f);
  }
}

__global__ void __launch_bounds__(kThreads)
uniform_rows_kernel(const uint32_t* __restrict__ keys, float* __restrict__ out, long long n,
                    float minval, float span) {
  const int r = blockIdx.y;
  const uint32_t k0 = keys[2 * r], k1 = keys[2 * r + 1];
  float* row = out + static_cast<long long>(r) * n;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; j < n;
       j += stride) {
    const float f = unit_float(threefry_bits(k0, k1, static_cast<uint64_t>(j)));
    row[j] = fmaxf(minval, __fmaf_rn(f, span, minval));
  }
}

// enough blocks to fill the card several times over; each thread strides
long long grid_for(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 64;
  return want < 1 ? 1 : (want > cap ? cap : want);
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16
extern "C" int threefry_dropout_launch(const void* x, void* y, long long n, unsigned int k0,
                                       unsigned int k1, float p, float c, int dtype,
                                       void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>(grid_for(n)));
  switch (dtype) {
    case 0:
      dropout_kernel<float><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<float*>(y), n, k0, k1, p, c);
      break;
    case 1:
      dropout_kernel<__half><<<grid, kThreads, 0, s>>>(
          static_cast<const __half*>(x), static_cast<__half*>(y), n, k0, k1, p, c);
      break;
    case 2:
      dropout_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n, k0, k1, p,
          c);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// keys: [R, 2] uint32 on the device; out: [R, n] f32
extern "C" int threefry_uniform_rows_launch(const void* keys, void* out, int rows, long long n,
                                            float minval, float span, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>(grid_for(n)), static_cast<unsigned int>(rows));
  uniform_rows_kernel<<<grid, kThreads, 0, s>>>(static_cast<const uint32_t*>(keys),
                                                static_cast<float*>(out), n, minval, span);
  return static_cast<int>(cudaGetLastError());
}
