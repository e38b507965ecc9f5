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
// counter's add, 6 key-injection adds and the final xor. At the card's
// issue ceiling, 128 thread instructions a clock an SM (132 SMs x ~1.98
// GHz, ~3.35e13/s), dropout's 71 take ~2.1e-12 s an element, against
// ~1.2e-12 s for its 4 bytes (bf16 read and written) at 3.35 TB/s. But an
// SM runs integer adds, logic and shifts on one pipe of 64 lanes and
// multiply-adds on another of 64: ptxas left to itself put 62 of the 99
// instructions it emitted an element on the integer ALU (IADD3, LOP3, SHF),
// and at 0.0385 ms for [8, 1024, 1024] bf16 that pipe ran at 0.81 of its
// rate (H100 80GB HBM3, 700 W; deepspeed_tpu_torch/tools/threefry_sass.py
// counts what ptxas emits, by pipe). The design:
//  - adds on the FMA pipe: every add of the hash is written as v * one + w
//    with v the value that changes (one = 1 arrives by value, so ptxas can
//    neither fold the product nor hoist it), an IMAD; the ALU keeps the 20
//    funnel-shift rotates, the 20 xors and the few compares and selects;
//  - an integer keep test: u < p with u = (bits >> 9) / 2^23 is bits <=
//    thr, thr = ceil(p 2^23) 2^9 - 1, computed exactly on the host
//    (ops/prng.py keep_threshold);
//  - the quotient: bf16/fp16 multiply by r = f32(1 / c) where the host has
//    proven that rounding x * r to the dtype gives the correctly rounded
//    quotient for every one of the 65,536 inputs at that rate
//    (ops/prng.py reciprocal_is_exact), else and in f32 __fdiv_rn;
//  - work per thread: 8 bf16/fp16 or 4 f32 elements through one 16-byte
//    load and store, with scalar heads and tails for an unaligned start or
//    n not a multiple of the vector (a misaligned view of x whose y is
//    aligned takes the scalar loop throughout); 32-bit indices below 2^31
//    elements (the counter's high word 0), a 64-bit variant above;
//  - keys from a device buffer, for dropout (the two words of a training
//    step's key table slot, which a captured step refills every step) and
//    for uniform_rows (a serving step's per-slot keys); no shared memory.
// ptxas now emits 79 instructions an element in the bf16 dropout's vector
// loop, 44.5 on the ALU (20 SHF, 21 LOP3, the compare and the select) and
// 33.5 on the FMA pipes, and the kernel takes 0.0274 ms at [8, 1024, 1024]
// bf16 (H100 80GB HBM3, 700 W; chip_smoke.py phase 16). Moving rotates to the FMA pipe as
// x * 2^r | umulhi(x, 2^r) (2 to 6 of the 20; ptxas makes each an
// IMAD.WIDE.U32) balanced the counts (ALU 42.5 to 40.5, FMA 35.5 to 37.9)
// but ran 1-7% slower (tools/threefry_sass.py --fma-rotates).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// a key's words, its parity word and the run-time 1 of the IMAD adds
struct Key {
  uint32_t k0, k1, k2, one;
};

__device__ __forceinline__ Key make_key(uint32_t k0, uint32_t k1, uint32_t one) {
  return Key{k0, k1, k0 ^ k1 ^ 0x1BD11BDAu, one};
}

// v + w as v * one + w: an IMAD on the FMA pipe (v the operand that changes)
__device__ __forceinline__ uint32_t madd(uint32_t v, uint32_t w, uint32_t one) {
  return v * one + w;
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32 (jax _src/prng.py _threefry2x32_lowering) of the counter
// pair (hi, lo), returned as x0 ^ x1
__device__ __forceinline__ uint32_t threefry_bits(const Key& k, uint32_t hi, uint32_t lo) {
  const uint32_t one = k.one;
  uint32_t x0 = madd(hi, k.k0, one);
  uint32_t x1 = madd(lo, k.k1, one);
#define TF_ROUND(r) x0 = madd(x1, x0, one); x1 = rotl(x1, r) ^ x0;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 = madd(x0, k.k1, one); x1 = madd(x1, k.k2 + 1u, one);
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 = madd(x0, k.k2, one); x1 = madd(x1, k.k0 + 2u, one);
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 = madd(x0, k.k0, one); x1 = madd(x1, k.k1 + 3u, one);
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 = madd(x0, k.k1, one); x1 = madd(x1, k.k2 + 4u, one);
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 = madd(x0, k.k2, one); x1 = madd(x1, k.k0 + 5u, one);
#undef TF_ROUND
  return x0 ^ x1;
}

// the bits of flat index i (an index type of 32 or 64 bits)
__device__ __forceinline__ uint32_t bits_at(const Key& k, uint32_t i) {
  return threefry_bits(k, 0u, i);
}
__device__ __forceinline__ uint32_t bits_at(const Key& k, unsigned long long i) {
  return threefry_bits(k, static_cast<uint32_t>(i >> 32), static_cast<uint32_t>(i));
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

// the dropout's arguments: the keep threshold, and the quotient's divisor c
// and its reciprocal r (used when MUL)
struct Drop {
  uint32_t thr;
  float c, r;
};

template <typename T, bool MUL>
__device__ __forceinline__ T drop_one(T x, uint32_t bits, const Drop& d) {
  const float xf = to_float(x);
  const float q = MUL ? xf * d.r : __fdiv_rn(xf, d.c);
  return from_float<T>(bits <= d.thr ? q : 0.0f);
}

// The counter of element i of x in the draw: base + i, with base = shard
// * n the element offset of x's slice (0 for a whole draw). Narrow: base +
// n does not carry out of the low word, so hi is base's high word for every
// element and lo = base_lo + i in 32 bits (hi and base_lo are invariant
// over a thread's loop; the add goes into the vector's index). Wide: the
// 64-bit sum, split.
struct NarrowCtr {
  uint32_t hi, lo;
  __device__ __forceinline__ uint32_t bits(const Key& k, uint32_t i) const {
    return threefry_bits(k, hi, lo + i);
  }
  __device__ __forceinline__ uint32_t bits(const Key& k, unsigned long long i) const {
    return threefry_bits(k, hi, lo + static_cast<uint32_t>(i));
  }
};
struct WideCtr {
  unsigned long long base;
  template <typename I>
  __device__ __forceinline__ uint32_t bits(const Key& k, I i) const {
    return bits_at(k, base + static_cast<unsigned long long>(i));
  }
};

// Elements [0, head) and [tail, n) one a thread, then vectors of V = 16 /
// sizeof(T) elements from head, 16-byte aligned in x and y. I: the index
// type (uint32_t below 2^31 elements, unsigned long long above)
template <typename T, bool MUL, typename I, typename C>
__device__ __forceinline__ void drop_range(const T* __restrict__ x, T* __restrict__ y, I n,
                                           I head, I nvec, const Key& k, const C& ctr,
                                           const Drop& d) {
  constexpr int V = 16 / sizeof(T);
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  const I g = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  const I tail = head + nvec * V;
  for (I i = g; i < head; i += stride) y[i] = drop_one<T, MUL>(x[i], ctr.bits(k, i), d);
  for (I i = tail + g; i < n; i += stride) y[i] = drop_one<T, MUL>(x[i], ctr.bits(k, i), d);
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  uint4* yv = reinterpret_cast<uint4*>(y + head);
  for (I v = g; v < nvec; v += stride) {
    const I i0 = head + v * V;
    uint4 raw = xv[v];
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) e[j] = drop_one<T, MUL>(e[j], ctr.bits(k, i0 + j), d);
    yv[v] = raw;
  }
}

// key: the key's two words, then (key_words 4) the shard index s as two
// words (low, high): x is elements [s * n, (s + 1) * n) of the draw, as a
// rank's slice of a batch split over data parallelism
template <typename T, bool MUL, typename I>
__global__ void __launch_bounds__(kThreads)
dropout_kernel(const T* __restrict__ x, T* __restrict__ y, I n, I head, I nvec,
               const uint32_t* __restrict__ key, int key_words, Drop d, uint32_t one) {
  const Key k = make_key(key[0], key[1], one);
  unsigned long long base = 0;
  if (key_words == 4)
    base = ((static_cast<unsigned long long>(key[3]) << 32) | key[2]) *
           static_cast<unsigned long long>(n);
  if (sizeof(I) == 4 && (base & 0xFFFFFFFFull) + static_cast<unsigned long long>(n) <= (1ull << 32)) {
    drop_range<T, MUL, I>(x, y, n, head, nvec, k,
                          NarrowCtr{static_cast<uint32_t>(base >> 32), static_cast<uint32_t>(base)},
                          d);
  } else {
    drop_range<T, MUL, I>(x, y, n, head, nvec, k, WideCtr{base}, d);
  }
}

__device__ __forceinline__ float uniform_one(uint32_t bits, float minval, float span) {
  return fmaxf(minval, __fmaf_rn(unit_float(bits), span, minval));
}

// Row r = blockIdx.y under keys[r]: its head (to a 16-byte boundary of out)
// and tail one a thread, then float4 vectors; I as dropout_kernel's
template <typename I>
__global__ void __launch_bounds__(kThreads)
uniform_rows_kernel(const uint32_t* __restrict__ keys, float* __restrict__ out, I n,
                    float minval, float span, uint32_t one) {
  const int r = blockIdx.y;
  const Key k = make_key(keys[2 * r], keys[2 * r + 1], one);
  float* row = out + static_cast<unsigned long long>(r) * n;
  const I mis = static_cast<I>((reinterpret_cast<uintptr_t>(row) / 4) % 4);
  const I head = mis == 0 ? 0 : (4 - mis < n ? 4 - mis : n);
  const I nvec = (n - head) / 4;
  const I tail = head + nvec * 4;
  const I stride = static_cast<I>(gridDim.x) * kThreads;
  const I g = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  for (I j = g; j < head; j += stride) row[j] = uniform_one(bits_at(k, j), minval, span);
  for (I j = tail + g; j < n; j += stride) row[j] = uniform_one(bits_at(k, j), minval, span);
  float4* rv = reinterpret_cast<float4*>(row + head);
  for (I v = g; v < nvec; v += stride) {
    const I j0 = head + v * 4;
    rv[v] = make_float4(uniform_one(bits_at(k, j0), minval, span),
                        uniform_one(bits_at(k, j0 + 1), minval, span),
                        uniform_one(bits_at(k, j0 + 2), minval, span),
                        uniform_one(bits_at(k, j0 + 3), minval, span));
  }
}

// enough blocks to fill the card several times over; each thread strides
long long grid_for(long long work) {
  const long long want = (work + kThreads - 1) / kThreads;
  const long long cap = 132LL * 64;
  return want < 1 ? 1 : (want > cap ? cap : want);
}

template <typename T, bool MUL>
cudaError_t launch_dropout(const void* x, void* y, long long n, const uint32_t* key,
                           int key_words, const Drop& d, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x), ya = reinterpret_cast<uintptr_t>(y);
  // vectors only where x and y share their offset in 16 bytes
  long long head = n, nvec = 0;
  if ((xa ^ ya) % 16 == 0) {
    head = static_cast<long long>((16 - xa % 16) % 16 / sizeof(T));
    head = head < n ? head : n;
    nvec = (n - head) / V;
  }
  const dim3 grid(static_cast<unsigned int>(grid_for(nvec > 0 ? nvec : n)));
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (n < (1LL << 31)) {
    dropout_kernel<T, MUL, uint32_t><<<grid, kThreads, 0, s>>>(
        xp, yp, static_cast<uint32_t>(n), static_cast<uint32_t>(head),
        static_cast<uint32_t>(nvec), key, key_words, d, 1u);
  } else {
    dropout_kernel<T, MUL, unsigned long long><<<grid, kThreads, 0, s>>>(
        xp, yp, static_cast<unsigned long long>(n), static_cast<unsigned long long>(head),
        static_cast<unsigned long long>(nvec), key, key_words, d, 1u);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16. key: key_words uint32 words on
// the device, the key's two, then (key_words 4) the 64-bit shard index s of
// x's slice of the draw, low word first (element i draws counter s * n +
// i). thr: the keep threshold (keep iff bits <= thr); c: the
// divisor; r: its f32 reciprocal, and mul = 1 when x * r rounds to the
// correctly rounded quotient for every input of the dtype (16-bit dtypes
// only)
extern "C" int threefry_dropout_launch(const void* x, void* y, long long n, const void* key,
                                       unsigned int thr, float c, float r, int mul, int dtype,
                                       int key_words, void* stream) {
  if (n <= 0) return 0;
  if (key == nullptr || (key_words != 2 && key_words != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Drop d{thr, c, r};
  const uint32_t* k = static_cast<const uint32_t*>(key);
  switch (dtype) {
    case 0:
      if (mul) return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(launch_dropout<float, false>(x, y, n, k, key_words, d, s));
    case 1:
      return static_cast<int>(mul ? launch_dropout<__half, true>(x, y, n, k, key_words, d, s)
                                  : launch_dropout<__half, false>(x, y, n, k, key_words, d, s));
    case 2:
      return static_cast<int>(
          mul ? launch_dropout<__nv_bfloat16, true>(x, y, n, k, key_words, d, s)
              : launch_dropout<__nv_bfloat16, false>(x, y, n, k, key_words, d, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// keys: [R, 2] uint32 on the device; out: [R, n] f32
extern "C" int threefry_uniform_rows_launch(const void* keys, void* out, int rows, long long n,
                                            float minval, float span, void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>(grid_for((n + 3) / 4)), static_cast<unsigned int>(rows));
  const uint32_t* kp = static_cast<const uint32_t*>(keys);
  float* op = static_cast<float*>(out);
  if (n < (1LL << 31)) {
    uniform_rows_kernel<uint32_t><<<grid, kThreads, 0, s>>>(kp, op, static_cast<uint32_t>(n),
                                                            minval, span, 1u);
  } else {
    uniform_rows_kernel<unsigned long long><<<grid, kThreads, 0, s>>>(
        kp, op, static_cast<unsigned long long>(n), minval, span, 1u);
  }
  return static_cast<int>(cudaGetLastError());
}
