// Shared pieces of the flash-attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu) for Hopper (sm_90a).
//
// Layout: q [B, S, H, D], k/v [B, S, KV, D] (H % KV == 0, GQA: q head h
// reads kv head h / (H / KV)), each with explicit batch / sequence / head
// strides in elements and a contiguous last dim, so q, k and v can be
// strided views of the [B, S, 3E] qkv projection. lse and delta are
// [B, H, S] f32.
//
// The precision contract is the JAX package's (deepspeed_tpu/ops/pallas/
// flash_attention.py:84-93): products take storage-dtype operands with an
// f32 accumulator, sm_scale multiplies the f32 scores after the product,
// masked scores are -1e30, the second product of each pass takes its f32
// left operand (p or ds) rounded to the storage dtype.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kMasked = -1e30f;

// shapes, strides (elements) and options of one call
struct Params {
  int B, S, H, KV, rep;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;   // o (backward: delta)
  long long do_sb, do_ss, do_sh;  // dO (backward)
  int causal, window;             // window > 0: keys in (row - window, row]
  float scale;
};

// key `col` is visible to query `row`: both inside the sequence, and under
// causal masking col <= row and (window > 0) col > row - window
__device__ __forceinline__ bool keep(int row, int col, const Params& p) {
  if (row >= p.S || col >= p.S) return false;
  if (!p.causal) return true;
  return col <= row && (p.window <= 0 || col > row - p.window);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// two floats rounded to the 16-bit type, packed low = a (the lower column)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float a, float b);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float a, float b) {
  __half2 v = __floats2half2_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a * b on the tensor cores: one m16n8k16 product, f32 accumulate
template <typename T>
__device__ __forceinline__ void mma16816(float d[4], const uint32_t a[4], const uint32_t b[2]);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float d[4], const uint32_t a[4],
                                                        const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float d[4], const uint32_t a[4],
                                                 const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16-byte global -> shared copy that bypasses registers; valid == false
// zero-fills the 16 bytes (the source is not read)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows row0 .. row0+R-1 of one head (base points at its row 0) into shared
// memory with row stride LD; rows at or past S are zero-filled
template <typename T, int R, int D, int LD, int NT>
__device__ __forceinline__ void load_rows_async(T* sm, const T* base, long long row_stride,
                                                int row0, int S, int tid) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CPR = D / VEC;
  for (int c = tid; c < R * CPR; c += NT) {
    const int r = c / CPR;
    const int col = (c % CPR) * VEC;
    const int gr = row0 + r;
    const bool ok = gr < S;
    cp_async16(sm + r * LD + col, base + (long long)(ok ? gr : 0) * row_stride + col, ok);
  }
}

// ---- m16n8k16 fragments from shared memory (16-bit types) -----------------
// lane = 4 * g + t. A (16x16, row-major X[r][k]): a0 = X[g][2t..], a1 =
// X[g+8][2t..], a2 = X[g][2t+8..], a3 = X[g+8][2t+8..]. B (16x8, B[k][n]):
// b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]. C (16x8): c0,c1 = C[g][2t..],
// c2,c3 = C[g+8][2t..]. Each fragment set is one ldmatrix.x4: four 8x8
// matrices, lane L giving the address of row L % 8 of matrix L / 8 (rows
// are 16-byte aligned: LD is a multiple of 8 elements).

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// A = X[r0 .. r0+15][k0 .. k0+15]
template <typename T, int LD>
__device__ __forceinline__ void load_a(uint32_t a[4], const T* X, int r0, int k0, int lane) {
  const int row = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldsm_x4(a, X + row * LD + k0 + (lane >> 4) * 8);
}

// the B fragments of the n-tiles n0 and n0 + 8 (b[0..1], b[2..3]) for
// B[k][n] = Y[n][k] (Y row-major with n as its row), k = k0 .. k0+15
template <typename T, int LD>
__device__ __forceinline__ void load_b_rows(uint32_t b[4], const T* Y, int n0, int k0, int lane) {
  const int row = n0 + (lane & 7) + (lane >> 4) * 8;
  ldsm_x4(b, Y + row * LD + k0 + ((lane >> 3) & 1) * 8);
}

// the same for B[k][n] = Y[k][n] (Y row-major with k as its row): the
// transposing load
template <typename T, int LD>
__device__ __forceinline__ void load_b_cols(uint32_t b[4], const T* Y, int k0, int n0, int lane) {
  const int row = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  ldsm_x4_trans(b, Y + row * LD + n0 + (lane >> 4) * 8);
}

// every (row, col) of the rectangle rows [r0, r1] x cols [c0, c1] is kept:
// the tile needs no per-element mask
__device__ __forceinline__ bool all_kept(int r0, int r1, int c0, int c1, const Params& p) {
  if (r1 >= p.S || c1 >= p.S) return false;
  if (!p.causal) return true;
  return c1 <= r0 && (p.window <= 0 || c0 > r1 - p.window);
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// the A fragment of k-step kk from two C tiles of a 16 x (16 * n) f32
// product held in registers: the register reuse of p and ds
template <typename T>
__device__ __forceinline__ void a_from_c(uint32_t a[4], const float c0[4], const float c1[4]) {
  a[0] = pack2<T>(c0[0], c0[1]);
  a[1] = pack2<T>(c0[2], c0[3]);
  a[2] = pack2<T>(c1[0], c1[1]);
  a[3] = pack2<T>(c1[2], c1[3]);
}

// reduce over the 4 lanes of a quad (the threads sharing a C row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// fp32 tiles: rows row0 .. row0+R-1 of one head into shared memory with row
// stride LD (16-byte vector reads, rows past S zero)
template <int R, int D, int LD, int NT>
__device__ __forceinline__ void load_rows_f32(float* sm, const float* base, long long row_stride,
                                              int row0, int S, int tid) {
  constexpr int CPR = D / 4;
  for (int c = tid; c < R * CPR; c += NT) {
    const int r = c / CPR;
    const int col = (c % CPR) * 4;
    const int gr = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < S) x = *reinterpret_cast<const float4*>(base + (long long)gr * row_stride + col);
    float* d = sm + r * LD + col;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

// ---- pieces of the TMA + wgmma kernels (forward and backward) ------------

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the max / sum of N registers as a tree (short dependency chains)
template <int N>
__device__ __forceinline__ float tree_max(const float* x) {
  if constexpr (N == 1) {
    return x[0];
  } else {
    return fmaxf(tree_max<N / 2>(x), tree_max<N / 2>(x + N / 2));
  }
}
template <int N>
__device__ __forceinline__ float tree_sum(const float* x) {
  if constexpr (N == 1) {
    return x[0];
  } else {
    return tree_sum<N / 2>(x) + tree_sum<N / 2>(x + N / 2);
  }
}

// an f32 accumulator tile of N columns rounded to T as the A fragments of
// N / 16 k16 steps (n8 tiles 2k and 2k + 1 are step k's)
template <typename T, int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&c)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack2<T>(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = pack2<T>(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack2<T>(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack2<T>(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// the item a persistent block takes in round r of the schedule, or -1:
// rounds of gridDim.x items, walked forwards in even rounds and backwards
// in odd ones (the heaviest item of a round goes to the block that had the
// lightest one of the previous round)
__device__ __forceinline__ int round_item(int r, int n_items) {
  const int g = gridDim.x;
  const int i = r * g + ((r & 1) ? g - 1 - (int)blockIdx.x : (int)blockIdx.x);
  return i < n_items ? i : -1;
}

// one-time opt-in to more than 48 KB of dynamic shared memory per block
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace flash
