// Flash attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernels deepspeed_tpu/ops/pallas/flash_attention.py
// _fwd_kernel (pallas_call :262, entries _fwd :282 and _fwd_bse :913) and
// _fwd_grid_kernel (pallas_call :643, entry _fwd_grid :633): causal or
// full online-softmax attention with an optional sliding window and GQA,
// o [B, S, H, D] in q's dtype plus the per-row log-sum-exp lse [B, H, S]
// f32 that the backward recomputes P from. The TPU needed two variants
// (whole K/V resident in VMEM up to 4 MB, else K/V blocked over the grid);
// here one kernel streams K/V through shared memory at any length.
//
// What bounds it on the card: its flops. At the training shape (B8 H16
// S1024 D64 bf16, causal) one call does 2 * 2 * B*H*S*S/2*D = 17.2 GFLOP
// against 67 MB of q/k/v/o, ~255 flops a byte, near the H100's bf16 ridge
// (~295): 0.017 ms at 989 TFLOP/s against 0.020 ms at 3.35 TB/s.
//
// What this design does about it:
//  - bf16/fp16: both products on the tensor cores (mma.sync m16n8k16, f32
//    accumulate). One block per (batch, head, tile of 64 queries), 4 warps
//    of 16 query rows (8 warps at D=256, two warps per row group each
//    owning half of the output columns so the accumulator fits in
//    registers). The block walks K/V tiles of 64 keys from the window's
//    first tile to the causal end through a double-buffered cp.async ring,
//    so the next tile's copy overlaps this tile's products. m, l and the
//    output accumulator stay in registers; P is rounded to the storage
//    dtype and fed back to the second product from registers (no shared
//    memory round trip). Fragments come from shared memory by ldmatrix
//    (V by its transposing form); the softmax runs in log2 units on exp2;
//    tiles wholly inside the mask skip the per-element test. The TPU
//    carried m/l/acc across a sequential grid axis; Hopper's blocks are
//    unordered, so the key loop is inside the block. Query tiles are
//    scheduled heaviest (last) first.
//  - fp32: the same tiling of work on the FMA pipes (no tensor-core path
//    keeps fp32 exact): 32 queries a block, lane j of a warp owns key j of
//    a 32-key chunk for the scores and D/32 output columns for the sum.
// What it does not do yet: wgmma, TMA, warp specialisation, a persistent
// schedule.
//
// Ragged S: rows and keys past S are zero-filled in shared memory and
// masked; nothing past S is written.

#include "flash_attention_common.cuh"

namespace {

using namespace flash;

template <typename T, int D>
struct FwdCfg {
  static constexpr int DSPLIT = D > 128 ? 2 : 1;  // warps sharing a row group
  static constexpr int RG = 4;                     // row groups of 16 queries
  static constexpr int NW = RG * DSPLIT;
  static constexpr int NT = NW * 32;
  static constexpr int BQ = 16 * RG;
  static constexpr int BK = 64;
  static constexpr int LD = D + 8;  // padded row: the fragment reads hit distinct banks
  static constexpr int DC = D / DSPLIT;
  static constexpr size_t SMEM = (size_t)(BQ + 4 * BK) * LD * sizeof(T);
};

template <typename T, int D>
__global__ void __launch_bounds__(FwdCfg<T, D>::NT)
flash_fwd_mma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, float* __restrict__ lse, const Params p) {
  using C = FwdCfg<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + C::BQ * C::LD;      // two buffers of BK rows
  T* Vs = Ks + 2 * C::BK * C::LD;  // two buffers of BK rows

  const int nq = (p.S + C::BQ - 1) / C::BQ;
  const int qt = nq - 1 - (int)(blockIdx.x % nq);
  const int bh = blockIdx.x / nq;
  const int h = bh % p.H;
  const int b = bh / p.H;
  const int kvh = h / p.rep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = warp % C::RG, part = warp / C::RG;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * C::BQ;

  const T* qb = q + b * p.q_sb + h * p.q_sh;
  const T* kb = k + b * p.k_sb + kvh * p.k_sh;
  const T* vb = v + b * p.v_sb + kvh * p.v_sh;

  const int nk = (p.S + C::BK - 1) / C::BK;
  int lo = 0, hi = nk;
  if (p.causal) {
    hi = min((q0 + C::BQ + C::BK - 1) / C::BK, nk);
    if (p.window > 0) lo = max(0, q0 - p.window + 1) / C::BK;
  }

  load_rows_async<T, C::BQ, D, C::LD, C::NT>(Qs, qb, p.q_ss, q0, p.S, tid);
  load_rows_async<T, C::BK, D, C::LD, C::NT>(Ks, kb, p.k_ss, lo * C::BK, p.S, tid);
  load_rows_async<T, C::BK, D, C::LD, C::NT>(Vs, vb, p.v_ss, lo * C::BK, p.S, tid);
  cp_async_commit();

  const int row[2] = {q0 + rg * 16 + g, q0 + rg * 16 + g + 8};
  // scores and the running max m in log2 units: exp2 is one SFU op
  const float scale2 = p.scale * kLog2e;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float acc[C::DC / 8][4];
#pragma unroll
  for (int n = 0; n < C::DC / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = lo; j < hi; ++j) {
    const int buf = (j - lo) & 1;
    if (j + 1 < hi) {
      const int nb = buf ^ 1;
      load_rows_async<T, C::BK, D, C::LD, C::NT>(Ks + nb * C::BK * C::LD, kb, p.k_ss,
                                                  (j + 1) * C::BK, p.S, tid);
      load_rows_async<T, C::BK, D, C::LD, C::NT>(Vs + nb * C::BK * C::LD, vb, p.v_ss,
                                                  (j + 1) * C::BK, p.S, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + buf * C::BK * C::LD;
    const T* Vt = Vs + buf * C::BK * C::LD;

    // s = q k^T for this warp's 16 rows and the tile's 64 keys
    float s[C::BK / 8][4];
#pragma unroll
    for (int n = 0; n < C::BK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      load_a<T, C::LD>(a, Qs, rg * 16, kk, lane);
#pragma unroll
      for (int n = 0; n < C::BK / 8; n += 2) {
        uint32_t bb[4];
        load_b_rows<T, C::LD>(bb, Kt, n * 8, kk, lane);
        mma16816<T>(s[n], a, bb);
        mma16816<T>(s[n + 1], a, bb + 2);
      }
    }

    // scale (to log2 units), mask, online softmax (rows row[0], row[1])
    const int c0 = j * C::BK;
    const bool full = all_kept(q0 + rg * 16, q0 + rg * 16 + 15, c0, c0 + C::BK - 1, p);
    float tmax[2] = {kMasked, kMasked};
#pragma unroll
    for (int n = 0; n < C::BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + n * 8 + 2 * t + (e & 1);
        const float x = full || keep(row[e >> 1], col, p) ? s[n][e] * scale2 : kMasked;
        s[n][e] = x;
        tmax[e >> 1] = fmaxf(tmax[e >> 1], x);
      }
    }
    float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mn = fmaxf(m[i], quad_max(tmax[i]));
      corr[i] = exp2f(m[i] - mn);
      m[i] = mn;
    }
#pragma unroll
    for (int n = 0; n < C::BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = pe;
        rsum[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(rsum[i]);
#pragma unroll
    for (int n = 0; n < C::DC / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += P v, P rounded to the storage dtype (this warp's DC columns)
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk) {
      uint32_t a[4];
      a_from_c<T>(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < C::DC / 8; n += 2) {
        uint32_t bb[4];
        load_b_cols<T, C::LD>(bb, Vt, kk * 16, part * C::DC + n * 8, lane);
        mma16816<T>(acc[n], a, bb);
        mma16816<T>(acc[n + 1], a, bb + 2);
      }
    }
    __syncthreads();  // this buffer is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= p.S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    if (part == 0 && t == 0) {
      lse[((long long)b * p.H + h) * p.S + row[i]] = m[i] * kLn2 + logf(lc);
    }
    T* orow = o + b * p.o_sb + row[i] * p.o_ss + h * p.o_sh + part * C::DC + 2 * t;
#pragma unroll
    for (int n = 0; n < C::DC / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack2<T>(acc[n][2 * i] / lc, acc[n][2 * i + 1] / lc);
    }
  }
}

// ---- fp32: FMA pipes -------------------------------------------------------

template <int D>
struct FwdCfg32 {
  static constexpr int NW = 4;
  static constexpr int QW = 8;  // queries a warp owns
  static constexpr int BQ = NW * QW;
  static constexpr int NT = NW * 32;
  static constexpr int NK = 32;  // keys per chunk, one a lane
  static constexpr int KLD = D + 1;
  static constexpr size_t SMEM = (size_t)(BQ * D + 2 * NK * KLD) * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(FwdCfg32<D>::NT)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              const Params p) {
  using C = FwdCfg32<D>;
  constexpr int E = D / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + C::BQ * D;
  float* Vs = Ks + C::NK * C::KLD;

  const int nq = (p.S + C::BQ - 1) / C::BQ;
  const int qt = nq - 1 - (int)(blockIdx.x % nq);
  const int bh = blockIdx.x / nq;
  const int h = bh % p.H;
  const int b = bh / p.H;
  const int kvh = h / p.rep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = qt * C::BQ;
  const float* kb = k + b * p.k_sb + kvh * p.k_sh;
  const float* vb = v + b * p.v_sb + kvh * p.v_sh;

  int lo = 0, hi = p.S;  // keys [lo, hi)
  if (p.causal) {
    hi = min(q0 + C::BQ, p.S);
    if (p.window > 0) lo = max(0, q0 - p.window + 1) / C::NK * C::NK;
  }
  load_rows_f32<C::BQ, D, D, C::NT>(Qs, q + b * p.q_sb + h * p.q_sh, p.q_ss, q0, p.S, tid);

  float m[C::QW], l[C::QW], acc[C::QW][E];
#pragma unroll
  for (int i = 0; i < C::QW; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[i][e] = 0.f;
  }
  const float* qw = Qs + warp * C::QW * D;

  for (int s0 = lo; s0 < hi; s0 += C::NK) {
    __syncthreads();
    load_rows_f32<C::NK, D, C::KLD, C::NT>(Ks, kb, p.k_ss, s0, p.S, tid);
    load_rows_f32<C::NK, D, C::KLD, C::NT>(Vs, vb, p.v_ss, s0, p.S, tid);
    __syncthreads();
    float sc[C::QW];
#pragma unroll
    for (int i = 0; i < C::QW; ++i) sc[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kk = Ks[lane * C::KLD + d];
#pragma unroll
      for (int i = 0; i < C::QW; ++i) sc[i] = fmaf(qw[i * D + d], kk, sc[i]);
    }
    const int key = s0 + lane;
    float pr[C::QW];
#pragma unroll
    for (int i = 0; i < C::QW; ++i) {
      const int r = q0 + warp * C::QW + i;
      const float x = keep(r, key, p) ? sc[i] * p.scale : kMasked;
      const float mn = fmaxf(m[i], warp_max(x));
      const float corr = expf(m[i] - mn);
      pr[i] = expf(x - mn);
      l[i] = l[i] * corr + warp_sum(pr[i]);
      m[i] = mn;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[i][e] *= corr;
    }
#pragma unroll 4
    for (int jj = 0; jj < C::NK; ++jj) {
      float vv[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vv[e] = Vs[jj * C::KLD + lane + 32 * e];
#pragma unroll
      for (int i = 0; i < C::QW; ++i) {
        const float pj = __shfl_sync(0xffffffffu, pr[i], jj);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[i][e] = fmaf(pj, vv[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < C::QW; ++i) {
    const int r = q0 + warp * C::QW + i;
    if (r >= p.S) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    float* orow = o + b * p.o_sb + r * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int e = 0; e < E; ++e) orow[lane + 32 * e] = acc[i][e] / lc;
    if (lane == 0) lse[((long long)b * p.H + h) * p.S + r] = m[i] + logf(lc);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   const Params& p, cudaStream_t stream) {
  using C = FwdCfg<T, D>;
  auto kern = flash_fwd_mma<T, D>;
  cudaError_t err = allow_smem(kern, C::SMEM);
  if (err != cudaSuccess) return err;
  const int nq = (p.S + C::BQ - 1) / C::BQ;
  kern<<<(unsigned)(p.B * p.H * nq), C::NT, C::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                       const Params& p, cudaStream_t stream) {
  using C = FwdCfg32<D>;
  auto kern = flash_fwd_f32<D>;
  cudaError_t err = allow_smem(kern, C::SMEM);
  if (err != cudaSuccess) return err;
  const int nq = (p.S + C::BQ - 1) / C::BQ;
  kern<<<(unsigned)(p.B * p.H * nq), C::NT, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_dtype(int dtype, const void* q, const void* k, const void* v, void* o,
                           float* lse, const Params& p, cudaStream_t s) {
  switch (dtype) {
    case 0: return launch_f32<D>(q, k, v, o, lse, p, s);
    case 1: return launch<__half, D>(q, k, v, o, lse, p, s);
    case 2: return launch<__nv_bfloat16, D>(q, k, v, o, lse, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 float16, 2 bfloat16 (q, k, v and o share it).
// o is [B, S, H, D] with strides o_*; lse is [B, H, S] f32 contiguous.
// Returns the CUDA error of the launch (0 on success), cudaErrorInvalidValue
// for shapes the kernel does not take. Asynchronous on `stream`.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, int B, int S, int H, int KV,
    int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, float sm_scale, int dtype,
    void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  Params p{};
  p.B = B; p.S = S; p.H = H; p.KV = KV; p.rep = H / KV;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.causal = causal; p.window = window; p.scale = sm_scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 64: return (int)dispatch_dtype<64>(dtype, q, k, v, o, l, p, s);
    case 128: return (int)dispatch_dtype<128>(dtype, q, k, v, o, l, p, s);
    case 256: return (int)dispatch_dtype<256>(dtype, q, k, v, o, l, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
