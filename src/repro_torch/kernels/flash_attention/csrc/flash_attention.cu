// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `flash_attention_fwd` / `_fa_kernel` in
// src/repro/kernels/flash_attention/flash_attention.py: causal GQA
// attention with an online softmax (fp32 m / l / acc), optional
// sliding-window, chunked-local and static q_offset masks, fully masked
// tiles skipped, tail K/V rows zeroed, l floored at 1e-30.
//
// Layout: q (B, Sq, H, D), k/v (B, Skv, KV, D), o (B, Sq, H, D), read and
// written through their batch / sequence / head strides (the last dim must
// be contiguous), so neither side makes a transposed copy.  q head h reads
// kv head h / n_rep.
//
// Grid: one block per (64-row q tile, q head, batch).  The Pallas kernel's
// sequential kv grid dimension becomes a loop over 64-row K/V tiles inside
// the block; the running softmax state lives in registers.  256 threads as
// a 16 x 16 grid: thread (ty, tx) owns q rows ty + 16 i (i < 4), score
// columns tx + 16 j (j < 4) and output columns tx + 16 k (k < D / 16), so
// the 16 threads that share a row sit in one half-warp and reduce it with
// shuffles.  Q, K and V tiles are staged in shared memory as fp32; Q / K
// rows are padded by one float so the column walks of the score loop hit
// 16 distinct banks; the probability tile reuses the K tile's space, which
// keeps the block at 97 KB for D = 128 and two blocks per SM.
//
// Bound on this card: causal attention does 2 B H D S^2 flops on
// 4 B S D (H + KV) bytes of q, k, v and o in bf16, so S H / (2 (H + KV))
// flops per byte: S / 3 for InternLM2's 16 q over 8 kv heads.  That
// crosses the H100's ~295 flop/byte ridge near S = 885, so the serving
// prompt (S = 128) is bound by bytes and long prompts by operations.
// This first version is bound by neither: its products are fp32 FMAs
// (67 TFLOP/s peak, not the 989 TFLOP/s of bf16 tensor cores) and a short
// prompt gives few blocks (B x H x S / 64).  It is right first; wgmma with
// TMA-staged tiles, and splitting the kv loop across blocks for short
// prompts, are the way to the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NTHREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int sq, skv, n_rep;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal, window, local_block, q_offset;  // window / local_block: 0 = off
};

template <int D>
constexpr int smem_floats() {
  // sQ (BQ x D+1) + shared K / P region + sV (BK x D)
  return BQ * (D + 1) +
         (BK * (D + 1) > BQ * (BK + 1) ? BK * (D + 1) : BQ * (BK + 1)) +
         BK * D;
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, 2) fa_fwd_kernel(Params p) {
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int RK = D / 16;
  constexpr int KP = (BK * DP > BQ * PP) ? BK * DP : BQ * PP;
  extern __shared__ float smem[];
  float* sQ = smem;         // BQ x DP, pre-scaled
  float* sK = sQ + BQ * DP; // BK x DP, then reused as P (BQ x PP)
  float* sP = sK;
  float* sV = sK + KP;      // BK x D

  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = hh / p.n_rep;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + hh * p.o_sh;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    sQ[r * DP + d] =
        (q0 + r < p.sq) ? to_f(qg[(q0 + r) * p.q_ss + d]) * p.scale : 0.f;
  }

  float m[4], l[4], acc[4][RK];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int k = 0; k < RK; ++k) acc[i][k] = 0.f;
  }

  // first and last real query positions of this tile
  const int qlo = p.q_offset + q0;
  const int qhi = p.q_offset + min(q0 + BQ, p.sq) - 1;
  const int nk = (p.skv + BK - 1) / BK;

  for (int kb = 0; kb < nk; ++kb) {
    const int k0 = kb * BK;
    const int khi = min(k0 + BK, p.skv) - 1;
    // tile-level reachability: skip tiles no (q, kv) pair of which is
    // unmasked (uniform across the block, so the barriers stay matched)
    bool run = true;
    if (p.causal) run = run && qhi >= k0;
    if (p.window > 0) run = run && (qlo - khi < p.window);
    if (p.local_block > 0)
      run = run && floordiv(qhi, p.local_block) >= floordiv(k0, p.local_block)
            && floordiv(qlo, p.local_block) <= floordiv(khi, p.local_block);
    if (!run) continue;

    __syncthreads();  // previous tile's P / V reads are done
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int r = i / D, d = i % D;
      const bool ok = k0 + r < p.skv;  // tail rows are zeroed
      sK[r * DP + d] = ok ? to_f(kg[(k0 + r) * p.k_ss + d]) : 0.f;
      sV[r * D + d] = ok ? to_f(vg[(k0 + r) * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = p.q_offset + q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < p.skv;
        if (p.causal) ok = ok && qpos >= kpos;
        if (p.window > 0) ok = ok && (qpos - kpos < p.window);
        if (p.local_block > 0)
          ok = ok && floordiv(qpos, p.local_block) ==
                         floordiv(kpos, p.local_block);
        if (!ok) s[i][j] = NEG_INF;
      }
    }
    __syncthreads();  // all score reads of sK are done: P may overwrite it

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        sP[(ty + 16 * i) * PP + tx + 16 * j] = e;
        rs += e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int k = 0; k < RK; ++k) acc[i][k] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * PP + c];
#pragma unroll
      for (int k = 0; k < RK; ++k) {
        const float vv = sV[c * D + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][k] = fmaf(pv[i], vv, acc[i][k]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < p.sq) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int k = 0; k < RK; ++k)
        og[row * p.o_ss + tx + 16 * k] = from_f<T>(acc[i][k] / den);
    }
  }
}

template <typename T, int D>
int launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  static bool configured = false;  // the opt-in above 48 KB, once
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  dim3 grid((p.sq + BQ - 1) / BQ, heads, batch);
  fa_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Params& p, int d, int batch, int heads,
               cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, batch, heads, stream);
    case 32: return launch<T, 32>(p, batch, heads, stream);
    case 64: return launch<T, 64>(p, batch, heads, stream);
    case 128: return launch<T, 128>(p, batch, heads, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.
int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int sq, int skv, int heads, int kv_heads, int d,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int window, int local_block, int q_offset,
    void* stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0 || sq <= 0 || skv <= 0 ||
      batch <= 0 || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, sq, skv, heads / kv_heads,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           o_sb, o_ss, o_sh, scale, causal, window, local_block, q_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(p, d, batch, heads, st);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(p, d, batch, heads, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
