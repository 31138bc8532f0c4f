// WKV6 chunked recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `wkv6_pallas` / `_wkv_kernel` in
// src/repro/kernels/rwkv6/rwkv6.py: the RWKV-6 time-mix recurrence
//
//     y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T
//
// evaluated chunk-parallel with C = 32 rows per chunk, all in fp32, exactly
// as the Pallas kernel does per chunk: the inclusive cumulative log-decay
// `cum` and `cum_prev = cum - lw`; the inter-chunk term
// (r * exp(cum_prev)) @ S; the intra-chunk term
// sum_k r_t k_s exp(clip(cum_prev_t - cum_s, -60, 0)) under a strict
// lower-triangular mask, times v; the diagonal bonus (r_t . u . k_t) v_t;
// and the state update S * exp(cum_C) + sum_s (k_s exp(cum_C - cum_s)) v_s^T.
// The pair decay is never factored into exp(cum_prev_t) * exp(-cum_s):
// lw reaches -e^4 per step, so -cum_s overflows fp32 within one chunk.
//
// Design.  Pallas walks the chunks on the grid's innermost axis and keeps
// the state in VMEM scratch between grid steps.  Here one block of 256
// threads serves one (batch row, head, group of VB = min(V, 32) state
// columns): y[:, v] and S[:, v] depend only on column v, so the groups are
// independent.  The chunk loop runs inside the block and the block's
// K x VB slice of the state stays in shared memory for the whole sequence.
// The per-column prefix sum over a chunk's 32 rows is a warp scan (lane =
// row).  Chunk tiles use an odd row stride (K + 1), so reading a column
// across lanes hits 32 different banks.  Rows past T load as r = k = v = 0
// and lw = 0, which is what padding T to a chunk multiple computes, so the
// tail needs no padded copy.  Inputs are read through their (B, T, H, K)
// strides, so the model's layout needs no transposed copy.
//
// Bound on this card: per chunk and (b, head) about 4 C K V fp32 products
// (the inter-chunk read of S and the state update) plus 5 K C (C - 1) / 2
// for the pair decays, against 10 bytes per input element (bf16 r, k, v and
// fp32 lw) and 2 per output: about 30 operations per byte at K = 64, above
// the card's fp32 balance of 67 TFLOP/s over 3.35 TB/s (20), so it is bound
// by the fp32 rate (the reference keeps every term in fp32, outside the
// tensor cores).  This first version does every product with scalar FMAs
// and recomputes the intra-chunk weights once per column group; tensor-core
// products in TF32 or bf16 would break the reference's fp32 arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int C = 32;        // chunk rows: one warp's lanes
constexpr int NT = 256;      // threads per block
constexpr int NW = NT / 32;  // warps per block

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

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* lw;
  const float* u;     // (H, K)
  const float* s0;    // (B, H, K, V), contiguous
  void* y;            // (B, T, H, V), strided
  float* s_fin;       // (B, H, K, V), contiguous
  int t_len, heads;
  long long r_sb, r_st, r_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long w_sb, w_st, w_sh;
  long long y_sb, y_st, y_sh;
};

template <int K, int VB>
constexpr int smem_floats() {
  return 4 * C * (K + 1) + C * VB + C * (C + 1) + K * VB + K;
}

template <typename T, int K, int VB>
__global__ void __launch_bounds__(NT) wkv6_kernel(Params p) {
  constexpr int V = K;
  constexpr int KP = K + 1;   // odd row stride: conflict-free columns
  constexpr int CP = C + 1;
  const int v0 = blockIdx.x * VB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float sm[];
  float* rs = sm;              // C x KP: r, then r * exp(cum_prev)
  float* ks = rs + C * KP;     // C x KP: k, then k * exp(cum_C - cum)
  float* ps = ks + C * KP;     // C x KP: lw, then cum_prev
  float* cs = ps + C * KP;     // C x KP: cum (inclusive)
  float* vs = cs + C * KP;     // C x VB: v columns [v0, v0 + VB)
  float* as = vs + C * VB;     // C x CP: pair weights, bonus on the diagonal
  float* ss = as + C * CP;     // K x VB: state columns [v0, v0 + VB)
  float* us = ss + K * VB;     // K: this head's bonus u

  const T* rg = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh + v0;
  const float* wg = p.lw + b * p.w_sb + h * p.w_sh;
  T* yg = static_cast<T*>(p.y) + b * p.y_sb + h * p.y_sh + v0;
  const long long sbase = (static_cast<long long>(b) * p.heads + h) * K * V;

  for (int i = tid; i < K * VB; i += NT)
    ss[i] = p.s0[sbase + (i / VB) * V + v0 + i % VB];
  for (int i = tid; i < K; i += NT) us[i] = p.u[h * K + i];

  const int n_chunks = (p.t_len + C - 1) / C;
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * C;
    // 1. the chunk's rows; rows past T read as zeros (lw = 0: decay 1)
    for (int i = tid; i < C * K; i += NT) {
      const int t = i / K, j = i % K;
      const long long row = t0 + t;
      const bool ok = row < p.t_len;
      rs[t * KP + j] = ok ? to_f(rg[row * p.r_st + j]) : 0.f;
      ks[t * KP + j] = ok ? to_f(kg[row * p.k_st + j]) : 0.f;
      ps[t * KP + j] = ok ? wg[row * p.w_st + j] : 0.f;
    }
    for (int i = tid; i < C * VB; i += NT) {
      const int t = i / VB, j = i % VB;
      const long long row = t0 + t;
      vs[i] = row < p.t_len ? to_f(vg[row * p.v_st + j]) : 0.f;
    }
    __syncthreads();

    // 2. cum and cum_prev per column: a warp scan over the chunk's rows
    for (int j = warp; j < K; j += NW) {
      const float w = ps[lane * KP + j];
      float x = w;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += up;
      }
      cs[lane * KP + j] = x;
      ps[lane * KP + j] = x - w;
    }
    __syncthreads();

    // 3. pair weights a[t][s]: decayed r.k below the diagonal, the u
    //    bonus on it, zero above
    for (int i = tid; i < C * C; i += NT) {
      const int t = i / C, s = i % C;
      float a = 0.f;
      if (s < t) {
        for (int j = 0; j < K; ++j) {
          const float d =
              fminf(fmaxf(ps[t * KP + j] - cs[s * KP + j], -60.f), 0.f);
          a = fmaf(rs[t * KP + j] * ks[s * KP + j], expf(d), a);
        }
      } else if (s == t) {
        for (int j = 0; j < K; ++j)
          a = fmaf(rs[t * KP + j] * us[j], ks[t * KP + j], a);
      }
      as[t * CP + s] = a;
    }
    __syncthreads();

    // 4. fold the decays into r (to the chunk start) and k (to its end)
    for (int i = tid; i < C * K; i += NT) {
      const int t = i / K, j = i % K;
      rs[t * KP + j] *= expf(ps[t * KP + j]);
      ks[t * KP + j] *= expf(cs[(C - 1) * KP + j] - cs[t * KP + j]);
    }
    __syncthreads();

    // 5. y = (r * exp(cum_prev)) @ S + a @ v
    for (int i = tid; i < C * VB; i += NT) {
      const int t = i / VB, j = i % VB;
      float acc = 0.f;
      for (int q = 0; q < K; ++q)
        acc = fmaf(rs[t * KP + q], ss[q * VB + j], acc);
      for (int s = 0; s <= t; ++s)
        acc = fmaf(as[t * CP + s], vs[s * VB + j], acc);
      const long long row = t0 + t;
      if (row < p.t_len) yg[row * p.y_st + j] = from_f<T>(acc);
    }
    __syncthreads();

    // 6. S = diag(exp(cum_C)) S + (k * exp(cum_C - cum))^T v
    for (int i = tid; i < K * VB; i += NT) {
      const int q = i / VB, j = i % VB;
      float acc = ss[i] * expf(cs[(C - 1) * KP + q]);
      for (int s = 0; s < C; ++s)
        acc = fmaf(ks[s * KP + q], vs[s * VB + j], acc);
      ss[i] = acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < K * VB; i += NT)
    p.s_fin[sbase + (i / VB) * V + v0 + i % VB] = ss[i];
}

template <typename T, int K>
int launch(const Params& p, int batch, cudaStream_t stream) {
  constexpr int VB = K < 32 ? K : 32;
  constexpr int smem =
      static_cast<int>(sizeof(float)) * smem_floats<K, VB>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        wkv6_kernel<T, K, VB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  wkv6_kernel<T, K, VB>
      <<<dim3(K / VB, p.heads, batch), NT, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_k(const Params& p, int k, int batch, cudaStream_t stream) {
  switch (k) {
    case 8: return launch<T, 8>(p, batch, stream);
    case 16: return launch<T, 16>(p, batch, stream);
    case 32: return launch<T, 32>(p, batch, stream);
    case 64: return launch<T, 64>(p, batch, stream);
    case 128: return launch<T, 128>(p, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype of r, k, v and y: 0 = float32, 1 = bfloat16.  lw, u, s0 and s_fin
// are float32; u (H, K), s0 and s_fin (B, H, K, V) are contiguous, with
// K == V.  Strides are in elements, for the (B, T, H, K) layout.
int repro_rwkv6_fwd(
    const void* r, const void* k, const void* v, const void* lw,
    const void* u, const void* s0, void* y, void* s_fin, int dtype,
    int batch, int t_len, int heads, int kdim,
    long long r_sb, long long r_st, long long r_sh,
    long long k_sb, long long k_st, long long k_sh,
    long long v_sb, long long v_st, long long v_sh,
    long long w_sb, long long w_st, long long w_sh,
    long long y_sb, long long y_st, long long y_sh, void* stream) {
  if (batch <= 0 || batch > 65535 || heads <= 0 || heads > 65535 ||
      t_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{r, k, v, static_cast<const float*>(lw),
           static_cast<const float*>(u), static_cast<const float*>(s0), y,
           static_cast<float*>(s_fin), t_len, heads,
           r_sb, r_st, r_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
           w_sb, w_st, w_sh, y_sb, y_st, y_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_k<float>(p, kdim, batch, st);
  if (dtype == 1) return dispatch_k<__nv_bfloat16>(p, kdim, batch, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_rwkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
