// WKV6 per-token recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `wkv6_pallas` / `_wkv_kernel` in
// src/repro/kernels/rwkv6/rwkv6.py: the RWKV-6 time-mix recurrence
//
//     y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T
//
// in fp32.  The Pallas kernel evaluates it chunk-parallel so that the TPU's
// matrix unit does the work: per 32-row chunk a (C, C, K) pair-decay tensor
// exp(clip(cum_prev_t - cum_s, -60, 0)) and three products.  On the CUDA
// cores that form costs an expf per (t, s, k) pair, a serial pair loop and
// a barrier between its steps.  This kernel computes the recurrence itself,
// one token at a time, as the plain version `wkv6_ref` does: no pair
// tensor, no exp per pair, no clipping.
//
// Bound on this card: per token and (b, head) the recurrence does 5 K V
// fp32 operations against about 10 K + 2 V bytes (bf16 r, k, v and fp32
// lw; y in bf16), some 27 operations per byte at K = 64, above the card's
// fp32 balance of 67 TFLOP/s over 3.35 TB/s (20): it is bound by the fp32
// rate.  Each (row i, column j, token t) costs three FP instructions here,
// y += r_ti s_ij and s_ij = fma(s_ij, w_ti, k_ti v_tj), which is that
// count, so the design keeps the FP pipes of the consumer warps fed and
// moves everything else off their path:
//
// * Columns of the state are independent (y[:, j] and S[:, j] depend only
//   on column j), so the grid is (V / VB, H, B): a block serves VB columns
//   of one (b, head).  Its consumer lanes form groups of P adjacent lanes;
//   a group holds CPT columns, each of its lanes R = K / P rows of them
//   (rows (m P + part) 4 + e), R x CPT state values in registers for the
//   whole sequence.  Each staged r, k, w value so serves CPT columns and
//   each v value R rows.  `launch_shape` in ops.py picks (VB, P, CPT).
// * Two producer warps stage the inputs per chunk of TC tokens: 16-byte
//   `cp.async` copies of the raw r, k, lw rows (all K) and v (the block's
//   columns) into a ring of RAW_SLOTS chunks that only they use, then a
//   conversion to fp32 (w = exp(lw)) into one of F32_SLOTS buffers, with
//   the bonus b_t = sum_i r_ti u_i k_ti, one lane per token.  Producers and
//   consumers hand the fp32 buffers over through `mbarrier` pairs (full,
//   empty), so no block-wide barrier stands in the consumers' path.  Rows
//   past T are neither read nor used.
// * A consumer loads the next token's operands while it computes the
//   current one, and writes its partial y per (token, part) to shared
//   memory.  After each chunk a warp sums the P partials of its own
//   columns, adds b_t v_tj and stores y in r's dtype, coalesced; the warp
//   alone orders this, with `__syncwarp`.
// * s0 is read once at the start and s_fin written once at the end.
//
// What still bounds it (PERF.md): the consumers' issue rate, at about 80%
// FP instructions in the token loop, with 8 (B = 8) or 2 (B = 1) consumer
// warps an SM at the serving shapes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 256;   // consumer threads, VB / CPT * P
constexpr int PRODUCERS = 64;      // producer threads: two warps

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four consecutive elements of shared memory, 8- or 16-byte aligned, as
// fp32.
__device__ __forceinline__ float4 load4(const float* x) {
  return *reinterpret_cast<const float4*>(x);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* x) {
  const uint2 u = *reinterpret_cast<const uint2*>(x);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void bar_init(unsigned long long* bar, int n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(n));
}
__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// The producer threads' own barrier (named barrier 1).
__device__ __forceinline__ void producers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(PRODUCERS) : "memory");
}
// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
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
  int t_len, heads, vb;
  long long r_sb, r_st, r_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long w_sb, w_st, w_sh;
  long long y_sb, y_st, y_sh;
};

__host__ __device__ constexpr int chunk_len(int K) {
  return K <= 64 ? 16 : 8;
}
constexpr int RAW_SLOTS = 3;   // the producer's copies run two chunks ahead
constexpr int F32_SLOTS = 2;   // converted chunks in flight to consumers
constexpr int YPAD = 4;        // y-partial rows padded: 4 bank groups apart

// The shared-memory layout at VB columns and P lanes per column group, in
// floats unless named: F32_SLOTS converted chunks (r, k, w rows of K + 4,
// v rows of VB, b per token), RAW_SLOTS raw chunks (bytes: r, k in T, lw
// in fp32, v in T), the consumers' y partials (TC x P rows of VB + YPAD),
// u, and 2 F32_SLOTS mbarriers.  Every piece starts on a 16-byte boundary.
template <typename T, int K>
struct Layout {
  static constexpr int TC = chunk_len(K);
  static constexpr int KP = K + 4;      // row stride of r, k, w
  int vb, p;
  __host__ __device__ int f32_slot() const {
    return TC * (3 * KP + vb + 4);
  }
  __host__ __device__ int raw_slot() const {     // bytes
    return TC * (2 * K * static_cast<int>(sizeof(T)) + 4 * K +
                 vb * static_cast<int>(sizeof(T)));
  }
  __host__ __device__ int raw_at() const { return 4 * F32_SLOTS * f32_slot(); }
  __host__ __device__ int yp_at() const {
    return raw_at() + RAW_SLOTS * raw_slot();
  }
  __host__ __device__ int us_at() const {
    return yp_at() + 4 * TC * p * (vb + YPAD);
  }
  __host__ __device__ int bars_at() const { return us_at() + 4 * K; }
  __host__ __device__ int bytes() const {
    return bars_at() + 2 * F32_SLOTS * 8;
  }
};

// The producer warps.  They alone use the raw slots: chunk c + RAW_SLOTS -
// 1 is copied (16-byte `cp.async`) while chunk c is converted into fp32
// slot c % F32_SLOTS, once the consumers have released that slot: r, k, w
// = exp(lw) and v, 4 elements a thread at a time, then b_t = sum_i r_ti u_i
// k_ti, one thread per token.
template <typename T, int K>
__device__ __forceinline__ void produce(const Params& p, unsigned char* sm,
                                        const Layout<T, K>& L, int pt,
                                        int b, int h, int v0) {
  constexpr int TC = Layout<T, K>::TC, KP = Layout<T, K>::KP;
  constexpr int E = 16 / sizeof(T);     // elements of T per 16-byte copy
  const int vb = p.vb;
  const T* rg = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh + v0;
  const float* wg = p.lw + b * p.w_sb + h * p.w_sh;
  const float* us = reinterpret_cast<const float*>(sm + L.us_at());
  auto* full = reinterpret_cast<unsigned long long*>(sm + L.bars_at());
  auto* empty = full + F32_SLOTS;
  const int n_chunks = (p.t_len + TC - 1) / TC;
  auto rows = [&](int c) { return min(TC, p.t_len - c * TC); };
  auto raw = [&](int c) {
    return sm + L.raw_at() + (c % RAW_SLOTS) * L.raw_slot();
  };
  const int vsh = __ffs(vb / E) - 1;    // log2 of the copies per v row

  auto stage = [&](int c) {             // one commit group per chunk
    if (c < n_chunks) {
      T* rr = reinterpret_cast<T*>(raw(c));
      T* kr = rr + TC * K;
      float* wr = reinterpret_cast<float*>(kr + TC * K);
      T* vr = reinterpret_cast<T*>(wr + TC * K);
      const int t0 = c * TC, n = rows(c);
      for (int i = pt; i < n * (K / E); i += PRODUCERS) {
        const int t = i / (K / E), q = i % (K / E);
        cp16(rr + t * K + q * E, rg + (t0 + t) * p.r_st + q * E);
        cp16(kr + t * K + q * E, kg + (t0 + t) * p.k_st + q * E);
      }
      for (int i = pt; i < n * (K / 4); i += PRODUCERS) {
        const int t = i / (K / 4), q = i % (K / 4);
        cp16(wr + t * K + q * 4, wg + (t0 + t) * p.w_st + q * 4);
      }
      for (int i = pt; i < n << vsh; i += PRODUCERS) {
        const int t = i >> vsh, q = i & ((1 << vsh) - 1);
        cp16(vr + t * vb + q * E, vg + (t0 + t) * p.v_st + q * E);
      }
    }
    cp_commit();
  };

  for (int c = 0; c < RAW_SLOTS - 1; ++c) stage(c);
  for (int c = 0; c < n_chunks; ++c) {
    stage(c + RAW_SLOTS - 1);       // into chunk c - 1's slot, converted
    cp_wait<RAW_SLOTS - 1>();       // chunk c's copies have landed
    producers_sync();
    const int slot = c % F32_SLOTS;
    if (c >= F32_SLOTS) bar_wait(empty + slot, (c / F32_SLOTS - 1) & 1);
    const T* rr = reinterpret_cast<const T*>(raw(c));
    const T* kr = rr + TC * K;
    const float* wr = reinterpret_cast<const float*>(kr + TC * K);
    const T* vr = reinterpret_cast<const T*>(wr + TC * K);
    float* rc = reinterpret_cast<float*>(sm) + slot * L.f32_slot();
    float* kc = rc + TC * KP;
    float* wc = kc + TC * KP;
    float* vc = wc + TC * KP;
    float* bc = vc + TC * vb;
    const int n = rows(c);
    for (int i = pt; i < n * (K / 4); i += PRODUCERS) {
      const int t = i / (K / 4), q = 4 * (i % (K / 4));
      const float4 w4 = load4(wr + t * K + q);
      *reinterpret_cast<float4*>(rc + t * KP + q) = load4(rr + t * K + q);
      *reinterpret_cast<float4*>(kc + t * KP + q) = load4(kr + t * K + q);
      *reinterpret_cast<float4*>(wc + t * KP + q) =
          make_float4(expf(w4.x), expf(w4.y), expf(w4.z), expf(w4.w));
    }
    for (int i = pt; i < n * vb / 4; i += PRODUCERS)
      *reinterpret_cast<float4*>(vc + 4 * i) = load4(vr + 4 * i);
    producers_sync();
    if (pt < n) {
      float b0 = 0.f, b1 = 0.f;
      for (int q = 0; q < K; q += 4) {
        const float4 r4 = load4(rc + pt * KP + q);
        const float4 k4 = load4(kc + pt * KP + q);
        const float4 u4 = load4(us + q);
        b0 = fmaf(r4.x * u4.x, k4.x, b0);
        b1 = fmaf(r4.y * u4.y, k4.y, b1);
        b0 = fmaf(r4.z * u4.z, k4.z, b0);
        b1 = fmaf(r4.w * u4.w, k4.w, b1);
      }
      bc[pt] = b0 + b1;
    }
    bar_arrive(full + slot);        // release: this thread's writes above
  }
}

// One token's operands for a consumer lane: its rows' r, k, w, its
// columns' v.
template <int CPT, int NV>
struct Operands {
  float4 r[NV], k[NV], w[NV];
  float2 v[CPT / 2];
};

template <typename T, int K, int R, int CPT>
__global__ void __launch_bounds__(MAX_THREADS + PRODUCERS)
    wkv6_kernel(Params p) {
  constexpr int TC = chunk_len(K);
  constexpr int KP = Layout<T, K>::KP;
  constexpr int V = K;
  constexpr int P = K / R;        // lanes per column group
  constexpr int NV = R / 4;       // float4s of each staged row a lane reads
  static_assert(R % 4 == 0 && P <= 32 && CPT % 2 == 0 && CPT <= P,
                "whole float4s of rows a lane, a group within a warp, a "
                "warp's columns within its lanes");
  const int vb = p.vb, nc = vb / CPT * P;   // consumer threads
  const int ncw = (nc + 31) / 32 * 32;      // consumer warps' threads
  const Layout<T, K> L{vb, P};
  const int v0 = blockIdx.x * vb;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char sm[];
  float* us = reinterpret_cast<float*>(sm + L.us_at());
  auto* full = reinterpret_cast<unsigned long long*>(sm + L.bars_at());
  auto* empty = full + F32_SLOTS;
  for (int i = tid; i < K; i += blockDim.x) us[i] = p.u[h * K + i];
  if (tid < F32_SLOTS) {
    bar_init(full + tid, PRODUCERS);
    bar_init(empty + tid, nc);
  }
  __syncthreads();
  if (tid >= ncw) {
    produce<T, K>(p, sm, L, tid - ncw, b, h, v0);
    return;
  }
  if (tid >= nc) return;

  // consumers: thread (group tid / P, part) holds rows (m P + part) 4 + e
  // of columns j0 .. j0 + CPT; s[(4 m + e) CPT + c] = S[row][j0 + c]
  const int part = tid % P, j0 = tid / P * CPT;
  const int yw = vb + YPAD;                 // y-partial row stride
  float* yp = reinterpret_cast<float*>(sm + L.yp_at());
  T* yg = static_cast<T*>(p.y) + b * p.y_sb + h * p.y_sh + v0;
  const long long sbase =
      (static_cast<long long>(b) * p.heads + h) * K * V + v0 + j0;
  float s[R * CPT];
#pragma unroll
  for (int m = 0; m < NV; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        s[(4 * m + e) * CPT + c] =
            p.s0[sbase + ((m * P + part) * 4 + e) * V + c];

  // the warp's y outputs: lane sums column wj of tokens t0, t0 + tstep, ..
  // of each chunk (its groups hold wcols <= 32 columns: CPT <= P)
  const int lanes = nc < 32 ? nc : 32;
  const unsigned mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
  const int lane = tid % lanes;
  const int wcols = lanes / P * CPT;
  const int wj = tid / lanes * wcols + lane % wcols;
  const int t0 = lane / wcols, tstep = lanes / wcols;

  const int n_chunks = (p.t_len + TC - 1) / TC;
  for (int c = 0; c < n_chunks; ++c) {
    const int slot = c % F32_SLOTS;
    bar_wait(full + slot, (c / F32_SLOTS) & 1);
    const float* rc = reinterpret_cast<const float*>(sm) +
                      slot * L.f32_slot();
    const float* kc = rc + TC * KP;
    const float* wc = kc + TC * KP;
    const float* vc = wc + TC * KP;
    const float* bc = vc + TC * vb;
    const int n = min(TC, p.t_len - c * TC);
    // token t's operands are loaded while token t - 1 is computed
    auto load = [&](Operands<CPT, NV>& x, int t) {
      const float* rt = rc + t * KP + part * 4;
      const float* kt = kc + t * KP + part * 4;
      const float* wt = wc + t * KP + part * 4;
#pragma unroll
      for (int m = 0; m < NV; ++m) {
        x.r[m] = *reinterpret_cast<const float4*>(rt + m * P * 4);
        x.k[m] = *reinterpret_cast<const float4*>(kt + m * P * 4);
        x.w[m] = *reinterpret_cast<const float4*>(wt + m * P * 4);
      }
#pragma unroll
      for (int q = 0; q < CPT; q += 2)
        x.v[q / 2] = *reinterpret_cast<const float2*>(vc + t * vb + j0 + q);
    };
    auto step = [&](const Operands<CPT, NV>& x, int t) {
      float y[CPT];
#pragma unroll
      for (int q = 0; q < CPT; ++q) y[q] = 0.f;
#pragma unroll
      for (int m = 0; m < NV; ++m) {
        const float rr[4] = {x.r[m].x, x.r[m].y, x.r[m].z, x.r[m].w};
        const float kk[4] = {x.k[m].x, x.k[m].y, x.k[m].z, x.k[m].w};
        const float ww[4] = {x.w[m].x, x.w[m].y, x.w[m].z, x.w[m].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int q = 0; q < CPT; ++q) {
            const float vq = q % 2 ? x.v[q / 2].y : x.v[q / 2].x;
            float& sv = s[(4 * m + e) * CPT + q];
            y[q] = fmaf(rr[e], sv, y[q]);
            sv = fmaf(sv, ww[e], kk[e] * vq);
          }
      }
      float* ypt = yp + (t * P + part) * yw + j0;
#pragma unroll
      for (int q = 0; q < CPT; q += 2)
        *reinterpret_cast<float2*>(ypt + q) = make_float2(y[q], y[q + 1]);
    };
    Operands<CPT, NV> xa, xb;
    load(xa, 0);
    int t = 0;
    for (; t + 1 < n; t += 2) {
      load(xb, t + 1);
      step(xa, t);
      if (t + 2 < n) load(xa, t + 2);
      step(xb, t + 1);
    }
    if (t < n) step(xa, t);
    // y = b_t v_tj + the P partials; the warp's groups are its own, so
    // the warp alone orders these reads after its writes
    __syncwarp(mask);
    T* yc = yg + (static_cast<long long>(c) * TC + t0) * p.y_st + wj;
    const float* src = yp + t0 * P * yw + wj;
    for (int tr = t0; tr < n; tr += tstep) {
      float y = bc[tr] * vc[tr * vb + wj];
#pragma unroll
      for (int q = 0; q < P; ++q) y += src[q * yw];
      *yc = from_f<T>(y);
      yc += tstep * p.y_st;
      src += tstep * P * yw;
    }
    __syncwarp(mask);
    bar_arrive(empty + slot);       // release: done with this slot
  }

#pragma unroll
  for (int m = 0; m < NV; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        p.s_fin[sbase + ((m * P + part) * 4 + e) * V + c] =
            s[(4 * m + e) * CPT + c];
}

template <typename T, int K, int R, int CPT>
int launch(const Params& p, int batch, cudaStream_t stream) {
  if constexpr (CPT > K / R) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (p.vb < CPT) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = Layout<T, K>{p.vb, K / R}.bytes();
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          wkv6_kernel<T, K, R, CPT>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int nc = p.vb / CPT * (K / R);
    wkv6_kernel<T, K, R, CPT><<<dim3(K / p.vb, p.heads, batch),
                                (nc + 31) / 32 * 32 + PRODUCERS, smem,
                                stream>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
}

// R = 8 state rows a lane (4 at K = 8): P = K / R lanes share a column.
template <typename T, int K>
int dispatch_cols(const Params& p, int split, int cols, int batch,
                  cudaStream_t stream) {
  constexpr int R = K >= 16 ? 8 : 4;
  if (split != K / R) return static_cast<int>(cudaErrorInvalidValue);
  switch (cols) {
    case 2: return launch<T, K, R, 2>(p, batch, stream);
    case 4: return launch<T, K, R, 4>(p, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_k(const Params& p, int k, int split, int cols, int batch,
               cudaStream_t stream) {
  // VB: a power of two dividing V, one 16-byte copy or more per v row
  if (p.vb <= 0 || (p.vb & (p.vb - 1)) || k % p.vb ||
      p.vb * static_cast<int>(sizeof(T)) % 16 || cols <= 0 ||
      p.vb % cols || p.vb / cols * split > MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
    case 8: return dispatch_cols<T, 8>(p, split, cols, batch, stream);
    case 16: return dispatch_cols<T, 16>(p, split, cols, batch, stream);
    case 32: return dispatch_cols<T, 32>(p, split, cols, batch, stream);
    case 64: return dispatch_cols<T, 64>(p, split, cols, batch, stream);
    case 128: return dispatch_cols<T, 128>(p, split, cols, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype of r, k, v and y: 0 = float32, 1 = bfloat16.  lw, u, s0 and s_fin
// are float32; u (H, K), s0 and s_fin (B, H, K, V) are contiguous, with
// K == V.  Strides are in elements, for the (B, T, H, K) layout; every row
// of r, k, v and lw starts on a 16-byte boundary.  vb state columns per
// block and split threads per column, as `launch_shape` picks them.
int repro_rwkv6_fwd(
    const void* r, const void* k, const void* v, const void* lw,
    const void* u, const void* s0, void* y, void* s_fin, int dtype,
    int batch, int t_len, int heads, int kdim, int vb, int split, int cols,
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
           static_cast<float*>(s_fin), t_len, heads, vb,
           r_sb, r_st, r_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
           w_sb, w_st, w_sh, y_sb, y_st, y_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_k<float>(p, kdim, split, cols, batch, st);
  if (dtype == 1)
    return dispatch_k<__nv_bfloat16>(p, kdim, split, cols, batch, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_rwkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
