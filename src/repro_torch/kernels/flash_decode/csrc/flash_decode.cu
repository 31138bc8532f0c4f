// Flash-decoding for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel `flash_decode_dynamic` / `_fd_dyn_kernel` in
// src/repro/kernels/flash_decode/flash_decode.py (and, through a one-element
// position tensor, the static-position `flash_decode` / `_fd_kernel`): one
// query token per sequence against a (B, S, KV, D) cache, with the position
// t read on the device, the linear mask slot <= t, the ring masks
// p_i = t - ((t - i) mod S) with their window / chunked-local tests, and an
// fp32 softmax.
//
// t is read through an int32 pointer, so one launch configuration serves
// every decode step with no host read of t (the job the TPU kernel's
// scalar prefetch did).
//
// Design.  The Pallas kernel walks the cache sequentially with one program
// per batch row.  Here the cache is split into 64-slot chunks, and one block
// of 128 threads serves one (chunk, kv head, batch row) for all n_rep query
// heads that read that kv head, so every cache byte is read once.  At B = 1
// and 8 kv heads a block per (b, kv head) would fill 8 of 132 SMs; the split
// gives S / 64 times as many blocks.  Each block writes its partial
// (max, sum, weighted V) in fp32; a second kernel combines the partials of a
// (b, head) with a logsumexp rescale, the combine of the reference's
// sequence-sharded decode.  On a linear cache, chunks that lie wholly past t
// write an empty partial without reading the cache.
//
// Bound on this card: per step it reads 2 B S KV D cache elements and does
// about 4 B H S D flops, under one flop per byte, so it is bound by bytes
// (HBM at 3.35 TB/s).  This first version loads one element per thread
// access; 16-byte vector loads and keeping more chunks in flight per SM
// are the next steps toward the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CH = 64;      // cache slots per split block
constexpr int NT = 128;     // threads per split block
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

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int pymod(int a, int b) {
  int r = a % b;
  return r < 0 ? r + b : r;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* t;
  float* part_m;    // (B, H, NS)
  float* part_l;    // (B, H, NS)
  float* part_acc;  // (B, H, NS, D)
  int s, heads, n_rep, ns;
  long long q_sb, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_sh;
  float scale;
  int window, local_block;  // 0 = off; either one on selects the ring cache
};

__device__ __forceinline__ bool slot_valid(const Params& p, int slot, int t) {
  if (p.window <= 0 && p.local_block <= 0) return slot <= t;  // linear cache
  const int pos = t - pymod(t - slot, p.s);                   // ring cache
  bool ok = pos >= 0;
  if (p.window > 0) ok = ok && (t - pos) < p.window;
  if (p.local_block > 0)
    ok = ok && pos >= floordiv(t, p.local_block) * p.local_block;
  return ok;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) fd_split_kernel(Params p) {
  constexpr int PER_LANE = (D + 31) / 32;
  const int j = blockIdx.x;   // chunk
  const int g = blockIdx.y;   // kv head
  const int b = blockIdx.z;   // batch row
  const int n_rep = p.n_rep;
  const int h0 = g * n_rep;
  const int s0 = j * CH;
  const int n = min(CH, p.s - s0);
  const int t = *p.t;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long pb = (static_cast<long long>(b) * p.heads + h0) * p.ns + j;

  const bool ring = p.window > 0 || p.local_block > 0;
  if (!ring && t >= 0 && s0 > t) {  // chunk wholly past t: empty partial
    for (int r = tid; r < n_rep; r += NT) {
      p.part_m[pb + r * p.ns] = NEG_INF;
      p.part_l[pb + r * p.ns] = 0.f;
    }
    for (int i = tid; i < n_rep * D; i += NT)
      p.part_acc[(pb + (i / D) * p.ns) * D + i % D] = 0.f;
    return;
  }

  extern __shared__ float sm[];
  float* sq = sm;               // n_rep x D, pre-scaled queries
  float* ss = sq + n_rep * D;   // n_rep x CH, scores then probabilities
  float* sv = ss + n_rep * CH;  // CH x D, the chunk's V rows

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h0 * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh +
                s0 * p.k_ss;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh +
                s0 * p.v_ss;
  for (int i = tid; i < n_rep * D; i += NT)
    sq[i] = to_f(qg[(i / D) * p.q_sh + i % D]) * p.scale;
  for (int i = tid; i < n * D; i += NT)
    sv[i] = to_f(vg[(i / D) * p.v_ss + i % D]);
  __syncthreads();

  // scores: one warp per slot, lanes across D
  for (int c = warp; c < n; c += NT / 32) {
    float kv[PER_LANE];
#pragma unroll
    for (int e = 0; e < PER_LANE; ++e) {
      const int d = lane + 32 * e;
      kv[e] = d < D ? to_f(kg[c * p.k_ss + d]) : 0.f;
    }
    const bool ok = slot_valid(p, s0 + c, t);
    for (int r = 0; r < n_rep; ++r) {
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < PER_LANE; ++e) {
        const int d = lane + 32 * e;
        if (d < D) a = fmaf(sq[r * D + d], kv[e], a);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane == 0) ss[r * CH + c] = ok ? a : NEG_INF;
    }
  }
  __syncthreads();

  // chunk softmax statistics: one warp per query head
  for (int r = warp; r < n_rep; r += NT / 32) {
    float mx = NEG_INF;
    for (int c = lane; c < n; c += 32) mx = fmaxf(mx, ss[r * CH + c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float e = expf(ss[r * CH + c] - mx);
      ss[r * CH + c] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      p.part_m[pb + r * p.ns] = mx;
      p.part_l[pb + r * p.ns] = sum;
    }
  }
  __syncthreads();

  // weighted V: one thread per (head, d)
  for (int i = tid; i < n_rep * D; i += NT) {
    const int r = i / D, d = i % D;
    float a = 0.f;
    for (int c = 0; c < n; ++c) a = fmaf(ss[r * CH + c], sv[c * D + d], a);
    p.part_acc[(pb + r * p.ns) * D + d] = a;
  }
}

template <typename T, int D>
__global__ void fd_combine_kernel(Params p) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const long long base = (static_cast<long long>(b) * p.heads + h) * p.ns;
  float mg = NEG_INF;
  for (int j = 0; j < p.ns; ++j) mg = fmaxf(mg, p.part_m[base + j]);
  float lg = 0.f, ag = 0.f;
  for (int j = 0; j < p.ns; ++j) {
    const float c = expf(p.part_m[base + j] - mg);
    lg = fmaf(p.part_l[base + j], c, lg);
    ag = fmaf(p.part_acc[(base + j) * D + d], c, ag);
  }
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  og[d] = from_f<T>(ag / fmaxf(lg, 1e-30f));
}

template <typename T, int D>
int launch(const Params& p, int batch, int kv_heads, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) *
                   (p.n_rep * D + p.n_rep * CH + CH * D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fd_split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fd_split_kernel<T, D><<<dim3(p.ns, kv_heads, batch), NT, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fd_combine_kernel<T, D><<<dim3(p.heads, batch), D, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Params& p, int d, int batch, int kv_heads,
               cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(p, batch, kv_heads, stream);
    case 32: return launch<T, 32>(p, batch, kv_heads, stream);
    case 64: return launch<T, 64>(p, batch, kv_heads, stream);
    case 128: return launch<T, 128>(p, batch, kv_heads, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Number of 64-slot chunks, for sizing the partial buffers.
int repro_flash_decode_num_splits(int s) { return (s + CH - 1) / CH; }

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; t points to
// one int32 on the device.  part_m / part_l hold B * H * num_splits floats,
// part_acc B * H * num_splits * D.
int repro_flash_decode_fwd(
    const void* q, const void* k, const void* v, void* o, const void* t,
    void* part_m, void* part_l, void* part_acc, int dtype,
    int batch, int s, int heads, int kv_heads, int d,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_sh,
    float scale, int window, int local_block, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0 || s <= 0 || batch <= 0 ||
      batch > 65535 || kv_heads > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, static_cast<const int*>(t),
           static_cast<float*>(part_m), static_cast<float*>(part_l),
           static_cast<float*>(part_acc),
           s, heads, heads / kv_heads, (s + CH - 1) / CH,
           q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh,
           scale, window, local_block};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(p, d, batch, kv_heads, st);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(p, d, batch, kv_heads, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
