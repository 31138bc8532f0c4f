// Flash-decoding for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels `flash_decode_dynamic` / `_fd_dyn_kernel` and
// `flash_decode` / `_fd_kernel` in src/repro/kernels/flash_decode/
// flash_decode.py: one query token per sequence against a (B, S, KV, D)
// cache, with the linear mask slot <= t, the ring masks
// p_i = t - ((t - i) mod S) with their window / chunked-local tests, and an
// fp32 softmax.  Two entries share one device body through a template flag:
//
// - repro_flash_decode_fwd (dynamic, `_fd_dyn_kernel`): t is read through
//   an int32 pointer, so one launch configuration serves every decode step
//   with no host read of t (the job the TPU kernel's scalar prefetch did);
//   the cluster is sized from S and a ring cache is walked whole.
// - repro_flash_decode_static_fwd (static, `_fd_kernel`, which bakes t in
//   at trace time): t travels by value in the launch's parameter block, and
//   the host, knowing t, passes the arc of live slots (first slot, count:
//   `live_slots` in ops.py).  The blocks walk only that arc, and the
//   cluster is sized from it, so a chunked-local ring of 8192 slots with
//   101 live reads 101 slots, not 8192.
//
// Bound on this card: per step it must read 2 B n KV D cache elements (n
// the live slots; the dynamic entry walks a whole ring, the static one only
// the n) and do about 4 B H n D flops, under one flop per byte, so it is
// bound by bytes (HBM at 3.35 TB/s).  At the serving shapes the
// cache is a few MB, so the time goes to latency: the design keeps many
// loads in flight and launches once.
//
// Design.  The Pallas kernel walks the cache sequentially with one program
// per batch row.  Here the cache is cut into 32-slot chunks, and each
// (b, kv head) gets one thread block cluster of C = min(8, chunks) blocks of
// 128 threads along the chunk axis (at the serving cache of 144 slots,
// 5 x 8 kv heads = 40 blocks at B = 1 and 320 at B = 8; 64 and 512 from
// 225 slots up); longer caches are walked by the loop, not by more blocks.
// Block `rank` walks chunks rank, rank + C, ... (on a linear cache only
// those that start at or before t) with an online softmax for all n_rep
// query heads of its kv head, so every cache byte is read once.  K and V
// chunks move as 16-byte cp.async.cg copies (8 bf16 or 4 fp32 a thread)
// into a ring of 2 chunk stages, the next chunk loading while this one is
// used; the first is requested before t is read, so the read of t hides
// under its latency.  The static entry cuts the arc of live slots instead
// of the cache: its chunk c holds the arc's offsets 32c .. 32c + 31, each
// row at slot (first + offset) mod S, so a ring's chunk may wrap from slot
// S - 1 to 0 (a row is its own 16-byte copies either way), and only the
// last chunk has rows past the arc.  Both keep the mask test on every row,
// so an arc that is wrong by a slot still gives the exact masked answer.  A score is a dot product over the D / 8 (bf16)
// lanes that hold one K row, reduced with shuffles.  The blocks' partial
// (m, l, acc) stay in shared memory, and after a cluster barrier each
// block combines a slice of the (head, d) outputs from every rank's
// partials through distributed shared memory with a logsumexp rescale and
// writes it: one launch, no partials in HBM.  A block with no valid slot
// holds m = -1e30, l = 0, acc = 0.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 128;     // threads per block
constexpr int MAX_CLUSTER = 8;
constexpr float NEG_INF = -1e30f;
// Cache slots per chunk and chunk stages in flight per block.  32 x 2 keeps
// a block at 35 KB (bf16, D = 128), so six fit on an SM and a batch of 8
// runs in one wave; on the H100 it was the fastest of 16-64 slots and 2-4
// stages from S = 144 to S = 4096.
constexpr int CH = 32, NSTAGE = 2;

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int pymod(int a, int b) {
  int r = a % b;
  return r < 0 ? r + b : r;
}

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* t;             // dynamic: the position on the device
  int t_value, first, n_live;  // static: the position and the live arc
  int s, n_rep, nch;
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

// Shared memory of one block: the K / V stage ring, then fp32 q (pre-scaled),
// acc, scores and the per-head m, l and rescale factor.
template <typename T, int D>
__host__ __device__ constexpr int ring_bytes() {
  return NSTAGE * 2 * CH * D * static_cast<int>(sizeof(T));
}
template <typename T, int D>
int smem_bytes(int n_rep) {
  return ring_bytes<T, D>() + 4 * n_rep * (2 * D + CH + 3);
}

// STATIC: t is p.t_value (p.t is never read) and the walk covers the arc of
// p.n_live slots from p.first; else t is *p.t and the walk covers slots
// 0 .. S - 1 (on a linear cache, the chunks up to t).
template <typename T, int D, bool STATIC>
__global__ void __launch_bounds__(NT) fd_cluster_kernel(Params p) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));  // elements a copy
  constexpr int LPS = D / VEC;   // lanes per K row (2 .. 32)
  constexpr int SPP = NT / LPS;  // rows per pass of the block
  constexpr int PIECES = CH * LPS;
  constexpr int PER_LANE = (CH + 31) / 32;  // softmax slots per lane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sk = reinterpret_cast<T*>(smem_raw);  // NSTAGE x CH x D
  T* sv = sk + NSTAGE * CH * D;            // NSTAGE x CH x D
  const int n_rep = p.n_rep;
  float* sq = reinterpret_cast<float*>(smem_raw +
                                       ring_bytes<T, D>());
  float* sacc = sq + n_rep * D;    // n_rep x D
  float* ss = sacc + n_rep * D;    // n_rep x CH, scores then weights
  float* sm = ss + n_rep * CH;     // n_rep running maxima
  float* sl = sm + n_rep;          // n_rep running sums
  float* sa = sl + n_rep;          // n_rep rescale factors of this chunk

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ncl = static_cast<int>(cluster.num_blocks());
  const int g = blockIdx.y;   // kv head
  const int b = blockIdx.z;   // batch row
  const int h0 = g * n_rep;
  const int tid = threadIdx.x;
  const bool ring = p.window > 0 || p.local_block > 0;

  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh;
  // the cache slot of walk offset j; offsets from `span` on are past the walk
  const int span = STATIC ? p.n_live : p.s;
  auto slot_of = [&](int j) {
    if (!STATIC) return j;
    const int slot = p.first + j;  // first < S and j < n_live <= S
    return slot >= p.s ? slot - p.s : slot;
  };
  auto load_chunk = [&](int i, int stage) {  // rows past the walk are zeroed
    const int c0 = (rank + i * ncl) * CH;
    T* dk = sk + stage * CH * D;
    T* dv = sv + stage * CH * D;
#pragma unroll
    for (int x0 = 0; x0 < PIECES; x0 += NT) {
      const int x = x0 + tid;
      if (PIECES % NT != 0 && x >= PIECES) break;
      const int r = x / LPS, c = (x % LPS) * VEC, j = c0 + r;
      const bool ok = j < span;
      const int slot = slot_of(ok ? j : 0);
      cp_async16(dk + r * D + c, ok ? kg + slot * p.k_ss + c : kg, ok);
      cp_async16(dv + r * D + c, ok ? vg + slot * p.v_ss + c : vg, ok);
    }
  };
  // the first chunks are requested before t is known, so the read of t
  // overlaps their latency; on a linear cache the chunks that start past t
  // are then skipped (their copies land unused)
  const int all = rank < p.nch ? (p.nch - rank + ncl - 1) / ncl : 0;
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) {
    if (i < all) load_chunk(i, i);
    cp_async_commit();
  }
  const int t = STATIC ? p.t_value : *p.t;
  const int nch =
      (!STATIC && !ring && t >= 0) ? min(p.nch, t / CH + 1) : p.nch;
  const int mine = rank < nch ? (nch - rank + ncl - 1) / ncl : 0;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h0 * p.q_sh;
  for (int i = tid; i < n_rep * D; i += NT) {
    sq[i] = to_f(qg[(i / D) * p.q_sh + i % D]) * p.scale;
    sacc[i] = 0.f;
  }
  for (int r = tid; r < n_rep; r += NT) {
    sm[r] = NEG_INF;
    sl[r] = 0.f;
  }

  const int lane = tid & 31, warp = tid >> 5;
  for (int i = 0; i < mine; ++i) {
    cp_async_wait<NSTAGE - 2>();  // chunk i has landed
    __syncthreads();  // ... for every thread; chunk i - 1's readers are done
    if (i + NSTAGE - 1 < mine)
      load_chunk(i + NSTAGE - 1, (i + NSTAGE - 1) % NSTAGE);
    cp_async_commit();
    const T* ck = sk + (i % NSTAGE) * CH * D;
    const T* cv = sv + (i % NSTAGE) * CH * D;
    const int c0 = (rank + i * ncl) * CH;

    // scores: LPS lanes per K row, VEC elements each, one 16-byte read; a
    // row lies in one warp, so the guard below is warp-uniform
#pragma unroll
    for (int pass = 0; pass < (CH + SPP - 1) / SPP; ++pass) {
      const int r = tid / LPS + pass * SPP;
      if (r >= CH) break;
      const int d0 = (tid % LPS) * VEC;
      const uint4 raw = *reinterpret_cast<const uint4*>(ck + r * D + d0);
      const T* kv = reinterpret_cast<const T*>(&raw);
      float kf[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) kf[e] = to_f(kv[e]);
      const int j = c0 + r;
      const bool in = j < span;
      const bool ok = in && slot_valid(p, slot_of(j), t);
      for (int h = 0; h < n_rep; ++h) {
        const float* qh = sq + h * D + d0;
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) a = fmaf(qh[e], kf[e], a);
#pragma unroll
        for (int off = LPS / 2; off > 0; off >>= 1)
          a += __shfl_xor_sync(0xffffffffu, a, off);
        // masked: -1e30 (weight 1 while every slot so far is masked, as in
        // a softmax over all -1e30 scores); past the walk: no weight at all
        if (tid % LPS == 0)
          ss[h * CH + r] = !in ? -INFINITY : (ok ? a : NEG_INF);
      }
    }
    __syncthreads();

    // online softmax: one warp per query head, lanes over the chunk
    for (int h = warp; h < n_rep; h += NT / 32) {
      float x[PER_LANE];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < PER_LANE; ++u) {
        const int c = lane + 32 * u;
        x[u] = c < CH ? ss[h * CH + c] : -INFINITY;
        mx = fmaxf(mx, x[u]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sm[h];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < PER_LANE; ++u) {
        const int c = lane + 32 * u;
        const float e = expf(x[u] - m_new);
        if (c < CH) ss[h * CH + c] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sa[h] = alpha;
        sl[h] = sl[h] * alpha + sum;
        sm[h] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha acc + sum_c w_c V_c: one thread per (head, d)
    for (int i2 = tid; i2 < n_rep * D; i2 += NT) {
      const int h = i2 / D, d = i2 % D;
      const float* w = ss + h * CH;
      float a = sacc[i2] * sa[h];
#pragma unroll
      for (int c = 0; c < CH; ++c) a = fmaf(w[c], to_f(cv[c * D + d]), a);
      sacc[i2] = a;
    }
  }
  cp_async_wait<0>();

  // combine the cluster's partials: block `rank` takes every ncl-th
  // (head, d) entry and reads each rank's m, l and acc remotely
  cluster.sync();
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h0 * p.o_sh;
  for (int i2 = rank * NT + tid; i2 < n_rep * D; i2 += ncl * NT) {
    const int h = i2 / D, d = i2 % D;
    float mg = NEG_INF;
    for (int j = 0; j < ncl; ++j)
      mg = fmaxf(mg, cluster.map_shared_rank(sm, j)[h]);
    float lg = 0.f, ag = 0.f;
    for (int j = 0; j < ncl; ++j) {
      const float c = expf(cluster.map_shared_rank(sm, j)[h] - mg);
      lg = fmaf(cluster.map_shared_rank(sl, j)[h], c, lg);
      ag = fmaf(cluster.map_shared_rank(sacc, j)[i2], c, ag);
    }
    og[h * p.o_sh + d] = from_f<T>(ag / fmaxf(lg, 1e-30f));
  }
  cluster.sync();  // no block leaves while another still reads its memory
}

template <typename T, int D, bool STATIC>
int launch(Params p, int batch, int kv_heads, cudaStream_t stream) {
  auto kernel = fd_cluster_kernel<T, D, STATIC>;
  const int smem = smem_bytes<T, D>(p.n_rep);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  p.nch = ((STATIC ? p.n_live : p.s) + CH - 1) / CH;
  const int ncl = p.nch < MAX_CLUSTER ? p.nch : MAX_CLUSTER;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ncl, kv_heads, batch);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool STATIC>
int dispatch_d(const Params& p, int d, int batch, int kv_heads,
               cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16, STATIC>(p, batch, kv_heads, stream);
    case 32: return launch<T, 32, STATIC>(p, batch, kv_heads, stream);
    case 64: return launch<T, 64, STATIC>(p, batch, kv_heads, stream);
    case 128: return launch<T, 128, STATIC>(p, batch, kv_heads, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool STATIC>
int dispatch(const Params& p, int dtype, int d, int batch, int kv_heads,
             void* stream) {
  if (kv_heads <= 0 || p.s <= 0 || batch <= 0 || batch > 65535 ||
      kv_heads > 65535 || p.n_rep <= 0 || p.n_rep * kv_heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float, STATIC>(p, d, batch, kv_heads, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16, STATIC>(p, d, batch, kv_heads, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; t points to
// one int32 on the device.  K and V move as 16-byte copies, so their
// pointers and slot / head / batch strides must be multiples of 16 bytes
// (the wrapper checks).
int repro_flash_decode_fwd(
    const void* q, const void* k, const void* v, void* o, const void* t,
    int dtype, int batch, int s, int heads, int kv_heads, int d,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_sh,
    float scale, int window, int local_block, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, static_cast<const int*>(t), 0, 0, 0,
           s, heads / kv_heads, 0,
           q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh,
           scale, window, local_block};
  return dispatch<false>(p, dtype, d, batch, kv_heads, stream);
}

// The same with the position t >= 0 by value and the arc of live slots the
// host computed from it: n_live slots from slot `first`, wrapping past
// S - 1 on a ring cache (0 < n_live <= S, 0 <= first < S).  Nothing is
// read from the host or copied to the device besides the launch.
int repro_flash_decode_static_fwd(
    const void* q, const void* k, const void* v, void* o, int t, int first,
    int n_live, int dtype, int batch, int s, int heads, int kv_heads, int d,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_sh,
    float scale, int window, int local_block, void* stream) {
  if (kv_heads <= 0 || heads % kv_heads != 0 || t < 0 || n_live <= 0 ||
      n_live > s || first < 0 || first >= s)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, nullptr, t, first, n_live,
           s, heads / kv_heads, 0,
           q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh,
           scale, window, local_block};
  return dispatch<true>(p, dtype, d, batch, kv_heads, stream);
}

const char* repro_flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
