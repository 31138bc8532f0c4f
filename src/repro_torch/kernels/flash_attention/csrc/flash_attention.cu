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
// kv head h / n_rep.  The Pallas kernel's sequential kv grid dimension
// becomes a loop over 64-row K/V tiles inside each block.
//
// Bound on this card: causal attention does 2 B H D S^2 flops on
// 4 B S D (H + KV) bytes of q, k, v and o in bf16, so S H / (2 (H + KV))
// flops per byte: S / 3 for InternLM2's 16 q over 8 kv heads.  That
// crosses the H100's ~295 flop/byte ridge near S = 885, so the serving
// prompt (S = 128) is bound by bytes and long prompts by operations.
//
// Two routes, chosen by dtype:
//
// * bfloat16 (the serving path): tensor cores, FlashAttention-2 style.
//   One block per (q tile of 16 x W rows, q head, batch), W warps of 16
//   query rows each.  The wrapper picks W in {1, 2, 4} so that the grid
//   fills the SMs where the shape allows, and the K / V tile: 32 rows in a
//   ring of 4 for short prompts, where each tile's latency sets the pace,
//   64 rows in a ring of 2 for long ones (both measured on the H100).  Q,
//   K and V tiles move from HBM as 16-byte cp.async.cg copies into bf16
//   shared memory whose rows are padded by 16 bytes, so the ldmatrix reads
//   of 8 rows hit 8 distinct 16-byte bank groups; K / V tiles are requested
//   NSTAGE - 1 tiles ahead of the one in use, with one barrier per tile.
//   S = Q K^T and O += P V are mma.sync.m16n8k16 bf16 products with fp32
//   accumulators; each warp keeps its Q fragments, S fragment, m, l and O
//   in registers, and P is rounded to bf16 in registers and fed back as
//   the A operand of P V (never through shared memory).  The softmax is
//   fp32, in the exp2 domain; a tile with no masked pair for a warp skips
//   the per-element mask tests.  The output tile is staged in the Q tile's
//   space and written as 16-byte rows.  wgmma with TMA-fed tiles is the
//   next step, for prompts long enough (S >~ 885) that the tensor-core
//   rate binds.
//
// * float32 (the reduced-model checks, where 2e-5 rules out bf16 and TF32
//   products): scalar fp32 FMAs.  One block of 256 threads per (64-row q
//   tile, q head, batch) as a 16 x 16 grid: thread (ty, tx) owns q rows
//   ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and output columns
//   tx + 16 k (k < D / 16); tiles are staged in shared memory as fp32,
//   Q / K rows padded by one float.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG_INF = -1e30f;

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

// Whether any (q, kv) pair with q in [qlo, qhi] and kv in [k0, khi] is
// unmasked: the tile-level test that lets a block or warp skip a tile.
__device__ __forceinline__ bool tile_reachable(const Params& p, int qlo,
                                               int qhi, int k0, int khi) {
  bool run = true;
  if (p.causal) run = run && qhi >= k0;
  if (p.window > 0) run = run && (qlo - khi < p.window);
  if (p.local_block > 0)
    run = run && floordiv(qhi, p.local_block) >= floordiv(k0, p.local_block)
          && floordiv(qlo, p.local_block) <= floordiv(khi, p.local_block);
  return run;
}

__device__ __forceinline__ bool pair_ok(const Params& p, int qpos, int kpos) {
  bool ok = true;
  if (p.causal) ok = ok && qpos >= kpos;
  if (p.window > 0) ok = ok && (qpos - kpos < p.window);
  if (p.local_block > 0)
    ok = ok && floordiv(qpos, p.local_block) == floordiv(kpos, p.local_block);
  return ok;
}

template <typename Kernel>
int opt_in_smem(Kernel kernel, int smem, bool& configured) {
  if (configured) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  configured = true;
  return 0;
}

// ---------------------------------------------------------------------------
// bfloat16 route: mma.sync tensor cores fed from a cp.async ring of tiles
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16-byte async copy; ok == false zero-fills the destination (src is not
// read, but must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
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

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<unsigned*>(&v);
}

template <int D, int W, int BK, int NSTAGE>
constexpr int smem_bytes() {
  // Q tile (16 W rows) + NSTAGE K tiles + NSTAGE V tiles, rows of D + 8
  return (16 * W + 2 * NSTAGE * BK) * (D + 8) * 2;
}

// W warps of 16 query rows; K / V tiles of BK rows in a ring of NSTAGE
template <int D, int W, int BK, int NSTAGE>
__global__ void __launch_bounds__(32 * W) fa_tc_kernel(Params p) {
  constexpr int BQ = 16 * W;
  constexpr int NT = 32 * W;
  constexpr int LD = D + 8;     // padded row, in bf16 elements
  constexpr int CPR = D / 8;    // 16-byte pieces per row
  constexpr int NS = BK / 8;    // score n-tiles per K tile
  constexpr int NO = D / 8;     // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD, later the output
  bf16* sK = sQ + BQ * LD;                       // NSTAGE x BK x LD
  bf16* sV = sK + NSTAGE * BK * LD;              // NSTAGE x BK x LD

  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = hh / p.n_rep;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;  // mma fragment row / column pair

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + hh * p.o_sh;

  // thread tid copies 16-byte piece pc of rows pr, pr + RS, ... of a tile
  constexpr int RS = NT / CPR;
  const int pc = (tid % CPR) * 8, pr = tid / CPR;
  {  // Q rows past sq are zero-filled
    const bf16* src = qg + static_cast<long long>(q0 + pr) * p.q_ss + pc;
#pragma unroll
    for (int r = 0; r < BQ; r += RS) {
      const bool ok = q0 + pr + r < p.sq;
      cp_async16(sQ + (pr + r) * LD + pc, ok ? src : qg, ok);
      src += RS * p.q_ss;
    }
  }
  auto load_kv = [&](int kb, int stage) {  // rows past skv are zero-filled
    bf16* dk = sK + stage * BK * LD + pc;
    bf16* dv = sV + stage * BK * LD + pc;
    const int row0 = kb * BK + pr;
    const bf16* ks = kg + static_cast<long long>(row0) * p.k_ss + pc;
    const bf16* vs = vg + static_cast<long long>(row0) * p.v_ss + pc;
#pragma unroll
    for (int r = 0; r < BK; r += RS) {
      if (RS > BK && pr >= BK) break;  // more threads than pieces
      const bool ok = row0 + r < p.skv;
      cp_async16(dk + (pr + r) * LD, ok ? ks : kg, ok);
      cp_async16(dv + (pr + r) * LD, ok ? vs : vg, ok);
      ks += RS * p.k_ss;
      vs += RS * p.v_ss;
    }
  };

  // first and last real query positions of the block and of this warp
  const int qlo = p.q_offset + q0;
  const int qhi = p.q_offset + min(q0 + BQ, p.sq) - 1;
  const int wrow0 = q0 + warp * 16;
  const bool warp_live = wrow0 < p.sq;
  const int wqlo = p.q_offset + wrow0;
  const int wqhi = p.q_offset + min(wrow0 + 16, p.sq) - 1;
  const int nk = (p.skv + BK - 1) / BK;
  auto next_tile = [&](int kb) {  // the next tile the block must visit
    for (; kb < nk; ++kb)
      if (tile_reachable(p, qlo, qhi, kb * BK, min(kb * BK + BK, p.skv) - 1))
        break;
    return kb;
  };

  // the ring: tiles are requested NSTAGE - 1 ahead of the one in use; the
  // first group also carries Q
  int kb_next = next_tile(0);
#pragma unroll
  for (int st = 0; st < NSTAGE - 1; ++st) {
    if (kb_next < nk) {
      load_kv(kb_next, st);
      kb_next = next_tile(kb_next + 1);
    }
    cp_async_commit();
  }

  const float sl2 = p.scale * LOG2E;  // scores in the exp2 domain
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // rows g and g + 8 of this warp
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  unsigned qf[D / 16][4];
  bool have_q = false;

  for (int kb = next_tile(0), i = 0; kb < nk; kb = next_tile(kb + 1), ++i) {
    cp_async_wait<NSTAGE - 2>();  // tile i (and Q) has landed
    __syncthreads();  // ... for every thread; tile i - 1's readers are done
    if (kb_next < nk) {
      load_kv(kb_next, (i + NSTAGE - 1) % NSTAGE);
      kb_next = next_tile(kb_next + 1);
    }
    cp_async_commit();
    if (!have_q) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                            (lane >> 4) * 8);
      have_q = true;
    }
    const int k0 = kb * BK;
    const int khi = min(k0 + BK, p.skv) - 1;
    if (!(warp_live && tile_reachable(p, wqlo, wqhi, k0, khi))) continue;
    const bf16* tk = sK + (i % NSTAGE) * BK * LD;
    const bf16* tv = sV + (i % NSTAGE) * BK * LD;
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    // S = Q K^T: B operand = K rows (n) by d (k), non-transposed ldmatrix
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        unsigned kf[4];
        ldsm_x4(kf, tk + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], kf[2], kf[3]);
      }
    }
    // masks, scale, online softmax; element e of n-tile j sits at row
    // g + 8 (e >> 1), column 8 j + 2 tg + (e & 1).  A tile with no masked
    // pair for this warp's rows skips the per-element tests and folds the
    // scale into the exp2's FMA (sc); otherwise the scores are scaled and
    // masked in place (sc = 1).
    bool full = k0 + BK <= p.skv;
    if (p.causal) full = full && wqlo >= k0 + BK - 1;
    if (p.window > 0) full = full && wqhi - k0 < p.window;
    if (p.local_block > 0) {  // every pair in one block
      const int blk = floordiv(wqlo, p.local_block);
      full = full && blk == floordiv(wqhi, p.local_block) &&
             blk == floordiv(k0, p.local_block) &&
             blk == floordiv(k0 + BK - 1, p.local_block);
    }
    const float sc = full ? sl2 : 1.f;
    if (!full) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qpos = wqlo + g + 8 * (e >> 1);
          const int kpos = k0 + 8 * j + 2 * tg + (e & 1);
          float x = s[j][e] * sl2;
          if (kpos >= p.skv) x = -INFINITY;  // past the end: weight 0
          else if (!pair_ok(p, qpos, kpos)) x = NEG_INF;
          s[j][e] = x;
        }
    }
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * h2], s[j][2 * h2 + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h2], mx * sc);
      const float alpha = exp2f(m[h2] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 2 * h2; e < 2 * h2 + 2; ++e) {
          const float pe = exp2f(fmaf(s[j][e], sc, -m_new));
          s[j][e] = pe;
          rs += pe;
        }
      l[h2] = l[h2] * alpha + rs;
      m[h2] = m_new;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][2 * h2] *= alpha;
        o[j][2 * h2 + 1] *= alpha;
      }
    }
    // O += P V: P from the score accumulators (bf16, registers), B operand
    // = V rows (k) by d (n), transposed ldmatrix
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const unsigned pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned vf[4];
        ldsm_x4_t(vf, tv + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                               LD + dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the Q tile's space may now take the output

  // normalise, stage this warp's 16 rows in its own rows of sQ, write rows
  // of 16-byte pieces
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float lt = l[h2];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    bf16* row = sQ + (warp * 16 + g + 8 * h2) * LD + 2 * tg;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<unsigned*>(row + 8 * j) =
          pack_bf16(o[j][2 * h2] * inv, o[j][2 * h2 + 1] * inv);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = i % CPR, row = wrow0 + r;
    if (row < p.sq)
      *reinterpret_cast<uint4*>(og + row * p.o_ss + c * 8) =
          *reinterpret_cast<const uint4*>(sQ + (warp * 16 + r) * LD + c * 8);
  }
}

template <int D, int W, int BK, int NSTAGE>
int launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D, W, BK, NSTAGE>();
  static bool configured = false;  // the opt-in above 48 KB, once
  int err = opt_in_smem(fa_tc_kernel<D, W, BK, NSTAGE>, smem, configured);
  if (err) return err;
  dim3 grid((p.sq + 16 * W - 1) / (16 * W), heads, batch);
  fa_tc_kernel<D, W, BK, NSTAGE><<<grid, 32 * W, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// kv_tile 32: a ring of 4 (short prompts, where a tile's latency counts);
// kv_tile 64: a ring of 2 (long prompts, where fewer, larger tiles do)
template <int D, int W>
int dispatch_kv(const Params& p, int kv_tile, int batch, int heads,
                cudaStream_t stream) {
  switch (kv_tile) {
    case 32: return launch<D, W, 32, 4>(p, batch, heads, stream);
    case 64: return launch<D, W, 64, 2>(p, batch, heads, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int D>
int dispatch_w(const Params& p, int q_tile, int kv_tile, int batch,
               int heads, cudaStream_t stream) {
  switch (q_tile) {
    case 16: return dispatch_kv<D, 1>(p, kv_tile, batch, heads, stream);
    case 32: return dispatch_kv<D, 2>(p, kv_tile, batch, heads, stream);
    case 64: return dispatch_kv<D, 4>(p, kv_tile, batch, heads, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(const Params& p, int d, int q_tile, int kv_tile, int batch,
             int heads, cudaStream_t stream) {
  switch (d) {
    case 16: return dispatch_w<16>(p, q_tile, kv_tile, batch, heads, stream);
    case 32: return dispatch_w<32>(p, q_tile, kv_tile, batch, heads, stream);
    case 64: return dispatch_w<64>(p, q_tile, kv_tile, batch, heads, stream);
    case 128:
      return dispatch_w<128>(p, q_tile, kv_tile, batch, heads, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32 route: scalar FMA products, fp32 tiles
// ---------------------------------------------------------------------------
namespace fp32 {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NTHREADS = 256;

template <int D>
constexpr int smem_floats() {
  // sQ (BQ x D+1) + shared K / P region + sV (BK x D)
  return BQ * (D + 1) +
         (BK * (D + 1) > BQ * (BK + 1) ? BK * (D + 1) : BQ * (BK + 1)) +
         BK * D;
}

template <int D>
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

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + hh * p.o_sh;

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    sQ[r * DP + d] = (q0 + r < p.sq) ? qg[(q0 + r) * p.q_ss + d] * p.scale
                                     : 0.f;
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
    // uniform across the block, so the barriers stay matched
    if (!tile_reachable(p, qlo, qhi, k0, khi)) continue;

    __syncthreads();  // previous tile's P / V reads are done
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int r = i / D, d = i % D;
      const bool ok = k0 + r < p.skv;  // tail rows are zeroed
      sK[r * DP + d] = ok ? kg[(k0 + r) * p.k_ss + d] : 0.f;
      sV[r * D + d] = ok ? vg[(k0 + r) * p.v_ss + d] : 0.f;
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
        if (!(kpos < p.skv && pair_ok(p, qpos, kpos))) s[i][j] = NEG_INF;
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
        og[row * p.o_ss + tx + 16 * k] = acc[i][k] / den;
    }
  }
}

template <int D>
int launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  static bool configured = false;  // the opt-in above 48 KB, once
  int err = opt_in_smem(fa_fwd_kernel<D>, smem, configured);
  if (err) return err;
  dim3 grid((p.sq + BQ - 1) / BQ, heads, batch);
  fa_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Params& p, int d, int batch, int heads,
             cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16>(p, batch, heads, stream);
    case 32: return launch<32>(p, batch, heads, stream);
    case 64: return launch<64>(p, batch, heads, stream);
    case 128: return launch<128>(p, batch, heads, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace fp32

}  // namespace

extern "C" {

// dtype: 0 = float32 (the FMA route), 1 = bfloat16 (the tensor-core route).
// Strides are in elements.  q_tile / kv_tile: query rows per block (16, 32
// or 64) and K / V rows per tile (32 or 64) of the bfloat16 route; the
// float32 route always takes 64 and 64.  The bfloat16 route copies 16-byte
// pieces, so its pointers and row strides must be multiples of 16 bytes
// (the wrapper checks).
int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int sq, int skv, int heads, int kv_heads, int d, int q_tile,
    int kv_tile,
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
  if (dtype == 0) return fp32::dispatch(p, d, batch, heads, st);
  if (dtype == 1)
    return tc::dispatch(p, d, q_tile, kv_tile, batch, heads, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* repro_flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
