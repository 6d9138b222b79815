// Flash attention backward, written by hand for Hopper (sm_90a).
//
// Replaces: jax.vjp of src/repro/kernels/ops.py::_jnp_flash_attention. The
//   JAX package trains through autodiff of its jnp path: neither Pallas
//   kernel (flash_attention_pallas, src/repro/kernels/flash_attention.py:113)
//   has a backward, so there is no TPU kernel body to translate.
//
// Computes: dQ, dK and dV of o = softmax(scale * q k^T + mask) v, causal and
//   optionally sliding-window, GQA with kv head = h / grp, query positions
//   right-aligned (qpos = i + Sk - Sq) as in the forward, from (q, k, v, o,
//   lse, dO), where lse (B, H, Sq) f32 is the forward's per-row log-sum-exp
//   in scaled units (csrc/flash_attention.cu). As in FlashAttention-2's
//   backward, P = exp(scale q k^T - lse) is recomputed tile by tile and the
//   S x S matrix never exists in device memory:
//     pass 1: delta_i = rowsum(dO_i * O_i), f32 (one warp a row);
//     pass 2: one block per (key tile, query head, batch): dV = sum P^T dO
//             and dK = sum dS^T Q, with dS = P * (dO V^T - delta), over the
//             query rows the tile is visible to (the causal limit, the
//             window's edge). With grp = 1 it writes dk (times scale) and dv;
//             with grp > 1 it writes its f32 partials to a scratch buffer
//             (2, B, Sk, H, D), and
//     pass 4 (grp > 1 only) sums each kv head's grp partials in the order
//             g = 0 .. grp - 1, applies scale to dK and rounds once;
//     pass 3: one block per (query tile, head, batch): dQ = scale * sum dS K
//             over the key tiles visible to it.
//   No atomics: every output element is summed in one fixed order, so the
//   result is bitwise repeatable from call to call. Masked pairs give P = 0
//   (the forward's -1e30 scores contribute exp(-1e30 - lse) = 0), so no row
//   turns into NaN. The key tiles of pass 2 that see the most query rows
//   (the low ones, under a causal mask) and the query tiles of pass 3 that
//   see the most keys (the high ones) are handed out first: the grid's x
//   index is the head, so every head's heavy tile goes before any light one.
//
// Bound on the H100: at long S the operations, 2.5x the forward's 4 *
//   (visible q-k pairs) * D * H (five products; the body runs seven, since
//   passes 2 and 3 each recompute S and dP), on the bf16 tensor cores; at
//   musicgen-medium's training shape (4, 128, 24 heads of 64) the three
//   launches and one trip to device memory.
//
// Design, bf16 (the training path): FlashAttention-2's backward on mma.sync
//   m16n8k16 bf16 -> f32, 128 threads (4 warps) a block, tiles of 64 rows.
//   Pass 2 in transposed form: each warp holds 16 of the block's 64 keys
//   and computes S^T = K Q^T and dP^T = V dO^T, so P^T = exp(scale S^T -
//   lse) and dS^T = P^T * (dP^T - delta) leave the accumulators already in
//   the A-operand layout of dV += P^T dO and dK += dS^T Q, and are packed to
//   bf16 in registers as the forward packs P. K and V stay in shared memory
//   for the block and are read by ldmatrix; Q and dO come by ldmatrix for
//   the scores and by ldmatrix.trans for the sums. Q, dO, lse and delta of
//   each 64-row query tile arrive by cp.async (16 bytes a copy for the
//   tiles, 4 for lse and delta) into a 2-stage ring, the next tile's copy
//   in flight while this one's products run. Pass 3: each warp holds 16
//   query rows, its Q and dO fragments loaded once into registers; K and V
//   tiles stream through the same kind of ring, and dS is packed to bf16 as
//   the A operand of dQ += dS K, K by ldmatrix.trans. In both passes only
//   tiles on the diagonal, at the window's edge or at the ragged end
//   compute a mask. lse, delta, the exponent and every accumulator are f32;
//   P and dS are rounded to bf16 only as mma operands, as the forward
//   rounds P. The products of a warp run over 64 query rows (pass 2) or 64
//   keys (pass 3) at once, 32 at D = 128, so that the S and dP accumulators
//   fit beside two 16 x 128 f32 accumulators (pass 2) or the Q and dO
//   fragments (pass 3) without spilling.
//
// Shared memory and registers: both passes stage six padded 64-row bf16
//   tiles (rows of D + 8 elements, so ldmatrix is free of bank conflicts):
//   pass 2 K, V and two stages of Q, dO (plus 1 KB of lse and delta), pass
//   3 Q, dO and two stages of K, V; 30, 54 or 102 KB at D = 32, 64, 128.
//   Registers, as ptxas reports them for sm_90a (-Xptxas -v, kept beside
//   the library by kernels/_build.py): pass 2 193, 221 and 252, pass 3 158,
//   230 and 247 at D = 32, 64, 128, so two blocks share an SM; no
//   instantiation may spill (the card tests and chip_smoke.py check).
//
// float32 keeps the simple body (tests and chip_smoke only): tiles staged in
//   shared memory as fp32, every product a scalar FMA, no rounding but the
//   outputs'. TF32 would miss its 2e-5 tolerance, as in the forward. It
//   shares the bf16 body's grid and GQA sum. This is a dispatch on dtype,
//   not a fallback.
//
// Next step: wgmma with TMA loads and warp specialisation.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;        // threads per block of passes 2 and 3

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// pass 1: delta (B, H, Sq) = rowsum(dO * O), one warp a row of (B, Sq, H)
template <typename T, int D>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(const T* __restrict__ o,
                                                              const T* __restrict__ dO,
                                                              float* __restrict__ delta,
                                                              long n_rows, int Sq, int H) {
  const long row = (long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += to_float(o[row * D + c]) * to_float(dO[row * D + c]);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long bi = row / H;
    const int i = (int)(bi % Sq);
    const long b = bi / Sq;
    delta[(b * H + h) * Sq + i] = s;
  }
}

// pass 4: dk = scale * sum_g part_k, dv = sum_g part_v over the grp query
// heads of each kv head, in the order g = 0 .. grp - 1; part is (2, B, Sk,
// H, D) f32, dK's partials then dV's. One thread per 4 output elements.
template <typename T> __device__ __forceinline__ void store4(T* p, float4 x);
template <> __device__ __forceinline__ void store4<float>(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
template <> __device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_gqa_sum_kernel(const float* __restrict__ part,
                                                                T* __restrict__ dk,
                                                                T* __restrict__ dv, long n4,
                                                                int H, int KV, int D,
                                                                float scale) {
  const long e = (long)blockIdx.x * 256 + threadIdx.x;
  if (e >= n4) return;
  const int grp = H / KV;
  const long o = e * 4;                     // ((b Sk + key) KV + kvh) D + c
  const long r = o / ((long)KV * D);        // b Sk + key
  const int kvh = (int)(o % ((long)KV * D)) / D, c = (int)(o % D);
  const long plane = n4 * 4 * grp;          // B Sk H D
  const float* pk = part + (r * H + (long)kvh * grp) * D + c;
  float4 sk = *reinterpret_cast<const float4*>(pk);
  float4 sv = *reinterpret_cast<const float4*>(pk + plane);
  for (int g = 1; g < grp; ++g) {
    const float4 a = *reinterpret_cast<const float4*>(pk + (long)g * D);
    const float4 w = *reinterpret_cast<const float4*>(pk + plane + (long)g * D);
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += w.x; sv.y += w.y; sv.z += w.z; sv.w += w.w;
  }
  sk.x *= scale; sk.y *= scale; sk.z *= scale; sk.w *= scale;
  store4<T>(dk + o, sk);
  store4<T>(dv + o, sv);
}

// ---- float32: the simple body ------------------------------------------

constexpr int BR = 32;         // query rows per tile
constexpr int BC = 32;         // keys per tile
constexpr int FNT = 256;       // threads per block
constexpr int TPR = FNT / BR;  // threads per query row (score phase) or per key (pass 2 sums)
constexpr int KPT = BC / TPR;  // keys scored per thread per tile (4)
constexpr int PS = BC + 1;     // padded row stride of the P and dS tiles
static_assert(BR == BC, "pass 2 maps one key of its tile to each group of TPR threads");

// the padded row stride of a staged (rows, D) tile, and the block's shared
// memory: Q, dO, K, V tiles, the P and dS tiles, lse and delta of the rows
template <int D> __host__ __device__ constexpr int dp() { return D + 1; }
template <int D> __host__ __device__ constexpr int smem_bytes() {
  return (2 * BR * dp<D>() + 2 * BC * dp<D>() + 2 * BR * PS + 2 * BR) * 4;
}

struct Tiles {
  float *qs, *dos, *ks, *vs, *ps, *dss, *lse_s, *del_s;
};

template <int D>
__device__ __forceinline__ Tiles carve(float* sm) {
  Tiles t;
  t.qs = sm;
  t.dos = t.qs + BR * dp<D>();
  t.ks = t.dos + BR * dp<D>();
  t.vs = t.ks + BC * dp<D>();
  t.ps = t.vs + BC * dp<D>();
  t.dss = t.ps + BR * PS;
  t.lse_s = t.dss + BR * PS;
  t.del_s = t.lse_s + BR;
  return t;
}

// rows row0 .. row0 + 31 of a (n_rows, stride) array, D wide, into a padded
// tile; rows at or past n_rows are zero
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, long stride, int row0,
                                      int n_rows) {
  for (int e = threadIdx.x; e < BR * D; e += FNT) {
    const int r = e / D, c = e % D;
    dst[r * dp<D>() + c] = row0 + r < n_rows ? src[(long)(row0 + r) * stride + c] : 0.f;
  }
}

// lse and delta of query rows i0 .. i0 + 31 of head h (0 past Sq)
__device__ __forceinline__ void stage_rows(const Tiles& t, const float* lse, const float* delta,
                                           long head_row0, int i0, int Sq) {
  if (threadIdx.x < BR) {
    const int i = i0 + threadIdx.x;
    t.lse_s[threadIdx.x] = i < Sq ? lse[head_row0 + i] : 0.f;
    t.del_s[threadIdx.x] = i < Sq ? delta[head_row0 + i] : 0.f;
  }
}

// The tile's P (if WANT_P) and dS: thread (r, c) scores query row r of the
// tile against keys c, c + 8, c + 16, c + 24. Rows past Sq, keys past Sk and
// masked pairs get P = dS = 0.
template <int D, bool WANT_P>
__device__ __forceinline__ void score_tile(const Tiles& t, int i0, int k0, int Sq, int Sk,
                                           int off, int causal, int window, float scale) {
  const int r = threadIdx.x / TPR, c = threadIdx.x % TPR;
  float s[KPT], dpv[KPT];
#pragma unroll
  for (int j = 0; j < KPT; ++j) s[j] = dpv[j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float qv = t.qs[r * dp<D>() + d], dov = t.dos[r * dp<D>() + d];
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      s[j] += qv * t.ks[(c + TPR * j) * dp<D>() + d];
      dpv[j] += dov * t.vs[(c + TPR * j) * dp<D>() + d];
    }
  }
  const int i = i0 + r, qpos = i + off;
  const float lse_r = t.lse_s[r], del_r = t.del_s[r];
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int kpos = k0 + c + TPR * j;
    bool ok = i < Sq && kpos < Sk;
    if (causal) ok = ok && qpos >= kpos;
    if (window >= 0) ok = ok && qpos - kpos < window;
    const float p = ok ? expf(s[j] * scale - lse_r) : 0.f;
    if (WANT_P) t.ps[r * PS + c + TPR * j] = p;
    t.dss[r * PS + c + TPR * j] = p * (dpv[j] - del_r);
  }
}

// pass 2: dK and dV of one 32-key tile against one query head
template <int D>
__global__ void __launch_bounds__(FNT) flash_bwd_dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dO, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ part, int Sq, int Sk,
    int H, int KV, int causal, int window, float scale) {
  constexpr int CPT = D / TPR;  // accumulator columns per thread
  extern __shared__ __align__(16) float sm[];
  const Tiles t = carve<D>(sm);
  const int h = blockIdx.x;
  const int k0 = blockIdx.y * BC;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int off = Sk - Sq;
  const long q_stride = (long)H * D, kv_stride = (long)KV * D;
  stage<D>(t.ks, k + (long)b * Sk * kv_stride + (long)kvh * D, kv_stride, k0, Sk);
  stage<D>(t.vs, v + (long)b * Sk * kv_stride + (long)kvh * D, kv_stride, k0, Sk);
  const float* qb = q + (long)b * Sq * q_stride + (long)h * D;
  const float* dob = dO + (long)b * Sq * q_stride + (long)h * D;

  // the query rows that see some key of this tile
  const int k_last = min(k0 + BC, Sk) - 1;
  const int i_lo = causal ? max(0, k0 - off) : 0;
  const int i_hi = window >= 0 ? min(Sq, k_last + window - off) : Sq;

  const int j = threadIdx.x / TPR, cc = threadIdx.x % TPR;  // this thread's key and columns
  float adk[CPT], adv[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) adk[c] = adv[c] = 0.f;

  for (int i0 = i_lo; i0 < i_hi; i0 += BR) {
    __syncthreads();  // the previous tile is consumed
    stage<D>(t.qs, qb, q_stride, i0, Sq);
    stage<D>(t.dos, dob, q_stride, i0, Sq);
    stage_rows(t, lse, delta, ((long)b * H + h) * Sq, i0, Sq);
    __syncthreads();
    score_tile<D, true>(t, i0, k0, Sq, Sk, off, causal, window, scale);
    __syncthreads();
    for (int r = 0; r < BR; ++r) {
      const float p = t.ps[r * PS + j], ds = t.dss[r * PS + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        adv[c] += p * t.dos[r * dp<D>() + cc + TPR * c];
        adk[c] += ds * t.qs[r * dp<D>() + cc + TPR * c];
      }
    }
  }
  if (k0 + j >= Sk) return;
  if (part == nullptr) {
    const long base = ((long)b * Sk + k0 + j) * kv_stride + (long)kvh * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dk[base + cc + TPR * c] = adk[c] * scale;
      dv[base + cc + TPR * c] = adv[c];
    }
  } else {
    const long base = ((long)b * Sk + k0 + j) * q_stride + (long)h * D;
    const long plane = (long)gridDim.z * Sk * q_stride;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      part[base + cc + TPR * c] = adk[c];
      part[plane + base + cc + TPR * c] = adv[c];
    }
  }
}

// pass 3: dQ of one 32-row query tile of one head
template <int D>
__global__ void __launch_bounds__(FNT) flash_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dO, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int Sq, int Sk, int H, int KV, int causal, int window,
    float scale) {
  constexpr int CPT = D / TPR;
  extern __shared__ __align__(16) float sm[];
  const Tiles t = carve<D>(sm);
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int off = Sk - Sq;
  const long q_stride = (long)H * D, kv_stride = (long)KV * D;
  const float* kb = k + (long)b * Sk * kv_stride + (long)kvh * D;
  const float* vb = v + (long)b * Sk * kv_stride + (long)kvh * D;
  stage<D>(t.qs, q + (long)b * Sq * q_stride + (long)h * D, q_stride, q0, Sq);
  stage<D>(t.dos, dO + (long)b * Sq * q_stride + (long)h * D, q_stride, q0, Sq);
  stage_rows(t, lse, delta, ((long)b * H + h) * Sq, q0, Sq);

  // the keys that some row of this tile can see, as in the forward
  const int qpos_lo = q0 + off;
  const int qpos_hi = min(q0 + BR, Sq) - 1 + off;
  const int k_end = causal ? min(Sk, qpos_hi + 1) : Sk;
  const int k_begin = window >= 0 ? max(0, qpos_lo - window + 1) / BC * BC : 0;

  const int r = threadIdx.x / TPR, cc = threadIdx.x % TPR;  // this thread's row and columns
  float adq[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) adq[c] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BC) {
    __syncthreads();  // the previous tile is consumed; the Q tile is staged
    stage<D>(t.ks, kb, kv_stride, k0, Sk);
    stage<D>(t.vs, vb, kv_stride, k0, Sk);
    __syncthreads();
    score_tile<D, false>(t, q0, k0, Sq, Sk, off, causal, window, scale);
    __syncthreads();
    for (int jj = 0; jj < BC; ++jj) {
      const float ds = t.dss[r * PS + jj];
#pragma unroll
      for (int c = 0; c < CPT; ++c) adq[c] += ds * t.ks[jj * dp<D>() + cc + TPR * c];
    }
  }
  if (q0 + r < Sq) {
    const long base = ((long)b * Sq + q0 + r) * q_stride + (long)h * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) dq[base + cc + TPR * c] = adq[c] * scale;
  }
}

// ---- bf16: tensor cores -------------------------------------------------

constexpr int TB = 64;  // rows of every staged tile: keys or query rows
// per head_dim TD: the padded row stride (bf16 elements, +16 bytes), one
// staged tile, the dynamic shared memory of passes 2 (six tiles, and lse and
// delta of two stages) and 3 (six tiles), and the query rows (pass 2) or
// keys (pass 3) a warp's products take at once
template <int TD> __host__ __device__ constexpr int trs() { return TD + 8; }
template <int TD> __host__ __device__ constexpr int tile() { return TB * trs<TD>(); }
template <int TD> __host__ __device__ constexpr int smem_dkdv() {
  return 6 * tile<TD>() * 2 + 4 * TB * 4;
}
template <int TD> __host__ __device__ constexpr int smem_dq() { return 6 * tile<TD>() * 2; }
template <int TD> __host__ __device__ constexpr int chunk() { return TD == 128 ? 32 : 64; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared; in == false zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
// 4 bytes, likewise
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col). Accumulator
// element e of lane 4 g + t sits at row g + 8 (e >> 1), column 2 t + (e & 1).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// The A operand (16 x 16) whose k columns are those of accumulator tiles
// x[2 kk] and x[2 kk + 1], rounded to bf16
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// 64 rows of TD bf16 from global (rows row0.. of a (rows, stride) array) to
// a padded shared tile; rows at or past n_rows are zero-filled
template <int TD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long stride, int row0, int n_rows, int tid) {
  static_assert(TB * TD / 8 % NT == 0, "the 16-byte copies of a tile fill whole rounds");
#pragma unroll
  for (int j = 0; j < TB * TD / 8 / NT; ++j) {
    const int e = tid + j * NT, r = e / (TD / 8), col = e % (TD / 8) * 8;
    const bool in = row0 + r < n_rows;
    cp_async16(dst + r * trs<TD>() + col, src + (in ? (row0 + r) * stride + col : 0), in);
  }
}

// Per-lane offsets (elements) into a padded tile for ldmatrix. a_off: the
// A operand of rows 0..15 (row-major, k 0..15 along the row); with
// ldmatrix.trans the same offsets give the B operand whose k runs down rows
// 0..15 (b0, b1 of columns 0..7, then of 8..15). b_off: the B operand whose
// n runs down rows 0..15 (b0, b1 of rows 0..7, then of 8..15; k along the row).
template <int TD> __device__ __forceinline__ int a_off(int lane) {
  return (((lane >> 3) & 1) * 8 + (lane & 7)) * trs<TD>() + (lane >> 4) * 8;
}
template <int TD> __device__ __forceinline__ int b_off(int lane) {
  return ((lane >> 4) * 8 + (lane & 7)) * trs<TD>() + ((lane >> 3) & 1) * 8;
}

// pass 2: dK and dV of one 64-key tile against one query head
template <int TD>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, float* __restrict__ part,
    int Sq, int Sk, int H, int KV, int causal, int window, float scale) {
  constexpr int TRS = trs<TD>();
  constexpr int TILE = tile<TD>();
  constexpr int QC = chunk<TD>();
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + TILE;
  // ring stage s: Q at ring + 2 s TILE, dO after it; lse at rows + 2 s TB, delta after it
  __nv_bfloat16* ring = vs + TILE;
  float* rows = reinterpret_cast<float*>(ring + 4 * TILE);

  const int h = blockIdx.x;
  const int k0 = blockIdx.y * TB;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int off = Sk - Sq;
  const long q_stride = (long)H * TD, kv_stride = (long)KV * TD;
  const __nv_bfloat16* qb = q + (long)b * Sq * q_stride + (long)h * TD;
  const __nv_bfloat16* dob = dO + (long)b * Sq * q_stride + (long)h * TD;
  const float* lseb = lse + ((long)b * H + h) * Sq;
  const float* delb = delta + ((long)b * H + h) * Sq;

  // the query rows that see some key of this tile
  const int k_last = min(k0 + TB, Sk) - 1;
  const int i_lo = causal ? max(0, k0 - off) : 0;
  const int i_hi = window >= 0 ? min(Sq, k_last + window - off) : Sq;
  const int n_tiles = i_hi > i_lo ? (i_hi - i_lo + TB - 1) / TB : 0;

  // Q, dO, lse and delta of query rows i0 .. i0 + 63 into ring stage s
  auto load_stage = [&](int s, int i0) {
    __nv_bfloat16* st = ring + s * 2 * TILE;
    load_tile<TD>(st, qb, q_stride, i0, Sq, tid);
    load_tile<TD>(st + TILE, dob, q_stride, i0, Sq, tid);
    const int r = tid % TB;
    const bool in = i0 + r < Sq;
    const float* src = tid < TB ? lseb : delb;
    cp_async4(rows + s * 2 * TB + (tid / TB) * TB + r, src + (in ? i0 + r : 0), in);
  };
  load_tile<TD>(ks, k + (long)b * Sk * kv_stride + (long)kvh * TD, kv_stride, k0, Sk, tid);
  load_tile<TD>(vs, v + (long)b * Sk * kv_stride + (long)kvh * TD, kv_stride, k0, Sk, tid);
  if (n_tiles > 0) load_stage(0, i_lo);
  cp_async_commit();

  float adk[TD / 8][4], adv[TD / 8][4];
#pragma unroll
  for (int nt = 0; nt < TD / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[nt][e] = adv[nt][e] = 0.f;
  const int kr = warp * 16;      // this warp's keys in the tile
  const int kp0 = k0 + kr + g;   // key positions of accumulator rows g and g + 8
  const __nv_bfloat16* ka_base = ks + kr * TRS + a_off<TD>(lane);
  const __nv_bfloat16* va_base = vs + kr * TRS + a_off<TD>(lane);

  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = i_lo + it * TB;
    if (it + 1 < n_tiles) load_stage((it + 1) & 1, i0 + TB);  // overlaps this tile's products
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and, the first time, K and V)
    __syncthreads();
    const __nv_bfloat16* qs = ring + (it & 1) * 2 * TILE;
    const __nv_bfloat16* dos = qs + TILE;
    const float* ls = rows + (it & 1) * 2 * TB;
    const float* dls = ls + TB;
    const bool edge = (causal && i0 + off < k0 + TB - 1) ||
                      (window >= 0 && i0 + TB - 1 + off - k0 >= window) || i0 + TB > Sq ||
                      k0 + TB > Sk;
#pragma unroll 1
    for (int c0 = 0; c0 < TB; c0 += QC) {
      float st[QC / 8][4], dpt[QC / 8][4];  // S^T and dP^T: 16 keys x QC query rows
#pragma unroll
      for (int nt = 0; nt < QC / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
      for (int kstep = 0; kstep < TD / 16; ++kstep) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, ka_base + kstep * 16);
        ldmatrix_x4(va, va_base + kstep * 16);
#pragma unroll
        for (int pr = 0; pr < QC / 16; ++pr) {
          const int o = (c0 + pr * 16) * TRS + b_off<TD>(lane) + kstep * 16;
          uint32_t bq[4], bd[4];  // b0, b1 of query rows 16 pr .. +7, then of +8 .. +15
          ldmatrix_x4(bq, qs + o);
          ldmatrix_x4(bd, dos + o);
          mma_bf16(st[2 * pr], ka, bq[0], bq[1]);
          mma_bf16(st[2 * pr + 1], ka, bq[2], bq[3]);
          mma_bf16(dpt[2 * pr], va, bd[0], bd[1]);
          mma_bf16(dpt[2 * pr + 1], va, bd[2], bd[3]);
        }
      }
      // P^T = exp(scale S^T - lse), dS^T = P^T (dP^T - delta); the query row of
      // element e is column c0 + 8 nt + 2 t + (e & 1), its key row g + 8 (e >> 1)
#pragma unroll
      for (int nt = 0; nt < QC / 8; ++nt) {
        const int ql = c0 + nt * 8 + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + ql);
        const float2 d2 = *reinterpret_cast<const float2*>(dls + ql);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool ok = true;
          if (edge) {
            const int qi = i0 + ql + (e & 1), kpos = kp0 + 8 * (e >> 1);
            ok = qi < Sq && kpos < Sk;
            if (causal) ok = ok && qi + off >= kpos;
            if (window >= 0) ok = ok && qi + off - kpos < window;
          }
          const float p = ok ? __expf(st[nt][e] * scale - ((e & 1) ? l2.y : l2.x)) : 0.f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - ((e & 1) ? d2.y : d2.x));
        }
      }
      // dV += P^T dO, dK += dS^T Q, over the QC query rows of this chunk
#pragma unroll
      for (int kk = 0; kk < QC / 16; ++kk) {
        uint32_t pa[4], sa[4];
        pack_a(pa, st[2 * kk], st[2 * kk + 1]);
        pack_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < TD / 16; ++np) {
          const int o = (c0 + kk * 16) * TRS + a_off<TD>(lane) + np * 16;
          uint32_t bd[4], bq[4];  // b0, b1 of dims 16 np .. +7, then of +8 .. +15
          ldmatrix_x4_trans(bd, dos + o);
          ldmatrix_x4_trans(bq, qs + o);
          mma_bf16(adv[2 * np], pa, bd[0], bd[1]);
          mma_bf16(adv[2 * np + 1], pa, bd[2], bd[3]);
          mma_bf16(adk[2 * np], sa, bq[0], bq[1]);
          mma_bf16(adk[2 * np + 1], sa, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before the next iteration refills it
  }
  cp_async_wait<0>();

  // rows g and g + 8 of the warp's keys, columns 8 nt + 2 t and + 1
  const long plane = (long)gridDim.z * Sk * q_stride;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = kp0 + 8 * half;
    if (key >= Sk) continue;
#pragma unroll
    for (int nt = 0; nt < TD / 8; ++nt) {
      const int c = nt * 8 + 2 * t;
      const float k0v = adk[nt][2 * half], k1v = adk[nt][2 * half + 1];
      const float v0v = adv[nt][2 * half], v1v = adv[nt][2 * half + 1];
      if (part == nullptr) {
        const long o = ((long)b * Sk + key) * kv_stride + (long)kvh * TD + c;
        *reinterpret_cast<uint32_t*>(dk + o) = pack_bf16(k0v * scale, k1v * scale);
        *reinterpret_cast<uint32_t*>(dv + o) = pack_bf16(v0v, v1v);
      } else {
        const long o = ((long)b * Sk + key) * q_stride + (long)h * TD + c;
        *reinterpret_cast<float2*>(part + o) = make_float2(k0v, k1v);
        *reinterpret_cast<float2*>(part + plane + o) = make_float2(v0v, v1v);
      }
    }
  }
}

// pass 3: dQ of one 64-row query tile of one head
template <int TD>
__global__ void __launch_bounds__(NT) flash_bwd_dq_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dO,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int Sq, int Sk, int H, int KV, int causal, int window,
    float scale) {
  constexpr int TRS = trs<TD>();
  constexpr int TILE = tile<TD>();
  constexpr int KC = chunk<TD>();
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + TILE;
  __nv_bfloat16* ring = dos + TILE;  // stage s: K at ring + 2 s TILE, V after it

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TB;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int off = Sk - Sq;
  const long q_stride = (long)H * TD, kv_stride = (long)KV * TD;
  const __nv_bfloat16* kb = k + (long)b * Sk * kv_stride + (long)kvh * TD;
  const __nv_bfloat16* vb = v + (long)b * Sk * kv_stride + (long)kvh * TD;

  // the keys that some row of this tile can see, as in the forward
  const int qpos_lo = q0 + off;
  const int qpos_hi = min(q0 + TB, Sq) - 1 + off;
  const int k_end = causal ? min(Sk, qpos_hi + 1) : Sk;
  const int k_begin = window >= 0 ? max(0, qpos_lo - window + 1) / TB * TB : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + TB - 1) / TB : 0;

  load_tile<TD>(qs, q + (long)b * Sq * q_stride + (long)h * TD, q_stride, q0, Sq, tid);
  load_tile<TD>(dos, dO + (long)b * Sq * q_stride + (long)h * TD, q_stride, q0, Sq, tid);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile<TD>(ring, kb, kv_stride, k_begin, Sk, tid);
    load_tile<TD>(ring + TILE, vb, kv_stride, k_begin, Sk, tid);
  }
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;  // rows g and g + 8 of this warp
  const long hrow = ((long)b * H + h) * Sq;
  const float lse0 = row0 < Sq ? lse[hrow + row0] : 0.f;
  const float lse1 = row0 + 8 < Sq ? lse[hrow + row0 + 8] : 0.f;
  const float del0 = row0 < Sq ? delta[hrow + row0] : 0.f;
  const float del1 = row0 + 8 < Sq ? delta[hrow + row0 + 8] : 0.f;
  const int qp0 = row0 + off, qp1 = qp0 + 8;

  cp_async_wait<1>();  // the Q and dO tiles
  __syncthreads();
  uint32_t qa[TD / 16][4], da[TD / 16][4];  // A fragments of this warp's 16 rows
  {
    const int o = warp * 16 * TRS + a_off<TD>(lane);
#pragma unroll
    for (int ks = 0; ks < TD / 16; ++ks) {
      ldmatrix_x4(qa[ks], qs + o + ks * 16);
      ldmatrix_x4(da[ks], dos + o + ks * 16);
    }
  }

  float adq[TD / 8][4];
#pragma unroll
  for (int nt = 0; nt < TD / 8; ++nt) adq[nt][0] = adq[nt][1] = adq[nt][2] = adq[nt][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = k_begin + i * TB;
    if (i + 1 < n_tiles) {  // the next tile's copy overlaps this tile's products
      __nv_bfloat16* nxt = ring + ((i + 1) & 1) * 2 * TILE;
      load_tile<TD>(nxt, kb, kv_stride, k0 + TB, Sk, tid);
      load_tile<TD>(nxt + TILE, vb, kv_stride, k0 + TB, Sk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile
    __syncthreads();
    const __nv_bfloat16* ks = ring + (i & 1) * 2 * TILE;
    const __nv_bfloat16* vs = ks + TILE;
    const bool edge = (causal && k0 + TB - 1 > qpos_lo) ||
                      (window >= 0 && k0 <= qpos_hi - window) || k0 + TB > Sk;
#pragma unroll 1
    for (int c0 = 0; c0 < TB; c0 += KC) {
      float s[KC / 8][4], dp[KC / 8][4];  // S and dP: 16 rows x KC keys
#pragma unroll
      for (int nt = 0; nt < KC / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kstep = 0; kstep < TD / 16; ++kstep)
#pragma unroll
        for (int pr = 0; pr < KC / 16; ++pr) {
          const int o = (c0 + pr * 16) * TRS + b_off<TD>(lane) + kstep * 16;
          uint32_t bk[4], bv[4];  // b0, b1 of keys 16 pr .. +7, then of +8 .. +15
          ldmatrix_x4(bk, ks + o);
          ldmatrix_x4(bv, vs + o);
          mma_bf16(s[2 * pr], qa[kstep], bk[0], bk[1]);
          mma_bf16(s[2 * pr + 1], qa[kstep], bk[2], bk[3]);
          mma_bf16(dp[2 * pr], da[kstep], bv[0], bv[1]);
          mma_bf16(dp[2 * pr + 1], da[kstep], bv[2], bv[3]);
        }
      // dS = P (dP - delta), P = exp(scale S - lse); key of element e is
      // k0 + c0 + 8 nt + 2 t + (e & 1), its row g + 8 (e >> 1)
#pragma unroll
      for (int nt = 0; nt < KC / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool ok = true;
          if (edge) {
            const int kpos = k0 + c0 + nt * 8 + 2 * t + (e & 1);
            const int qpos = e < 2 ? qp0 : qp1;
            ok = kpos < Sk;
            if (causal) ok = ok && qpos >= kpos;
            if (window >= 0) ok = ok && qpos - kpos < window;
          }
          const float p = ok ? __expf(s[nt][e] * scale - (e < 2 ? lse0 : lse1)) : 0.f;
          s[nt][e] = p * (dp[nt][e] - (e < 2 ? del0 : del1));
        }
      // dQ += dS K over the KC keys of this chunk
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t sa[4];
        pack_a(sa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < TD / 16; ++np) {
          uint32_t bk[4];  // b0, b1 of dims 16 np .. +7, then of +8 .. +15
          ldmatrix_x4_trans(bk, ks + (c0 + kk * 16) * TRS + a_off<TD>(lane) + np * 16);
          mma_bf16(adq[2 * np], sa, bk[0], bk[1]);
          mma_bf16(adq[2 * np + 1], sa, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before the next iteration refills it
  }
  cp_async_wait<0>();

  __nv_bfloat16* qrow = dq + (long)b * Sq * q_stride + (long)h * TD;
#pragma unroll
  for (int nt = 0; nt < TD / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(qrow + row0 * q_stride + c) =
          pack_bf16(adq[nt][0] * scale, adq[nt][1] * scale);
    if (row0 + 8 < Sq)
      *reinterpret_cast<uint32_t*>(qrow + (row0 + 8) * q_stride + c) =
          pack_bf16(adq[nt][2] * scale, adq[nt][3] * scale);
  }
}

// ---- launches ------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *o, *dO;
  const float* lse;
  float *delta, *part;
  void *dq, *dk, *dv;
  int B, Sq, Sk, H, KV, causal, window;
  float scale;
  cudaStream_t st;
};

template <typename T, int D>
int launch_delta(const Args& a) {
  const long rows = (long)a.B * a.Sq * a.H;
  flash_bwd_delta_kernel<T, D><<<(unsigned)((rows + 7) / 8), 256, 0, a.st>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dO), a.delta, rows, a.Sq, a.H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_gqa_sum(const Args& a, int D) {
  const long n4 = (long)a.B * a.Sk * a.KV * D / 4;
  flash_bwd_gqa_sum_kernel<T><<<(unsigned)((n4 + 255) / 256), 256, 0, a.st>>>(
      a.part, static_cast<T*>(a.dk), static_cast<T*>(a.dv), n4, a.H, a.KV, D, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const Args& a) {
  static const cudaError_t a2 = cudaFuncSetAttribute(
      flash_bwd_dkdv_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  static const cudaError_t a3 = cudaFuncSetAttribute(
      flash_bwd_dq_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  if (a2 != cudaSuccess) return static_cast<int>(a2);
  if (a3 != cudaSuccess) return static_cast<int>(a3);
  int err = launch_delta<float, D>(a);
  if (err) return err;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dO = static_cast<const float*>(a.dO);
  const bool gqa = a.H != a.KV;
  flash_bwd_dkdv_f32_kernel<D><<<dim3(a.H, (a.Sk + BC - 1) / BC, a.B), FNT, smem_bytes<D>(),
                                 a.st>>>(
      q, k, v, dO, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      gqa ? a.part : nullptr, a.Sq, a.Sk, a.H, a.KV, a.causal, a.window, a.scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if (gqa && (err = launch_gqa_sum<float>(a, D))) return err;
  flash_bwd_dq_f32_kernel<D><<<dim3(a.H, (a.Sq + BR - 1) / BR, a.B), FNT, smem_bytes<D>(),
                               a.st>>>(q, k, v, dO, a.lse, a.delta, static_cast<float*>(a.dq),
                                       a.Sq, a.Sk, a.H, a.KV, a.causal, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const Args& a) {
  static const cudaError_t a2 = cudaFuncSetAttribute(
      flash_bwd_dkdv_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv<D>());
  static const cudaError_t a3 = cudaFuncSetAttribute(
      flash_bwd_dq_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq<D>());
  if (a2 != cudaSuccess) return static_cast<int>(a2);
  if (a3 != cudaSuccess) return static_cast<int>(a3);
  int err = launch_delta<__nv_bfloat16, D>(a);
  if (err) return err;
  using bf = __nv_bfloat16;
  const bf* q = static_cast<const bf*>(a.q);
  const bf* k = static_cast<const bf*>(a.k);
  const bf* v = static_cast<const bf*>(a.v);
  const bf* dO = static_cast<const bf*>(a.dO);
  const bool gqa = a.H != a.KV;
  flash_bwd_dkdv_bf16_kernel<D><<<dim3(a.H, (a.Sk + TB - 1) / TB, a.B), NT, smem_dkdv<D>(),
                                  a.st>>>(
      q, k, v, dO, a.lse, a.delta, static_cast<bf*>(a.dk), static_cast<bf*>(a.dv),
      gqa ? a.part : nullptr, a.Sq, a.Sk, a.H, a.KV, a.causal, a.window, a.scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if (gqa && (err = launch_gqa_sum<bf>(a, D))) return err;
  flash_bwd_dq_bf16_kernel<D><<<dim3(a.H, (a.Sq + TB - 1) / TB, a.B), NT, smem_dq<D>(),
                                a.st>>>(q, k, v, dO, a.lse, a.delta, static_cast<bf*>(a.dq),
                                        a.Sq, a.Sk, a.H, a.KV, a.causal, a.window, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const Args& a, int dtype) {
  if (dtype == 0) return launch_f32<D>(a);
  if (dtype == 1) return launch_bf16<D>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, o, dO, dq (B,Sq,H,D); k, v, dk, dv (B,Sk,KV,D), all contiguous and of
// one dtype (0 float32, 1 bfloat16); lse (B,H,Sq) f32 from the forward;
// delta (B,H,Sq) f32 scratch; part (2,B,Sk,H,D) f32 scratch when H > KV
// (the per-query-head partials of dK and dV), else unused and may be null.
// D is 32, 64 or 128. window < 0 means none. Three launches on the stream,
// four when H > KV; returns the first cudaError_t that is not 0.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dO, const float* lse, float* delta, float* part,
                                   void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
                                   int KV, int D, int causal, int window, float scale, int dtype,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sq > Sk || KV <= 0 || H % KV != 0 || (H != KV && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, dO, lse, delta, part, dq, dk, dv, B, Sq, Sk, H, KV, causal, window,
               scale, static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32: return launch<32>(a, dtype);
    case 64: return launch<64>(a, dtype);
    case 128: return launch<128>(a, dtype);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
