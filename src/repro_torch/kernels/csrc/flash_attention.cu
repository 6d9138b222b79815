// Flash attention forward (prefill), written by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
//   (pl.pallas_call at line 113, kernel body _kernel at line 30).
//
// Computes: o = softmax(scale * q k^T + mask) v for every (batch, head),
//   causal and optionally sliding-window, GQA with kv head = h / grp. The
//   running max, sum and accumulator are fp32. Masked scores are -1e30, not
//   -inf, so a row whose first visited tile is fully masked corrects itself
//   on the next tile (exp(-1e30 - m) == 0) instead of turning into NaN.
//   Query positions are right-aligned (qpos = i + Sk - Sq), as in the
//   reference oracle; the serving path has Sq == Sk.
//
// Log-sum-exp: given a non-null lse (B, H, Sq) f32, each row also writes
//   m + log(l), its running max and sum in the scaled units the kernel
//   keeps (scale * q k^T), for the backward pass
//   (csrc/flash_attention_bwd.cu), which recomputes P = exp(scale q k^T -
//   lse) from it. Serving passes null: nothing else changes, so o is bit
//   for bit what it is without lse.
//
// Bound on the H100: at long prompts the 4 * (visible q-k pairs) * D * H
//   operations, on the bf16 tensor cores; at the serving path's prompts
//   (S = 3 to 19) the launch and one trip to device memory.
//
// Design, bf16 (the serving path): FlashAttention-2 on mma.sync. One block
//   of 4 warps per (64-row query tile, head, batch), each warp holding 16
//   query rows; the Q tile arrives by cp.async and its fragments are loaded
//   once by ldmatrix into registers. The TPU kernel's sequential K grid axis
//   is a loop inside the block over 64-key tiles (32 at 224), from the window's first
//   tile to the causal limit, so wholly masked tiles are never loaded. K and
//   V tiles arrive by 16-byte cp.async into a 2-stage bf16 ring in dynamic
//   shared memory (rows padded by 16 bytes, so ldmatrix is free of bank
//   conflicts); the next tile's copy is in flight while this tile's products
//   run. S = Q K^T and O += P V are mma.sync m16n8k16 bf16 -> fp32; the scale
//   is applied to S in fp32; only tiles on the diagonal, the window's edge or
//   the end of the keys compute masks. Row max and sum are taken over the 4
//   lanes of a quad, and P is converted to bf16 in registers as the A operand
//   of the second product (V by ldmatrix.trans). This replaces the first
//   version, which staged fp32 tiles in shared memory and ran both products
//   as scalar FMA; that body stays as the fp32 instantiation (tests and
//   chip_smoke only): TF32 would miss its 2e-5 tolerance. The next step is
//   wgmma with TMA loads and warp specialisation.
//
// Head dims: both bodies take the head_dim as a template parameter, built
//   for 32, 64 (zamba2-1.2b's shared attention, musicgen-medium), 128 (the
//   dense configs) and 224 (Zamba2-7B's shared blocks). It sizes the Q
//   fragments, the accumulator, the copy loop and the padded row stride of
//   the staged tiles: 40, 72, 136 or 232 bf16 (80, 144, 272 or 464 bytes:
//   5, 9, 17 or 29 sixteen-byte units, each odd, so the eight rows of an
//   ldmatrix phase fall on distinct banks). Shared memory for the Q tile and
//   2 K/V stages: 25, 45, 85 or 87 KB. At 224 the accumulator alone is 112
//   floats a lane, so the Q fragments are re-read from shared memory at each
//   key tile instead of held in 56 more registers, a key tile is 32 keys, not
//   64 (16 score floats a lane, not 32), and the fp32 body stages 16 keys a
//   tile (its static tiles of 32 would pass 48 KB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 16;          // query rows per block
constexpr int NT = 128;         // threads per block
constexpr int TPR = NT / BQ;    // threads per query row (8, consecutive lanes)
constexpr float NEG_INF = -1e30f;
// keys per tile of the fp32 body: 32, or 16 above D = 128, where the staged
// fp32 tiles of 32 keys would pass the 48 KB of static shared memory
template <int D> __host__ __device__ constexpr int fbk() { return D > 128 ? 16 : 32; }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_attention_f32_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int Sq, int Sk, int H, int KV, int causal,
    int window, float scale) {
  constexpr int BK = fbk<D>();  // keys per tile
  constexpr int KPT = BK / TPR; // keys scored per thread per tile (4, or 2)
  constexpr int PS = BK + 1;    // padded row stride of the probability tile
  constexpr int DP = D + 1;     // padded row stride of the q and k tiles
  constexpr int CPT = D / TPR;  // accumulator columns per thread
  __shared__ float qs[BQ * DP];
  __shared__ float ks[BK * DP];
  __shared__ float vs[BK * D];
  __shared__ float ps[BQ * PS];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int sub = tid % TPR;
  const int off = Sk - Sq;
  const long q_stride = (long)H * D;
  const long kv_stride = (long)KV * D;
  const T* qb = q + (long)b * Sq * q_stride + (long)h * D;
  const T* kb = k + (long)b * Sk * kv_stride + (long)kvh * D;
  const T* vb = v + (long)b * Sk * kv_stride + (long)kvh * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    qs[r * DP + c] = q0 + r < Sq ? to_float(qb[(q0 + r) * q_stride + c]) * scale : 0.f;
  }

  // the keys that some row of this tile can see
  const int qpos_lo = q0 + off;
  const int qpos_hi = min(q0 + BQ, Sq) - 1 + off;
  const int k_end = causal ? min(Sk, qpos_hi + 1) : Sk;
  const int k_begin = window >= 0 ? max(0, qpos_lo - window + 1) / BK * BK : 0;

  const int qpos = q0 + row + off;
  float m = NEG_INF, l = 0.f;
  float acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed; the q tile is staged
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < Sk;
      ks[r * DP + c] = in ? to_float(kb[(k0 + r) * kv_stride + c]) : 0.f;
      vs[r * D + c] = in ? to_float(vb[(k0 + r) * kv_stride + c]) : 0.f;
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float qv = qs[row * DP + c];
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[j] += qv * ks[(sub + TPR * j) * DP + c];
    }
    float tile_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kpos = k0 + sub + TPR * j;
      bool ok = kpos < Sk;
      if (causal) ok = ok && qpos >= kpos;
      if (window >= 0) ok = ok && qpos - kpos < window;
      if (!ok) s[j] = NEG_INF;
      tile_max = fmaxf(tile_max, s[j]);
    }
#pragma unroll
    for (int w = TPR / 2; w > 0; w >>= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, w));
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
      ps[row * PS + sub + TPR * j] = p;
    }
#pragma unroll
    for (int w = TPR / 2; w > 0; w >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, w);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // a row's 8 threads share one warp
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[j] *= corr;
    for (int kk = 0; kk < BK; ++kk) {
      const float p = ps[row * PS + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[j] += p * vs[kk * D + sub + TPR * j];
    }
  }

  if (q0 + row < Sq) {
    T* ob = o + ((long)b * Sq + q0 + row) * q_stride + (long)h * D;
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int j = 0; j < CPT; ++j) ob[sub + TPR * j] = from_float<T>(acc[j] / denom);
    if (lse != nullptr && sub == 0) lse[((long)b * H + h) * Sq + q0 + row] = m + logf(denom);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq,
               int Sk, int H, int KV, int causal, int window, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_f32_kernel<float, D><<<grid, NT, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, Sq, Sk, H, KV, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16: tensor cores -------------------------------------------------

constexpr int TBQ = 64;          // query rows per block, 16 per warp
// per head_dim TD: keys per tile (64; 32 above TD = 128, which halves the
// score fragments a lane holds beside its TD / 2 accumulator floats), the
// padded row stride (bf16 elements, +16 bytes), one staged K or V tile, and
// the dynamic shared memory (Q tile + 2 K/V stages)
template <int TD> __host__ __device__ constexpr int tbk() { return TD > 128 ? 32 : 64; }
template <int TD> __host__ __device__ constexpr int trs() { return TD + 8; }
template <int TD> __host__ __device__ constexpr int tile() { return tbk<TD>() * trs<TD>(); }
template <int TD> __host__ __device__ constexpr int tsmem() {
  return (TBQ * trs<TD>() + 2 * 2 * tile<TD>()) * 2;
}

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

// ROWS rows of TD bf16 from global (rows row0.. of a (rows, stride) array)
// to a padded shared tile; rows at or past n_rows are zero-filled
template <int TD, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long stride, int row0, int n_rows, int tid) {
  static_assert(ROWS * TD / 8 % NT == 0, "the 16-byte copies of a tile fill whole rounds");
#pragma unroll
  for (int j = 0; j < ROWS * TD / 8 / NT; ++j) {
    const int e = tid + j * NT, r = e / (TD / 8), col = e % (TD / 8) * 8;
    const bool in = row0 + r < n_rows;
    cp_async16(dst + r * trs<TD>() + col, src + (in ? (row0 + r) * stride + col : 0), in);
  }
}

template <int TD>
__global__ void __launch_bounds__(NT) flash_attention_bf16_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int Sq, int Sk, int H, int KV, int causal, int window,
    float scale) {
  constexpr int TBK = tbk<TD>();
  constexpr int TRS = trs<TD>();
  constexpr int TILE = tile<TD>();
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ring = qs + TBQ * TRS;  // stage s: K at ring + 2 s TILE, V after it

  // the last query tiles, which see the most keys under a causal mask, are
  // handed out first, so the short ones fill the tail of the grid
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int off = Sk - Sq;
  const long q_stride = (long)H * TD;
  const long kv_stride = (long)KV * TD;
  const __nv_bfloat16* qb = q + (long)b * Sq * q_stride + (long)h * TD;
  const __nv_bfloat16* kb = k + (long)b * Sk * kv_stride + (long)kvh * TD;
  const __nv_bfloat16* vb = v + (long)b * Sk * kv_stride + (long)kvh * TD;

  // the keys that some row of this tile can see
  const int qpos_lo = q0 + off;
  const int qpos_hi = min(q0 + TBQ, Sq) - 1 + off;
  const int k_end = causal ? min(Sk, qpos_hi + 1) : Sk;
  const int k_begin = window >= 0 ? max(0, qpos_lo - window + 1) / TBK * TBK : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + TBK - 1) / TBK : 0;

  load_tile<TD, TBQ>(qs, qb, q_stride, q0, Sq, tid);
  cp_async_commit();
  if (n_tiles > 0) {
    load_tile<TD, TBK>(ring, kb, kv_stride, k_begin, Sk, tid);
    load_tile<TD, TBK>(ring + TILE, vb, kv_stride, k_begin, Sk, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();  // the Q tile
  __syncthreads();
  // A fragments of this warp's 16 rows, TD / 16 k-steps: held in registers
  // up to TD = 128; above, re-read from the staged Q tile at each key tile,
  // which leaves the registers to the accumulator's TD / 2 floats a lane
  constexpr bool QREG = TD <= 128;
  uint32_t qa[QREG ? TD / 16 : 1][4];
  const __nv_bfloat16* qbase =
      qs + (warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * TRS + (lane >> 4) * 8;
  if constexpr (QREG) {
#pragma unroll
    for (int ks = 0; ks < TD / 16; ++ks) ldmatrix_x4(qa[ks], qbase + ks * 16);
  }

  const int qp0 = q0 + warp * 16 + g + off;  // positions of rows g and g + 8
  const int qp1 = qp0 + 8;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float acc[TD / 8][4];
#pragma unroll
  for (int nt = 0; nt < TD / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = k_begin + i * TBK;
    if (i + 1 < n_tiles) {  // the next tile's copy overlaps this tile's products
      __nv_bfloat16* nxt = ring + ((i + 1) & 1) * 2 * TILE;
      load_tile<TD, TBK>(nxt, kb, kv_stride, k0 + TBK, Sk, tid);
      load_tile<TD, TBK>(nxt + TILE, vb, kv_stride, k0 + TBK, Sk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile
    __syncthreads();
    const __nv_bfloat16* ks = ring + (i & 1) * 2 * TILE;
    const __nv_bfloat16* vs = ks + TILE;

    float s[TBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < TBK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    {
      const __nv_bfloat16* base =
          ks + ((lane >> 4) * 8 + (lane & 7)) * TRS + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kstep = 0; kstep < TD / 16; ++kstep) {
        uint32_t a[4];
        if constexpr (QREG) {
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = qa[kstep][r];
        } else {
          ldmatrix_x4(a, qbase + kstep * 16);
        }
#pragma unroll
        for (int pr = 0; pr < TBK / 16; ++pr) {
          uint32_t bf[4];  // b0, b1 of keys 16 pr .. +7, then of keys +8 .. +15
          ldmatrix_x4(bf, base + pr * 16 * TRS + kstep * 16);
          mma_bf16(s[2 * pr], a, bf[0], bf[1]);
          mma_bf16(s[2 * pr + 1], a, bf[2], bf[3]);
        }
      }
    }
    const bool edge = (causal && k0 + TBK - 1 > qpos_lo) ||
                      (window >= 0 && k0 <= qpos_hi - window) || k0 + TBK > Sk;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < TBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale;
        if (edge) {
          const int kpos = k0 + nt * 8 + 2 * t + (e & 1);
          const int qpos = e < 2 ? qp0 : qp1;
          bool ok = kpos < Sk;
          if (causal) ok = ok && qpos >= kpos;
          if (window >= 0) ok = ok && qpos - kpos < window;
          if (!ok) x = NEG_INF;
        }
        s[nt][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = __expf(m0 - mn0), c1 = __expf(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < TBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[nt][e] == NEG_INF ? 0.f : __expf(s[nt][e] - (e < 2 ? mn0 : mn1));
        s[nt][e] = p;
        if (e < 2) ps0 += p;
        else ps1 += p;
      }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nt = 0; nt < TD / 8; ++nt) {
      acc[nt][0] *= c0;
      acc[nt][1] *= c0;
      acc[nt][2] *= c1;
      acc[nt][3] *= c1;
    }
    {
      const __nv_bfloat16* base =
          vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * TRS + (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < TBK / 16; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < TD / 16; ++np) {
          uint32_t bf[4];  // b0, b1 of dims 16 np .. +7, then of dims +8 .. +15
          ldmatrix_x4_trans(bf, base + kk * 16 * TRS + np * 16);
          mma_bf16(acc[2 * np], pa, bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], pa, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before the next iteration refills it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {  // each lane summed its own columns
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float r0 = 1.f / fmaxf(l0, 1e-30f), r1 = 1.f / fmaxf(l1, 1e-30f);
  const int row0 = q0 + warp * 16 + g;
  __nv_bfloat16* ob = o + (long)b * Sq * q_stride + (long)h * TD;
#pragma unroll
  for (int nt = 0; nt < TD / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + row0 * q_stride + c) =
          pack_bf16(acc[nt][0] * r0, acc[nt][1] * r0);
    if (row0 + 8 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (row0 + 8) * q_stride + c) =
          pack_bf16(acc[nt][2] * r1, acc[nt][3] * r1);
  }
  if (lse != nullptr && t == 0) {  // m and l are the same on the 4 lanes of a quad
    float* lb = lse + ((long)b * H + h) * Sq;
    if (row0 < Sq) lb[row0] = m0 + logf(fmaxf(l0, 1e-30f));
    if (row0 + 8 < Sq) lb[row0 + 8] = m1 + logf(fmaxf(l1, 1e-30f));
  }
}

template <int TD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq,
                int Sk, int H, int KV, int causal, int window, float scale, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<TD>, cudaFuncAttributeMaxDynamicSharedMemorySize, tsmem<TD>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((Sq + TBQ - 1) / TBQ, H, B);
  flash_attention_bf16_kernel<TD><<<grid, NT, tsmem<TD>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, H, KV,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq,
           int Sk, int H, int KV, int causal, int window, float scale, int dtype,
           cudaStream_t st) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window, scale, st);
  if (dtype == 1)
    return launch_bf16<D>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B,Sq,H,D), k/v (B,Sk,KV,D), o (B,Sq,H,D), all contiguous; lse (B,H,Sq)
// f32, or null to write none. D is 32, 64, 128 or 224, the head_dims the
// kernel is built for. dtype: 0 float32, 1 bfloat16. window < 0 means none.
// Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int B, int Sq, int Sk, int H, int KV, int D,
                                   int causal, int window, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sq > Sk || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window, scale, dtype, st);
    case 64: return launch<64>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window, scale, dtype, st);
    case 128:
      return launch<128>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window, scale, dtype, st);
    case 224:
      return launch<224>(q, k, v, o, lse, B, Sq, Sk, H, KV, causal, window, scale, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
