// Mamba2 SSD chunked scan, backward, written by hand for Hopper (sm_90a).
//
// Replaces: jax.vjp of src/repro/kernels/ops.py::_jnp_ssd_chunked (line 212),
//   the path the JAX package trains through: its Pallas kernel
//   (src/repro/kernels/ssd_scan.py::ssd_scan_pallas) has no backward.
//
// Computes: dx, ddt, dA, dB, dC, dD and dh0 of csrc/ssd_scan.cu's scan from
//   dy, the cotangent of the final state (or zero) and the state entering
//   each chunk, h_in (B, nc, H, P, N) f32, which the forward writes for
//   training. Per (batch, head) and chunk, with a_k = dt_k A, cs the
//   inclusive cumsum of a over the chunk, L_ij = exp(cs_i - cs_j) (j <= i),
//   G_ij = C_i . B_j, M_ij = G_ij L_ij dt_j, w_j = exp(cs_last - cs_j) dt_j,
//   h_c the state entering the chunk and gn the cotangent of the state
//   leaving it:
//     the reverse chain: g_nc = d(final), g_c = exp(cs_last) g_{c+1}
//       + sum_i exp(cs_i) dy_i (outer) C_i, dh0 = g_0;
//     dx_j = sum_{i>=j} M_ij dy_i + w_j gn B_j + D dy_j;
//     dM_ij = dy_i . x_j, dG_ij = dM_ij L_ij dt_j;
//     dC_i = sum_j dG_ij B_j + exp(cs_i) h_c^T dy_i, dB_j = sum_i dG_ij C_i
//       + w_j gn^T x_j, each summed over the group's heads;
//     ddt_j = sum_i dM_ij G_ij L_ij + exp(cs_last - cs_j) x_j . gn B_j + A da_j,
//   where da_k = sum_{i>=k} dcs_i, and dcs gathers R_ij = dM_ij M_ij (to
//   dcs_i, minus to dcs_j), exp(cs_i) dy_i . h_c C_i (to dcs_i), T_j =
//   w_j x_j . gn B_j (minus to dcs_j, to dcs_last) and exp(cs_last)
//   <gn, h_c> (to dcs_last); dA = sum dt da, dD = sum dy . x.
//   kernels/ssd_scan.py::ssd_scan_bwd_plain writes the same out in PyTorch,
//   and ssd_scan_bwd_tiled_plain this kernel's algorithm.
//
// Built for (head_dim P, d_state N, chunk Q) = (64, 128, 128) (mamba2-2.7b),
//   (64, 64, 128) (zamba2-1.2b) and (32, 16, 32) (both configs reduced), in
//   bf16 and f32, as the forward; any other shape is refused at ssd_scan_bwd.
//
// Bound on the H100: at the training shape of mamba2-2.7b (4 x 512 tokens,
//   80 heads, 4 chunks) bytes: x, dy and dx (21 MB each in bf16), the f32
//   chunk states h_in (42 MB) and dh0, about 118 MB or 35 us; the products
//   over the causal pairs and the state terms are about 19 GFLOP, 19 us at
//   the bf16 tensor-core rate.
//
// Design: one block of Q / 16 warps (8 at Q = 128, one block an SM) per
//   (chunk, block of R heads of one group, batch). R is chosen on the host
//   (ssd_scan.py::bwd_heads_per_block: the fewest head-times over the
//   card's SMs; mamba2-2.7b's training step takes its 80 heads 10 a block,
//   128 blocks in one wave). The chunk's B and C, shared by the group's
//   heads, are loaded once; the block takes its heads in turn, three times,
//   each visit's x, dy and dt by cp.async into two stages (bf16), the next
//   visit's copy in flight under this one's work. Each warp holds one
//   16-row tile over the full width; it recomputes G = C B^T and dM = dy
//   x^T (exact bf16 operands) tile by tile on or below the diagonal (exp
//   only there), turns them into M and dG in registers, takes their row
//   sums for dcs and ddt from the accumulator fragments (quad shuffles; a
//   row lies in one warp, so the order is fixed) and feeds the same
//   fragments as the A operand of the next product. Passes:
//   A, per head: the cumsum; a wait for chunk c + 1's flag of its (batch,
//     head) (release/acquire at gpu scope; blocks take tickets in reverse
//     chunk-major order, so each block the chain waits on already runs);
//     gn from the slot (dh0, in place: one reader per state, as the forward
//     publishes in the final-state output), kept in gsave for pass B, and
//     g_c = exp(cs_last) gn + u published in its place, u = (exp(cs) dy)^T
//     C spread over every warp; <gn, h_c>; then rows j: dx = w gn B^T + D
//     dy + M^T dy (G^T tiles for i >= j) and x_j . gn B_j.
//   B, per head: rows j: G^T and dM^T for i >= j, their sums over i, dB +=
//     dG^T C, and dB += w x gn (gn from gsave).
//   C, per head: rows i: dC += exp(cs) dy h_c and dy_i . h_c C_i, then G
//     and dM for j <= i, their sums over j, dC += dG B; then, in warp 0,
//     dcs, its reverse cumsum da, ddt and the head's dA.
//   One persistent accumulator at a time (dB in pass B, dC in pass C): dx,
//   dB and dC of a warp's tile held together take more than 255 registers
//   at N = 128. The block's dB and dC sum its heads in head order in
//   registers (one 16 x N f32 tile a warp) and are written once as one f32
//   partial per block, (B, S, H / R, N); a second launch sums the partials
//   over a group's head blocks in order, and dA and dD over the (batch,
//   chunk) blocks in order: no atomics, two calls are bitwise equal. The
//   ticket counter and the per-(batch, head) flags are the forward's
//   zeroed buffer and are left zero. At Q = 128 the SM's four schedulers
//   each get row tiles t and 7 - t, so the causal triangle's work is even.
//   Products: mma.sync m16n8k16 bf16 -> f32, operands by ldmatrix (.trans
//   where k runs down the rows), a warp's A operand held in registers
//   (streamed from shared memory at N = 128, where it would not fit beside
//   the accumulators). The f32 operands (M, dG, gn, h_c and the scaled rows
//   exp(cs_i) dy_i) enter as a bf16 hi + lo pair against the exact bf16
//   partner, two products summed in f32, as the forward does; <gn, h_c>
//   takes gn as its pair. Shared memory: B, C and two stages of x and dy as
//   bf16 rows padded by 16 bytes (no ldmatrix bank conflicts), gn or h_c as
//   one hi + lo pair, the per-row arrays: 195 KB at (64, 128, 128).
//   The f32 instantiation (tests and chip_smoke only) runs the same plan in
//   scalar FMA on the same fragment layout, with f32 tiles in shared memory
//   (one stage); gn and h_c are read where they lie in device memory, and
//   the publish of g_c waits until pass A no longer reads gn in the slot.
//   TF32 would miss its 3e-4.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int RMAX = 16;  // heads a block may take (ssd_scan.py MAX_HEADS_PER_BLOCK)

// Byte offsets of the shared-memory regions: B [Q][LDN], C [Q][LDN], x and
// dy [STAGES][Q][LDP] in T (bf16: two stages, the next visit's copy in
// flight), for bf16 the hi + lo pair [2][P][LDN] (gn, then h_c), then the
// f32 per-row arrays: dt [STAGES][Q], cs, exp(cs), exp(cs_last - cs), w,
// x_j . gn B_j, the sums of R over j, dy_i . h_c C_i (7 Q), the warps' sums
// of <gn, h_c> and dy . x (2 NW), and what passes A and B leave for pass C,
// two arrays of Q a head (RMAX heads).
template <typename T, int Q, int P, int N>
struct Layout {
  static constexpr bool BF16 = sizeof(T) == 2;
  static constexpr int STAGES = BF16 ? 2 : 1;
  static constexpr int NW = Q / 16, NT = 32 * NW;
  static constexpr int LDN = N + 16 / (int)sizeof(T), LDP = P + 16 / (int)sizeof(T);
  static constexpr int b = 0;
  static constexpr int c = b + Q * LDN * (int)sizeof(T);
  static constexpr int x = c + Q * LDN * (int)sizeof(T);
  static constexpr int dy = x + STAGES * Q * LDP * (int)sizeof(T);
  static constexpr int pair = dy + STAGES * Q * LDP * (int)sizeof(T);
  static constexpr int f = pair + (BF16 ? 2 * P * LDN * 2 : 0);
  static constexpr int bytes = f + ((STAGES + 7) * Q + 2 * NW + 2 * RMAX * Q) * 4;
};

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* D;
  const float* h_in;
  const void* dy;
  const float* dfinal;
  void* dx;
  float* ddt;
  float* dA;
  void* dB;
  void* dC;
  float* dD;
  float* dh0;  // also the chain's slot
  float* gsave;  // (B, nc, H, P, N): gn, the cotangent of each chunk's end state, for pass B
  float* part_B;
  float* part_C;
  float* part_A;
  float* part_D;
  int* sync;
  int Bsz, S, H, G, R, drop_dcs;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// two consecutive outputs
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (or 4) bytes from global to shared; in == false zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n"); }

// one 128-byte line from device memory into L2, holding no register
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
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
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col); a pure function
// of registers, so not volatile
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The sum over the 4 lanes of a quad (the lanes that share an accumulator
// row), in a fixed order; every lane of the quad gets it.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// Fragments (lane = 4 g + t): accumulator element e of an m16n8 tile sits
// at row g + 8 (e >> 1), column 2 t + (e & 1); an A fragment's register e
// holds row g + 8 (e & 1), columns 2 t + 8 (e >> 1) and the next; a B
// fragment's two hold rows (k) 2 t (+1) and 2 t + 8 (+1) of column g. The
// f32 overloads compute the same accumulator elements in scalar FMA; their
// operands marked G lie in device memory, read through L2 (__ldcg: the
// chain's slot is written by other SMs).
template <bool G> __device__ __forceinline__ float ldf(const float* p) {
  if constexpr (G) return __ldcg(p);
  return *p;
}

// 16 rows of an A operand with K contiguous: bf16 holds them as fragments
// in registers, loaded once and used against many B tiles; f32 keeps the
// shared-memory rows (its products read them as they go).
template <typename T, int K> struct ARows;
template <int K> struct ARows<__nv_bfloat16, K> {
  uint32_t f[K / 16][4];
  __device__ __forceinline__ void load(const __nv_bfloat16* a, int lda, int lane) {
    const __nv_bfloat16* base = a + (((lane >> 3) & 1) * 8 + (lane & 7)) * lda + (lane >> 4) * 8;
#pragma unroll
    for (int ks = 0; ks < K / 16; ++ks) ldmatrix_x4(f[ks], base + ks * 16);
  }
};
template <int K> struct ARows<float, K> {
  const float* a;
  int lda;
  __device__ __forceinline__ void load(const float* p, int ld, int) {
    a = p;
    lda = ld;
  }
};

// acc (16 x 8 NT8) += A B^T over K: B's 8 NT8 rows at b, row-major with K
// contiguous (C B^T, dy x^T, B gn^T).
template <int K, int NT8, bool G = false>
__device__ __forceinline__ void mm_bt(float (&acc)[NT8][4], const ARows<__nv_bfloat16, K>& A,
                                      const __nv_bfloat16* b, int ldb, int lane) {
  static_assert(NT8 % 2 == 0, "B rows come in pairs of n8 tiles");
  const __nv_bfloat16* bbase = b + ((lane >> 4) * 8 + (lane & 7)) * ldb + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks)
#pragma unroll
    for (int pr = 0; pr < NT8 / 2; ++pr) {
      uint32_t bf[4];
      ldmatrix_x4(bf, bbase + pr * 16 * ldb + ks * 16);
      mma_bf16(acc[2 * pr], A.f[ks], bf[0], bf[1]);
      mma_bf16(acc[2 * pr + 1], A.f[ks], bf[2], bf[3]);
    }
}
// The same with A streamed from shared memory a k-step at a time (where
// its fragments would not fit in registers beside the accumulators; the
// loop is not unrolled, or every k-step's loads are hoisted and spill).
template <int K, int NT8>
__device__ __forceinline__ void mm_bt(float (&acc)[NT8][4], const __nv_bfloat16* a, int lda,
                                      const __nv_bfloat16* b, int ldb, int lane) {
  static_assert(NT8 % 2 == 0, "B rows come in pairs of n8 tiles");
  const __nv_bfloat16* abase = a + (((lane >> 3) & 1) * 8 + (lane & 7)) * lda + (lane >> 4) * 8;
  const __nv_bfloat16* bbase = b + ((lane >> 4) * 8 + (lane & 7)) * ldb + ((lane >> 3) & 1) * 8;
#pragma unroll 1
  for (int ks = 0; ks < K / 16; ++ks) {
    uint32_t af[4];
    ldmatrix_x4(af, abase + ks * 16);
#pragma unroll
    for (int pr = 0; pr < NT8 / 2; ++pr) {
      uint32_t bf[4];
      ldmatrix_x4(bf, bbase + pr * 16 * ldb + ks * 16);
      mma_bf16(acc[2 * pr], af, bf[0], bf[1]);
      mma_bf16(acc[2 * pr + 1], af, bf[2], bf[3]);
    }
  }
}
template <int K, int NT8, bool G = false>
__device__ __forceinline__ void mm_bt(float (&acc)[NT8][4], const ARows<float, K>& A,
                                      const float* b, int ldb, int lane) {
  const int g = lane >> 2, t = lane & 3;
  constexpr int GRP = NT8 < 2 ? NT8 : 2;  // n8 tiles a sweep over K
#pragma unroll
  for (int n0 = 0; n0 < NT8; n0 += GRP)
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const float a0 = A.a[g * A.lda + k], a1 = A.a[(g + 8) * A.lda + k];
#pragma unroll
    for (int nt = n0; nt < n0 + GRP; ++nt) {
      const float b0 = ldf<G>(b + (nt * 8 + 2 * t) * ldb + k);
      const float b1 = ldf<G>(b + (nt * 8 + 2 * t + 1) * ldb + k);
      acc[nt][0] += a0 * b0;
      acc[nt][1] += a0 * b1;
      acc[nt][2] += a1 * b0;
      acc[nt][3] += a1 * b1;
    }
  }
}

// acc (16 x 8 NT8) += A [B_k0 .. B_k0+15] with A's 16 x 16 fragments in
// hi and lo and B 16 rows (k) at b, row-major [k][n] (ldmatrix.trans).
template <int NT8>
__device__ __forceinline__ void a_kmajor(float (&acc)[NT8][4], const uint32_t (&hi)[4],
                                         const uint32_t (&lo)[4], const __nv_bfloat16* b,
                                         int ldb, int lane) {
  const __nv_bfloat16* base = b + (lane & 15) * ldb + (lane >> 4) * 8;
#pragma unroll
  for (int np = 0; np < NT8 / 2; ++np) {
    uint32_t bf[4];
    ldmatrix_x4_trans(bf, base + np * 16);
    mma_bf16(acc[2 * np], hi, bf[0], bf[1]);
    mma_bf16(acc[2 * np + 1], hi, bf[2], bf[3]);
    mma_bf16(acc[2 * np], lo, bf[0], bf[1]);
    mma_bf16(acc[2 * np + 1], lo, bf[2], bf[3]);
  }
  if constexpr (NT8 % 2) {
    uint32_t bf[2];
    ldmatrix_x2_trans(bf, b + (lane & 15) * ldb + (NT8 - 1) * 8);
    mma_bf16(acc[NT8 - 1], hi, bf[0], bf[1]);
    mma_bf16(acc[NT8 - 1], lo, bf[0], bf[1]);
  }
}

// acc (16 x 8 NT8) += S B: S a 16 x 16 f32 tile in accumulator fragments
// (M^T, dG^T or dG), B 16 rows (k) at b, row-major [k][n]. bf16: S as hi +
// lo A fragments.
template <int NT8>
__device__ __forceinline__ void frag_kmajor(float (&acc)[NT8][4], const float (&s)[2][4],
                                            const __nv_bfloat16* b, int ldb, int lane) {
  float r[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) r[nt][e] = s[nt][e] - bf16_round(s[nt][e]);
  const uint32_t hi[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                          pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
  const uint32_t lo[4] = {pack_bf16(r[0][0], r[0][1]), pack_bf16(r[0][2], r[0][3]),
                          pack_bf16(r[1][0], r[1][1]), pack_bf16(r[1][2], r[1][3])};
  a_kmajor<NT8>(acc, hi, lo, b, ldb, lane);
}
template <int NT8>
__device__ __forceinline__ void frag_kmajor(float (&acc)[NT8][4], const float (&s)[2][4],
                                            const float* b, int ldb, int lane) {
  const int t = lane & 3;
  constexpr int GRP = NT8 < 2 ? NT8 : 2;  // n8 tiles a sweep over the 16 columns
#pragma unroll
  for (int n0 = 0; n0 < NT8; n0 += GRP) {
#pragma unroll 1
    for (int j = 0; j < 16; ++j) {
      const int src = (lane & ~3) | ((j & 7) >> 1);  // the quad lane holding column j
      const bool odd = j & 1, high = j >= 8;
      const float v0 = high ? (odd ? s[1][1] : s[1][0]) : (odd ? s[0][1] : s[0][0]);
      const float v8 = high ? (odd ? s[1][3] : s[1][2]) : (odd ? s[0][3] : s[0][2]);
      const float sg = __shfl_sync(FULL, v0, src);
      const float sg8 = __shfl_sync(FULL, v8, src);
#pragma unroll
      for (int nt = n0; nt < n0 + GRP; ++nt) {
        const float2 bv = *reinterpret_cast<const float2*>(b + j * ldb + nt * 8 + 2 * t);
        acc[nt][0] += sg * bv.x;
        acc[nt][1] += sg * bv.y;
        acc[nt][2] += sg8 * bv.x;
        acc[nt][3] += sg8 * bv.y;
      }
    }
  }
}

// acc (16 x 8 NT8) += A B over K: B K rows at b, row-major [k][n] (x gn,
// dy h_c). bf16: b is one bf16 array of a hi + lo pair, the caller adds
// both.
template <int K, int NT8, bool G = false>
__device__ __forceinline__ void mm_b(float (&acc)[NT8][4], const ARows<__nv_bfloat16, K>& A,
                                     const __nv_bfloat16* b, int ldb, int lane) {
  const __nv_bfloat16* bbase = b + (lane & 15) * ldb + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
#pragma unroll
    for (int np = 0; np < NT8 / 2; ++np) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, bbase + ks * 16 * ldb + np * 16);
      mma_bf16(acc[2 * np], A.f[ks], bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], A.f[ks], bf[2], bf[3]);
    }
    if constexpr (NT8 % 2) {
      uint32_t bf[2];
      ldmatrix_x2_trans(bf, b + ((lane & 15) + ks * 16) * ldb + (NT8 - 1) * 8);
      mma_bf16(acc[NT8 - 1], A.f[ks], bf[0], bf[1]);
    }
  }
}
template <int K, int NT8, bool G = false>
__device__ __forceinline__ void mm_b(float (&acc)[NT8][4], const ARows<float, K>& A,
                                     const float* b, int ldb, int lane) {
  const int g = lane >> 2, t = lane & 3;
  constexpr int GRP = NT8 < 2 ? NT8 : 2;  // n8 tiles a sweep over K
#pragma unroll
  for (int n0 = 0; n0 < NT8; n0 += GRP)
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const float a0 = A.a[g * A.lda + k], a1 = A.a[(g + 8) * A.lda + k];
#pragma unroll
    for (int nt = n0; nt < n0 + GRP; ++nt) {
      const float b0 = ldf<G>(b + k * ldb + nt * 8 + 2 * t);
      const float b1 = ldf<G>(b + k * ldb + nt * 8 + 2 * t + 1);
      acc[nt][0] += a0 * b0;
      acc[nt][1] += a0 * b1;
      acc[nt][2] += a1 * b0;
      acc[nt][3] += a1 * b1;
    }
  }
}

// The chain term: acc (16 rows p x 8 NT8 columns n) += sum_i exp(cs_i)
// dy_i[p] C_i[n] over 16 ksteps rows i. dy at dyc ([i][p], from this
// warp's first p), C at cc ([i][n], from its first n). bf16: dy^T by
// ldmatrix.trans, scaled by exp(cs_i) into hi + lo A fragments.
template <int NT8>
__device__ __forceinline__ void chain_term(float (&acc)[NT8][4], const __nv_bfloat16* dyc,
                                           int ldp, const __nv_bfloat16* cc, int ldn,
                                           const float* es, int ksteps, int lane) {
  const int t = lane & 3;
  const __nv_bfloat16* abase = dyc + ((lane & 7) + ((lane >> 4) & 1) * 8) * ldp + ((lane >> 3) & 1) * 8;
#pragma unroll 1
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k0 = ks * 16;
    uint32_t af[4], hi[4], lo[4];
    ldmatrix_x4_trans(af, abase + k0 * ldp);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + 2 * t + 8 * (e >> 1);
      const float2 f = unpack_bf16(af[e]);
      const float v0 = f.x * es[k], v1 = f.y * es[k + 1];
      hi[e] = pack_bf16(v0, v1);
      lo[e] = pack_bf16(v0 - bf16_round(v0), v1 - bf16_round(v1));
    }
    a_kmajor<NT8>(acc, hi, lo, cc + k0 * ldn, ldn, lane);
  }
}
template <int NT8>
__device__ __forceinline__ void chain_term(float (&acc)[NT8][4], const float* dyc, int ldp,
                                           const float* cc, int ldn, const float* es,
                                           int ksteps, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int i = 0; i < 16 * ksteps; ++i) {
    const float d0 = es[i] * dyc[i * ldp + g], d1 = es[i] * dyc[i * ldp + g + 8];
#pragma unroll
    for (int nt = 0; nt < NT8; ++nt) {
      const float2 cv = *reinterpret_cast<const float2*>(cc + i * ldn + nt * 8 + 2 * t);
      acc[nt][0] += d0 * cv.x;
      acc[nt][1] += d0 * cv.y;
      acc[nt][2] += d1 * cv.x;
      acc[nt][3] += d1 * cv.y;
    }
  }
}

// The sum over a warp in a fixed order (a butterfly); every lane gets it.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// sync: [0] the ticket counter, then one flag per (batch, head): the number
// of chunks of it published in this launch. All zero between launches.
template <typename T, int Q, int P, int N>
__global__ void __launch_bounds__(Q / 16 * 32, Q >= 128 ? 1 : 4)
    ssd_bwd_kernel(const Args args) {
  using L = Layout<T, Q, P, N>;
  constexpr bool BF16 = L::BF16;
  constexpr int NW = L::NW, NT = L::NT;          // a warp per 16-row tile
  constexpr int LDN = L::LDN, LDP = L::LDP;
  constexpr int EPC = 16 / (int)sizeof(T);       // elements per 16-byte copy
  constexpr int MT = P / 16, NTU = MT * (N / 8) / NW;  // the chain term's tiles a warp
  constexpr int VG = N / 8 >= 4 ? (BF16 ? 4 : 2) : N / 8;  // n8 tiles of x gn and dy h_c at a time
  constexpr int PER = Q / 32;                    // rows a lane of warp 0 scans
  static_assert(Q % 32 == 0 && P % 16 == 0 && N % 16 == 0 && N % EPC == 0 && N / 8 % VG == 0);
  static_assert(NW % MT == 0 && NTU % 2 == 0 && (N / 8) == NW / MT * NTU, "u's tiles cover P x N");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ticket;
  T* Bs = reinterpret_cast<T*>(smem + L::b);
  T* Cs = reinterpret_cast<T*>(smem + L::c);
  T* const xs0 = reinterpret_cast<T*>(smem + L::x);
  T* const dys0 = reinterpret_cast<T*>(smem + L::dy);
  __nv_bfloat16* ghi = reinterpret_cast<__nv_bfloat16*>(smem + L::pair);  // bf16 only
  __nv_bfloat16* glo = ghi + P * LDN;
  float* const dts0 = reinterpret_cast<float*>(smem + L::f);
  float* cum = dts0 + L::STAGES * Q;
  float* es = cum + Q;     // exp(cs_i)
  float* te = es + Q;      // exp(cs_last - cs_j)
  float* ws = te + Q;      // w_j
  float* xUs = ws + Q;     // x_j . gn B_j
  float* rowR = xUs + Q;   // sum_j R_ij
  float* dcsI = rowR + Q;  // dy_i . h_c C_i
  float* red = dcsI + Q;   // [2][NW]: the warps' <gn, h_c> and dy . x
  float* sdcs = red + 2 * NW;     // [RMAX][Q]: passes A and B's terms of dcs
  float* sddt = sdcs + RMAX * Q;  // [RMAX][Q]: passes A and B's terms of ddt

  const int R = args.R;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int nc = (args.S + Q - 1) / Q;
  int blk = blockIdx.x;
  if (nc > 1) {  // reverse chunk-major tickets in the order blocks start
    if (tid == 0) {
      ticket = atomicAdd(args.sync, 1);
      if (ticket == (int)gridDim.x - 1) atomicExch(args.sync, 0);  // every ticket is taken
    }
    __syncthreads();
    blk = ticket;
  }
  // (chunk, head block, batch); head blocks of R heads, args.H / R of them.
  // Indices are 32-bit: the wrapper keeps every element index below 2^31
  const int c = nc - 1 - blk / (args.H / R * args.Bsz), hb = blk % (args.H / R);
  const int b = blk / (args.H / R) % args.Bsz;
  const int qn = min(Q, args.S - c * Q);  // valid rows of this chunk
  const int row0 = b * args.S + c * Q;
  const bool has_gn = c < nc - 1 || args.dfinal != nullptr;  // else gn = 0
  // the warp's 16-row tile: at Q = 128 each of the SM's four schedulers
  // gets tiles t and 7 - t, so the triangle's work is even
  const int rt = NW == 8 ? (warp < 4 ? warp : 11 - warp) : warp;
  const int r0 = 16 * rt;
  const bool live = r0 < qn;

  // ---- the chunk's B and C (the group's) once ----
  {
    const int brow = args.G * N, grp = hb * R / (args.H / args.G);
    const T* Bb = static_cast<const T*>(args.B) + row0 * brow + grp * N;
    const T* Cb = static_cast<const T*>(args.C) + row0 * brow + grp * N;
    for (int e = tid; e < Q * (N / EPC); e += NT) {
      const int r = e / (N / EPC), col = e % (N / EPC) * EPC;
      const bool in = r < qn;
      const int off = in ? r * brow + col : 0;
      cp_async16(Bs + r * LDN + col, Bb + off, in);
      cp_async16(Cs + r * LDN + col, Cb + off, in);
    }
  }
  // The block's 3 R head visits (passes A, B and C): visit v's
  // x, dy and dt go to stage v % STAGES. With two stages visit v + 1's copy
  // is issued as visit v begins and runs under its work.
  auto issue = [&](int v) {
    const int h = hb * R + v % R, st = v % L::STAGES, xrow = args.H * P;
    const T* xb = static_cast<const T*>(args.x) + row0 * xrow + h * P;
    const T* dyb = static_cast<const T*>(args.dy) + row0 * xrow + h * P;
    T* xd = xs0 + st * Q * LDP;
    T* dyd = dys0 + st * Q * LDP;
    for (int e = tid; e < Q * (P / EPC); e += NT) {
      const int r = e / (P / EPC), col = e % (P / EPC) * EPC;
      const bool in = r < qn;
      const int off = in ? r * xrow + col : 0;
      cp_async16(xd + r * LDP + col, xb + off, in);
      cp_async16(dyd + r * LDP + col, dyb + off, in);
    }
    for (int r = tid; r < Q; r += NT)
      cp_async4(dts0 + st * Q + r, args.dt + (row0 + (r < qn ? r : 0)) * args.H + h, r < qn);
    cp_async_commit();
  };
  // Visit v begins: its copy has landed and every thread is done with
  // visit v - 1; the next visit's copy is issued (one stage: this one's).
  auto begin = [&](int v) {
    if constexpr (L::STAGES == 1) {
      if (v > 0) {
        __syncthreads();
        issue(v);
      }
      cp_async_wait_all();
      __syncthreads();
    } else {
      cp_async_wait_all();
      __syncthreads();
      if (v + 1 < 3 * R) issue(v + 1);
    }
  };
  issue(0);  // with B and C
  // the inclusive cumsum of dt * a and the decays, in warp 0 (PER rows a
  // lane, then a shuffle scan); returns exp(cs_last). Padded rows add 0.
  auto decays = [&](const float* dts, float a) {
    if (warp == 0) {
      float v[PER], run = 0.f;
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        run += dts[lane * PER + m] * a;
        v[m] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += t;
      }
      float excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = 0.f;
      const float last = __shfl_sync(FULL, incl, 31);
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int q = lane * PER + m;
        const float cs = excl + v[m];
        cum[q] = cs;
        es[q] = expf(cs);
        te[q] = expf(last - cs);
        ws[q] = te[q] * dts[q];
      }
    }
    __syncthreads();
    return expf(cum[Q - 1]);
  };

  // A product's A operand held in registers (cached) or, at N = 128 in
  // bf16, streamed from shared memory a k-step at a time: cached beside the
  // dB or dC accumulators it spills.
  constexpr bool STREAM = BF16 && N >= 128;
  // the tiles G^T = B_j C_i^T (pass A and B) or G = C_i B_j^T (pass C) of
  // this warp's rows r0 against the 16 rows at o
  auto g_tile = [&](float (&g)[2][4], const T* rows, const T* other, int o,
                    const ARows<T, STREAM ? 16 : N>& cached) {
    if constexpr (STREAM) mm_bt<N, 2>(g, rows + r0 * LDN, LDN, other + o * LDN, LDN, lane);
    else mm_bt<N, 2>(g, cached, other + o * LDN, LDN, lane);
  };
  // gn (passes A and B) or h_c (pass C), f32 (P, N) in device memory, as the
  // bf16 hi + lo pair in shared memory
  auto stage_pair = [&](const float* src) {
#pragma unroll 2
    for (int e = tid; e < P * N / 4; e += NT) {
      const int p = e / (N / 4), n = e % (N / 4) * 4;
      const float4 v = __ldcg(reinterpret_cast<const float4*>(src + p * N + n));
      uint32_t* hi = reinterpret_cast<uint32_t*>(ghi + p * LDN + n);
      uint32_t* lo = reinterpret_cast<uint32_t*>(glo + p * LDN + n);
      hi[0] = pack_bf16(v.x, v.y);
      hi[1] = pack_bf16(v.z, v.w);
      lo[0] = pack_bf16(v.x - bf16_round(v.x), v.y - bf16_round(v.y));
      lo[1] = pack_bf16(v.z - bf16_round(v.z), v.w - bf16_round(v.w));
    }
  };

  // ======== pass A, per head: the chain and dx ========
  for (int k = 0; k < R; ++k) {
    const int h = hb * R + k;
    begin(k);
    const T* xs = xs0 + k % L::STAGES * Q * LDP;
    const T* dys = dys0 + k % L::STAGES * Q * LDP;
    const float* dts = dts0 + k % L::STAGES * Q;
    decays(dts, args.A[h]);
    const int sc = ((b * nc + c) * args.H + h) * P * N;  // this (batch, chunk, head)'s state
    for (int e = tid; e < P * N / 32; e += NT) prefetch_l2(args.h_in + sc + e * 32);

    // ---- the chain: gn = g_{c+1} from the slot (d(final) or zero at the
    // last chunk), kept in gsave for pass B; g_c = exp(cs_last) gn + u
    // published in its place, u = (exp(cs) dy)^T C spread over every warp
    // and taken in parts of this warp's columns (f32: after dx's state
    // term, which reads gn in the slot) ----
    const int st = (b * args.H + h) * P * N;
    float* slot = args.dh0 + st;
    int* flag = args.sync + 1 + b * args.H + h;
    const float* gsrc = c < nc - 1 ? slot : args.dfinal == nullptr ? nullptr : args.dfinal + st;
    const float* hc = args.h_in + sc;
    if (c < nc - 1) {
      if (tid == 0)
        while (ld_acquire(flag) < nc - 1 - c) {
        }
      __syncthreads();
    }
    auto gn_at = [&](int p, int n) {
      float2 v = make_float2(0.f, 0.f);
      if (c < nc - 1) v = __ldcg(reinterpret_cast<const float2*>(gsrc + p * N + n));
      else if (gsrc != nullptr) v = *reinterpret_cast<const float2*>(gsrc + p * N + n);
      return v;
    };
    auto publish = [&]() {
      const float el = expf(cum[Q - 1]);
      constexpr int PARTS = NTU >= 4 ? 4 : 2;
#pragma unroll
      for (int part = 0; part < PARTS; ++part) {
        constexpr int NTH = NTU / PARTS;
        const int n0 = warp / MT * NTU * 8 + part * NTH * 8;
        float u[NTH][4];
#pragma unroll
        for (int nt = 0; nt < NTH; ++nt) u[nt][0] = u[nt][1] = u[nt][2] = u[nt][3] = 0.f;
        chain_term<NTH>(u, dys + (warp % MT) * 16, LDP, Cs + n0, LDN, es, (qn + 15) / 16, lane);
#pragma unroll
        for (int nt = 0; nt < NTH; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int p = (warp % MT) * 16 + g8 + 8 * hf, n = n0 + nt * 8 + 2 * t4;
            const float2 v = gn_at(p, n);
            store2(args.gsave + sc + p * N + n, v.x, v.y);
            store2(slot + p * N + n, el * v.x + u[nt][2 * hf], el * v.y + u[nt][2 * hf + 1]);
            if constexpr (BF16) {  // gn as a hi + lo pair for dx's state term
              *reinterpret_cast<uint32_t*>(ghi + p * LDN + n) = pack_bf16(v.x, v.y);
              *reinterpret_cast<uint32_t*>(glo + p * LDN + n) =
                  pack_bf16(v.x - bf16_round(v.x), v.y - bf16_round(v.y));
            }
          }
      }
      if (nc > 1) {
        if (c > 0) {
          __threadfence();
          __syncthreads();
          if (tid == 0) st_release(flag, nc - c);
        } else if (tid == 0) {
          *flag = 0;  // chunk 0: nothing waits on it; ready for the next launch
        }
      }
    };
    if constexpr (BF16) publish();
    __syncthreads();  // the pair
    // this thread's share of <gn, h_c> (bf16: gn as its pair), at the
    // positions it published, summed over the warp at once
    float hg = 0.f;
#pragma unroll 1
    for (int nt = 0; nt < NTU; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = (warp % MT) * 16 + g8 + 8 * hf, n = warp / MT * NTU * 8 + nt * 8 + 2 * t4;
        const float2 hv = __ldg(reinterpret_cast<const float2*>(hc + p * N + n));
        float2 v;
        if constexpr (BF16) {
          const float2 hi = unpack_bf16(*reinterpret_cast<const uint32_t*>(ghi + p * LDN + n));
          const float2 lo = unpack_bf16(*reinterpret_cast<const uint32_t*>(glo + p * LDN + n));
          v = make_float2(hi.x + lo.x, hi.y + lo.y);
        } else {
          v = gn_at(p, n);
        }
        hg += v.x * hv.x + v.y * hv.y;
      }
    hg = warp_sum(hg);
    if (lane == 0) red[warp] = hg;

    // ---- this warp's rows j: dx_j = w_j gn B_j + D dy_j + sum_{i>=j} M_ij
    // dy_i (G^T tile by tile, M^T in place, exp only on or below the
    // diagonal); x_j . gn B_j; sum dy . x ----
    [[maybe_unused]] ARows<T, STREAM ? 16 : N> bj;  // B_j, the A operand here
    if constexpr (!STREAM) bj.load(Bs + r0 * LDN, LDN, lane);
    float dd = 0.f, xu[2] = {0.f, 0.f};
    if (live) {
      float dxa[P / 8][4];
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt) dxa[nt][0] = dxa[nt][1] = dxa[nt][2] = dxa[nt][3] = 0.f;
      if (has_gn) {
        if constexpr (STREAM) {
          mm_bt<N, P / 8>(dxa, Bs + r0 * LDN, LDN, ghi, LDN, lane);
          mm_bt<N, P / 8>(dxa, Bs + r0 * LDN, LDN, glo, LDN, lane);
        } else if constexpr (BF16) {
          mm_bt<N, P / 8>(dxa, bj, ghi, LDN, lane);
          mm_bt<N, P / 8>(dxa, bj, glo, LDN, lane);
        } else {
          mm_bt<N, P / 8, true>(dxa, bj, gsrc, N, lane);
        }
      }
      const float dcoef = args.D[h];
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int j = r0 + g8 + 8 * hf, p = nt * 8 + 2 * t4;
          const float x0 = to_float(xs[j * LDP + p]), x1 = to_float(xs[j * LDP + p + 1]);
          const float d0 = to_float(dys[j * LDP + p]), d1 = to_float(dys[j * LDP + p + 1]);
          xu[hf] += x0 * dxa[nt][2 * hf] + x1 * dxa[nt][2 * hf + 1];
          dd += d0 * x0 + d1 * x1;
          dxa[nt][2 * hf] = ws[j] * dxa[nt][2 * hf] + dcoef * d0;
          dxa[nt][2 * hf + 1] = ws[j] * dxa[nt][2 * hf + 1] + dcoef * d1;
        }
      const float csj[2] = {cum[r0 + g8], cum[r0 + g8 + 8]};
      const float dtj[2] = {dts[r0 + g8], dts[r0 + g8 + 8]};
#pragma unroll 1
      for (int ti = rt; ti < NW && 16 * ti < qn; ++ti) {
        const int i0 = 16 * ti;
        float gt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        g_tile(gt, Bs, Cs, i0, bj);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int jh = e >> 1, i = i0 + nt * 8 + 2 * t4 + (e & 1);
            gt[nt][e] = i >= r0 + g8 + 8 * jh ? gt[nt][e] * expf(cum[i] - csj[jh]) * dtj[jh] : 0.f;
          }
        frag_kmajor<P / 8>(dxa, gt, dys + i0 * LDP, LDP, lane);
      }
      const int xrow = args.H * P;
      T* dxb = static_cast<T*>(args.dx) + row0 * xrow + h * P;
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int j = r0 + g8 + 8 * hf;
          if (j < qn)
            store2(dxb + j * xrow + nt * 8 + 2 * t4, dxa[nt][2 * hf], dxa[nt][2 * hf + 1]);
        }
    }
    dd = warp_sum(dd);
    xu[0] = quad_sum(xu[0]);
    xu[1] = quad_sum(xu[1]);
    if (lane == 0) red[NW + warp] = dd;
    if (t4 == 0) {
      xUs[r0 + g8] = xu[0];
      xUs[r0 + g8 + 8] = xu[1];
    }
    if constexpr (!BF16) {
      __syncthreads();  // every read of gn in the slot is done
      publish();
    }
    __syncthreads();  // xUs, red

    // ---- in warp 0: dcs's and ddt's terms from this pass (T_j = w_j x_j .
    // gn B_j; sum_j T_j + exp(cs_last) <gn, h_c> to dcs_last); the head's dD ----
    if (warp == 0) {
      float tsum = 0.f;
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int q = lane + 32 * m;
        const float tj = ws[q] * xUs[q];
        tsum += tj;
        sdcs[k * Q + q] = -tj;
        sddt[k * Q + q] = te[q] * xUs[q];
      }
      tsum = warp_sum(tsum);
      __syncwarp();
      if (lane == 0) {
        float hgs = 0.f, dds = 0.f;
        for (int w = 0; w < NW; ++w) {
          hgs += red[w];
          dds += red[NW + w];
        }
        sdcs[k * Q + Q - 1] += tsum + expf(cum[Q - 1]) * hgs;
        args.part_D[(b * nc + c) * args.H + h] = dds;
      }
    }
  }

  // ======== pass B, per head: the block's dB, the sums over i ========
  {
    float dBa[N / 8][4];
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) dBa[nt][0] = dBa[nt][1] = dBa[nt][2] = dBa[nt][3] = 0.f;
    for (int k = 0; k < R; ++k) {
      const int h = hb * R + k, v = R + k;
      const int sc = ((b * nc + c) * args.H + h) * P * N;
      begin(v);
      const T* xs = xs0 + v % L::STAGES * Q * LDP;
      const T* dys = dys0 + v % L::STAGES * Q * LDP;
      const float* dts = dts0 + v % L::STAGES * Q;
      if constexpr (BF16)
        if (has_gn) stage_pair(args.gsave + sc);
      decays(dts, args.A[h]);  // its barrier also publishes the pair

      // ---- this warp's rows j: over the tiles i >= j G^T and dM^T, their
      // sums over i, dG^T in place, dB += dG^T C_i; dB_j += w_j x_j gn ----
      [[maybe_unused]] ARows<T, STREAM ? 16 : N> bj;  // B_j and x_j, the A operands here
      ARows<T, P> xj;
      if constexpr (!STREAM) bj.load(Bs + r0 * LDN, LDN, lane);
      xj.load(xs + r0 * LDP, LDP, lane);
      float kj[2] = {0.f, 0.f}, rj[2] = {0.f, 0.f};
      if (live) {
        const float csj[2] = {cum[r0 + g8], cum[r0 + g8 + 8]};
        const float dtj[2] = {dts[r0 + g8], dts[r0 + g8 + 8]};
#pragma unroll 1
        for (int ti = rt; ti < NW && 16 * ti < qn; ++ti) {
          const int i0 = 16 * ti;
          float gt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          float mt[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
          g_tile(gt, Bs, Cs, i0, bj);
          mm_bt<P, 2>(mt, xj, dys + i0 * LDP, LDP, lane);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int jh = e >> 1, i = i0 + nt * 8 + 2 * t4 + (e & 1);
              if (i >= r0 + g8 + 8 * jh) {
                const float l = expf(cum[i] - csj[jh]);
                const float kv = mt[nt][e] * gt[nt][e] * l;
                kj[jh] += kv;
                rj[jh] += kv * dtj[jh];
                mt[nt][e] *= l * dtj[jh];
              } else {
                mt[nt][e] = 0.f;
              }
            }
          frag_kmajor<N / 8>(dBa, mt, Cs + i0 * LDN, LDN, lane);
        }
        if (has_gn) {
          const float w0 = ws[r0 + g8], w1 = ws[r0 + g8 + 8];
#pragma unroll
          for (int gi = 0; gi < N / 8 / VG; ++gi) {  // VG n8 tiles at a time
            float tmp[VG][4];
#pragma unroll
            for (int nt = 0; nt < VG; ++nt) tmp[nt][0] = tmp[nt][1] = tmp[nt][2] = tmp[nt][3] = 0.f;
            if constexpr (BF16) {
              mm_b<P, VG>(tmp, xj, ghi + gi * VG * 8, LDN, lane);
              mm_b<P, VG>(tmp, xj, glo + gi * VG * 8, LDN, lane);
            } else {
              mm_b<P, VG, true>(tmp, xj, args.gsave + sc + gi * VG * 8, N, lane);
            }
#pragma unroll
            for (int nt = 0; nt < VG; ++nt) {
              dBa[gi * VG + nt][0] += w0 * tmp[nt][0];
              dBa[gi * VG + nt][1] += w0 * tmp[nt][1];
              dBa[gi * VG + nt][2] += w1 * tmp[nt][2];
              dBa[gi * VG + nt][3] += w1 * tmp[nt][3];
            }
          }
        }
      }
      // the sums over i into pass A's terms (a row lies in one warp)
#pragma unroll
      for (int jh = 0; jh < 2; ++jh) {
        kj[jh] = quad_sum(kj[jh]);
        rj[jh] = quad_sum(rj[jh]);
        if (t4 == 0) {
          sdcs[k * Q + r0 + g8 + 8 * jh] -= rj[jh];
          sddt[k * Q + r0 + g8 + 8 * jh] += kj[jh];
        }
      }
    }
    // the block's dB partial
    const int HB = args.H / R;
    float* pB = args.part_B + (row0 * HB + hb) * N;
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = r0 + g8 + 8 * hf;
        if (j < qn) store2(pB + j * HB * N + nt * 8 + 2 * t4, dBa[nt][2 * hf], dBa[nt][2 * hf + 1]);
      }
  }

  // ======== pass C, per head: the block's dC, then dcs, da, ddt and dA ========
  float dCa[N / 8][4];
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) dCa[nt][0] = dCa[nt][1] = dCa[nt][2] = dCa[nt][3] = 0.f;
  for (int k = 0; k < R; ++k) {
    const int h = hb * R + k, v = 2 * R + k;
    const float* hc = args.h_in + ((b * nc + c) * args.H + h) * P * N;
    begin(v);
    const T* xs = xs0 + v % L::STAGES * Q * LDP;
    const T* dys = dys0 + v % L::STAGES * Q * LDP;
    const float* dts = dts0 + v % L::STAGES * Q;
    if constexpr (BF16) stage_pair(hc);  // h_c as a hi + lo pair
    const float a = args.A[h];
    decays(dts, a);  // its barrier also publishes the pair

    // ---- this warp's rows i: dC_i += exp(cs_i) h_c^T dy_i and dy_i . h_c
    // C_i; over the tiles j <= i G and dM, the sums over j of R, dG in
    // place of dM, dC += dG B_j ----
    [[maybe_unused]] ARows<T, STREAM ? 16 : N> ci;  // C_i and dy_i, the A operands here
    ARows<T, P> dyi;
    if constexpr (!STREAM) ci.load(Cs + r0 * LDN, LDN, lane);
    dyi.load(dys + r0 * LDP, LDP, lane);
    float ri[2] = {0.f, 0.f}, di[2] = {0.f, 0.f};
    if (live) {
      const float ei[2] = {es[r0 + g8], es[r0 + g8 + 8]};
#pragma unroll
      for (int gi = 0; gi < N / 8 / VG; ++gi) {  // VG n8 tiles at a time
        float tmp[VG][4];
#pragma unroll
        for (int nt = 0; nt < VG; ++nt) tmp[nt][0] = tmp[nt][1] = tmp[nt][2] = tmp[nt][3] = 0.f;
        const int n0 = gi * VG * 8;
        if constexpr (BF16) {
          mm_b<P, VG>(tmp, dyi, ghi + n0, LDN, lane);
          mm_b<P, VG>(tmp, dyi, glo + n0, LDN, lane);
        } else {
          mm_b<P, VG, true>(tmp, dyi, hc + n0, N, lane);
        }
#pragma unroll
        for (int nt = 0; nt < VG; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = r0 + g8 + 8 * (e >> 1), n = n0 + nt * 8 + 2 * t4 + (e & 1);
            di[e >> 1] += to_float(Cs[i * LDN + n]) * tmp[nt][e];
            dCa[gi * VG + nt][e] += ei[e >> 1] * tmp[nt][e];
          }
      }
      const float csi[2] = {cum[r0 + g8], cum[r0 + g8 + 8]};
#pragma unroll 1
      for (int tj = 0; tj <= rt; ++tj) {
        const int j0 = 16 * tj;
        float gg[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        float dm[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        g_tile(gg, Cs, Bs, j0, ci);
        mm_bt<P, 2>(dm, dyi, xs + j0 * LDP, LDP, lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ih = e >> 1, j = j0 + nt * 8 + 2 * t4 + (e & 1);
            if (j <= r0 + g8 + 8 * ih) {
              const float l = expf(csi[ih] - cum[j]) * dts[j];
              dm[nt][e] *= l;
              ri[ih] += dm[nt][e] * gg[nt][e];
            } else {
              dm[nt][e] = 0.f;
            }
          }
        frag_kmajor<N / 8>(dCa, dm, Bs + j0 * LDN, LDN, lane);
      }
    }
#pragma unroll
    for (int ih = 0; ih < 2; ++ih) {
      ri[ih] = quad_sum(ri[ih]);
      di[ih] = quad_sum(di[ih]);
    }
    if (t4 == 0) {
#pragma unroll
      for (int ih = 0; ih < 2; ++ih) {
        dcsI[r0 + g8 + 8 * ih] = di[ih];
        rowR[r0 + g8 + 8 * ih] = ri[ih];
      }
    }
    __syncthreads();

    // ---- in warp 0: dcs, da = its reverse cumsum (lane l takes rows
    // Q - 1 - PER l down), ddt and the head's dA ----
    if (warp == 0) {
      float v[PER], run = 0.f;
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int q = Q - 1 - (lane * PER + m);
        const float d = rowR[q] + es[q] * dcsI[q] + sdcs[k * Q + q];
        run += args.drop_dcs ? 0.f : d;
        v[m] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += t;
      }
      float excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = 0.f;
      float dtda = 0.f;
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int q = Q - 1 - (lane * PER + m);
        const float da = excl + v[m];
        if (q < qn) args.ddt[(row0 + q) * args.H + h] = sddt[k * Q + q] + a * da;
        dtda += dts[q] * da;
      }
      dtda = warp_sum(dtda);
      if (lane == 0) args.part_A[(b * nc + c) * args.H + h] = dtda;
    }
  }
  {  // the block's dC partial
    const int HB = args.H / R;
    float* pC = args.part_C + (row0 * HB + hb) * N;
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = r0 + g8 + 8 * hf;
        if (i < qn) store2(pC + i * HB * N + nt * 8 + 2 * t4, dCa[nt][2 * hf], dCa[nt][2 * hf + 1]);
      }
  }
}

// The fixed-order sums: dB and dC over each group's head blocks in order,
// dA and dD over the (batch, chunk) blocks in order. A thread per output.
template <typename T>
__global__ void ssd_bwd_sum_kernel(const Args args, int N, int nblocks) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int H = args.H, G = args.G, HB = H / args.R, per = HB / G;
  const long total = (long)args.Bsz * args.S * G * N;
  if (e < total) {
    const int n = e % N, g = e / N % G;
    const long row = e / N / G;
    const long off = (row * HB + (long)g * per) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < per; ++k) {
      sb += args.part_B[off + (long)k * N];
      sc += args.part_C[off + (long)k * N];
    }
    put(static_cast<T*>(args.dB) + e, sb);
    put(static_cast<T*>(args.dC) + e, sc);
  } else if (e < total + H) {
    const int h = e - total;
    float sa = 0.f, sd = 0.f;
    for (int k = 0; k < nblocks; ++k) {
      sa += args.part_A[(long)k * H + h];
      sd += args.part_D[(long)k * H + h];
    }
    args.dA[h] = sa;
    args.dD[h] = sd;
  }
}

template <typename T, int Q, int P, int N>
cudaError_t prepare() {
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_bwd_kernel<T, Q, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<T, Q, P, N>::bytes);
  return attr;
}

template <typename T, int Q, int P, int N>
int launch(const Args& args, cudaStream_t stream) {
  using L = Layout<T, Q, P, N>;
  const cudaError_t attr = prepare<T, Q, P, N>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long nc = (args.S + Q - 1) / Q;
  if (args.R < 1 || args.R > RMAX || (args.H / args.G) % args.R != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long blocks = nc * (args.H / args.R) * args.Bsz;
  const long sums = (long)args.Bsz * args.S * args.G * N + args.H;
  if (blocks > 0x7fffffffL || (sums + 255) / 256 > 0x7fffffffL ||
      (nc > 1 && args.sync == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  ssd_bwd_kernel<T, Q, P, N><<<(unsigned)blocks, L::NT, L::bytes, stream>>>(args);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_sum_kernel<T><<<(unsigned)((sums + 255) / 256), 256, 0, stream>>>(
      args, N, (int)(nc * args.Bsz));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int Q, int P, int N>
int occupancy(int* blocks) {
  using L = Layout<T, Q, P, N>;
  const cudaError_t attr = prepare<T, Q, P, N>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ssd_bwd_kernel<T, Q, P, N>, L::NT, L::bytes));
}

template <int Q, int P, int N>
int launch_dtype(int dtype, const Args& args, cudaStream_t stream) {
  if (dtype == 0) return launch<float, Q, P, N>(args, stream);
  if (dtype == 1) return launch<__nv_bfloat16, Q, P, N>(args, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int Q, int P, int N>
int occupancy_dtype(int dtype, int* blocks) {
  if (dtype == 0) return occupancy<float, Q, P, N>(blocks);
  if (dtype == 1) return occupancy<__nv_bfloat16, Q, P, N>(blocks);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, dy, dx (B,S,H,P), dt, ddt (B,S,H) f32, A, D, dA, dD (H,) f32, Bm, Cm, dB,
// dC (B,S,G,N), h_in (B,nc,H,P,N) f32 (the forward's state entering each
// chunk), dfinal (B,H,P,N) f32 or null (zero), dh0 (B,H,P,N) f32; scratch:
// gsave (B,nc,H,P,N) f32, part_B, part_C (B,S,H/R,N) f32 and part_A,
// part_D (B,nc,H) f32; all
// contiguous, x, Bm, Cm and dy 16-byte aligned. sync: at least 1 + B * H
// int32 zeros (the forward's buffer), left zero. R: heads a block takes, a
// divisor of H / G, at most 16. dtype (of x, Bm, Cm, dy and their
// cotangents): 0 float32, 1 bfloat16. drop_dcs != 0 drops the decays'
// cotangent (a wrong gradient, for controls). Two launches; returns the
// cudaError_t of the launches.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* D, const void* h_in, const void* dy,
                            const void* dfinal, void* dx, void* ddt, void* dA, void* dB, void* dC,
                            void* dD, void* dh0, void* gsave, void* part_B, void* part_C,
                            void* part_A, void* part_D, void* sync, int Bsz, int S, int H, int Pdim, int G,
                            int N, int chunk, int R, int dtype, int drop_dcs, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args args{x,
                  static_cast<const float*>(dt),
                  static_cast<const float*>(A),
                  Bm,
                  Cm,
                  static_cast<const float*>(D),
                  static_cast<const float*>(h_in),
                  dy,
                  static_cast<const float*>(dfinal),
                  dx,
                  static_cast<float*>(ddt),
                  static_cast<float*>(dA),
                  dB,
                  dC,
                  static_cast<float*>(dD),
                  static_cast<float*>(dh0),
                  static_cast<float*>(gsave),
                  static_cast<float*>(part_B),
                  static_cast<float*>(part_C),
                  static_cast<float*>(part_A),
                  static_cast<float*>(part_D),
                  static_cast<int*>(sync),
                  Bsz,
                  S,
                  H,
                  G,
                  R,
                  drop_dcs};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Pdim == 64 && N == 128 && chunk == 128) return launch_dtype<128, 64, 128>(dtype, args, st);
  if (Pdim == 64 && N == 64 && chunk == 128) return launch_dtype<128, 64, 64>(dtype, args, st);
  if (Pdim == 32 && N == 16 && chunk == 32) return launch_dtype<32, 32, 16>(dtype, args, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The blocks of the backward kernel one SM holds at (Pdim, N, chunk) and
// dtype, into *blocks; returns the cudaError_t of the query.
extern "C" int ssd_scan_bwd_blocks_per_sm(int Pdim, int N, int chunk, int dtype, int* blocks) {
  if (Pdim == 64 && N == 128 && chunk == 128) return occupancy_dtype<128, 64, 128>(dtype, blocks);
  if (Pdim == 64 && N == 64 && chunk == 128) return occupancy_dtype<128, 64, 64>(dtype, blocks);
  if (Pdim == 32 && N == 16 && chunk == 32) return occupancy_dtype<32, 32, 16>(dtype, blocks);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
