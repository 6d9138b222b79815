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
// Design: the forward's chunk-parallel shape, one block of 8 warps per
//   (chunk, head, batch) over the whole head_dim (dM, dC, dB and dcs sum
//   over every column p, so a column split would need partials). Blocks
//   take tickets in reverse chunk-major order, so each block the chain
//   waits on already runs. A block computes its chunk's chain term u =
//   sum_i exp(cs_i) dy_i (outer) C_i, waits for chunk c + 1's flag of its
//   (batch, head) (release/acquire at gpu scope), reads gn from the slot
//   (dh0, in place: one reader per state, as the forward publishes in the
//   final-state output), publishes g_c = exp(cs_last) gn + u there, and
//   then, with gn kept in shared memory, does its intra-chunk work, which
//   overlaps the chain of later tickets. The ticket counter and the flags
//   are the forward's zeroed buffer and are left zero. The chunk's two
//   Q x Q matrices, C B^T and dy x^T, are recomputed on or below the
//   diagonal (mma.sync m16n8k16 bf16 -> f32 with operands read straight
//   from global memory: exact products of the bf16 inputs; scalar FMA in
//   f32) into shared memory; a thread per row and one per column take
//   their sums for dcs and ddt; they are turned into M and dG in place;
//   and dx, dB and dC are three passes of scalar f32 FMA over them, each
//   thread holding a (Q / 16) x (width / 16) tile. Nothing is rounded but
//   the outputs. Sums are in a fixed order with no atomics: dB and dC are
//   written as f32 per-head partials and dA, dD as per-block partials, and
//   a second launch sums them in index order (heads of a group, then
//   (batch, chunk)), so two calls are bitwise equal. This is the simple
//   kernel: its f32 FMA passes, not the bound, set its time; the products
//   on the tensor cores and the partials' bytes are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int NW = NT / 32;
constexpr unsigned FULL = 0xffffffffu;

// Shared memory of a block: the two Q x Q matrices at a row stride of Q + 1
// (a thread per row and a thread per column both read without bank
// conflicts), gn as [P][N + 1], twelve Q-long arrays and two of NW.
template <int Q, int P, int N>
struct Smem {
  static constexpr int LDQ = Q + 1, LDG = N + 1;
  static constexpr int bytes = (2 * Q * LDQ + P * LDG + 12 * Q + 2 * NW) * 4;
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
  float* part_B;
  float* part_C;
  float* part_A;
  float* part_D;
  int* sync;
  int Bsz, S, H, G, drop_dcs;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p, bool in) {
  return in ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

// Fragments (lane = 4 g + t): accumulator element e of an m16n8 tile sits at
// row g + 8 (e >> 1), column 2 t + (e & 1). acc (16 x 8) += A B^T over K:
// A's rows i0 .. i0 + 15 and B's rows j0 .. j0 + 7, row-major with K
// contiguous at row strides lda and ldb; rows from qn on read as zero.
// bf16: the fragments are loaded from global memory 4 bytes at a time.
template <int K>
__device__ __forceinline__ void tile_abt(float (&acc)[4], const __nv_bfloat16* a, long lda,
                                         const __nv_bfloat16* b, long ldb, int i0, int j0,
                                         int qn, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bool a0 = i0 + g < qn, a1 = i0 + g + 8 < qn, b0 = j0 + g < qn;
  const __nv_bfloat16* ar = a + (long)(i0 + g) * lda + 2 * t;
  const __nv_bfloat16* br = b + (long)(j0 + g) * ldb + 2 * t;
#pragma unroll
  for (int k = 0; k < K; k += 16) {
    const uint32_t af[4] = {ld_pair(ar + k, a0), ld_pair(ar + 8 * lda + k, a1),
                            ld_pair(ar + k + 8, a0), ld_pair(ar + 8 * lda + k + 8, a1)};
    mma_bf16(acc, af, ld_pair(br + k, b0), ld_pair(br + k + 8, b0));
  }
}
template <int K>
__device__ __forceinline__ void tile_abt(float (&acc)[4], const float* a, long lda,
                                         const float* b, long ldb, int i0, int j0, int qn,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int ia = i0 + g, ib = ia + 8, ja = j0 + 2 * t, jb = ja + 1;
  const float* ra = a + (long)ia * lda;
  const float* rb = a + (long)ib * lda;
  const float* ca = b + (long)ja * ldb;
  const float* cb = b + (long)jb * ldb;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float x0 = ia < qn ? ra[k] : 0.f, x1 = ib < qn ? rb[k] : 0.f;
    const float y0 = ja < qn ? ca[k] : 0.f, y1 = jb < qn ? cb[k] : 0.f;
    acc[0] += x0 * y0;
    acc[1] += x0 * y1;
    acc[2] += x1 * y0;
    acc[3] += x1 * y1;
  }
}

// The sum of v over the block in a fixed order (a shuffle tree in each warp,
// then the warps' sums in order); every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();  // red is free
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < NW; ++k) s += red[k];
  return s;
}

// The sum over the 16 lanes of a half-warp (the threads that share a row of
// a pass's tile), in a fixed order; every lane of the half gets it.
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// sync: [0] the ticket counter, then one flag per (batch, head): the number
// of chunks of it published in this launch. All zero between launches.
template <typename T, int Q, int P, int N>
__global__ void __launch_bounds__(NT, 1) ssd_bwd_kernel(const Args args) {
  static_assert(Q % 32 == 0 && 2 * Q <= NT && P % 16 == 0 && N % 16 == 0);
  constexpr int LDQ = Smem<Q, P, N>::LDQ, LDG = Smem<Q, P, N>::LDG;
  constexpr int RP = P / 16, RN = N / 16, RQ = Q / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ticket;
  float* bufG = reinterpret_cast<float*>(smem);  // C B^T, then M
  float* bufD = bufG + Q * LDQ;                  // dy x^T, then dG
  float* gns = bufD + Q * LDQ;                   // gn, [P][N + 1]
  float* cum = gns + P * LDG;                    // cs
  float* dts = cum + Q;
  float* es = dts + Q;    // exp(cs_i)
  float* te = es + Q;     // exp(cs_last - cs_j)
  float* ws = te + Q;     // w_j
  float* rowR = ws + Q;   // sum_j R_ij
  float* colR = rowR + Q; // sum_i R_ij
  float* colK = colR + Q; // sum_i dM_ij G_ij L_ij
  float* xU = colK + Q;   // x_j . gn B_j
  float* dcsI = xU + Q;   // exp(cs_i) dy_i . h_c C_i
  float* da = dcsI + Q;
  float* dcs = da + Q;
  float* red = dcs + Q;   // NW
  float* tot = red + NW;  // NW: the scans' warp totals

  const T* x = static_cast<const T*>(args.x);
  const T* Bm = static_cast<const T*>(args.B);
  const T* Cm = static_cast<const T*>(args.C);
  const T* dy = static_cast<const T*>(args.dy);
  const int Bsz = args.Bsz, S = args.S, H = args.H, G = args.G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nc = (S + Q - 1) / Q;
  int blk = blockIdx.x;
  if (nc > 1) {  // reverse chunk-major tickets in the order blocks start
    if (tid == 0) {
      ticket = atomicAdd(args.sync, 1);
      if (ticket == (int)gridDim.x - 1) atomicExch(args.sync, 0);  // every ticket is taken
    }
    __syncthreads();
    blk = ticket;
  }
  const int c = nc - 1 - blk / (H * Bsz), h = blk % H, b = blk / H % Bsz;
  const int grp = h / (H / G);
  const int s0 = c * Q, qn = min(Q, S - s0);  // valid rows of this chunk
  const long xrow = (long)H * P, brow = (long)G * N, prow = (long)H * N;
  const long row0 = (long)b * S + s0;
  const T* xb = x + row0 * xrow + (long)h * P;
  const T* dyb = dy + row0 * xrow + (long)h * P;
  T* dxb = static_cast<T*>(args.dx) + row0 * xrow + (long)h * P;
  const float* dtb = args.dt + row0 * H + h;
  float* ddtb = args.ddt + row0 * H + h;
  const T* Bb = Bm + row0 * brow + (long)grp * N;
  const T* Cb = Cm + row0 * brow + (long)grp * N;
  float* pBb = args.part_B + row0 * prow + (long)h * N;
  float* pCb = args.part_C + row0 * prow + (long)h * N;
  const long st = ((long)b * H + h) * P * N;
  const float* hc = args.h_in + (((long)b * nc + c) * H + h) * P * N;
  float* slot = args.dh0 + st;
  int* flag = args.sync + 1 + (long)b * H + h;

  // ---- dt, the inclusive cumsum of dt * A (a shuffle scan in each of Q /
  // 32 warps) and the decays ----
  if (tid < Q) dts[tid] = tid < qn ? dtb[(long)tid * H] : 0.f;
  __syncthreads();
  const float a = args.A[h];
  if (tid < Q) {
    float v = dts[tid] * a;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) tot[warp] = v;
    cum[tid] = v;
  }
  __syncthreads();
  if (tid < Q) {
    float v = cum[tid];
    for (int k = 0; k < warp; ++k) v += tot[k];
    cum[tid] = v;
  }
  __syncthreads();
  const float cs_last = cum[Q - 1], el = expf(cs_last);  // padded rows add 0
  if (tid < Q) {
    es[tid] = expf(cum[tid]);
    te[tid] = expf(cs_last - cum[tid]);
    ws[tid] = te[tid] * dts[tid];
  }
  __syncthreads();

  // ---- the chain term u = sum_i exp(cs_i) dy_i (outer) C_i; the thread
  // holds (p, n) = (pt + 16 k, nt + 16 l) ----
  const int pt = tid / 16, nt = tid % 16;
  float gc[RP][RN];
#pragma unroll
  for (int k = 0; k < RP; ++k)
#pragma unroll
    for (int l = 0; l < RN; ++l) gc[k][l] = 0.f;
  for (int i = 0; i < qn; ++i) {
    float dv[RP], cv[RN];
#pragma unroll
    for (int k = 0; k < RP; ++k) dv[k] = es[i] * to_float(dyb[i * xrow + pt + 16 * k]);
#pragma unroll
    for (int l = 0; l < RN; ++l) cv[l] = to_float(Cb[i * brow + nt + 16 * l]);
#pragma unroll
    for (int k = 0; k < RP; ++k)
#pragma unroll
      for (int l = 0; l < RN; ++l) gc[k][l] += dv[k] * cv[l];
  }

  // ---- the chain: gn = g_{c+1} from the slot (d(final) or zero at the
  // last chunk); publish g_c = exp(cs_last) gn + u in its place ----
  if (c < nc - 1) {
    if (tid == 0)
      while (ld_acquire(flag) < nc - 1 - c) {
      }
    __syncthreads();
  }
  const float* src = c < nc - 1 ? slot : args.dfinal == nullptr ? nullptr : args.dfinal + st;
  float hg = 0.f;  // this thread's share of <gn, h_c>
#pragma unroll
  for (int k = 0; k < RP; ++k)
#pragma unroll
    for (int l = 0; l < RN; ++l) {
      const int p = pt + 16 * k, n = nt + 16 * l;
      float v = 0.f;
      if (c < nc - 1) v = __ldcg(src + p * N + n);
      else if (src != nullptr) v = src[p * N + n];
      gns[p * LDG + n] = v;
      hg += v * hc[p * N + n];
      slot[p * N + n] = el * v + gc[k][l];
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
  const float hgsum = block_sum(hg, red);  // its barriers also publish gns

  // ---- C B^T and dy x^T over the chunk: the 16 x 8 tiles on or below the
  // diagonal, a warp each ----
  for (int tI = warp; tI < RQ * (Q / 8); tI += NW) {
    const int i0 = tI / (Q / 8) * 16, j0 = tI % (Q / 8) * 8;
    if (j0 > i0 + 15) continue;
    float g4[4] = {0.f, 0.f, 0.f, 0.f}, m4[4] = {0.f, 0.f, 0.f, 0.f};
    tile_abt<N>(g4, Cb, brow, Bb, brow, i0, j0, qn, lane);
    tile_abt<P>(m4, dyb, xrow, xb, xrow, i0, j0, qn, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + (lane >> 2) + 8 * (e >> 1), j = j0 + 2 * (lane & 3) + (e & 1);
      bufG[i * LDQ + j] = g4[e];
      bufD[i * LDQ + j] = m4[e];
    }
  }
  __syncthreads();

  // ---- row sums of R = dM G L dt_j (a thread per row) and column sums of R
  // and of dM G L (a thread per column) ----
  if (tid < Q) {
    const int i = tid;
    float s = 0.f;
    for (int j = 0; j <= i; ++j)
      s += bufD[i * LDQ + j] * bufG[i * LDQ + j] * expf(cum[i] - cum[j]) * dts[j];
    rowR[i] = s;
  } else if (tid < 2 * Q) {
    const int j = tid - Q;
    float sr = 0.f, sk = 0.f;
    for (int i = j; i < Q; ++i) {
      const float k = bufD[i * LDQ + j] * bufG[i * LDQ + j] * expf(cum[i] - cum[j]);
      sk += k;
      sr += k * dts[j];
    }
    colR[j] = sr;
    colK[j] = sk;
  }
  __syncthreads();

  // ---- M = G L dt_j and dG = dM L dt_j in place, zero above the diagonal ----
  for (int e = tid; e < Q * Q; e += NT) {
    const int i = e / Q, j = e % Q;
    float m = 0.f, d = 0.f;
    if (j <= i) {
      const float l = expf(cum[i] - cum[j]) * dts[j];
      m = bufG[i * LDQ + j] * l;
      d = bufD[i * LDQ + j] * l;
    }
    bufG[i * LDQ + j] = m;
    bufD[i * LDQ + j] = d;
  }
  __syncthreads();

  // The three passes: the thread holds rows rg + 16 a and columns cg + 16 l.
  const int rg = tid / 16, cg = tid % 16;
  float dsum = 0.f;  // this thread's share of sum dy . x
  // ---- dx_j = w_j gn B_j + D dy_j + sum_i M_ij dy_i; x_j . gn B_j ----
  {
    float acc[RQ][RP];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int l = 0; l < RP; ++l) acc[r][l] = 0.f;
    for (int n = 0; n < N; ++n) {
      float bv[RQ], gv[RP];
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const int j = rg + 16 * r;
        bv[r] = j < qn ? to_float(Bb[j * brow + n]) : 0.f;
      }
#pragma unroll
      for (int l = 0; l < RP; ++l) gv[l] = gns[(cg + 16 * l) * LDG + n];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int l = 0; l < RP; ++l) acc[r][l] += bv[r] * gv[l];
    }
    const float dcoef = args.D[h];
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int j = rg + 16 * r;
      float part = 0.f;
#pragma unroll
      for (int l = 0; l < RP; ++l) {
        const int p = cg + 16 * l;
        const float xv = j < qn ? to_float(xb[j * xrow + p]) : 0.f;
        const float dv = j < qn ? to_float(dyb[j * xrow + p]) : 0.f;
        part += xv * acc[r][l];
        dsum += dv * xv;
        acc[r][l] = ws[j] * acc[r][l] + dcoef * dv;
      }
      part = half_sum(part);
      if (cg == 0) xU[j] = part;
    }
    for (int i = 0; i < qn; ++i) {
      float mv[RQ], dv[RP];
#pragma unroll
      for (int r = 0; r < RQ; ++r) mv[r] = bufG[i * LDQ + rg + 16 * r];
#pragma unroll
      for (int l = 0; l < RP; ++l) dv[l] = to_float(dyb[i * xrow + cg + 16 * l]);
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int l = 0; l < RP; ++l) acc[r][l] += mv[r] * dv[l];
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int j = rg + 16 * r;
      if (j < qn)
#pragma unroll
        for (int l = 0; l < RP; ++l) put(dxb + j * xrow + cg + 16 * l, acc[r][l]);
    }
  }
  // ---- this head's dB_j = w_j gn^T x_j + sum_i dG_ij C_i ----
  {
    float acc[RQ][RN];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int l = 0; l < RN; ++l) acc[r][l] = 0.f;
    for (int p = 0; p < P; ++p) {
      float xv[RQ], gv[RN];
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const int j = rg + 16 * r;
        xv[r] = j < qn ? to_float(xb[j * xrow + p]) : 0.f;
      }
#pragma unroll
      for (int l = 0; l < RN; ++l) gv[l] = gns[p * LDG + cg + 16 * l];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int l = 0; l < RN; ++l) acc[r][l] += xv[r] * gv[l];
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int l = 0; l < RN; ++l) acc[r][l] *= ws[rg + 16 * r];
    for (int i = 0; i < qn; ++i) {
      float dv[RQ], cv[RN];
#pragma unroll
      for (int r = 0; r < RQ; ++r) dv[r] = bufD[i * LDQ + rg + 16 * r];
#pragma unroll
      for (int l = 0; l < RN; ++l) cv[l] = to_float(Cb[i * brow + cg + 16 * l]);
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int l = 0; l < RN; ++l) acc[r][l] += dv[r] * cv[l];
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int j = rg + 16 * r;
      if (j < qn)
#pragma unroll
        for (int l = 0; l < RN; ++l) pBb[j * prow + cg + 16 * l] = acc[r][l];
    }
  }
  // ---- this head's dC_i = exp(cs_i) h_c^T dy_i + sum_j dG_ij B_j, and
  // exp(cs_i) dy_i . h_c C_i ----
  {
    float acc[RQ][RN];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int l = 0; l < RN; ++l) acc[r][l] = 0.f;
    for (int p = 0; p < P; ++p) {
      float dv[RQ], hv[RN];
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const int i = rg + 16 * r;
        dv[r] = i < qn ? to_float(dyb[i * xrow + p]) : 0.f;
      }
#pragma unroll
      for (int l = 0; l < RN; ++l) hv[l] = hc[p * N + cg + 16 * l];
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int l = 0; l < RN; ++l) acc[r][l] += dv[r] * hv[l];
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int i = rg + 16 * r;
      float part = 0.f;
#pragma unroll
      for (int l = 0; l < RN; ++l) {
        part += (i < qn ? to_float(Cb[i * brow + cg + 16 * l]) : 0.f) * acc[r][l];
        acc[r][l] *= es[i];
      }
      part = half_sum(part);
      if (cg == 0) dcsI[i] = es[i] * part;
    }
    for (int j = 0; j < qn; ++j) {
      float dv[RQ], bv[RN];
#pragma unroll
      for (int r = 0; r < RQ; ++r) dv[r] = bufD[(rg + 16 * r) * LDQ + j];
#pragma unroll
      for (int l = 0; l < RN; ++l) bv[l] = to_float(Bb[j * brow + cg + 16 * l]);
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int l = 0; l < RN; ++l) acc[r][l] += dv[r] * bv[l];
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int i = rg + 16 * r;
      if (i < qn)
#pragma unroll
        for (int l = 0; l < RN; ++l) pCb[i * prow + cg + 16 * l] = acc[r][l];
    }
  }
  __syncthreads();  // xU and dcsI

  // ---- the decays' cotangents: dcs, da = the reverse cumsum of dcs, ddt,
  // and this block's partials of dA and dD ----
  const float tj = tid < Q ? ws[tid] * xU[tid] : 0.f;  // T_j
  const float tsum = block_sum(tj, red);
  const float dD_blk = block_sum(dsum, red);
  if (tid < Q) {
    float v = rowR[tid] - colR[tid] + dcsI[tid] - tj;
    if (tid == Q - 1) v += tsum + el * hgsum;
    dcs[tid] = args.drop_dcs ? 0.f : v;
  }
  __syncthreads();
  if (tid < Q) {  // thread t scans row Q - 1 - t
    float v = dcs[Q - 1 - tid];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) tot[warp] = v;
    da[Q - 1 - tid] = v;
  }
  __syncthreads();
  float dtda = 0.f;
  if (tid < Q) {
    const int j = Q - 1 - tid;
    float v = da[j];
    for (int k = 0; k < warp; ++k) v += tot[k];
    if (j < qn) ddtb[(long)j * H] = colK[j] + te[j] * xU[j] + a * v;
    dtda = dts[j] * v;
  }
  const float dA_blk = block_sum(dtda, red);
  if (tid == 0) {
    args.part_A[((long)b * nc + c) * H + h] = dA_blk;
    args.part_D[((long)b * nc + c) * H + h] = dD_blk;
  }
}

// The fixed-order sums: dB and dC over each group's heads in head order,
// dA and dD over the (batch, chunk) blocks in order. A thread per output.
template <typename T>
__global__ void ssd_bwd_sum_kernel(const Args args, int N, int nblocks) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int H = args.H, G = args.G, r = H / G;
  const long total = (long)args.Bsz * args.S * G * N;
  if (e < total) {
    const int n = e % N, g = e / N % G;
    const long row = e / N / G;
    const long off = (row * H + (long)g * r) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < r; ++k) {
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
int launch(const Args& args, cudaStream_t stream) {
  auto kernel = ssd_bwd_kernel<T, Q, P, N>;
  constexpr int bytes = Smem<Q, P, N>::bytes;
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long nc = (args.S + Q - 1) / Q;
  const long blocks = nc * args.H * args.Bsz;
  const long sums = (long)args.Bsz * args.S * args.G * N + args.H;
  if (blocks > 0x7fffffffL || (sums + 255) / 256 > 0x7fffffffL ||
      (nc > 1 && args.sync == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<(unsigned)blocks, NT, bytes, stream>>>(args);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_sum_kernel<T><<<(unsigned)((sums + 255) / 256), 256, 0, stream>>>(
      args, N, (int)(nc * args.Bsz));
  return static_cast<int>(cudaGetLastError());
}

template <int Q, int P, int N>
int launch_dtype(int dtype, const Args& args, cudaStream_t stream) {
  if (dtype == 0) return launch<float, Q, P, N>(args, stream);
  if (dtype == 1) return launch<__nv_bfloat16, Q, P, N>(args, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, dy, dx (B,S,H,P), dt, ddt (B,S,H) f32, A, D, dA, dD (H,) f32, Bm, Cm, dB,
// dC (B,S,G,N), h_in (B,nc,H,P,N) f32 (the forward's state entering each
// chunk), dfinal (B,H,P,N) f32 or null (zero), dh0 (B,H,P,N) f32; scratch:
// part_B, part_C (B,S,H,N) f32 and part_A, part_D (B,nc,H) f32; all
// contiguous. sync: at least 1 + B * H int32 zeros (the forward's buffer),
// left zero. dtype (of x, Bm, Cm, dy and their cotangents): 0 float32, 1
// bfloat16. drop_dcs != 0 drops the decays' cotangent (a wrong gradient,
// for controls). Two launches; returns the cudaError_t of the launches.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* D, const void* h_in, const void* dy,
                            const void* dfinal, void* dx, void* ddt, void* dA, void* dB, void* dC,
                            void* dD, void* dh0, void* part_B, void* part_C, void* part_A,
                            void* part_D, void* sync, int Bsz, int S, int H, int Pdim, int G,
                            int N, int chunk, int dtype, int drop_dcs, void* stream) {
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
                  static_cast<float*>(part_B),
                  static_cast<float*>(part_C),
                  static_cast<float*>(part_A),
                  static_cast<float*>(part_D),
                  static_cast<int*>(sync),
                  Bsz,
                  S,
                  H,
                  G,
                  drop_dcs};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Pdim == 64 && N == 128 && chunk == 128) return launch_dtype<128, 64, 128>(dtype, args, st);
  if (Pdim == 64 && N == 64 && chunk == 128) return launch_dtype<128, 64, 64>(dtype, args, st);
  if (Pdim == 32 && N == 16 && chunk == 32) return launch_dtype<32, 32, 16>(dtype, args, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
