// Mamba2 SSD chunked scan, written by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan_pallas
//   (pl.pallas_call at line 122, kernel body _kernel at line 31).
//
// Computes: for each (batch, head) the SSD recurrence over the sequence in
//   chunks of Q positions. Per chunk, with cs the inclusive cumsum of
//   dt * A over the chunk:
//     y_i  = exp(cs_i) * C_i . S  +  sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//            + D * x_i
//     S   <- exp(cs_last) * S  +  sum_j exp(cs_last - cs_j) dt_j B_j (outer) x_j
//   x and y (B,S,H,P) in x's type, dt (B,S,H), B/C (B,S,G,N) at group
//   h / (H/G), state (B,H,P,N) f32. Everything is summed in f32.
//
// Built for (head_dim P, d_state N, chunk Q) = (64, 128, 128) (mamba2-2.7b),
//   (64, 64, 128) (zamba2-1.2b) and (32, 16, 32) (both configs reduced), in
//   bf16 and f32; Q, P and N are template parameters, any other shape is
//   refused at ssd_scan_fwd.
//
// Bound on the H100: at the serving path's prompt lengths (3 and 19
//   tokens, one chunk) bytes, and mostly the 2.6 MB f32 final state of
//   mamba2-2.7b's 80 heads: about a microsecond, so a launch is
//   latency-bound. At S = 2048 bytes (46 MB, 14 us) and the bf16 products
//   (13 GFLOP, 14 us at the tensor-core rate) are about even.
//
// Design: the chunks run in parallel. One block of 8 warps per (chunk,
//   32-column half of P, head, batch): a column p of y and of the state
//   needs only x[:, p] and state[p, :], so each half is a scan of its own;
//   both load C and B (from L2) and compute C B^T, and the split halves
//   each block's registers and shared memory so two blocks share an SM. A
//   block computes its chunk's intra-chunk part and its local end state
//   s_c = (w . B)^T X, w_j = exp(cs_last - cs_j) dt_j, and only the state
//   passes from chunk to chunk, in the same launch, as a chained scan: the
//   block takes its chunk from an atomic ticket in launch order (chunk-
//   major, so every block it waits on already runs and the chain cannot
//   deadlock), waits for the flag of its (batch, head, half) to say chunk
//   c - 1 is published (release/acquire at gpu scope), reads the inclusive
//   state S_{c-1} from L2, publishes S_c = exp(cs_last) S_{c-1} + s_c and
//   adds exp(cs_i) C_i . S_{c-1} to its y. The state is published in place
//   in the final-state output (each state has one reader, the next chunk's
//   block, which reads it before it writes its own), so the chain needs no
//   scratch: 16 KB per block at N = 128, in L2. The ticket counter and the
//   flags are zeroed once per device and left zero by the launch (the last
//   ticket resets the counter, the last chunk its flag), so no memset is
//   launched. A sequence of one chunk (the serving path) takes no ticket
//   and waits on nothing. On the card the chain costs little: 2560 blocks
//   of one chunk each take about as long as 160 chains of 16; at long
//   prompts the time goes to every block of a chunk loading the group's C
//   and B from L2 and recomputing C B^T (ssd_probe.py, PERF.md).
//   Warps 0-3 compute y (row tiles w and 7 - w, so the causal triangle is
//   shared evenly); warps 4-7 the state (a quarter of N each) and the
//   chain, which overlaps the y warps' intra-chunk work. Shared memory is
//   sized to the rows a block computes (a 19-token prompt: 32 rows, 21 KB
//   at N = 128; a full chunk: 97 KB). Each block's loads of a chunk (dt,
//   then C, B and x, rows past S zero-filled) are all issued together by
//   cp.async and read in place at their own strides.
//   The bf16 products are mma.sync m16n8k16 bf16 -> f32: C B^T (bf16
//   operands, exact), scores @ X, C @ S and the state update (w . B)^T X.
//   The f32 operands (the scores, S and w . B) enter as a bf16 pair hi +
//   lo, two products each, which keeps ~16 bits: one bf16 rounding of the
//   scores or of S misses the 2e-2 tolerance at S = 4096 with an initial
//   state (ssd_scan_chained_plain in ssd_scan.py mirrors these rounding
//   points; tests/test_torch_ssd_chained.py). exp(cs_i - cs_j) is evaluated
//   only where j <= i (it overflows above the diagonal). The f32
//   instantiation (tests and chip_smoke only) runs the same structure in
//   scalar FMA on the same fragment layout: TF32 would miss its 3e-4.
//   The reduced shape runs the same plan with less of it: P = 32 is one
//   column half (a block per chunk, head and batch), Q = 32 is two row
//   tiles (y warps 0 and 1 take one each, 2 and 3 idle), and at N = 16 the
//   state is 2 x 2 tiles of 16 x 8, one per state warp, where from N = 32
//   each state warp takes every row and a quarter of N.
//   For training the launch may also write the state entering each chunk
//   (h_in, (B, nc, H, P, N) f32): the state warps hold it (S_{c-1}, or h0 or
//   zero at chunk 0) for their block's columns and store it when the pointer
//   is not null; csrc/ssd_scan_bwd.cu reads it. Serving passes null, and y
//   and the final state are the same bit for bit either way.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The chunk length Q, head_dim P and d_state N are template parameters
// (the built shapes are listed at ssd_scan_fwd).
constexpr int PB = 32;       // head_dim columns per block
constexpr int NYW = 4;       // warps computing y; as many compute the state
constexpr int NT = 2 * NYW * 32;
// cumsum, dt and w (Q each), the scan's warp totals
template <int Q> constexpr int small_bytes() { return 3 * Q * 4 + 16; }

// Barrier ids besides 0 (__syncthreads): the state warps among themselves,
// and the state operand S handed from the state warps to the y warps.
constexpr int BAR_STATE = 1;
constexpr int BAR_S_READY = 2;

// Byte offsets of the shared-memory regions for R rows (a multiple of 16):
// the small arrays, C [R][LDN], B [R][LDN], this block's columns of x
// [R][LDP] and, where the y warps need the state entering the chunk, S as
// [PB][LDN] (bf16 hi and lo, or one f32 array). Rows are padded by 16
// bytes, so the 8 rows an ldmatrix phase reads fall into distinct banks.
template <typename T, int Q, int N>
struct Layout {
  static constexpr int LDN = N + 16 / (int)sizeof(T);
  static constexpr int LDP = PB + 16 / (int)sizeof(T);
  static constexpr int S_ARRAYS = sizeof(T) == 2 ? 2 : 1;
  int c, b, x, s, bytes;
  __host__ __device__ Layout(int R, bool inter) {
    c = small_bytes<Q>();
    b = c + R * LDN * (int)sizeof(T);
    x = b + R * LDN * (int)sizeof(T);
    s = x + R * LDP * (int)sizeof(T);
    bytes = s + (inter ? S_ARRAYS * PB * LDN * (int)sizeof(T) : 0);
  }
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

// two consecutive outputs of y at p, p + 1
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared; src_bytes 0 zero-fills and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int K> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K));
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
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

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col); a pure
// function of registers, so not volatile: the compiler may interleave
// products of independent accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments (lane = 4 g + t): accumulator element e of an m16n8 tile sits
// at row g + 8 (e >> 1), column 2 t + (e & 1); an A fragment's register e
// holds row g + 8 (e & 1), columns 2 t + 8 (e >> 1) and the next; a B
// fragment's two hold rows 2 t (+1) and 2 t + 8 (+1) of column g. The f32
// overloads compute the same accumulator elements in scalar FMA.

// acc (16 rows x 16 NPAIR columns) += A B^T over K: A's 16 rows at a and
// B's 16 NPAIR rows at b, both row-major with K contiguous. C B^T (K = N)
// and C S (S stored as [PB][N]).
template <int K, int NPAIR>
__device__ __forceinline__ void mm_abt(float (&acc)[2 * NPAIR][4], const __nv_bfloat16* a,
                                       const __nv_bfloat16* b, int ld, int lane) {
  const __nv_bfloat16* abase = a + (((lane >> 3) & 1) * 8 + (lane & 7)) * ld + (lane >> 4) * 8;
  const __nv_bfloat16* bbase = b + ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    uint32_t af[4];
    ldmatrix_x4(af, abase + ks * 16);
#pragma unroll
    for (int pr = 0; pr < NPAIR; ++pr) {
      uint32_t bf[4];  // b0, b1 of columns 16 pr .. +7, then of +8 .. +15
      ldmatrix_x4(bf, bbase + pr * 16 * ld + ks * 16);
      mma_bf16(acc[2 * pr], af, bf[0], bf[1]);
      mma_bf16(acc[2 * pr + 1], af, bf[2], bf[3]);
    }
  }
}
template <int K, int NPAIR>
__device__ __forceinline__ void mm_abt(float (&acc)[2 * NPAIR][4], const float* a,
                                       const float* b, int ld, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = a[g * ld + k], a1 = a[(g + 8) * ld + k];
#pragma unroll
    for (int nt = 0; nt < 2 * NPAIR; ++nt) {
      const float b0 = b[(nt * 8 + 2 * t) * ld + k], b1 = b[(nt * 8 + 2 * t + 1) * ld + k];
      acc[nt][0] += a0 * b0;
      acc[nt][1] += a0 * b1;
      acc[nt][2] += a1 * b0;
      acc[nt][3] += a1 * b1;
    }
  }
}

// acc (16 rows x PB) += s (16 x 16 scores in accumulator fragments) @ x
// (16 rows j of [j][LDP] at xs). bf16: the scores as hi + lo A fragments,
// x by ldmatrix.trans.
template <int LDP>
__device__ __forceinline__ void mm_px(float (&acc)[PB / 8][4], const float (&s)[2][4],
                                      const __nv_bfloat16* xs, int lane) {
  float r[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) r[nt][e] = s[nt][e] - bf16_round(s[nt][e]);
  const uint32_t hi[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                          pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
  const uint32_t lo[4] = {pack_bf16(r[0][0], r[0][1]), pack_bf16(r[0][2], r[0][3]),
                          pack_bf16(r[1][0], r[1][1]), pack_bf16(r[1][2], r[1][3])};
  const __nv_bfloat16* base = xs + (((lane >> 3) & 1) * 8 + (lane & 7)) * LDP + (lane >> 4) * 8;
#pragma unroll
  for (int np = 0; np < PB / 16; ++np) {
    uint32_t bf[4];  // b0, b1 of columns 16 np .. +7, then of +8 .. +15
    ldmatrix_x4_trans(bf, base + np * 16);
    mma_bf16(acc[2 * np], hi, bf[0], bf[1]);
    mma_bf16(acc[2 * np + 1], hi, bf[2], bf[3]);
    mma_bf16(acc[2 * np], lo, bf[0], bf[1]);
    mma_bf16(acc[2 * np + 1], lo, bf[2], bf[3]);
  }
}
template <int LDP>
__device__ __forceinline__ void mm_px(float (&acc)[PB / 8][4], const float (&s)[2][4],
                                      const float* xs, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int src = (lane & ~3) | ((j & 7) >> 1);  // the quad lane holding column j
    const float sg = __shfl_sync(0xffffffffu, s[j >> 3][j & 1], src);
    const float sg8 = __shfl_sync(0xffffffffu, s[j >> 3][2 + (j & 1)], src);
#pragma unroll
    for (int nt = 0; nt < PB / 8; ++nt) {
      const float2 xv = *reinterpret_cast<const float2*>(xs + j * LDP + nt * 8 + 2 * t);
      acc[nt][0] += sg * xv.x;
      acc[nt][1] += sg * xv.y;
      acc[nt][2] += sg8 * xv.x;
      acc[nt][3] += sg8 * xv.y;
    }
  }
}

// acc (16 MTW rows p x 8 NTW columns n) += x^T (w . B) over 16 rows j: x at
// xs ([j][LDP], from this warp's first column p), B at bs ([j][LDN], from
// this warp's first column n), w at w. bf16: x^T by ldmatrix.trans, w . B
// in f32 as hi + lo B fragments.
template <int MTW, int NTW, int LDP, int LDN>
__device__ __forceinline__ void mm_xtwb(float (&acc)[MTW][NTW][4], const __nv_bfloat16* xs,
                                        const __nv_bfloat16* bs, const float* w, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint32_t af[MTW][4];
  const __nv_bfloat16* abase = xs + ((lane & 7) + ((lane >> 4) & 1) * 8) * LDP + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt) ldmatrix_x4_trans(af[mt], abase + mt * 16);
  const float w0 = w[2 * t], w1 = w[2 * t + 1], w8 = w[2 * t + 8], w9 = w[2 * t + 9];
#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    const int n = nt * 8 + g;
    const float v0 = w0 * __bfloat162float(bs[(2 * t) * LDN + n]);
    const float v1 = w1 * __bfloat162float(bs[(2 * t + 1) * LDN + n]);
    const float v8 = w8 * __bfloat162float(bs[(2 * t + 8) * LDN + n]);
    const float v9 = w9 * __bfloat162float(bs[(2 * t + 9) * LDN + n]);
    const uint32_t b0 = pack_bf16(v0, v1), b1 = pack_bf16(v8, v9);
    const uint32_t l0 = pack_bf16(v0 - bf16_round(v0), v1 - bf16_round(v1));
    const uint32_t l1 = pack_bf16(v8 - bf16_round(v8), v9 - bf16_round(v9));
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt) {
      mma_bf16(acc[mt][nt], af[mt], b0, b1);
      mma_bf16(acc[mt][nt], af[mt], l0, l1);
    }
  }
}
template <int MTW, int NTW, int LDP, int LDN>
__device__ __forceinline__ void mm_xtwb(float (&acc)[MTW][NTW][4], const float* xs,
                                        const float* bs, const float* w, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 2
  for (int j = 0; j < 16; ++j) {
    const float wj = w[j];
    float xv[MTW][2];
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt) {
      xv[mt][0] = xs[j * LDP + mt * 16 + g];
      xv[mt][1] = xs[j * LDP + mt * 16 + g + 8];
    }
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const float2 bv = *reinterpret_cast<const float2*>(bs + j * LDN + nt * 8 + 2 * t);
      const float v0 = wj * bv.x, v1 = wj * bv.y;
#pragma unroll
      for (int mt = 0; mt < MTW; ++mt) {
        acc[mt][nt][0] += xv[mt][0] * v0;
        acc[mt][nt][1] += xv[mt][0] * v1;
        acc[mt][nt][2] += xv[mt][1] * v0;
        acc[mt][nt][3] += xv[mt][1] * v1;
      }
    }
  }
}

// The state operand S_{c-1} (p, n .. n + 1) into shared memory for the
// y warps: bf16 hi and lo arrays, or one f32 array.
__device__ __forceinline__ void put_state(__nv_bfloat16* s, int lds, int p, int n, float a,
                                          float b) {
  *reinterpret_cast<uint32_t*>(s + p * lds + n) = pack_bf16(a, b);
  *reinterpret_cast<uint32_t*>(s + PB * lds + p * lds + n) =
      pack_bf16(a - bf16_round(a), b - bf16_round(b));
}
__device__ __forceinline__ void put_state(float* s, int lds, int p, int n, float a, float b) {
  store2(s + p * lds + n, a, b);
}

// sync: [0] the ticket counter, then one flag per (batch, head, column
// half): the number of chunks of it published in this launch. All zero
// between launches.
template <typename T, int Q, int P, int N>
__global__ void __launch_bounds__(NT, 2) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ Dv,
    const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ hout,
    float* __restrict__ hin, int* __restrict__ sync, int Bsz, int S, int H, int G, int R) {
  static_assert(Q % 32 == 0 && Q <= 2 * NYW * 16 && P % PB == 0 && N % 16 == 0 && N <= 128);
  using L = Layout<T, Q, N>;
  constexpr int LDN = L::LDN, LDP = L::LDP;
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ticket;
  float* cum = reinterpret_cast<float*>(smem);
  float* dts = cum + Q;
  float* wv = dts + Q;
  float* tot = wv + Q;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int nc = (S + Q - 1) / Q;
  int blk = blockIdx.x;
  if (nc > 1) {  // chunk-major tickets in the order blocks start
    if (tid == 0) {
      ticket = atomicAdd(sync, 1);
      if (ticket == (int)gridDim.x - 1) atomicExch(sync, 0);  // every ticket is taken
    }
    __syncthreads();
    blk = ticket;
  }
  const int c = blk / (P / PB * H * Bsz), half = blk % (P / PB);
  const int h = blk / (P / PB) % H, b = blk / (P / PB) / H % Bsz;
  const bool inter = c > 0 || h0 != nullptr;  // the y warps need S_{c-1}
  const L lay(R, inter);
  T* cs_ = reinterpret_cast<T*>(smem + lay.c);
  T* bs_ = reinterpret_cast<T*>(smem + lay.b);
  T* xs_ = reinterpret_cast<T*>(smem + lay.x);
  T* ss_ = reinterpret_cast<T*>(smem + lay.s);

  const int grp = h / (H / G);
  const int s0 = c * Q, qn = min(Q, S - s0);  // valid rows of this chunk
  const long xrow = (long)H * P, brow = (long)G * N;
  const int p0 = half * PB;
  const T* xb = x + ((long)b * S + s0) * xrow + (long)h * P + p0;
  T* yb = y + ((long)b * S + s0) * xrow + (long)h * P + p0;
  const float* dtb = dt + ((long)b * S + s0) * H + h;
  const T* Bb = Bm + ((long)b * S + s0) * brow + (long)grp * N;
  const T* Cb = Cm + ((long)b * S + s0) * brow + (long)grp * N;
  const long st_off = (((long)b * H + h) * P + p0) * N;  // this block's rows p of (P, N)
  float* hb = hout + st_off;
  int* flag = sync + 1 + ((long)b * H + h) * (P / PB) + half;

  // ---- every load of the chunk, issued together; rows past S are 0 ----
  if (tid < R) cp_async4(dts + tid, dtb + (tid < qn ? (long)tid * H : 0), tid < qn);
  cp_async_commit();
  for (int e = tid; e < R * (N / EPC); e += NT) {
    const int r = e / (N / EPC), col = e % (N / EPC) * EPC;
    const bool in = r < qn;
    const long off = in ? r * brow + col : 0;
    cp_async16(cs_ + r * LDN + col, Cb + off, in);
    cp_async16(bs_ + r * LDN + col, Bb + off, in);
  }
  for (int e = tid; e < R * (PB / EPC); e += NT) {
    const int r = e / (PB / EPC), col = e % (PB / EPC) * EPC;
    const bool in = r < qn;
    cp_async16(xs_ + r * LDP + col, xb + (in ? r * xrow + col : 0), in);
  }
  cp_async_commit();
  cp_async_wait<1>();  // dt
  __syncthreads();

  // ---- inclusive cumsum of dt * A: a shuffle scan in each of 4 warps ----
  const float a = A[h];
  if (tid < Q) {
    float v = tid < R ? dts[tid] * a : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
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
  const float cs_last = cum[Q - 1];  // padded rows add 0
  if (tid < R) wv[tid] = expf(cs_last - cum[tid]) * dts[tid];
  cp_async_wait<0>();
  __syncthreads();

  if (warp < NYW) {
    // ---- y: row tiles warp and 7 - warp of the chunk (a tile from Q / 16
    // on holds no row below qn: at Q = 32 warps 0 and 1 take a tile each) ----
    float acc[2][PB / 8][4];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int nt = 0; nt < PB / 8; ++nt) acc[k][nt][0] = acc[k][nt][1] = acc[k][nt][2] = acc[k][nt][3] = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i0 = (k == 0 ? warp : 2 * NYW - 1 - warp) * 16;
      if (i0 >= qn) continue;
      // scores (C_i . B_j) exp(cs_i - cs_j) dt_j for j <= i, else 0, of the
      // 16 columns at j0, then their product with x
      auto intra = [&](float (&s)[2][4], int j0) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + g8 + 8 * (e >> 1), j = j0 + nt * 8 + 2 * t4 + (e & 1);
            s[nt][e] = j <= i ? s[nt][e] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
          }
        mm_px<LDP>(acc[k], s, xs_ + j0 * LDP, lane);
      };
      int j0 = 0;
      for (; j0 + 16 <= i0; j0 += 32) {  // two column blocks of C B^T at once
        float s[2][2][4] = {};
        mm_abt<N, 2>(reinterpret_cast<float(&)[4][4]>(s), cs_ + i0 * LDN, bs_ + j0 * LDN,
                     LDN, lane);
        intra(s[0], j0);
        intra(s[1], j0 + 16);
      }
      if (j0 <= i0) {  // the diagonal block, when left over
        float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        mm_abt<N, 1>(s, cs_ + i0 * LDN, bs_ + j0 * LDN, LDN, lane);
        intra(s, j0);
      }
    }
    if (inter) {
      bar_sync(BAR_S_READY, NT);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i0 = (k == 0 ? warp : 2 * NYW - 1 - warp) * 16;
        if (i0 >= qn) continue;
        float tmp[PB / 8][4];
#pragma unroll
        for (int nt = 0; nt < PB / 8; ++nt) tmp[nt][0] = tmp[nt][1] = tmp[nt][2] = tmp[nt][3] = 0.f;
        mm_abt<N, PB / 16>(tmp, cs_ + i0 * LDN, ss_, LDN, lane);
        if constexpr (sizeof(T) == 2) mm_abt<N, PB / 16>(tmp, cs_ + i0 * LDN, ss_ + PB * LDN, LDN, lane);
        const float e0 = expf(cum[i0 + g8]), e1 = expf(cum[i0 + g8 + 8]);
#pragma unroll
        for (int nt = 0; nt < PB / 8; ++nt) {
          acc[k][nt][0] += e0 * tmp[nt][0];
          acc[k][nt][1] += e0 * tmp[nt][1];
          acc[k][nt][2] += e1 * tmp[nt][2];
          acc[k][nt][3] += e1 * tmp[nt][3];
        }
      }
    }
    // ---- D * x; store the valid rows of y ----
    const float dcoef = Dv[h];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i0 = (k == 0 ? warp : 2 * NYW - 1 - warp) * 16;
      if (i0 >= qn) continue;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = i0 + g8 + 8 * hf;
        if (i >= qn) continue;
#pragma unroll
        for (int nt = 0; nt < PB / 8; ++nt) {
          const int p = nt * 8 + 2 * t4;
          store2(yb + i * xrow + p,
                 acc[k][nt][2 * hf] + dcoef * to_float(xs_[i * LDP + p]),
                 acc[k][nt][2 * hf + 1] + dcoef * to_float(xs_[i * LDP + p + 1]));
        }
      }
    }
    return;
  }

  // ---- the state: rows [m0, m0 + 16 MTW) and columns [n0, n0 + 8 NTW) of
  // the local end state. From N = 32 each warp takes every row and a
  // quarter of N; at N = 16 the block's (PB / 16) x (N / 8) = 2 x 2 tiles
  // of 16 x 8 are one per warp ----
  constexpr bool WIDE = N >= 32;
  constexpr int MTW = WIDE ? PB / 16 : 1, NTW = WIDE ? N / 32 : 1;
  static_assert(NYW * MTW * NTW == (PB / 16) * (N / 8), "the state warps cover the state");
  const int ws = warp - NYW;
  const int n0 = WIDE ? ws * (N / 4) : ws % (N / 8) * 8, m0 = WIDE ? 0 : ws / (N / 8) * 16;
  float acc[MTW][NTW][4];
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  for (int j0 = 0; j0 < qn; j0 += 16)
    mm_xtwb<MTW, NTW, LDP, LDN>(acc, xs_ + j0 * LDP + m0, bs_ + j0 * LDN + n0, wv + j0, lane);

  // ---- the chain: S_c = exp(cs_last) S_{c-1} + s_c ----
  if (c > 0) {
    if (ws == 0 && lane == 0)
      while (ld_acquire(flag) < c) {
      }
    bar_sync(BAR_STATE, NYW * 32);
  }
  const float* src = c > 0 ? hb : h0 == nullptr ? nullptr : h0 + st_off;
  float prev[MTW][NTW][4];
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = m0 + mt * 16 + g8 + 8 * hf, n = n0 + nt * 8 + 2 * t4;
        float2 v = make_float2(0.f, 0.f);
        if (c > 0) v = __ldcg(reinterpret_cast<const float2*>(src + p * N + n));
        else if (src != nullptr) v = *reinterpret_cast<const float2*>(src + p * N + n);
        prev[mt][nt][2 * hf] = v.x;
        prev[mt][nt][2 * hf + 1] = v.y;
        if (hin != nullptr)  // the state entering chunk c, for the backward
          store2(hin + (((long)b * nc + c) * H + h) * P * N + (long)(p0 + p) * N + n, v.x, v.y);
      }
  const float decay = expf(cs_last);
#pragma unroll
  for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int p = m0 + mt * 16 + g8 + 8 * hf, n = n0 + nt * 8 + 2 * t4;
        store2(hb + p * N + n, decay * prev[mt][nt][2 * hf] + acc[mt][nt][2 * hf],
               decay * prev[mt][nt][2 * hf + 1] + acc[mt][nt][2 * hf + 1]);
      }
  if (nc > 1) {
    if (c < nc - 1) {
      __threadfence();
      bar_sync(BAR_STATE, NYW * 32);
      if (ws == 0 && lane == 0) st_release(flag, c + 1);
    } else if (ws == 0 && lane == 0) {
      *flag = 0;  // the last chunk: nothing waits on it; ready for the next launch
    }
  }
  if (inter) {
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          put_state(ss_, LDN, m0 + mt * 16 + g8 + 8 * hf, n0 + nt * 8 + 2 * t4,
                    prev[mt][nt][2 * hf], prev[mt][nt][2 * hf + 1]);
    __threadfence_block();
    bar_arrive(BAR_S_READY, NT);
  }
}

template <typename T, int Q, int P, int N>
int launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
           const void* D, const void* h0, void* y, void* hout, void* hin, void* sync, int Bsz,
           int S, int H, int G, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<T, Q, P, N>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<T, Q, N>(Q, true).bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long nc = (S + Q - 1) / Q;
  const long blocks = nc * (P / PB) * H * Bsz;
  if (blocks > 0x7fffffffL || (nc > 1 && sync == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = nc > 1 ? Q : (S + 15) / 16 * 16;  // rows a block computes
  const Layout<T, Q, N> lay(R, nc > 1 || h0 != nullptr);
  kernel<<<(unsigned)blocks, NT, lay.bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<T*>(y), static_cast<float*>(hout),
      static_cast<float*>(hin), static_cast<int*>(sync), Bsz, S, H, G, R);
  return static_cast<int>(cudaGetLastError());
}

template <int Q, int P, int N>
int launch_dtype(int dtype, const void* x, const void* dt, const void* A, const void* B,
                 const void* C, const void* D, const void* h0, void* y, void* hout, void* hin,
                 void* sync, int Bsz, int S, int H, int G, cudaStream_t stream) {
  if (dtype == 0)
    return launch<float, Q, P, N>(x, dt, A, B, C, D, h0, y, hout, hin, sync, Bsz, S, H, G,
                                  stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, Q, P, N>(x, dt, A, B, C, D, h0, y, hout, hin, sync, Bsz, S, H,
                                          G, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (B,S,H,P), dt (B,S,H) f32, A (H,) f32, Bm/Cm (B,S,G,N), D (H,) f32,
// h0 (B,H,P,N) f32 or null, y (B,S,H,P), hout (B,H,P,N) f32, hin (B,nc,H,P,N)
// f32 (the state entering each chunk, nc = ceil(S / chunk)) or null; all contiguous,
// x, Bm and Cm 16-byte aligned. sync: 1 + (P / 32) * B * H int32 zeros,
// which the launch leaves zero (launches that share it run in one stream's
// order). Built for (P, N, chunk) = (64, 128, 128) and (64, 64, 128), the
// full-width Mamba2 and hybrid configs, and (32, 16, 32), the reduced ones.
// dtype (of x, Bm, Cm, y): 0 float32, 1 bfloat16. Returns the cudaError_t
// of the launch.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* D, const void* h0, void* y,
                            void* hout, void* hin, void* sync, int Bsz, int S, int H, int Pdim,
                            int G, int N, int chunk, int dtype, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Pdim == 64 && N == 128 && chunk == 128)
    return launch_dtype<128, 64, 128>(dtype, x, dt, A, Bm, Cm, D, h0, y, hout, hin, sync, Bsz,
                                      S, H, G, st);
  if (Pdim == 64 && N == 64 && chunk == 128)
    return launch_dtype<128, 64, 64>(dtype, x, dt, A, Bm, Cm, D, h0, y, hout, hin, sync, Bsz,
                                     S, H, G, st);
  if (Pdim == 32 && N == 16 && chunk == 32)
    return launch_dtype<32, 32, 16>(dtype, x, dt, A, Bm, Cm, D, h0, y, hout, hin, sync, Bsz,
                                    S, H, G, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
