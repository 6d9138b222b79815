// Flash-decode, written by hand for Hopper (sm_90a), in two entries that
// share one kernel body.
//
// Replaces:
//   decode_attention_fwd:          src/repro/kernels/decode_attention.py::decode_attention_pallas
//     (pl.pallas_call at line 121, kernel body _kernel at line 31);
//   decode_attention_partials_fwd: src/repro/kernels/decode_attention.py::
//     decode_attention_partials_pallas (pl.pallas_call at line 169, body
//     _kernel_partials at line 87, which runs _kernel with partials=True).
//
// Computes: one query token per sequence against its KV cache over
//   [0, len) or, with a window, [len - window, len). The grp = H / KV query
//   heads of a GQA group share each KV tile. Running max, sum and
//   accumulator are fp32; masked scores are -1e30. The plain entry divides
//   the accumulator by the sum; the partials entry (the PARTIALS template
//   flag, as the Pallas source's partials=True) writes the unnormalized
//   accumulator, the running max m and the sum l of a local slice of the
//   cache, all fp32, for the caller to combine across slices. A slice whose
//   effective length is 0 writes m = -1e30, l = 0 and acc = 0, the Pallas
//   kernel's initial state, never a NaN.
//
// Bound on the H100: bytes. Each K and V element up to the length is read
//   once per step and used for 2 * grp operations, far below the ~295
//   operations per byte at which bf16 tensor cores would bind. The qwen2-7b
//   serving step (4 sequences, Smax 192, 4 kv heads, bf16) reads at most
//   786 KB of cache: about 0.2 us at 3.35 TB/s. What held the first version
//   (one block per (kv head, batch) walking 32-key tiles in series, 16
//   blocks on 132 SMs, ~4.5 us a tile) was serial latency, not bytes.
//
// Design: split-KV flash-decode in one launch. The grid is (split, kv head,
//   batch). Each row's visited keys, from its own first key max(0, len -
//   window) (or 0) to min(len, Smax), are cut into splits of kps keys
//   (split_plan in decode_attention.py, fixed from Smax and the window on
//   the host; lengths are read on the device). A block holds the whole GQA
//   group (grp <= 16) as the 16 rows of an mma tile, so each cache byte is
//   read once. Its 4 warps own 16-key chunks of the split in turn, each with
//   its own ring of 2 stages in shared memory, filled by 16-byte cp.async
//   (rows past the length are zero-filled, never read); with kps <= 128 (any
//   cache up to 8192 keys) all of a split's chunks are in flight before the
//   first is used; above, the rings cycle. Each warp
//   keeps its own online-softmax state, so no block barrier falls inside
//   the key loop. For a bf16 cache both products are mma.sync m16n8k16 bf16
//   -> fp32: S = Q K^T from ldmatrix'd K, then P V with P kept in registers
//   as the A operand and V read by ldmatrix.trans. An fp32 query (the
//   partials' pre-scaled q) enters as a bf16 pair hi + lo, two products, so
//   it keeps ~16 bits. The f32 cache (tests and chip_smoke only) uses scalar
//   FMA on the same fragment layout: TF32 would miss its 2e-5 tolerance. The
//   warps merge once, through shared memory; a split writes its partials to
//   scratch and the last block of a (batch, kv head) to arrive (threadfence,
//   then an atomicAdd on that row's counter) merges every split in split
//   order, which makes the result bitwise deterministic, writes the output
//   and sets the counter back to 0. Only the splits that hold keys of the
//   row (known from its length on the device) take part: the blocks of the
//   others leave at once, and a row with keys in one split (or none) has
//   its block write the output itself. Loads that a block waits on (q, the splits' partials)
//   are issued together, so each costs one trip to memory.
//
// Head dims: the head_dim D is a template parameter, built for 32, 64
//   (zamba2-1.2b's shared attention, musicgen-medium), 128 (the dense
//   configs) and 224 (Zamba2-7B's shared blocks; the plain entry only). It
//   sizes the rings (rows padded to 40, 72, 136 or 232 bf16, which keep an
//   ldmatrix phase's eight rows on distinct banks), the fragments, the q
//   staging and the merge buffers. Both merges give each thread (group row,
//   head dim) pairs, e = tid, tid + NT, ... over grp x D, so all 128 threads
//   work at every D and each element still sums its warps, then its splits,
//   in a fixed order. At 224 (112 accumulator floats a lane) the bf16 body
//   uses 255 registers and spills 224 bytes, the fp32 one 668 (ptxas); Q's
//   fragments kept in shared memory instead spilled 328. An fp32 cache (tests
//   only) at 224 has one ring stage a warp, not two, which would pass the
//   shared memory a block may have.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NW = 4;      // warps per block
constexpr int NT = NW * 32;
constexpr int CK = 16;     // keys per warp chunk (one mma k-step of P V)
constexpr int MAXG = 16;   // largest GQA group: the 16 rows of an mma tile
constexpr int MAX_SPLITS = 64;  // the last block stages every split's m and l
constexpr float NEG_INF = -1e30f;

// padded row stride of a staged cache row: 16 more bytes, so the 8 rows an
// ldmatrix phase reads fall into distinct banks
template <typename T, int D> __host__ __device__ constexpr int row_stride() {
  return D + 16 / (int)sizeof(T);
}
// ring stages per warp: 2, or 1 for an fp32 cache above D = 128, whose two
// stages would pass the 227 KB of shared memory a block may have
template <typename T, int D> __host__ __device__ constexpr int nst() {
  return sizeof(T) == 4 && D > 128 ? 1 : 2;
}
template <typename T, int D> __host__ __device__ constexpr int ring_bytes() {
  return NW * nst<T, D>() * 2 * CK * row_stride<T, D>() * (int)sizeof(T);
}
template <int D> __host__ __device__ constexpr int qs_bytes() { return MAXG * D * 4; }
template <int D> __host__ __device__ constexpr int merge_bytes() {
  return (NW * MAXG * D + 2 * NW * MAXG) * 4;
}
template <typename T, int D> __host__ __device__ constexpr int smem_bytes() {
  return qs_bytes<D>() + ring_bytes<T, D>();
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes 0 zero-fills and reads nothing
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

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Accumulator fragments of the m16n8 tiles (lane = 4 g + t): element e of
// a thread's 4 sits at row g + 8 (e >> 1), column 2 t + (e & 1). An A
// fragment's register e holds row g + 8 (e & 1), columns 2 t + 8 (e >> 1)
// and the next; a B fragment's two hold rows 2 t (+1) and 2 t + 8 (+1) of
// column g.

// Q fragments (the A operand over D / 16 k-steps of 16 head dims) from the
// staged fp32 q: hi = bf16(q), and with an fp32 query lo = bf16(q - hi).
template <bool LO, int D>
struct QFrags {
  uint32_t hi[D / 16][4];
  uint32_t lo[LO ? D / 16 : 1][4];
  __device__ __forceinline__ void load(const float* qs, int g, int t) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + 8 * (e & 1), col = ks * 16 + 2 * t + 8 * (e >> 1);
        const float x0 = qs[row * D + col], x1 = qs[row * D + col + 1];
        hi[ks][e] = pack_bf16(x0, x1);
        if constexpr (LO) {
          lo[ks][e] = pack_bf16(x0 - __bfloat162float(__float2bfloat16(x0)),
                                x1 - __bfloat162float(__float2bfloat16(x1)));
        }
      }
    }
  }
};

// S (16 query rows x 16 keys, two n8 tiles) of one staged chunk.
template <bool LO, int D>
__device__ __forceinline__ void chunk_scores(float (&s)[2][4], const QFrags<LO, D>& qf,
                                             const __nv_bfloat16* ks, const float*, int lane) {
  constexpr int RS = row_stride<__nv_bfloat16, D>();
  const __nv_bfloat16* base = ks + ((lane >> 4) * 8 + (lane & 7)) * RS + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kstep = 0; kstep < D / 16; ++kstep) {
    uint32_t b[4];  // b0, b1 of keys 0-7, then of keys 8-15
    ldmatrix_x4(b, base + kstep * 16);
    mma_bf16(s[0], qf.hi[kstep], b[0], b[1]);
    mma_bf16(s[1], qf.hi[kstep], b[2], b[3]);
    if constexpr (LO) {
      mma_bf16(s[0], qf.lo[kstep], b[0], b[1]);
      mma_bf16(s[1], qf.lo[kstep], b[2], b[3]);
    }
  }
}
template <bool LO, int D>
__device__ __forceinline__ void chunk_scores(float (&s)[2][4], const QFrags<LO, D>&,
                                             const float* ks, const float* qs, int lane) {
  constexpr int RS = row_stride<float, D>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    const float q0 = qs[g * D + c], q1 = qs[(g + 8) * D + c];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float k0 = ks[(nt * 8 + 2 * t) * RS + c], k1 = ks[(nt * 8 + 2 * t + 1) * RS + c];
      s[nt][0] += q0 * k0;
      s[nt][1] += q0 * k1;
      s[nt][2] += q1 * k0;
      s[nt][3] += q1 * k1;
    }
  }
}

// acc (16 rows x D dims, D / 8 n8 tiles) += P (16 x 16 keys) V (16 keys x D)
template <int D>
__device__ __forceinline__ void chunk_pv(float (&acc)[D / 8][4], const float (&p)[2][4],
                                         const __nv_bfloat16* vs, int lane) {
  constexpr int RS = row_stride<__nv_bfloat16, D>();
  const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                         pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
  const __nv_bfloat16* base = vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * RS + (lane >> 4) * 8;
#pragma unroll
  for (int np = 0; np < D / 16; ++np) {
    uint32_t b[4];  // b0, b1 of dims 16 np .. +7, then of dims +8 .. +15
    ldmatrix_x4_trans(b, base + np * 16);
    mma_bf16(acc[2 * np], a, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
  }
}
template <int D>
__device__ __forceinline__ void chunk_pv(float (&acc)[D / 8][4], const float (&p)[2][4],
                                         const float* vs, int lane) {
  constexpr int RS = row_stride<float, D>();
  const int t = lane & 3;
#pragma unroll
  for (int key = 0; key < CK; ++key) {
    const int src = (lane & ~3) | ((key & 7) >> 1);  // the quad lane holding this key
    const float pg = __shfl_sync(0xffffffffu, p[key >> 3][key & 1], src);
    const float pg8 = __shfl_sync(0xffffffffu, p[key >> 3][2 + (key & 1)], src);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const float2 vv = *reinterpret_cast<const float2*>(vs + key * RS + nt * 8 + 2 * t);
      acc[nt][0] += pg * vv.x;
      acc[nt][1] += pg * vv.y;
      acc[nt][2] += pg8 * vv.x;
      acc[nt][3] += pg8 * vv.y;
    }
  }
}

// TQ: the query's type; T: the cache's; TO: the output's (fp32 for
// PARTIALS). The cache is (B, Smax, KV, D) with rows of KV * D elements and
// sequences batch_stride elements apart (Smax * KV * D for a whole cache,
// more for a slice of one). part holds each split's acc (grp x D), then
// every split's m and l; counter one int per (batch, kv head).
template <typename TQ, typename T, typename TO, bool PARTIALS, int D>
__global__ void __launch_bounds__(NT) decode_attention_kernel(
    const TQ* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, TO* __restrict__ o, float* __restrict__ m_out,
    float* __restrict__ l_out, float* __restrict__ part, int* __restrict__ counter, int Smax,
    long batch_stride, int H, int KV, int window, float scale, int kps) {
  constexpr int RS = row_stride<T, D>();
  constexpr int NST = nst<T, D>();
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int CPR = D / EPC;         // copies per cache row
  constexpr int QS_BYTES = qs_bytes<D>();
  constexpr bool QLO = sizeof(TQ) == 4 && sizeof(T) == 2;
  static_assert(merge_bytes<D>() <= ring_bytes<T, D>(), "merge area overlays the ring");
  static_assert((2 * MAX_SPLITS + 2) * MAXG * 4 <= merge_bytes<D>(), "the splits' m and l fit");
  static_assert(CK * CPR % 32 == 0 && MAXG * D % NT == 0,
                "copies, q staging and the cross-split merge fill whole rounds");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  float* qs = reinterpret_cast<float*>(smem);
  T* ring = reinterpret_cast<T*>(smem + QS_BYTES);

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int grp = H / KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int len = lengths[b];
  const int k_end = min(len, Smax);  // keys past Smax do not exist, whatever the length says
  const int start = window >= 0 ? max(0, len - window) : 0;
  // the splits this row has keys in; a row with none keeps split 0, which
  // writes the empty state. The other blocks of the row leave at once.
  const int n_real = min(max(1, (k_end - start + kps - 1) / kps), n_splits);
  if (split >= n_real) return;
  const int lo = start + split * kps;
  const int hi = min(lo + kps, k_end);  // this split's keys: [lo, hi)
  const long kv_stride = (long)KV * D;
  const T* kb = k + (long)b * batch_stride + (long)kvh * D;
  const T* vb = v + (long)b * batch_stride + (long)kvh * D;

  // this warp's chunks of the split: c = warp, warp + NW, ...; each starts
  // below hi, so holds at least one key
  const int n_chunks = hi > lo ? (hi - lo + CK - 1) / CK : 0;
  const int mine = n_chunks > warp ? (n_chunks - warp + NW - 1) / NW : 0;
  T* wring = ring + warp * NST * 2 * CK * RS;
  auto issue = [&](int i) {
    const int key0 = lo + (warp + i * NW) * CK;
    T* ks = wring + (i % NST) * 2 * CK * RS;
    T* vs = ks + CK * RS;
#pragma unroll
    for (int j = 0; j < CK * CPR / 32; ++j) {
      const int e = lane + 32 * j, r = e / CPR, col = e % CPR * EPC;
      const bool in = key0 + r < hi;
      const long off = in ? (key0 + r) * kv_stride + col : 0;
      cp_async16(ks + r * RS + col, kb + off, in);
      cp_async16(vs + r * RS + col, vb + off, in);
    }
  };
#pragma unroll
  for (int i = 0; i < NST; ++i) {
    if (i < mine) issue(i);
    cp_async_commit();
  }

  // every load of q is issued before the first store, so the block waits
  // for one trip to memory, not one per row
  const TQ* qb = q + ((long)b * H + (long)kvh * grp) * D;
  float qv[MAXG * D / NT];
#pragma unroll
  for (int j = 0; j < MAXG * D / NT; ++j) {
    const int i = tid + j * NT;
    qv[j] = i < grp * D ? to_float(qb[i]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < MAXG * D / NT; ++j) qs[tid + j * NT] = qv[j];
  __syncthreads();
  QFrags<QLO, D> qf;
  if constexpr (sizeof(T) == 2) qf.load(qs, g, t);

  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // rows g and g + 8
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int i = 0; i < mine; ++i) {
    cp_async_wait<NST - 1>();
    __syncwarp();
    const T* ks = wring + (i % NST) * 2 * CK * RS;
    const T* vs = ks + CK * RS;
    const int key0 = lo + (warp + i * NW) * CK;
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    chunk_scores(s, qf, ks, qs, lane);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = key0 + nt * 8 + 2 * t + (e & 1) < hi;
        s[nt][e] = ok ? s[nt][e] * scale : NEG_INF;
        if (e < 2) mx0 = fmaxf(mx0, s[nt][e]);
        else mx1 = fmaxf(mx1, s[nt][e]);
      }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    // the chunk's first key is real, so mn0 and mn1 are real scores
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = s[nt][e] == NEG_INF ? 0.f : expf(s[nt][e] - (e < 2 ? mn0 : mn1));
        s[nt][e] = p;
        if (e < 2) ps0 += p;
        else ps1 += p;
      }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      acc[nt][0] *= c0;
      acc[nt][1] *= c0;
      acc[nt][2] *= c1;
      acc[nt][3] *= c1;
    }
    chunk_pv<D>(acc, s, vs, lane);
    __syncwarp();  // every lane is done with this stage before it is refilled
    if (i + NST < mine) issue(i + NST);
    cp_async_commit();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {  // each lane summed its own columns
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }

  // merge the warps through shared memory (over the ring, now consumed)
  __syncthreads();
  float* wacc = reinterpret_cast<float*>(smem + QS_BYTES);
  float* wm = wacc + NW * MAXG * D;
  float* wl = wm + NW * MAXG;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    *reinterpret_cast<float2*>(wacc + (warp * MAXG + g) * D + c) = make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(wacc + (warp * MAXG + g + 8) * D + c) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
  if (t == 0) {
    wm[warp * MAXG + g] = m0;
    wm[warp * MAXG + g + 8] = m1;
    wl[warp * MAXG + g] = l0;
    wl[warp * MAXG + g + 8] = l1;
  }
  __syncthreads();

  const long row0 = (long)b * H + (long)kvh * grp;  // (b, kvh, 0) of (B, KV, grp)
  // group row gi, head dim c; the thread of column 0 writes the row's m and l
  auto emit = [&](int gi, int c, float a, float mm, float ll) {
    if constexpr (PARTIALS) {
      o[(row0 + gi) * D + c] = from_float<TO>(a);
      if (c == 0) {
        m_out[row0 + gi] = mm;
        l_out[row0 + gi] = ll;
      }
    } else {
      o[(row0 + gi) * D + c] = from_float<TO>(a / fmaxf(ll, 1e-30f));
    }
  };
  // (group row, head dim) pairs e = tid, tid + NT, ...; at D = 128 a thread
  // keeps one head dim over every row. Splits and warps merge in a fixed order.
  const long rowkv = (long)b * KV + kvh;
  float* part_acc = part + rowkv * n_splits * grp * D;  // slots for every planned split
  float* part_m = part + (long)gridDim.z * KV * n_splits * grp * D + rowkv * n_splits * grp;
  float* part_l = part_m + (long)gridDim.z * KV * n_splits * grp;
  for (int e = tid; e < grp * D; e += NT) {
    const int gi = e / D, c = e % D;
    float mm = NEG_INF;
#pragma unroll
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, wm[w * MAXG + gi]);
    float a = 0.f, ll = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float cw = expf(wm[w * MAXG + gi] - mm);
      a += wacc[(w * MAXG + gi) * D + c] * cw;
      ll += wl[w * MAXG + gi] * cw;
    }
    if (n_real == 1) {
      emit(gi, c, a, mm, ll);
    } else {
      part_acc[((long)split * grp + gi) * D + c] = a;
      if (c == 0) {
        part_m[split * grp + gi] = mm;
        part_l[split * grp + gi] = ll;
      }
    }
  }
  if (n_real == 1) return;

  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counter + rowkv, 1) == n_real - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // every split's m and l, loaded at once into shared memory (over the
  // warps' partials, consumed); then each row's max, sum and split weights
  float* sm = wacc;                // n_real x grp: m, then the weight
  float* sl = sm + n_real * grp;   // n_real x grp: l
  float* rm = sl + n_real * grp;   // grp: the merged m, then l
  float* rl = rm + MAXG;
  for (int e = tid; e < n_real * grp; e += NT) {
    sm[e] = __ldcg(part_m + e);
    sl[e] = __ldcg(part_l + e);
  }
  __syncthreads();
  if (tid < grp) {
    float mm = NEG_INF;
    for (int sp = 0; sp < n_real; ++sp) mm = fmaxf(mm, sm[sp * grp + tid]);
    float ll = 0.f;
    for (int sp = 0; sp < n_real; ++sp) {
      const float c = expf(sm[sp * grp + tid] - mm);
      sm[sp * grp + tid] = c;
      ll += sl[sp * grp + tid] * c;
    }
    rm[tid] = mm;
    rl[tid] = ll;
  }
  __syncthreads();
  // each thread keeps the (group row, head dim) pairs e = tid + i NT: head
  // dim c0 = tid % D of the rows r0, r0 + NT / D, ... where D divides NT
  // (every row at D = 128, every second at 64, every fourth at 32), so the
  // index is worked out once; two head dims of each of 28 pairs at 224. The
  // pairs of SB splits are loaded together, then summed in split order
  constexpr int SB = D > 128 ? 2 : 4;
  constexpr int MR = MAXG * D / NT;  // pairs per thread, at most
  const int c0 = tid % D, r0 = tid / D;
  auto row = [&](int i) { return NT % D == 0 ? r0 + i * (NT / D) : (tid + i * NT) / D; };
  auto dim = [&](int i) { return NT % D == 0 ? c0 : (tid + i * NT) % D; };
  float a[MR];
#pragma unroll
  for (int i = 0; i < MR; ++i) a[i] = 0.f;
  for (int sp0 = 0; sp0 < n_real; sp0 += SB) {
    float x[SB][MR];
#pragma unroll
    for (int j = 0; j < SB; ++j)
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const int gi = row(i);
        x[j][i] = gi < grp && sp0 + j < n_real
                      ? __ldcg(part_acc + ((long)(sp0 + j) * grp + gi) * D + dim(i)) : 0.f;
      }
#pragma unroll
    for (int j = 0; j < SB; ++j)
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const int gi = row(i);
        if (gi < grp && sp0 + j < n_real) a[i] += x[j][i] * sm[(sp0 + j) * grp + gi];
      }
  }
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int gi = row(i);
    if (gi < grp) emit(gi, dim(i), a[i], rm[gi], rl[gi]);
  }
  if (tid == 0) counter[rowkv] = 0;  // ready for the next launch
}

template <typename TQ, typename T, typename TO, bool PARTIALS, int D>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* o,
           float* m, float* l, void* part, void* counter, int B, int Smax, long batch_stride,
           int H, int KV, int window, float scale, int n_splits, int kps, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<TQ, T, TO, PARTIALS, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T, D>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(n_splits, KV, B);
  kernel<<<grid, NT, smem_bytes<T, D>(), stream>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<TO*>(o), m, l, static_cast<float*>(part),
      static_cast<int*>(counter), Smax, batch_stride, H, KV, window, scale, kps);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int Smax, int H, int KV, int n_splits, int kps, const void* part,
               const void* counter) {
  return B <= 0 || Smax <= 0 || KV <= 0 || H % KV != 0 || H / KV > MAXG ||
         n_splits <= 0 || n_splits > MAX_SPLITS ||
         kps <= 0 || kps % (NW * CK) != 0 || counter == nullptr ||
         (n_splits > 1 && part == nullptr);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* lengths, void* o,
               void* part, void* counter, int B, int Smax, int H, int KV, int window,
               float scale, int dtype, int n_splits, int kps, cudaStream_t st) {
  const long bs = (long)Smax * KV * D;
  if (dtype == 0)
    return launch<float, float, float, false, D>(q, k, v, lengths, o, nullptr, nullptr, part,
                                                 counter, B, Smax, bs, H, KV, window, scale,
                                                 n_splits, kps, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16, false, D>(
        q, k, v, lengths, o, nullptr, nullptr, part, counter, B, Smax, bs, H, KV, window,
        scale, n_splits, kps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_partials(const void* q, const void* k, const void* v, const void* lengths,
                    void* acc, float* m, float* l, void* part, void* counter, int B, int chunk,
                    long batch_stride, int H, int KV, int window, float scale, int kv_dtype,
                    int n_splits, int kps, cudaStream_t st) {
  if (batch_stride < (long)chunk * KV * D) return static_cast<int>(cudaErrorInvalidValue);
  if (kv_dtype == 0)
    return launch<float, float, float, true, D>(q, k, v, lengths, acc, m, l, part, counter, B,
                                                chunk, batch_stride, H, KV, window, scale,
                                                n_splits, kps, st);
  if (kv_dtype == 1)
    return launch<float, __nv_bfloat16, float, true, D>(q, k, v, lengths, acc, m, l, part,
                                                        counter, B, chunk, batch_stride, H, KV,
                                                        window, scale, n_splits, kps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B,H,D), k/v (B,Smax,KV,D), lengths (B,) int32, o (B,H,D), all contiguous.
// D is 32, 64, 128 or 224, the head_dims the kernel is built for.
// dtype: 0 float32, 1 bfloat16. window < 0 means none. n_splits splits of
// kps keys (a multiple of 64) from each row's first visited key; part is fp32
// scratch of n_splits * B * H * (D + 2) floats (unused with one split) and
// counter B * KV int32 zeros, which the launch leaves zero. Returns the
// cudaError_t of the launch.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* lengths, void* o, void* part, void* counter,
                                    int B, int Smax, int H, int KV, int d, int window,
                                    float scale, int dtype, int n_splits, int kps,
                                    void* stream) {
  if (bad_shape(B, Smax, H, KV, n_splits, kps, part, counter))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto dim) {
    return launch_fwd<decltype(dim)::value>(q, k, v, lengths, o, part, counter, B, Smax, H,
                                            KV, window, scale, dtype, n_splits, kps, st);
  };
  switch (d) {
    case 32: return run(std::integral_constant<int, 32>{});
    case 64: return run(std::integral_constant<int, 64>{});
    case 128: return run(std::integral_constant<int, 128>{});
    case 224: return run(std::integral_constant<int, 224>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The partials over a slice of the cache. q (B,H,D) fp32, contiguous, H =
// KV * grp in kv-major order; k/v a (B,chunk,KV,D) slice, rows contiguous
// and sequences batch_stride elements apart, every row 16-byte aligned;
// lengths (B,) int32 measured against the slice (0 allowed); acc (B,KV,grp,D),
// m and l (B,KV,grp), fp32, contiguous. kv_dtype: 0 float32, 1 bfloat16.
// D is 32, 64 or 128: no sharded decode runs at 224, where the fp32 query's
// bf16 hi + lo fragments would add 56 registers a lane to the 112 of the
// accumulator.
// n_splits, kps, part and counter as for decode_attention_fwd.
extern "C" int decode_attention_partials_fwd(const void* q, const void* k, const void* v,
                                             const void* lengths, void* acc, void* m, void* l,
                                             void* part, void* counter, int B, int chunk,
                                             long batch_stride, int H, int KV, int d,
                                             int window, float scale, int kv_dtype,
                                             int n_splits, int kps, void* stream) {
  if (bad_shape(B, chunk, H, KV, n_splits, kps, part, counter))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mp = static_cast<float*>(m);
  float* lp = static_cast<float*>(l);
  auto run = [&](auto dim) {
    return launch_partials<decltype(dim)::value>(q, k, v, lengths, acc, mp, lp, part, counter,
                                                 B, chunk, batch_stride, H, KV, window, scale,
                                                 kv_dtype, n_splits, kps, st);
  };
  switch (d) {
    case 32: return run(std::integral_constant<int, 32>{});
    case 64: return run(std::integral_constant<int, 64>{});
    case 128: return run(std::integral_constant<int, 128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
