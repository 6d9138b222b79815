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
//   operations per byte at which bf16 tensor cores would bind. A partials
//   slice of the qwen2-7b serving step (4 sequences, 48 positions, 4 kv
//   heads, bf16) reads at most 393 KB of cache: about 0.15 us at 3.35 TB/s.
//
// Design: one block per (kv head, batch) holding all grp query rows of the
//   group, so each cache byte is read from device memory once. The TPU
//   kernel's sequential sequence grid axis is a loop inside the block over
//   32-key tiles, from the window's first tile to the length; tiles past the
//   length are never loaded. A tile arrives as 16-byte loads, all issued
//   before the first is used, since with few blocks the bytes in flight per
//   block set the rate (cache rows must be 16-byte aligned). Lengths are
//   read on the device, so the host never waits. D threads, one accumulator
//   column each for every query row (grp <= 16, any value, not only powers
//   of two). One warp per query row runs the online softmax over the 32
//   scores of a tile. The cache is addressed with its own batch stride, so
//   a slice of the sequence axis is read in place as a view of the whole
//   cache, with no copy. q may be fp32 against a bf16 cache (the partials
//   caller pre-scales q in fp32). At the serving batch, B * KV = 16 blocks
//   occupy 16 of the 132 SMs per launch; the partials entry, launched once
//   per sequence slice, is the split that raises that count, and one grid
//   over every slice is the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BK = 32;     // keys per tile == warp size
constexpr int MAXG = 16;   // largest GQA group handled
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// TQ: the query's type; T: the cache's; TO: the output's (fp32 for
// PARTIALS). The cache is (B, Smax, KV, D) with rows of KV * D elements and
// sequences batch_stride elements apart (Smax * KV * D for a whole cache,
// more for a slice of one).
template <typename TQ, typename T, typename TO, int D, bool PARTIALS>
__global__ void __launch_bounds__(D) decode_attention_kernel(
    const TQ* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, TO* __restrict__ o, float* __restrict__ m_out,
    float* __restrict__ l_out, int Smax, long batch_stride, int H, int KV, int window,
    float scale) {
  constexpr int NT = D;        // threads per block, one output column each
  constexpr int DP = D + 1;    // padded row stride of the k tile
  constexpr int NW = NT / 32;  // warps per block
  constexpr int EPC = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int CPR = D / EPC;            // 16-byte chunks per cache row
  constexpr int CPT = BK * CPR / NT;      // chunks of K (and of V) per thread per tile
  static_assert(BK * CPR % NT == 0, "tile chunks must divide over the threads");
  __shared__ float qs[MAXG * D];
  __shared__ float ks[BK * DP];
  __shared__ float vs[BK * D];
  __shared__ float ps[MAXG * BK];  // scores, then probabilities
  __shared__ float m_s[MAXG];
  __shared__ float l_s[MAXG];
  __shared__ float corr_s[MAXG];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = H / KV;
  const int t = threadIdx.x;
  const int warp = t / 32;
  const int lane = t % 32;
  const int len = lengths[b];
  const long kv_stride = (long)KV * D;
  const TQ* qb = q + ((long)b * H + (long)kvh * grp) * D;
  const T* kb = k + (long)b * batch_stride + (long)kvh * D;
  const T* vb = v + (long)b * batch_stride + (long)kvh * D;

  for (int g = 0; g < grp; ++g) qs[g * D + t] = to_float(qb[g * D + t]) * scale;
  if (t < grp) {
    m_s[t] = NEG_INF;
    l_s[t] = 0.f;
  }
  float acc[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;

  // keys past Smax do not exist, whatever the length says
  const int k_begin = window >= 0 ? max(0, len - window) / BK * BK : 0;
  const int k_end = min(len, Smax);

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // issue every 16-byte load of the tile before the first store, so the
    // block keeps CPT * 2 loads per thread in flight from device memory
    uint4 kbuf[CPT], vbuf[CPT];
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = t + i * NT, r = c / CPR, col = c % CPR * EPC;
      const bool in = k0 + r < Smax;
      kbuf[i] = in ? *reinterpret_cast<const uint4*>(kb + (k0 + r) * kv_stride + col)
                   : make_uint4(0u, 0u, 0u, 0u);
      vbuf[i] = in ? *reinterpret_cast<const uint4*>(vb + (k0 + r) * kv_stride + col)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();  // the previous tile is consumed; q, m and l are staged
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = t + i * NT, r = c / CPR, col = c % CPR * EPC;
      const T* kx = reinterpret_cast<const T*>(&kbuf[i]);
      const T* vx = reinterpret_cast<const T*>(&vbuf[i]);
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        ks[r * DP + col + e] = to_float(kx[e]);
        vs[r * D + col + e] = to_float(vx[e]);
      }
    }
    __syncthreads();

    for (int i = t; i < grp * BK; i += NT) {
      const int g = i / BK, j = i % BK;
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) s += qs[g * D + c] * ks[j * DP + c];
      const int kpos = k0 + j;
      const bool ok = kpos < k_end && (window < 0 || kpos >= len - window);
      ps[g * BK + j] = ok ? s : NEG_INF;
    }
    __syncthreads();

    // every tile from k_begin to k_end holds at least one unmasked key, so
    // m_new is a real score and masked keys get p = exp(-1e30 - m_new) = 0
    for (int g = warp; g < grp; g += NW) {
      const float s = ps[g * BK + lane];
      float mx = s;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      ps[g * BK + lane] = p;
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        corr_s[g] = c;
        l_s[g] = l_s[g] * c + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < grp) {
        float a = acc[g] * corr_s[g];
        for (int j = 0; j < BK; ++j) a += ps[g * BK + j] * vs[j * D + t];
        acc[g] = a;
      }
    }
  }
  __syncthreads();

  const long row0 = (long)b * H + (long)kvh * grp;  // (b, kvh, 0) of (B, KV, grp)
  TO* ob = o + row0 * D;
  if constexpr (PARTIALS) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < grp) ob[g * D + t] = from_float<TO>(acc[g]);
    if (t < grp) {
      m_out[row0 + t] = m_s[t];
      l_out[row0 + t] = l_s[t];
    }
  } else {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < grp) ob[g * D + t] = from_float<TO>(acc[g] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename TQ, typename T, typename TO, bool PARTIALS>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* o,
           float* m, float* l, int B, int Smax, long batch_stride, int H, int KV, int window,
           float scale, cudaStream_t stream) {
  const dim3 grid(KV, B);
  decode_attention_kernel<TQ, T, TO, 128, PARTIALS><<<grid, 128, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<TO*>(o), m, l, Smax, batch_stride, H,
      KV, window, scale);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int Smax, int H, int KV, int D) {
  return B <= 0 || Smax <= 0 || KV <= 0 || H % KV != 0 || H / KV > MAXG || D != 128;
}

}  // namespace

// q (B,H,D), k/v (B,Smax,KV,D), lengths (B,) int32, o (B,H,D), all contiguous.
// D must be 128, the head_dim of every dense config the port serves.
// dtype: 0 float32, 1 bfloat16. window < 0 means none. Returns the
// cudaError_t of the launch.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* lengths, void* o, int B, int Smax, int H,
                                    int KV, int D, int window, float scale, int dtype,
                                    void* stream) {
  if (bad_shape(B, Smax, H, KV, D)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long bs = (long)Smax * KV * D;
  if (dtype == 0)
    return launch<float, float, float, false>(q, k, v, lengths, o, nullptr, nullptr, B, Smax,
                                              bs, H, KV, window, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16, false>(
        q, k, v, lengths, o, nullptr, nullptr, B, Smax, bs, H, KV, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The partials over a slice of the cache. q (B,H,D) fp32, contiguous, H =
// KV * grp in kv-major order; k/v a (B,chunk,KV,D) slice, rows contiguous
// and sequences batch_stride elements apart, every row 16-byte aligned;
// lengths (B,) int32 measured against the slice (0 allowed); acc (B,KV,grp,D),
// m and l (B,KV,grp), fp32, contiguous. kv_dtype: 0 float32, 1 bfloat16.
extern "C" int decode_attention_partials_fwd(const void* q, const void* k, const void* v,
                                             const void* lengths, void* acc, void* m, void* l,
                                             int B, int chunk, long batch_stride, int H,
                                             int KV, int D, int window, float scale,
                                             int kv_dtype, void* stream) {
  if (bad_shape(B, chunk, H, KV, D) || batch_stride < (long)chunk * KV * D)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mp = static_cast<float*>(m);
  float* lp = static_cast<float*>(l);
  if (kv_dtype == 0)
    return launch<float, float, float, true>(q, k, v, lengths, acc, mp, lp, B, chunk,
                                             batch_stride, H, KV, window, scale, st);
  if (kv_dtype == 1)
    return launch<float, __nv_bfloat16, float, true>(q, k, v, lengths, acc, mp, lp, B, chunk,
                                                     batch_stride, H, KV, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
