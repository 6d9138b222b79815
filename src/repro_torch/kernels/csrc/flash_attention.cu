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
// Bound on the H100: at long prompts the 4 * (visible q-k pairs) * D * H
//   operations; at the serving path's prompts (S = 3 to 19) the launch.
//
// Design: one block per (16-row query tile, head, batch). The TPU kernel's
//   sequential K grid axis is a loop inside the block over 32-key tiles; it
//   starts at the window's first tile and stops at the causal limit, so
//   fully masked tiles are never loaded. Q, K and V tiles are staged in
//   shared memory as fp32 with a padded row stride (no bank conflicts). Each
//   of the 8 threads of a query row keeps the scores of 4 keys and D/8
//   accumulator columns in registers; max and sum are reduced over those 8
//   lanes with warp shuffles. Plain FMA: moving the two products onto the
//   tensor cores (mma.sync / wgmma) is the next step for speed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 16;          // query rows per block
constexpr int BK = 32;          // keys per tile
constexpr int NT = 128;         // threads per block
constexpr int TPR = NT / BQ;    // threads per query row (8, consecutive lanes)
constexpr int KPT = BK / TPR;   // keys scored per thread per tile (4)
constexpr int PS = BK + 1;      // padded row stride of the probability tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Sk, int H, int KV, int causal, int window,
    float scale) {
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
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
           int H, int KV, int causal, int window, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, D><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, KV, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (B,Sq,H,D), k/v (B,Sk,KV,D), o (B,Sq,H,D), all contiguous. D must be 128,
// the head_dim of every dense config the port serves. dtype: 0 float32,
// 1 bfloat16. window < 0 means none. Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int Sq, int Sk, int H, int KV, int D, int causal,
                                   int window, float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sq > Sk || KV <= 0 || H % KV != 0 || D != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, 128>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, 128>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
