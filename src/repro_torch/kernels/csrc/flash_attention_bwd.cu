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
//     pass 2: one block per (32-key tile, kv head, batch): dV = sum P^T dO
//             and dK = scale * sum dS^T Q, with dS = P * (dO V^T - delta),
//             over every query row the tile is visible to (the causal limit,
//             the window's edge) and over the grp query heads of the kv
//             head, in registers, in a fixed order;
//     pass 3: one block per (32-row query tile, head, batch): dQ = scale *
//             sum dS K over the key tiles visible to it.
//   No atomics: every output element is summed by one thread in a fixed
//   order, so the result is bitwise repeatable from call to call. Masked
//   scores give P = 0 (the forward's -1e30 scores contribute exp(-1e30 -
//   lse) = 0), so no row turns into NaN.
//
// Bound on the H100: operations, 2.5x the forward's 4 * (visible q-k pairs)
//   * D * H (pass 2 and pass 3 each recompute S and dP), on the bf16 tensor
//   cores; at musicgen-medium's training shape (4, 128, 24 heads of 64) the
//   launches and one trip to device memory.
//
// Design: the simple body. Tiles are staged in shared memory as fp32 (rows
//   padded by one float, so the row-per-thread and key-per-thread reads fall
//   on distinct banks), and every product is a scalar fp32 FMA. bf16 inputs
//   are widened when staged, the outputs rounded once at the end; no
//   intermediate (P, dS) is rounded. One instantiation per (dtype, head_dim)
//   for head_dim 32, 64 and 128; shared memory 25, 41 or 73 KB. The next
//   step is mma.sync (the forward's fragments) and then wgmma with TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads per block
constexpr int BR = 32;         // query rows per tile
constexpr int BC = 32;         // keys per tile
constexpr int TPR = NT / BR;   // threads per query row (score phase) or per key (pass 2 sums)
constexpr int KPT = BC / TPR;  // keys scored per thread per tile (4)
constexpr int PS = BC + 1;     // padded row stride of the P and dS tiles
constexpr float NEG_INF = -1e30f;
static_assert(BR == BC, "pass 2 maps one key of its tile to each group of TPR threads");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

// rows row0 .. row0 + 31 of a (n_rows, stride) array, D wide, widened to fp32
// into a padded tile; rows at or past n_rows are zero
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, long stride, int row0,
                                      int n_rows) {
  for (int e = threadIdx.x; e < BR * D; e += NT) {
    const int r = e / D, c = e % D;
    dst[r * dp<D>() + c] = row0 + r < n_rows ? to_float(src[(long)(row0 + r) * stride + c]) : 0.f;
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

// pass 1: delta (B, H, Sq) = rowsum(dO * O), one warp a row of (B, Sq, H)
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_delta_kernel(const T* __restrict__ o,
                                                             const T* __restrict__ dO,
                                                             float* __restrict__ delta,
                                                             long n_rows, int Sq, int H) {
  const long row = (long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
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

// pass 2: dK and dV of one 32-key tile of one kv head
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dO, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H, int KV, int causal,
    int window, float scale) {
  constexpr int CPT = D / TPR;  // accumulator columns per thread
  extern __shared__ __align__(16) float sm[];
  const Tiles t = carve<D>(sm);
  const int k0 = blockIdx.x * BC;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int grp = H / KV;
  const int off = Sk - Sq;
  const long q_stride = (long)H * D, kv_stride = (long)KV * D;
  const T* kb = k + (long)b * Sk * kv_stride + (long)kvh * D;
  const T* vb = v + (long)b * Sk * kv_stride + (long)kvh * D;
  stage<T, D>(t.ks, kb, kv_stride, k0, Sk);
  stage<T, D>(t.vs, vb, kv_stride, k0, Sk);

  // the query rows that see some key of this tile
  const int k_last = min(k0 + BC, Sk) - 1;
  const int i_lo = causal ? max(0, k0 - off) : 0;
  const int i_hi = window >= 0 ? min(Sq, k_last + window - off) : Sq;

  const int j = threadIdx.x / TPR, cc = threadIdx.x % TPR;  // this thread's key and columns
  float adk[CPT], adv[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) adk[c] = adv[c] = 0.f;

  for (int g = 0; g < grp; ++g) {
    const int h = kvh * grp + g;
    const T* qb = q + (long)b * Sq * q_stride + (long)h * D;
    const T* dob = dO + (long)b * Sq * q_stride + (long)h * D;
    for (int i0 = i_lo; i0 < i_hi; i0 += BR) {
      __syncthreads();  // the previous tile is consumed
      stage<T, D>(t.qs, qb, q_stride, i0, Sq);
      stage<T, D>(t.dos, dob, q_stride, i0, Sq);
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
  }
  if (k0 + j < Sk) {
    const long base = ((long)b * Sk + k0 + j) * kv_stride + (long)kvh * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dk[base + cc + TPR * c] = from_float<T>(adk[c] * scale);
      dv[base + cc + TPR * c] = from_float<T>(adv[c]);
    }
  }
}

// pass 3: dQ of one 32-row query tile of one head
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dO, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int Sq, int Sk, int H, int KV, int causal, int window, float scale) {
  constexpr int CPT = D / TPR;
  extern __shared__ __align__(16) float sm[];
  const Tiles t = carve<D>(sm);
  const int q0 = blockIdx.x * BR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int off = Sk - Sq;
  const long q_stride = (long)H * D, kv_stride = (long)KV * D;
  const T* kb = k + (long)b * Sk * kv_stride + (long)kvh * D;
  const T* vb = v + (long)b * Sk * kv_stride + (long)kvh * D;
  stage<T, D>(t.qs, q + (long)b * Sq * q_stride + (long)h * D, q_stride, q0, Sq);
  stage<T, D>(t.dos, dO + (long)b * Sq * q_stride + (long)h * D, q_stride, q0, Sq);
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
    stage<T, D>(t.ks, kb, kv_stride, k0, Sk);
    stage<T, D>(t.vs, vb, kv_stride, k0, Sk);
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
    for (int c = 0; c < CPT; ++c) dq[base + cc + TPR * c] = from_float<T>(adq[c] * scale);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dO,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Sq, int Sk,
           int H, int KV, int causal, int window, float scale, cudaStream_t st) {
  static const cudaError_t a2 = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  static const cudaError_t a3 = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<D>());
  if (a2 != cudaSuccess) return static_cast<int>(a2);
  if (a3 != cudaSuccess) return static_cast<int>(a3);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dO);
  const long rows = (long)B * Sq * H;
  flash_bwd_delta_kernel<T, D><<<(unsigned)((rows + NT / 32 - 1) / (NT / 32)), NT, 0, st>>>(
      static_cast<const T*>(o), dot, delta, rows, Sq, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<T, D><<<dim3((Sk + BC - 1) / BC, KV, B), NT, smem_bytes<D>(), st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KV,
      causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<T, D><<<dim3((Sq + BR - 1) / BR, H, B), NT, smem_bytes<D>(), st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), Sq, Sk, H, KV, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dtype(const void* q, const void* k, const void* v, const void* o, const void* dO,
                 const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int Sq,
                 int Sk, int H, int KV, int causal, int window, float scale, int dtype,
                 cudaStream_t st) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, Sq, Sk, H, KV, causal,
                            window, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, D>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, Sq, Sk, H, KV,
                                    causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, o, dO, dq (B,Sq,H,D); k, v, dk, dv (B,Sk,KV,D), all contiguous and of
// one dtype (0 float32, 1 bfloat16); lse (B,H,Sq) f32 from the forward;
// delta (B,H,Sq) f32 scratch. D is 32, 64 or 128. window < 0 means none.
// Three launches on the stream; returns the first cudaError_t that is not 0.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dO, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
                                   int D, int causal, int window, float scale, int dtype,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sq > Sk || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch_dtype<32>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, Sq, Sk, H, KV, causal,
                              window, scale, dtype, st);
    case 64:
      return launch_dtype<64>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, Sq, Sk, H, KV, causal,
                              window, scale, dtype, st);
    case 128:
      return launch_dtype<128>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, Sq, Sk, H, KV, causal,
                               window, scale, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
