// Mamba2 SSD chunked scan, written by hand for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan_pallas
//   (pl.pallas_call at line 122, kernel body _kernel at line 31).
//
// Computes: for each (batch, head) the SSD recurrence over the sequence in
//   chunks of Q = 128 positions. Per chunk, with cs the inclusive cumsum of
//   dt * A over the chunk:
//     y_i  = exp(cs_i) * C_i . S  +  sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//            + D * x_i
//     S   <- exp(cs_last) * S  +  sum_j exp(cs_last - cs_j) dt_j B_j (outer) x_j
//   x and y (B,S,H,P) in x's type, dt (B,S,H), B/C (B,S,G,N) at group
//   h / (H/G), state (B,H,P,N) f32. Everything is summed in f32.
//
// Bound on the H100: at the serving path's prompt lengths (3 and 19
//   tokens, one chunk) bytes, and mostly the 2.6 MB f32 final state of
//   mamba2-2.7b's 80 heads; the bound is about a microsecond, so a launch is
//   latency-bound. At S = 2048 bytes (46 MB, 14 us) and operations (13 GFLOP,
//   14 us at the bf16 tensor rate) are about even.
//
// Design: on the TPU the chunk axis is a sequential grid axis and a VMEM
//   scratch carries the (N, P) state from one grid step to the next. Blocks
//   on Hopper run in no order, so the chunk loop runs inside the block and
//   the state tile stays in shared memory in f32 from the first chunk to the
//   last. One block per (P / 32 column tile, head, batch): a column p of y
//   and of the state needs only x[:, p] and state[:, p], so splitting P in
//   two gives 160 blocks for 80 heads on 132 SMs; each block recomputes
//   C B^T and the cumsum of its chunk, which costs operations, not bytes.
//   Inputs are read in place at their own strides (no transposed, repeated
//   or padded copies); rows past S are masked to dt = x = B = C = 0, which
//   is what zero padding gives. The cumsum is one warp-shuffle scan per
//   chunk. exp(cs_i - cs_j) is evaluated only where j <= i: above the
//   diagonal it can overflow f32. Work is skipped where it can only give
//   zeros: column blocks above the diagonal, rows and columns past the
//   chunk's last position (a 19-token prompt computes 2 of C B^T's 16
//   tiles), and the inter-chunk term while the state is still zero. The
//   final state is written as (P, N) directly. Plain f32 FMA; the three
//   products per chunk are a later PR's work for the tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int Q = 128;       // chunk length
constexpr int P = 64;        // head_dim
constexpr int PT = 32;       // head_dim columns per block
constexpr int NT = 256;      // threads per block
constexpr int LDQ = Q + 4;   // row stride of B^T, C^T and the scores (16-byte rows)
constexpr int LDS = PT + 4;  // row stride of the state tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Shared-memory layout, offsets in floats (every region starts 16-byte aligned).
template <int N>
struct Smem {
  static constexpr int bt = 0;                   // B^T   [n][j], N x LDQ
  static constexpr int ct = bt + N * LDQ;        // C^T   [n][i], then scores [j][i], Q x LDQ
  static constexpr int xs = ct + Q * LDQ;        // x     [j][p], Q x PT
  static constexpr int ss = xs + Q * PT;         // state [n][p], N x LDS
  static constexpr int cum = ss + N * LDS;       // cumsum of dt * A, Q
  static constexpr int w = cum + Q;              // exp(cs_last - cs_j) * dt_j, Q
  static constexpr int dt = w + Q;               // dt, Q
  static constexpr int tot = dt + Q;             // the scan's warp totals, 4
  static constexpr size_t bytes = (tot + 4) * sizeof(float);
};

template <typename T, int N>
__global__ void __launch_bounds__(NT, 1) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ Dv,
    const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ hout, int S, int H,
    int G) {
  static_assert(N <= Q && N % 32 == 0, "the state rows must fit the chunk-sized regions");
  using L = Smem<N>;
  constexpr int NK = N / 32;                 // state rows per thread
  constexpr int EPC = 16 / sizeof(T);        // elements per 16-byte load
  extern __shared__ __align__(16) float smem[];
  float* bt = smem + L::bt;
  float* ct = smem + L::ct;
  float* xs = smem + L::xs;
  float* ss = smem + L::ss;
  float* cum = smem + L::cum;
  float* wv = smem + L::w;
  float* dts = smem + L::dt;
  float* tot = smem + L::tot;

  const int p0 = blockIdx.x * PT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const float a = A[h];
  const float dcoef = Dv[h];
  const long xrow = (long)H * P;             // x and y: elements between positions
  const long brow = (long)G * N;             // B and C: elements between positions
  const T* xb = x + (long)b * S * xrow + (long)h * P + p0;
  T* yb = y + (long)b * S * xrow + (long)h * P + p0;
  const float* dtb = dt + (long)b * S * H + h;
  const T* Bb = Bm + (long)b * S * brow + (long)g * N;
  const T* Cb = Cm + (long)b * S * brow + (long)g * N;
  const long st_off = ((long)b * H + h) * P * N + (long)p0 * N;

  for (int i = t; i < N * PT; i += NT) {
    const int n = i % N, p = i / N;
    ss[n * LDS + p] = h0 ? h0[st_off + (long)p * N + n] : 0.f;
  }

  // thread roles: C B^T rows ci*8..+7 and columns cj*4 + 64*cc + e;
  // y rows yi*4..+3 and state rows sn + 32*k, both at columns yp..yp+3
  const int ci = t / 16, cj = t % 16;
  const int yi = t / 8, sn = t / 8, yp = (t % 8) * 4;

  const int n_chunks = (S + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int s0 = c * Q;
    const int qn = min(Q, S - s0);           // valid rows of this chunk
    __syncthreads();                         // the previous chunk is consumed

    // ---- load the chunk: dt, the x tile, B^T and C^T; rows past S are 0 ----
    if (t < Q) dts[t] = t < qn ? dtb[(long)(s0 + t) * H] : 0.f;
    for (int i = t; i < Q * PT; i += NT) {
      const int j = i / PT, p = i % PT;
      xs[i] = j < qn ? to_float(xb[(long)(s0 + j) * xrow + p]) : 0.f;
    }
    for (int i = t; i < Q * N / EPC; i += NT) {
      const int j = i % Q, n0 = i / Q * EPC;
      uint4 bv = make_uint4(0u, 0u, 0u, 0u), cv = make_uint4(0u, 0u, 0u, 0u);
      if (j < qn) {
        bv = *reinterpret_cast<const uint4*>(Bb + (long)(s0 + j) * brow + n0);
        cv = *reinterpret_cast<const uint4*>(Cb + (long)(s0 + j) * brow + n0);
      }
      const T* be = reinterpret_cast<const T*>(&bv);
      const T* ce = reinterpret_cast<const T*>(&cv);
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        bt[(n0 + e) * LDQ + j] = to_float(be[e]);
        ct[(n0 + e) * LDQ + j] = to_float(ce[e]);
      }
    }
    __syncthreads();

    // ---- inclusive cumsum of dt * A: a shuffle scan in each of 4 warps ----
    if (t < Q) {
      float v = dts[t] * a;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += u;
      }
      if (lane == 31) tot[warp] = v;
      cum[t] = v;
    }
    __syncthreads();
    if (t < Q) {
      float v = cum[t];
      for (int k = 0; k < warp; ++k) v += tot[k];
      cum[t] = v;
    }
    __syncthreads();
    const float cs_last = cum[Q - 1];        // padded rows add 0
    if (t < Q) wv[t] = expf(cs_last - cum[t]) * dts[t];

    // ---- inter-chunk part: acc = exp(cs_i) * C_i . S ----
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
    const bool y_rows = yi * 4 < qn;
    if (y_rows && (c > 0 || h0)) {
      for (int n = 0; n < N; ++n) {
        const float4 cv = ld4(ct + n * LDQ + yi * 4);
        const float4 sv = ld4(ss + n * LDS + yp);
        const float cr[4] = {cv.x, cv.y, cv.z, cv.w};
        const float sp[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] += cr[r] * sp[e];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float d = expf(cum[yi * 4 + r]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] *= d;
      }
    }

    // ---- C B^T on the tiles at or below the diagonal, inside the chunk ----
    const bool need0 = ci * 8 < qn;
    const bool need1 = need0 && 64 < qn && 64 <= ci * 8 + 7;
    float cb[2][8][4];
#pragma unroll
    for (int cc = 0; cc < 2; ++cc)
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) cb[cc][r][e] = 0.f;
    if (need0) {
      for (int n = 0; n < N; ++n) {
        const float4 c0 = ld4(ct + n * LDQ + ci * 8);
        const float4 c1 = ld4(ct + n * LDQ + ci * 8 + 4);
        const float cr[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        const float4 b0 = ld4(bt + n * LDQ + cj * 4);
        const float bc0[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) cb[0][r][e] += cr[r] * bc0[e];
        if (need1) {
          const float4 b1 = ld4(bt + n * LDQ + cj * 4 + 64);
          const float bc1[4] = {b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e) cb[1][r][e] += cr[r] * bc1[e];
        }
      }
    }
    __syncthreads();                         // C^T is read: the scores take its place

    // scores[j][i] = (C_i . B_j) exp(cs_i - cs_j) dt_j for j <= i, else 0
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const bool need = cc == 0 ? need0 : need1;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = cj * 4 + 64 * cc + e;
        const float csj = cum[j], dj = dts[j];
        float v[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = ci * 8 + r;
          v[r] = 0.f;
          if (need && j <= i) v[r] = cb[cc][r][e] * expf(cum[i] - csj) * dj;
        }
        st4(ct + j * LDQ + ci * 8, v[0], v[1], v[2], v[3]);
        st4(ct + j * LDQ + ci * 8 + 4, v[4], v[5], v[6], v[7]);
      }
    }
    __syncthreads();

    // ---- intra-chunk part and D * x; store the valid rows of y ----
    if (y_rows) {
      const int j_end = min(qn, yi * 4 + 4);
      for (int j = 0; j < j_end; ++j) {
        const float4 sv = ld4(ct + j * LDQ + yi * 4);
        const float4 xv = ld4(xs + j * PT + yp);
        const float sr[4] = {sv.x, sv.y, sv.z, sv.w};
        const float xp[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][e] += sr[r] * xp[e];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = yi * 4 + r;
        if (i < qn) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            yb[(long)(s0 + i) * xrow + yp + e] =
                from_float<T>(acc[r][e] + dcoef * xs[i * PT + yp + e]);
        }
      }
    }

    // ---- state: S = exp(cs_last) S + sum_j w_j B_j (outer) x_j ----
    const float decay = expf(cs_last);
    float sacc[NK][4];
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const float4 sv = ld4(ss + (sn + 32 * k) * LDS + yp);
      sacc[k][0] = decay * sv.x;
      sacc[k][1] = decay * sv.y;
      sacc[k][2] = decay * sv.z;
      sacc[k][3] = decay * sv.w;
    }
    for (int j = 0; j < qn; ++j) {
      const float wj = wv[j];
      const float4 xv = ld4(xs + j * PT + yp);
      const float xw[4] = {wj * xv.x, wj * xv.y, wj * xv.z, wj * xv.w};
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const float bn = bt[(sn + 32 * k) * LDQ + j];
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[k][e] += bn * xw[e];
      }
    }
#pragma unroll
    for (int k = 0; k < NK; ++k)
      st4(ss + (sn + 32 * k) * LDS + yp, sacc[k][0], sacc[k][1], sacc[k][2], sacc[k][3]);
  }
  __syncthreads();

  for (int i = t; i < N * PT; i += NT) {
    const int n = i % N, p = i / N;
    hout[st_off + (long)p * N + n] = ss[n * LDS + p];
  }
}

template <typename T, int N>
int launch(const void* x, const void* dt, const void* A, const void* B, const void* C,
           const void* D, const void* h0, void* y, void* hout, int Bsz, int S, int H, int G,
           cudaStream_t stream) {
  constexpr size_t smem = Smem<N>::bytes;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(P / PT, H, Bsz);
  ssd_scan_kernel<T, N><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(B), static_cast<const T*>(C), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<T*>(y), static_cast<float*>(hout), S, H, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B,S,H,P), dt (B,S,H) f32, A (H,) f32, Bm/Cm (B,S,G,N), D (H,) f32,
// h0 (B,H,P,N) f32 or null, y (B,S,H,P), hout (B,H,P,N) f32; all contiguous,
// Bm and Cm 16-byte aligned. P must be 64, N 64 or 128, chunk 128.
// dtype (of x, Bm, Cm, y): 0 float32, 1 bfloat16. Returns the cudaError_t
// of the launch.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* D, const void* h0, void* y,
                            void* hout, int Bsz, int S, int H, int Pdim, int G, int N,
                            int chunk, int dtype, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || Pdim != P || chunk != Q)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && N == 128)
    return launch<float, 128>(x, dt, A, Bm, Cm, D, h0, y, hout, Bsz, S, H, G, st);
  if (dtype == 0 && N == 64)
    return launch<float, 64>(x, dt, A, Bm, Cm, D, h0, y, hout, Bsz, S, H, G, st);
  if (dtype == 1 && N == 128)
    return launch<__nv_bfloat16, 128>(x, dt, A, Bm, Cm, D, h0, y, hout, Bsz, S, H, G, st);
  if (dtype == 1 && N == 64)
    return launch<__nv_bfloat16, 64>(x, dt, A, Bm, Cm, D, h0, y, hout, Bsz, S, H, G, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
