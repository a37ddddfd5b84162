// The fp32 step of the generator's fused GRC chain, for Hopper (sm_90a), on
// the CUDA cores.
//
// Replaces the Pallas TPU kernel hifigan_tpu/ops/pallas/grc_kernel.py
// (_grc_kernel / fused_grc_step, both tap_concat settings) for fp32
// activations; bf16 runs on the tensor cores (grc_step_bf16.cu).  For a
// batch row b and time t of pre [B, T, C]:
//
//   y[t]       = leaky(gamma * (pre[t] - mean) * inv + beta, slope)
//                (0 for t outside [0, T))
//   pre_out[t] = sum_j y[t + dil*j - lo] . W2[j] + bias + y[t]
//
// and the fp32 per-channel partial sums of pre_out and pre_out^2 over each
// CTA's time tile, which the wrapper reduces for the next GroupNorm.  The
// TPU kernel packs 4 time steps into 128 lanes and runs a block-sparse
// folded kernel dense; this one runs unfolded on C = 32 channels with the
// original k taps and dilation.
//
// What bounds it: at the flagship's MRF shapes ([8, 65536, 32]) a step moves
// 2*B*T*C fp32 values (40 us at 3.35 TB/s) and does 2*B*T*k*C*C flops as
// fp32 FMAs on the CUDA cores (67 TFLOP/s: 48 us for k=3, 176 us for k=11),
// so it is bounded by operations.  TF32 tensor cores would not keep fp32
// parity with the plain version.
//
// Design: one CTA per (batch row, 128-step time tile); the haloed window is
// read from device memory once, normalised, activated and masked in shared
// memory, and the tap contraction reads it from there; W2 is staged in
// shared memory; each thread owns one output channel and 16 time steps,
// holding one tap's 32 weights in registers while the window rows are
// broadcast to the warp.  Sums of each tile go to [B, n_tiles, C] (no
// atomics, so runs repeat bit for bit).

#include <cuda_runtime.h>

namespace {

constexpr int kC = 32;                  // channels
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSteps = 16;              // time steps per thread
constexpr int kTile = kWarps * kSteps;  // time steps per CTA

__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
grc_step_kernel(const T* __restrict__ pre, const float* __restrict__ mean,
                const float* __restrict__ inv, const float* __restrict__ gamma,
                const float* __restrict__ beta, const T* __restrict__ w,
                const float* __restrict__ bias, float slope, T* __restrict__ out,
                float* __restrict__ part1, float* __restrict__ part2, int t_len, int k,
                int dil, int lo) {
  extern __shared__ float4 smem4[];
  __shared__ float red1[kWarps][kC];
  __shared__ float red2[kWarps][kC];

  const int rows = kTile + (k - 1) * dil;
  float* ys = reinterpret_cast<float*>(smem4);  // [rows][kC] activated window
  float* ws = ys + rows * kC;                   // [k][kC][kC] taps

  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int t0 = tile * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < k * kC * kC; i += kThreads) ws[i] = to_float(w[i]);

  // Window row r holds time t0 - lo + r.  Padding applies to y, after the
  // normalisation.  The _rn intrinsics keep nvcc from contracting into FMAs,
  // so y rounds exactly as the plain version's separate multiplies and adds.
  {
    const int c = lane;
    const float mu = mean[b * kC + c], iv = inv[b * kC + c];
    const float g = gamma[b * kC + c], be = beta[b * kC + c];
    const T* src = pre + static_cast<size_t>(b) * t_len * kC;
    for (int r = warp; r < rows; r += kWarps) {
      const int t = t0 - lo + r;
      float y = 0.f;
      if (t >= 0 && t < t_len) {
        float xn = __fmul_rn(__fsub_rn(to_float(src[static_cast<size_t>(t) * kC + c]), mu), iv);
        xn = __fadd_rn(__fmul_rn(xn, g), be);
        y = xn >= 0.f ? xn : __fmul_rn(slope, xn);
        y = to_float(from_float<T>(y));
      }
      ys[r * kC + c] = y;
    }
  }
  __syncthreads();

  const int co = lane;
  const int tb = warp * kSteps;  // this thread's first time step in the tile
  float acc[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) acc[i] = ys[(tb + i + lo) * kC + co] + bias[co];

  for (int j = 0; j < k; ++j) {
    float wr[kC];
#pragma unroll
    for (int ci = 0; ci < kC; ++ci) wr[ci] = ws[(j * kC + ci) * kC + co];
    const float4* yj = reinterpret_cast<const float4*>(ys + (tb + j * dil) * kC);
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      float a = acc[i];
#pragma unroll
      for (int q = 0; q < kC / 4; ++q) {
        const float4 v = yj[i * (kC / 4) + q];
        a = fmaf(v.x, wr[4 * q + 0], a);
        a = fmaf(v.y, wr[4 * q + 1], a);
        a = fmaf(v.z, wr[4 * q + 2], a);
        a = fmaf(v.w, wr[4 * q + 3], a);
      }
      acc[i] = a;
    }
  }

  T* dst = out + static_cast<size_t>(b) * t_len * kC;
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int t = t0 + tb + i;
    if (t < t_len) {
      dst[static_cast<size_t>(t) * kC + co] = from_float<T>(acc[i]);
      s1 += acc[i];
      s2 += acc[i] * acc[i];
    }
  }
  red1[warp][co] = s1;
  red2[warp][co] = s2;
  __syncthreads();
  if (warp == 0) {
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      a1 += red1[v][co];
      a2 += red2[v][co];
    }
    const size_t o = (static_cast<size_t>(b) * gridDim.x + tile) * kC + co;
    part1[o] = a1;
    part2[o] = a2;
  }
}

template <typename T>
int launch(const void* pre, const void* mean, const void* inv, const void* gamma,
           const void* beta, const void* w, const void* bias, float slope, void* out,
           void* part1, void* part2, int batch, int t_len, int k, int dil, int lo,
           void* stream) {
  const size_t smem = (static_cast<size_t>(kTile + (k - 1) * dil) * kC + k * kC * kC) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(grc_step_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) {  // e.g. a window too large for a CTA's shared memory
    cudaGetLastError();       // clear it, so the next launch does not report it again
    return static_cast<int>(err);
  }
  const dim3 grid((t_len + kTile - 1) / kTile, batch);
  grc_step_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pre), static_cast<const float*>(mean),
      static_cast<const float*>(inv), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const T*>(w),
      static_cast<const float*>(bias), slope, static_cast<T*>(out),
      static_cast<float*>(part1), static_cast<float*>(part2), t_len, k, dil, lo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int grc_step_f32_tile() { return kTile; }
int grc_step_channels() { return kC; }
const char* grc_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int grc_step_f32(const void* pre, const void* mean, const void* inv, const void* gamma,
                 const void* beta, const void* w, const void* bias, float slope, void* out,
                 void* part1, void* part2, int batch, int t_len, int k, int dil, int lo,
                 void* stream) {
  return launch<float>(pre, mean, inv, gamma, beta, w, bias, slope, out, part1, part2, batch,
                       t_len, k, dil, lo, stream);
}

}  // extern "C"
