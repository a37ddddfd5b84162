// The fp32 step of the generator's fused GRC chain, on Hopper's tensor cores
// (sm_90a), kept at fp32 accuracy by the 3xTF32 split.
//
// Replaces the Pallas TPU kernel hifigan_tpu/ops/pallas/grc_kernel.py
// (_grc_kernel / fused_grc_step, both tap_concat settings) for fp32
// activations; bf16 runs in grc_step_bf16.cu.  For a batch row b and time t
// of pre [B, T, 32]:
//
//   y[t]       = leaky(gamma * (pre[t] - mean) * inv + beta, slope)
//                (0 for t outside [0, T))
//   pre_out[t] = sum_j y[t + dil*j - lo] . W2[j] + bias + y[t]
//
// and the fp32 per-channel sums of pre_out and pre_out^2 over each CTA's
// tiles, which the wrapper reduces for the next GroupNorm.
//
// The 3xTF32 split: each fp32 operand x is split as x ~ hi + lo with
// hi = tf32(x) and lo = tf32(x - hi) (cvt.rna, round to nearest; x - hi is
// exact in fp32), and each product is taken as lo.hi + hi.lo + hi.hi, three
// TF32 mma.sync products accumulated in fp32.  The dropped lo.lo term and
// the rounding of lo leave a relative error of about 2^-21 per product, the
// order of an fp32 summation-order difference; one TF32 pass would leave
// 2^-11.
//
// What bounds it: at the flagship's MRF shapes ([8, 65536, 32]) a step moves
// 2*B*T*C fp32 values (40 us at 3.35 TB/s) and does 3 * 2*B*T*k*C*C TF32
// flops (20 us for k=3, 72 us for k=11 at 495 TFLOP/s), so the k=3 steps are
// bound by bytes and the k=7 and k=11 steps by the tensor cores.
//
// Design:
// - The taps are an implicit GEMM, out[t, :] = sum_j Y[t + j*dil - lo, :] .
//   W2[j] (M = time, N = 32, K = 32 per tap: 4 k8 steps), run by mma.sync
//   m16n8k8 tf32 x tf32 -> fp32.  Operands come from shared memory by
//   ldmatrix without .trans: an 8x8 b16 matrix is 8 rows of 4 fp32 words and
//   lane l receives row l/4, word l%4, which is the m16n8k8 TF32 A layout
//   (time x ci) and, for W2 kept as [co][ci] rows, the B ("col") layout.
//   ldmatrix takes one row address per lane, so a tap at offset j*dil needs
//   no alignment beyond a row (wgmma's 8-row swizzled atoms would).
// - The split is done once per element, not once per use: W2 is transposed
//   to [j][co][ci], split and stored as hi and lo when a CTA starts, and each
//   tile's window is split as it is normalised.  The tap loop is ldmatrix and
//   mma alone.  Rows are padded to 144 B so that the 8 row addresses of an
//   ldmatrix fall in 8 distinct 16-byte bank groups.
// - A CTA walks a fixed run of contiguous 256-step tiles of one batch row;
//   the split depends on T alone (partition() in ops/cuda/grc_kernel.py), so
//   the sums repeat bit for bit with no atomics.  The haloed window of the
//   next tile (256 + (k-1)*dil rows of pre) is copied by cp.async into a
//   staging buffer while the current tile's taps run.  At k=11, d=5, W2
//   (2 x 50.7 KB), the split window (2 x 44.1 KB) and the staging buffer
//   (39.2 KB) take 228.7 KB: one CTA an SM.
// - 8 warps, each owning 32 time steps x 32 channels (2 x 4 m16n8 tiles, 32
//   fp32 accumulators a thread), which start at the bias.  Epilogue: the
//   residual y = hi + lo from the window, the sums in fp32 over rows t < T,
//   reduced across the warp by shuffles and across the CTA's tiles in shared
//   memory in a fixed order; outputs are stored 8 bytes a lane, full 32-byte
//   sectors.  y keeps the plain version's separate fp32 operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;                      // channels
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpSteps = 32;              // time steps per warp
constexpr int kM = kWarpSteps / 16;         // m16 tiles per warp
constexpr int kTile = kWarps * kWarpSteps;  // time steps per tile
constexpr int kPitch = 36;                  // fp32 values per window / weight row (144 B)
constexpr int kRowBytes = kPitch * 4;
constexpr int kChunks = kC * 4 / 16;        // 16-byte chunks per row of pre

static_assert(kThreads % kChunks == 0, "a thread keeps the same 4 channels across rows");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a . b: a 16x8 tf32 (row-major), b 8x8 tf32 (K-major per column), d fp32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away), as an fp32 value.
__device__ __forceinline__ float tf32(float x) {
  uint32_t v;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(v) : "f"(x));
  return __uint_as_float(v);
}

// The 3xTF32 split x ~ hi + lo.
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, hi));
}

constexpr size_t smem_bytes(int k, int dil) {
  // W2 hi, lo [k][co][kPitch] + window hi, lo [rows][kPitch] + staged pre [rows][kC], all fp32
  return (2 * static_cast<size_t>(k) * kC * kPitch +
          static_cast<size_t>(kTile + (k - 1) * dil) * (2 * kPitch + kC)) * 4;
}

__global__ void __launch_bounds__(kThreads, 1)
grc_step_f32_kernel(const float* __restrict__ pre, const float* __restrict__ mean,
                    const float* __restrict__ inv, const float* __restrict__ gamma,
                    const float* __restrict__ beta, const float* __restrict__ w,
                    const float* __restrict__ bias, float slope, float* __restrict__ out,
                    float* __restrict__ part1, float* __restrict__ part2, int t_len, int k,
                    int dil, int lo, int tiles_per_cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float prm[5][kC];  // mean, inv, gamma, beta of row b; bias
  __shared__ float red[2][kWarps][kC];        // each warp's sums over the CTA's tiles

  const int rows = kTile + (k - 1) * dil;  // window row r holds time tile*kTile - lo + r
  float* w_hi = reinterpret_cast<float*>(smem);  // [k][co][kPitch]: W2, transposed
  float* w_lo = w_hi + k * kC * kPitch;
  float* y_hi = w_lo + k * kC * kPitch;          // [rows][kPitch]: y
  float* y_lo = y_hi + rows * kPitch;
  float* raw = y_lo + rows * kPitch;             // [rows][kC]: pre, staged

  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int first = blockIdx.x * tiles_per_cta;
  const int n_tiles = min(tiles_per_cta, (t_len + kTile - 1) / kTile - first);
  const float* src = pre + static_cast<size_t>(b) * t_len * kC;
  float* dst = out + static_cast<size_t>(b) * t_len * kC;

  // Start copying a tile's window of pre into raw.  Rows outside [0, T) are
  // not copied: the normalisation writes zeros for them.
  auto stage = [&](int tile) {
    const int t0 = tile * kTile - lo;
    for (int q = tid; q < rows * kChunks; q += kThreads) {
      const int r = q / kChunks, t = t0 + r, c = (q % kChunks) * 4;
      if (t >= 0 && t < t_len)
        cp_async_16(smem_u32(raw + r * kC + c), src + static_cast<size_t>(t) * kC + c);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  stage(first);
  // W2 [j][ci][co] -> hi, lo [j][co][ci] (read once per CTA; L2 holds it).
  for (int i = tid; i < k * kC * kC; i += kThreads) {
    const int j = i / (kC * kC), ci = (i / kC) % kC, co = i % kC;
    float hi, lo_;
    split(w[i], hi, lo_);
    w_hi[(j * kC + co) * kPitch + ci] = hi;
    w_lo[(j * kC + co) * kPitch + ci] = lo_;
  }
  if (tid < kC) {
    prm[0][tid] = mean[b * kC + tid];
    prm[1][tid] = inv[b * kC + tid];
    prm[2][tid] = gamma[b * kC + tid];
    prm[3][tid] = beta[b * kC + tid];
    prm[4][tid] = bias[tid];
  }
  for (int i = tid; i < 2 * kWarps * kC; i += kThreads) (&red[0][0][0])[i] = 0.f;

  const int c4 = (tid % kChunks) * 4;  // the 4 channels this thread normalises
  const int wrow = warp * kWarpSteps;  // this warp's first time step in a tile
  const int g = lane >> 2, q4 = lane & 3;
  // Fragment addresses.  A: window rows wrow + (lane & 15), channels
  // (lane >> 4) * 4 (matrices: rows 0-7 / 8-15 x k 0-3 / 4-7 = a0..a3).
  // B: W2 rows co = (lane >> 4) * 8 + (lane & 7), channels ((lane >> 3) & 1)
  // * 4 (matrices: b0, b1 of n8 tile 2p, then of 2p + 1).
  const uint32_t a_hi = smem_u32(y_hi + (wrow + (lane & 15)) * kPitch + (lane >> 4) * 4);
  const uint32_t a_lo = a_hi + rows * kRowBytes;
  const uint32_t b_hi = smem_u32(w_hi + ((lane >> 4) * 8 + (lane & 7)) * kPitch + ((lane >> 3) & 1) * 4);
  const uint32_t b_lo = b_hi + k * kC * kRowBytes;

  for (int it = 0; it < n_tiles; ++it) {
    const int tile = first + it;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // raw holds this tile's pre; no warp reads the window any more

    // Normalise raw into the window and split it.  The _rn intrinsics keep
    // nvcc from contracting into FMAs, so y rounds exactly as the plain
    // version's separate ops.
    {
      float mu[4], iv[4], ga[4], be[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        mu[c] = prm[0][c4 + c];
        iv[c] = prm[1][c4 + c];
        ga[c] = prm[2][c4 + c];
        be[c] = prm[3][c4 + c];
      }
      const int t0 = tile * kTile - lo;
      for (int q = tid; q < rows * kChunks; q += kThreads) {
        const int r = q / kChunks, t = t0 + r;
        float4 h = make_float4(0.f, 0.f, 0.f, 0.f), l = h;
        if (t >= 0 && t < t_len) {
          const float4 x = *reinterpret_cast<const float4*>(raw + r * kC + c4);
          float y[4] = {x.x, x.y, x.z, x.w}, yh[4], yl[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float xn = __fmul_rn(__fsub_rn(y[c], mu[c]), iv[c]);
            xn = __fadd_rn(__fmul_rn(xn, ga[c]), be[c]);
            split(xn >= 0.f ? xn : __fmul_rn(slope, xn), yh[c], yl[c]);
          }
          h = make_float4(yh[0], yh[1], yh[2], yh[3]);
          l = make_float4(yl[0], yl[1], yl[2], yl[3]);
        }
        *reinterpret_cast<float4*>(y_hi + r * kPitch + c4) = h;
        *reinterpret_cast<float4*>(y_lo + r * kPitch + c4) = l;
      }
    }
    __syncthreads();  // the window is ready; raw is free
    if (it + 1 < n_tiles) stage(tile + 1);

    // Taps: acc[m][n] is the m16 x n8 tile (rows wrow + 16m, channels 8n);
    // lane (g, q4) holds rows g and g + 8, channels 8n + 2*q4 and + 1.
    float acc[kM][4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float b0 = prm[4][n * 8 + 2 * q4], b1 = prm[4][n * 8 + 2 * q4 + 1];
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        acc[m][n][0] = acc[m][n][2] = b0;
        acc[m][n][1] = acc[m][n][3] = b1;
      }
    }
    for (int j = 0; j < k; ++j) {
      const uint32_t wj = j * kC * kRowBytes, yj = j * dil * kRowBytes;
#pragma unroll
      for (int s = 0; s < kC / 8; ++s) {  // k8 steps: channels 8s .. 8s + 7
        uint32_t bh[2][4], bl[2][4];      // [n8 tile pair][b0, b1 of 2p; b0, b1 of 2p + 1]
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          ldmatrix_x4(bh[p], b_hi + wj + p * 16 * kRowBytes + s * 32);
          ldmatrix_x4(bl[p], b_lo + wj + p * 16 * kRowBytes + s * 32);
        }
#pragma unroll
        for (int m = 0; m < kM; ++m) {
          uint32_t ah[4], al[4];
          ldmatrix_x4(ah, a_hi + yj + m * 16 * kRowBytes + s * 32);
          ldmatrix_x4(al, a_lo + yj + m * 16 * kRowBytes + s * 32);
#pragma unroll
          for (int n = 0; n < 4; ++n) {  // small products first
            const int p = n >> 1, e = (n & 1) * 2;
            mma_tf32(acc[m][n], al, bh[p][e], bh[p][e + 1]);
            mma_tf32(acc[m][n], ah, bl[p][e], bl[p][e + 1]);
            mma_tf32(acc[m][n], ah, bh[p][e], bh[p][e + 1]);
          }
        }
      }
    }

    // Epilogue: the residual y[t] = window row t + lo, the sums over rows
    // t < T, and the outputs.
    float s1[4][2], s2[4][2];
#pragma unroll
    for (int n = 0; n < 4; ++n) s1[n][0] = s1[n][1] = s2[n][0] = s2[n][1] = 0.f;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wrow + m * 16 + h * 8 + g;
        const int t = tile * kTile + r;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = n * 8 + 2 * q4;
          const float2 yh = *reinterpret_cast<const float2*>(y_hi + (r + lo) * kPitch + c);
          const float2 yl = *reinterpret_cast<const float2*>(y_lo + (r + lo) * kPitch + c);
          const float v0 = acc[m][n][2 * h] + __fadd_rn(yh.x, yl.x);
          const float v1 = acc[m][n][2 * h + 1] + __fadd_rn(yh.y, yl.y);
          if (t < t_len) {
            *reinterpret_cast<float2*>(dst + static_cast<size_t>(t) * kC + c) = make_float2(v0, v1);
            s1[n][0] += v0;
            s1[n][1] += v1;
            s2[n][0] += v0 * v0;
            s2[n][1] += v1 * v1;
          }
        }
      }
    }
    // Lanes with the same q4 hold the same channels: reduce over g.
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s1[n][e] += __shfl_xor_sync(0xffffffffu, s1[n][e], off);
          s2[n][e] += __shfl_xor_sync(0xffffffffu, s2[n][e], off);
        }
    if (g == 0) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          red[0][warp][n * 8 + 2 * q4 + e] += s1[n][e];
          red[1][warp][n * 8 + 2 * q4 + e] += s2[n][e];
        }
    }
  }

  __syncthreads();
  if (tid < kC) {
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      a1 += red[0][v][tid];
      a2 += red[1][v][tid];
    }
    const size_t o = (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * kC + tid;
    part1[o] = a1;
    part2[o] = a2;
  }
}

cudaError_t set_shared_memory(int k, int dil) {
  cudaError_t err = cudaFuncSetAttribute(grc_step_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes(k, dil)));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(grc_step_f32_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) cudaGetLastError();  // e.g. a window too large: clear it for the next launch
  return err;
}

}  // namespace

extern "C" {

int grc_step_f32_tile() { return kTile; }
int grc_step_channels() { return kC; }
const char* grc_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// CTAs of the kernel that one SM holds at once for (k, dil); 0 on an error.
int grc_step_f32_ctas_per_sm(int k, int dil) {
  int n = 0;
  if (set_shared_memory(k, dil) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, grc_step_f32_kernel, kThreads,
                                                    smem_bytes(k, dil)) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

int grc_step_f32(const void* pre, const void* mean, const void* inv, const void* gamma,
                 const void* beta, const void* w, const void* bias, float slope, void* out,
                 void* part1, void* part2, int batch, int t_len, int k, int dil, int lo,
                 int tiles_per_cta, int n_cta, void* stream) {
  const cudaError_t err = set_shared_memory(k, dil);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_cta, batch);
  grc_step_f32_kernel<<<grid, kThreads, smem_bytes(k, dil), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pre), static_cast<const float*>(mean),
      static_cast<const float*>(inv), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const float*>(w),
      static_cast<const float*>(bias), slope, static_cast<float*>(out),
      static_cast<float*>(part1), static_cast<float*>(part2), t_len, k, dil, lo, tiles_per_cta);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
