// The bf16 step of the generator's fused GRC chain, on Hopper's tensor cores
// (sm_90a).
//
// Replaces the Pallas TPU kernel hifigan_tpu/ops/pallas/grc_kernel.py
// (_grc_kernel / fused_grc_step, both tap_concat settings) for bf16
// activations; the fp32 step runs on the CUDA cores (grc_step.cu).  For a
// batch row b and time t of pre [B, T, 32]:
//
//   y[t]       = leaky(gamma * (pre[t] - mean) * inv + beta, slope)
//                (rounded to bf16; 0 for t outside [0, T))
//   pre_out[t] = sum_j y[t + dil*j - lo] . W2[j] + bias + y[t]
//
// and the fp32 per-channel sums of pre_out and pre_out^2 over each CTA's
// tiles, which the wrapper reduces for the next GroupNorm.
//
// What bounds it: at the flagship's MRF shapes ([8, 65536, 32]) a step moves
// 2*B*T*C bf16 values (20 us at 3.35 TB/s) and does 2*B*T*k*C*C flops
// (3 to 12 us at 989 TFLOP/s), so it is bound by bytes once the taps run on
// the tensor cores and pre is read about once.
//
// Design:
// - The taps are an implicit GEMM, out[t, :] = sum_j Y[t + j*dil - lo, :] .
//   W2[j] (M = time, N = 32, K = 32 per tap), run by mma.sync m16n8k16
//   bf16 x bf16 -> fp32, as the TPU kernel contracts bf16 taps with bf16
//   weights into fp32 on the MXU.  A fragments come from the window by
//   ldmatrix, which takes one row address per lane, so the tap offsets
//   j*dil need no alignment beyond a row (wgmma reads shared-memory operands
//   in 8-row swizzled atoms, which these offsets do not respect).  The
//   residual y[t] is one more tap, at offset lo, with an identity B built in
//   registers (y * 1 is exact in fp32), and the accumulators start at the
//   bias: the epilogue reads nothing but the accumulators.
// - A CTA walks a fixed run of contiguous 512-step tiles of one batch row;
//   the split depends on T alone (partition() in ops/cuda/grc_kernel.py), so
//   the sums repeat bit for bit with no atomics.  W2 is staged once per CTA,
//   in bf16, by cp.async; ldmatrix.trans turns its [ci][co] rows into B
//   fragments.
// - The haloed window of each tile (512 + (k-1)*dil rows of pre) is copied by
//   cp.async into a staging buffer while the previous tile's taps run, then
//   normalised, activated, rounded to bf16 and masked into the window.  Window
//   and weight rows are padded to 80 B, so that the 8 row addresses of an
//   ldmatrix or stmatrix fall in 8 distinct 16-byte bank groups.
// - 8 warps, each owning 64 time steps x 32 channels (4 x 4 m16n8 tiles, 64
//   fp32 accumulators a thread).  Epilogue: the sums are taken in fp32
//   before the bf16 rounding, reduced across the warp by shuffles and across
//   the CTA's tiles in shared memory, in a fixed order; the bf16 outputs go
//   through the warp's own rows of the window (stmatrix), so that device
//   memory is written 16 bytes a lane, 512 contiguous bytes a warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 32;                      // channels
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpSteps = 64;              // time steps per warp: 4 m16 tiles
constexpr int kTile = kWarps * kWarpSteps;  // time steps per tile
constexpr int kPitch = 40;                  // bf16 values per window / weight row (80 B)
constexpr int kRowBytes = kPitch * 2;
constexpr int kChunks = kC * 2 / 16;        // 16-byte chunks per row of pre

static_assert(kThreads % kChunks == 0, "a thread keeps the same 8 channels across rows");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void stmatrix_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// d += a . b: a 16x16 bf16 (row-major), b 16x8 bf16 (K-major per column), d fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// The two bf16 values of a 32-bit word as floats (exact), and back (round to nearest even).
__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t v;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(v) : "f"(hi), "f"(lo));
  return v;
}

constexpr size_t smem_bytes(int k, int dil) {
  // W2 [k][ci][kPitch] + window [rows][kPitch] + staged pre [rows][kC], all bf16
  return (static_cast<size_t>(k) * kC * kPitch +
          static_cast<size_t>(kTile + (k - 1) * dil) * (kPitch + kC)) * 2;
}

__global__ void __launch_bounds__(kThreads, 2)
grc_step_bf16_kernel(const __nv_bfloat16* __restrict__ pre, const float* __restrict__ mean,
                     const float* __restrict__ inv, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bias, float slope,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ part1,
                     float* __restrict__ part2, int t_len, int k, int dil, int lo,
                     int tiles_per_cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float prm[5][kC];  // mean, inv, gamma, beta of row b; bias
  __shared__ float red[2][kWarps][kC];        // each warp's sums over the CTA's tiles

  const int rows = kTile + (k - 1) * dil;  // window row r holds time tile*kTile - lo + r
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);  // [k][ci][kPitch]: W2
  __nv_bfloat16* win = ws + k * kC * kPitch;                   // [rows][kPitch]: y
  __nv_bfloat16* raw = win + rows * kPitch;                    // [rows][kC]: pre, staged

  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int first = blockIdx.x * tiles_per_cta;
  const int n_tiles = min(tiles_per_cta, (t_len + kTile - 1) / kTile - first);
  const __nv_bfloat16* src = pre + static_cast<size_t>(b) * t_len * kC;
  __nv_bfloat16* dst = out + static_cast<size_t>(b) * t_len * kC;

  // Start copying a tile's window of pre into raw.  Rows outside [0, T) are
  // not copied: the normalisation writes zeros for them.
  auto stage = [&](int tile) {
    const int t0 = tile * kTile - lo;
    for (int q = tid; q < rows * kChunks; q += kThreads) {
      const int r = q / kChunks, t = t0 + r, c = (q % kChunks) * 8;
      if (t >= 0 && t < t_len)
        cp_async_16(smem_u32(raw + r * kC + c), src + static_cast<size_t>(t) * kC + c);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  for (int q = tid; q < k * kC * kChunks; q += kThreads)  // W2, in one group with the first tile
    cp_async_16(smem_u32(ws + (q / kChunks) * kPitch + (q % kChunks) * 8), w + q * 8);
  stage(first);
  if (tid < kC) {
    prm[0][tid] = mean[b * kC + tid];
    prm[1][tid] = inv[b * kC + tid];
    prm[2][tid] = gamma[b * kC + tid];
    prm[3][tid] = beta[b * kC + tid];
    prm[4][tid] = bias[tid];
  }
  for (int i = tid; i < 2 * kWarps * kC; i += kThreads) (&red[0][0][0])[i] = 0.f;

  const int c8 = (tid % kChunks) * 8;  // the 8 channels this thread normalises
  const int wrow = warp * kWarpSteps;  // this warp's first time step in a tile
  const int g = lane >> 2, q4 = lane & 3;
  // Fragment addresses.  A (ldmatrix): window rows wrow + (lane & 15),
  // channels (lane >> 4) * 8.  B (ldmatrix.trans): W2 row ci = lane of a
  // tap.  Output (stmatrix): rows wrow + (lane & 7), channels (lane >> 3) * 8.
  const uint32_t a_base = smem_u32(win + (wrow + (lane & 15)) * kPitch + (lane >> 4) * 8);
  const uint32_t b_base = smem_u32(ws + lane * kPitch);
  const uint32_t o_base = smem_u32(win + (wrow + (lane & 7)) * kPitch + (lane >> 3) * 8);
  // B fragments of the 32x32 identity: lane (g, q4) holds rows ci = 2*q4, +1
  // (b0) and 8 + 2*q4, +1 (b1) of column co = g of an n8 tile.  n8 tiles 2s
  // and 2s + 1 of k16 step s hold the diagonal; the others are zero.
  auto ident = [&](int ci, int co) {
    return (ci == co ? 0x3f80u : 0u) | (ci + 1 == co ? 0x3f800000u : 0u);
  };
  const uint32_t id_even[2] = {ident(2 * q4, g), ident(8 + 2 * q4, g)};
  const uint32_t id_odd[2] = {ident(2 * q4, 8 + g), ident(8 + 2 * q4, 8 + g)};

  for (int it = 0; it < n_tiles; ++it) {
    const int tile = first + it;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // raw holds this tile's pre; no warp reads win any more

    // Normalise raw into win.  The _rn intrinsics keep nvcc from contracting
    // into FMAs, so y rounds exactly as the plain version's separate ops.
    {
      float mu[8], iv[8], ga[8], be[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        mu[c] = prm[0][c8 + c];
        iv[c] = prm[1][c8 + c];
        ga[c] = prm[2][c8 + c];
        be[c] = prm[3][c8 + c];
      }
      const int t0 = tile * kTile - lo;
      for (int q = tid; q < rows * kChunks; q += kThreads) {
        const int r = q / kChunks, t = t0 + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (t >= 0 && t < t_len) {
          const uint4 x = *reinterpret_cast<const uint4*>(raw + r * kC + c8);
          const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
          uint32_t ys[4];
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            float y[2] = {bf16_lo(xs[p]), bf16_hi(xs[p])};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 2 * p + e;
              float xn = __fmul_rn(__fsub_rn(y[e], mu[c]), iv[c]);
              xn = __fadd_rn(__fmul_rn(xn, ga[c]), be[c]);
              y[e] = xn >= 0.f ? xn : __fmul_rn(slope, xn);
            }
            ys[p] = pack_bf16(y[0], y[1]);
          }
          v = make_uint4(ys[0], ys[1], ys[2], ys[3]);
        }
        *reinterpret_cast<uint4*>(win + r * kPitch + c8) = v;
      }
    }
    __syncthreads();  // win is ready; raw is free
    if (it + 1 < n_tiles) stage(tile + 1);

    // Taps: acc[m][n] is the m16 x n8 tile (rows wrow + 16m, channels 8n);
    // lane (g, q4) holds rows g and g + 8, channels 8n + 2*q4 and + 1.
    float acc[4][4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float b0 = prm[4][n * 8 + 2 * q4], b1 = prm[4][n * 8 + 2 * q4 + 1];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        acc[m][n][0] = acc[m][n][2] = b0;
        acc[m][n][1] = acc[m][n][3] = b1;
      }
    }
    {  // the residual: y[t] = window row t + lo, times the identity
      const uint32_t ar = a_base + lo * kRowBytes;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        uint32_t a0[4], a1[4];  // ci 0..15 and 16..31
        ldmatrix_x4(a0, ar + m * 16 * kRowBytes);
        ldmatrix_x4(a1, ar + m * 16 * kRowBytes + 32);
        mma_bf16(acc[m][0], a0, id_even[0], id_even[1]);
        mma_bf16(acc[m][1], a0, id_odd[0], id_odd[1]);
        mma_bf16(acc[m][2], a1, id_even[0], id_even[1]);
        mma_bf16(acc[m][3], a1, id_odd[0], id_odd[1]);
      }
    }
    for (int j = 0; j < k; ++j) {
      uint32_t bw[4][4];  // [n8 tile][ci block of 8]
#pragma unroll
      for (int n = 0; n < 4; ++n) ldmatrix_x4_trans(bw[n], b_base + j * kC * kRowBytes + n * 16);
      const uint32_t aj = a_base + j * dil * kRowBytes;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        uint32_t a0[4], a1[4];
        ldmatrix_x4(a0, aj + m * 16 * kRowBytes);
        ldmatrix_x4(a1, aj + m * 16 * kRowBytes + 32);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          mma_bf16(acc[m][n], a0, bw[n][0], bw[n][1]);
          mma_bf16(acc[m][n], a1, bw[n][2], bw[n][3]);
        }
      }
    }
    __syncthreads();  // no warp reads win any more: each may write its own rows

    // Epilogue: sums over rows t < T, bf16 outputs into the warp's rows of
    // win, then 16 bytes a lane to device memory.
    float s1[4][2], s2[4][2];
#pragma unroll
    for (int n = 0; n < 4; ++n) s1[n][0] = s1[n][1] = s2[n][0] = s2[n][1] = 0.f;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool live = tile * kTile + wrow + m * 16 + h * 8 + g < t_len;
        uint32_t packed[4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float v0 = acc[m][n][2 * h], v1 = acc[m][n][2 * h + 1];
          packed[n] = pack_bf16(v0, v1);
          if (live) {
            s1[n][0] += v0;
            s1[n][1] += v1;
            s2[n][0] += v0 * v0;
            s2[n][1] += v1 * v1;
          }
        }
        stmatrix_x4(o_base + (m * 16 + h * 8) * kRowBytes, packed);
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kWarpSteps * kChunks / 32; ++i) {
      const int q = i * 32 + lane, r = wrow + q / kChunks, c = (q % kChunks) * 8;
      const int t = tile * kTile + r;
      if (t < t_len)
        *reinterpret_cast<uint4*>(dst + static_cast<size_t>(t) * kC + c) =
            *reinterpret_cast<const uint4*>(win + r * kPitch + c);
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
  cudaError_t err = cudaFuncSetAttribute(grc_step_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes(k, dil)));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(grc_step_bf16_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) cudaGetLastError();  // e.g. a window too large: clear it for the next launch
  return err;
}

}  // namespace

extern "C" {

int grc_step_bf16_tile() { return kTile; }

// CTAs of the kernel that one SM holds at once for (k, dil); 0 on an error.
int grc_step_bf16_ctas_per_sm(int k, int dil) {
  int n = 0;
  if (set_shared_memory(k, dil) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, grc_step_bf16_kernel, kThreads,
                                                    smem_bytes(k, dil)) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

int grc_step_bf16(const void* pre, const void* mean, const void* inv, const void* gamma,
                  const void* beta, const void* w, const void* bias, float slope, void* out,
                  void* part1, void* part2, int batch, int t_len, int k, int dil, int lo,
                  int tiles_per_cta, int n_cta, void* stream) {
  const cudaError_t err = set_shared_memory(k, dil);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_cta, batch);
  grc_step_bf16_kernel<<<grid, kThreads, smem_bytes(k, dil), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(pre), static_cast<const float*>(mean),
      static_cast<const float*>(inv), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), slope, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part1), static_cast<float*>(part2), t_len, k, dil, lo, tiles_per_cta);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
