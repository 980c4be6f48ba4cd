// K3: the fused dense RelConv.
//
//   agg = A @ bf16(h)                  [N, F] f32
//   out = relu(agg @ W + h @ root + b)  [N, H] f32
//
// Replaces mpgnn_tpu/ops/pallas_conv.py::_conv_kernel (launched by
// _conv_fwd_impl). A is the row-normalised mean adjacency of one relation,
// [N, N] bf16, built by mpgnn_tpu_torch/ops/conv.py::build_dense_conv_operand;
// h, W, root, b and every output are float32 and contiguous. Its backward
// product, K4, is csrc/dense_matmul.cu.
//
// Bound on the H100: bytes of A. A is N*N*2 bytes (50 MB at N = 5,000,
// 2.1 GB at N = 32,768) and is read once; h, the outputs and W/root are
// N*F*4 bytes each or less. The product is 2*N*N*F operations, which at the
// bf16 tensor-core rate takes a fifth of the time A takes to stream at F=64.
//
// Design. A first pass rounds h to bf16 with __float2bfloat16_rn, exactly
// JAX's h.astype(bfloat16), into a scratch [N, FP] (FP = F rounded up to 16,
// 32, 64, 128 or 256, the extra columns zero) that the wrapper allocates.
// Then one CTA of 4 warps owns a block of 32 rows (157 CTAs at N = 5,000,
// enough to give every SM of 132 one; the TPU kernel's VMEM-sized 256-row
// block would give 20) and walks the N columns in chunks of 256 (fewer for
// FP > 64):
//   * the A tile [32, 256] and the bf16 h tile [256, FP] are staged in
//     shared memory with 16-byte cp.async copies, double-buffered, so that
//     the next chunk's copies are in flight while this one is multiplied;
//     rows past N are zero-filled, so any N works (a plain 2-byte load path
//     stages A when N is not a multiple of 8);
//   * the warps multiply the tiles with bf16 WMMA (16x16x16 tensor-core
//     products, float32 accumulate). Products of two bf16 values are exact
//     in float32, so this differs from float32 FMA on the rounded values
//     only in the order of the sum; the tensor cores keep the loop well
//     under the A stream's time, where float32 FMA would not at F = 64.
// Every CTA reads all of h: rounding it once halves those bytes, and
// staging it asynchronously keeps the loads in flight (rounding it in every
// CTA with plain loads stalls on each load: 0.43 ms on the H100 at
// N = 5,000, F = 64, against 15 us for A's bytes).
// K3's epilogue stages agg, the block's rows of h, W and root in shared
// memory (above 48 KB the limit is raised with cudaFuncSetAttribute), writes
// agg and forms z = (agg @ W + h_blk @ root) + b with float32 FMA, writing
// relu(z). Every output row is written once by one CTA: no atomics, and the
// sum order is fixed, so results are deterministic. wgmma and TMA are left
// for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 128;          // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 32;                // rows of A per CTA
constexpr int kMaxSmem = 232448;       // a block's shared-memory ceiling

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;        // 0 source bytes: the 16 are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Round x [n, F] float32 to bf16 (round to nearest even: JAX's
// x.astype(bfloat16)) into xb [n, FP], columns F..FP zero.
__global__ void round_bf16_kernel(const float* __restrict__ x,
                                  __nv_bfloat16* __restrict__ xb, int n, int F,
                                  int FP) {
  const size_t total = (size_t)n * FP;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t r = i / FP;
    const int f = (int)(i % FP);
    xb[i] = __float2bfloat16_rn(f < F ? __ldg(x + r * F + f) : 0.f);
  }
}

// Columns of A per chunk: 256, or fewer for wide h tiles so that two
// stages of both tiles fit in shared memory.
__host__ __device__ constexpr int chunk_cols(int fp) {
  return fp <= 64 ? 256 : 16384 / fp;
}

// Stage A[row0 : row0+32, k0 : k0+BK] into As (zeros past N).
template <int BK, bool VEC>
__device__ __forceinline__ void stage_a(const __nv_bfloat16* __restrict__ a,
                                        __nv_bfloat16* As, int row0, int k0,
                                        int n) {
  constexpr int kLd = BK + 8;
  if (VEC) {
    constexpr int kPieces = BK / 8;    // 16-byte pieces per tile row
    for (int q = threadIdx.x; q < kBM * kPieces; q += kThreads) {
      const int r = q / kPieces;
      const int c = (q % kPieces) * 8;
      const bool valid = row0 + r < n && k0 + c < n;
      const __nv_bfloat16* src =
          valid ? a + (size_t)(row0 + r) * n + k0 + c : a;
      cp_async16(As + r * kLd + c, src, valid);
    }
  } else {
    const unsigned short* a16 = reinterpret_cast<const unsigned short*>(a);
    unsigned short* s16 = reinterpret_cast<unsigned short*>(As);
    for (int q = threadIdx.x; q < kBM * BK; q += kThreads) {
      const int r = q / BK;
      const int c = q % BK;
      s16[r * kLd + c] = (row0 + r < n && k0 + c < n)
                             ? a16[(size_t)(row0 + r) * n + k0 + c]
                             : (unsigned short)0;
    }
  }
}

// Stage hb[k0 : k0+BK, :FP] into Hs (zeros past N).
template <int FP, int BK>
__device__ __forceinline__ void stage_h(const __nv_bfloat16* __restrict__ hb,
                                        __nv_bfloat16* Hs, int k0, int n) {
  constexpr int kPieces = FP / 8;
  for (int q = threadIdx.x; q < BK * kPieces; q += kThreads) {
    const int k = q / kPieces;
    const int c = (q % kPieces) * 8;
    const bool valid = k0 + k < n;
    cp_async16(Hs + k * (FP + 8) + c,
               valid ? hb + (size_t)(k0 + k) * FP + c : hb, valid);
  }
}

template <int FP>
constexpr size_t main_loop_bytes() {
  // two stages of the A tile and of the h tile, bf16
  return (size_t)2 * 2 *
         ((size_t)kBM * (chunk_cols(FP) + 8) +
          (size_t)chunk_cols(FP) * (FP + 8));
}

template <int FP, bool VEC, bool EPI>
__global__ void __launch_bounds__(kThreads)
dense_kernel(const __nv_bfloat16* __restrict__ a,
             const __nv_bfloat16* __restrict__ hb, const float* __restrict__ h,
             const float* __restrict__ w, const float* __restrict__ root,
             const float* __restrict__ b, float* __restrict__ out,
             float* __restrict__ agg, int n, int F, int H) {
  constexpr int kBK = chunk_cols(FP);
  constexpr int kLdA = kBK + 8;        // staged A row, padded (bf16)
  constexpr int kLdH = FP + 8;         // staged h row, padded (bf16)
  constexpr int kLdC = FP + 4;         // staged agg row (float32)
  constexpr int kNT = FP / 16;         // 16-wide column tiles
  constexpr int kFrags = (kBM / 16) * kNT;
  constexpr int kPerWarp = (kFrags + kWarps - 1) / kWarps;

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* base = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* As[2] = {base, base + kBM * kLdA};
  __nv_bfloat16* Hs[2] = {base + 2 * kBM * kLdA,
                          base + 2 * kBM * kLdA + kBK * kLdH};

  const int row0 = blockIdx.x * kBM;
  const int warp = threadIdx.x / 32;
  const int chunks = (n + kBK - 1) / kBK;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kPerWarp];
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) wmma::fill_fragment(acc[i], 0.f);

  if (VEC) stage_a<kBK, true>(a, As[0], row0, 0, n);
  stage_h<FP, kBK>(hb, Hs[0], 0, n);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    const int s = c & 1;
    if (c + 1 < chunks) {
      if (VEC) stage_a<kBK, true>(a, As[s ^ 1], row0, (c + 1) * kBK, n);
      stage_h<FP, kBK>(hb, Hs[s ^ 1], (c + 1) * kBK, n);
    }
    cp_async_commit();
    if (!VEC) stage_a<kBK, false>(a, As[s], row0, c * kBK, n);
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < kPerWarp; ++i) {
        const int q = warp * kPerWarp + i;
        if (q < kFrags) {
          const int mi = q / kNT;
          const int ni = q % kNT;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fb;
          wmma::load_matrix_sync(fa, As[s] + mi * 16 * kLdA + kk * 16, kLdA);
          wmma::load_matrix_sync(fb, Hs[s] + kk * 16 * kLdH + ni * 16, kLdH);
          wmma::mma_sync(acc[i], fa, fb, acc[i]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: the tile buffers are free; agg goes through shared memory
  float* Cs = reinterpret_cast<float*>(smem);      // [kBM][kLdC]
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int q = warp * kPerWarp + i;
    if (q < kFrags) {
      wmma::store_matrix_sync(Cs + (q / kNT) * 16 * kLdC + (q % kNT) * 16,
                              acc[i], kLdC, wmma::mem_row_major);
    }
  }
  float* Hb = Cs + kBM * kLdC;                     // [kBM][F] rows of h
  float* Ws = Hb + kBM * F;                        // [F][H]
  float* Rs = Ws + F * H;                          // [F][H]
  if (EPI) {
    for (int q = threadIdx.x; q < kBM * F; q += kThreads) {
      const int r = q / F;
      Hb[q] = row0 + r < n ? __ldg(h + (size_t)row0 * F + q) : 0.f;
    }
    for (int q = threadIdx.x; q < F * H; q += kThreads) {
      Ws[q] = __ldg(w + q);
      Rs[q] = __ldg(root + q);
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < kBM * F; q += kThreads) {
    const int r = q / F;
    if (row0 + r < n) agg[(size_t)row0 * F + q] = Cs[r * kLdC + q % F];
  }
  if (EPI) {
    for (int q = threadIdx.x; q < kBM * H; q += kThreads) {
      const int r = q / H;
      const int j = q % H;
      if (row0 + r >= n) continue;
      float s1 = 0.f, s2 = 0.f;
      for (int f = 0; f < F; ++f) {
        s1 = fmaf(Cs[r * kLdC + f], Ws[f * H + j], s1);
        s2 = fmaf(Hb[r * F + f], Rs[f * H + j], s2);
      }
      out[(size_t)row0 * H + q] = fmaxf(s1 + s2 + __ldg(b + j), 0.f);
    }
  }
}

template <int FP>
size_t smem_bytes(bool epi, int F, int H) {
  size_t epilogue = (size_t)kBM * (FP + 4) * 4;
  if (epi) epilogue += ((size_t)kBM * F + (size_t)2 * F * H) * 4;
  return main_loop_bytes<FP>() > epilogue ? main_loop_bytes<FP>() : epilogue;
}

template <int FP, bool VEC, bool EPI>
int launch(const __nv_bfloat16* a, __nv_bfloat16* hb, const float* h,
           const float* w, const float* root, const float* b, float* out,
           float* agg, int n, int F, int H, cudaStream_t s) {
  const size_t smem = smem_bytes<FP>(EPI, F, H);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dense_kernel<FP, VEC, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t total = (size_t)n * FP;
  const int round_blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                           : 4096);
  round_bf16_kernel<<<round_blocks, 256, 0, s>>>(h, hb, n, F, FP);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kBM - 1) / kBM);
  dense_kernel<FP, VEC, EPI><<<grid, kThreads, smem, s>>>(
      a, hb, h, w, root, b, out, agg, n, F, H);
  return (int)cudaGetLastError();
}

template <bool EPI>
int dispatch(const __nv_bfloat16* a, __nv_bfloat16* hb, const float* h,
             const float* w, const float* root, const float* b, float* out,
             float* agg, int n, int F, int H, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (F <= 0 || F > 256 || (EPI && H <= 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = n % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
#define MPGNN_FP(FPV)                                                        \
  if (F <= FPV)                                                              \
    return vec ? launch<FPV, true, EPI>(a, hb, h, w, root, b, out, agg, n,  \
                                        F, H, s)                             \
               : launch<FPV, false, EPI>(a, hb, h, w, root, b, out, agg, n, \
                                         F, H, s);
  MPGNN_FP(16)
  MPGNN_FP(32)
  MPGNN_FP(64)
  MPGNN_FP(128)
  MPGNN_FP(256)
#undef MPGNN_FP
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K3. a: [n, n] bf16; hb: [n, FP] bf16 scratch (FP = F rounded up to 16,
// 32, 64, 128 or 256); h: [n, F]; w, root: [F, H]; b: [H]; out: [n, H];
// agg: [n, F]. F <= 256, and F*H small enough for the epilogue's shared
// memory (F = H = 64 takes 49 KB).
int mpgnn_dense_conv(const void* a, void* hb, const float* h, const float* w,
                     const float* root, const float* b, float* out, float* agg,
                     int n, int F, int H, void* stream) {
  return dispatch<true>(static_cast<const __nv_bfloat16*>(a),
                        static_cast<__nv_bfloat16*>(hb), h, w, root, b, out,
                        agg, n, F, H, stream);
}

const char* mpgnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
