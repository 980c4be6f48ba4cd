// K3 and K4: the dense RelConv, forward and backward, on one main loop.
//
//   K4: out = A @ bf16(x)          A: [n, n] bf16 (row stride lda), x: [n, F]
//                                  float32, out: [n, F] float32 (float32 sums)
//   K3: agg = A @ bf16(h)          the same product over A = a, then
//       out = relu(agg @ W + h @ root + b)   W, root: [F, H], b: [H] float32
//       h float32, or bf16 (mpgnn_dense_conv_bf16h: the hop 0 of a
//       compute_dtype='bfloat16' run, whose h is the bf16 input features);
//       agg and out float32 either way, as the JAX kernel's are.
//
// K4 replaces mpgnn_tpu/ops/pallas_conv.py::_matmul_kernel (launched by
// _blocked_matmul in _conv_vjp_bwd, with A = the transposed adjacency a_t);
// K3 replaces pallas_conv.py::_conv_kernel (launched by _conv_fwd_impl, with
// A = the adjacency a). Both operands are built by
// mpgnn_tpu_torch/ops/conv.py::build_dense_conv_operand.
//
// Bound on the H100: bytes of A, read once (n*n*2 bytes: 50 MB at
// n = 5,000, 2.1 GB at n = 32,768). The product, 2*n*n*F operations, takes
// a fifth of A's time at the bf16 tensor-core rate at F = 64; K3's
// epilogue adds 4*n*F*H float32 operations and a few n*F*4-byte passes.
//
// Design of the main loop (sm_90a), shared by K3 and K4:
//   * a pre-pass rounds x to bf16 with __float2bfloat16_rn (JAX's
//     x.astype(bfloat16)) into a scratch xt [FP, np] that the wrapper
//     allocates: transposed, so that both operands are K-major, FP = F
//     rounded up to 64, 128, 192 or 256 and np = n rounded up to 8, the
//     extra rows and columns zero;
//   * a CTA owns 128 rows of A and one of `splits` equal ranges of the
//     reduction (64-column tiles), so that every SM gets a CTA (at
//     n = 5,000: 40 row blocks x 3 splits) and each reads only its share of
//     xt;
//   * one producer thread keeps a ring of 4 stages full with TMA copies
//     (A tile [128, 64] and xt tile [FP, 64], 128-byte swizzle, rows and
//     columns past n zero-filled by the copy engine), guarded by a full and
//     an empty mbarrier per stage;
//   * two consumer warpgroups, 64 rows each, run wgmma m64n64k16 bf16 ->
//     float32 (FP / 64 products per 16 columns) straight from the swizzled
//     tiles and release the stage when their products are done. Products of
//     two bf16 values are exact in float32, so this differs from float32
//     FMA on the rounded values only in the order of the sum;
//   * with splits > 1 each CTA writes its float32 sums to a scratch
//     [splits, n, F] and a last pass adds the splits in order: no atomics,
//     and the sum order is fixed, so results are deterministic. (A cluster
//     per row block adding the splits through distributed shared memory
//     measured slower on the H100 than this pass, and was not kept.)
// The last pass differs: K4's adds the splits into out; K3's epilogue
// (conv_epilogue_kernel, one CTA per 32 rows and 64 output columns, 16
// where H % 4 != 0) adds them in the same order (or reads the single
// split, which the main loop wrote into agg), writes agg, and writes
// relu((agg @ W + h @ root) + b) with float32 FMA, every output once. It
// stages 32 rows of f at a time (the block's agg and h transposed, W's and
// root's rows for its columns), so its shared memory (25 KB) does not grow
// with F or H.
// K3 takes any F, as the JAX kernel does: where F > 256 its main loop runs
// once a slice of at most 256 columns of h, each slice streaming A once
// into its columns of agg (or of the split scratch); K4 takes F <= 256 and
// its wrapper slices wider operands.
// TMA needs a 16-byte row stride: A's row stride lda must be a multiple of
// 8 elements. build_dense_conv_operand pads the storage of a and a_t to
// such a stride when n is not a multiple of 8 (each is then a view of its
// first n columns), and the wrappers refuse any other operand.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 128;                       // rows of A per CTA
constexpr int kBK = 64;                        // reduction columns per stage
constexpr int kStages = 4;
constexpr int kConsumers = 2;                  // warpgroups of 64 rows
constexpr int kThreads = kConsumers * 128 + 32;  // + one producer warp
constexpr int kATile = kBM * kBK * 2;          // 16 KB
constexpr int kMaxSmem = 232448;
constexpr int kMaxWidth = 256;                 // columns of x a main loop

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte rows and
// the 128-byte swizzle, 1024-byte aligned: 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator accesses across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 64] += A[64 x 16] @ B[16 x 64], both K-major in shared memory
__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// a float32 value of x: float32 as it is, bf16 widened (exact)
__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __uint_as_float(
      (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// xt[f, k] = bf16(x[k, f]) for f < F, k < n (x's rows ldx apart); 0
// elsewhere in [FP, np]. For a bf16 x the rounding keeps every value: the
// pre-pass only transposes.
template <typename In>
__global__ void round_bf16_t_kernel(const In* __restrict__ x, int ldx,
                                    __nv_bfloat16* __restrict__ xt, int n,
                                    int F, int FP, int np) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, f0 = blockIdx.y * 32;
  for (int j = threadIdx.y; j < 32; j += blockDim.y) {
    const int k = k0 + j, f = f0 + threadIdx.x;
    tile[j][threadIdx.x] =
        k < n && f < F ? load_f(x + (size_t)k * ldx + f) : 0.f;
  }
  __syncthreads();
  for (int j = threadIdx.y; j < 32; j += blockDim.y) {
    const int f = f0 + j, k = k0 + threadIdx.x;
    if (f < FP && k < np) {
      xt[(size_t)f * np + k] = __float2bfloat16_rn(tile[threadIdx.x][j]);
    }
  }
}

template <int FP>
__host__ __device__ constexpr int stage_bytes() {
  return kATile + FP * kBK * 2;
}

template <int FP>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)kStages * stage_bytes<FP>() + 2 * kStages * 8 + 1024;
}

// out[split][row, col] for col < F, rows ldo apart and splits
// split_stride apart
template <int FP>
__global__ void __launch_bounds__(kThreads, 1)
dense_matmul_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    float* __restrict__ out, int ldo, size_t split_stride,
                    int n, int F, int k_tiles, int splits) {
  constexpr int kStage = stage_bytes<FP>();
  constexpr int kNT = FP / 64;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStage);
  uint64_t* empty = full + kStages;

  const int row0 = blockIdx.x * kBM;
  const int split = blockIdx.y;
  const int t0 = (int)((long long)split * k_tiles / splits);
  const int nt = (int)((long long)(split + 1) * k_tiles / splits) - t0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // producer: one thread issues every copy
    if (threadIdx.x == kConsumers * 128) {
      for (int i = 0; i < nt; ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        uint8_t* st = smem + s * kStage;
        mbar_expect_tx(&full[s], kStage);
        const int k0 = (t0 + i) * kBK;
        tma_load_2d(st, &map_a, &full[s], k0, row0);
        tma_load_2d(st + kATile, &map_b, &full[s], k0, 0);
      }
    }
    return;
  }

  float acc[kNT][32];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  }
  for (int i = 0; i < nt; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    const uint8_t* st = smem + s * kStage;
    const uint64_t da = sw128_desc(st + wg * 64 * 128);
    const uint64_t db = sw128_desc(st + kATile);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        // 16 columns are 32 bytes (2 in the descriptor's 16-byte units);
        // 64 rows of the xt tile are 8 KB
        wgmma_64x64(acc[j], da + 2 * kk, db + (uint64_t)j * 512 + 2 * kk);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < kNT; ++j) fence_acc(acc[j]);
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
  }

  // accumulator layout of m64nNk16: register i of lane l in warp wi of the
  // warpgroup holds row 16*wi + l/4 + 8*((i/2)%2), column 8*(i/4) +
  // 2*(l%4) + i%2
  float* dst = out + split * split_stride;
  const bool pairs = F % 2 == 0 && ldo % 2 == 0 && split_stride % 2 == 0;
  const int wi = (threadIdx.x % 128) / 32, l = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = row0 + wg * 64 + wi * 16 + (l >> 2) + 8 * ((i >> 1) & 1);
      const int col = j * 64 + 8 * (i >> 2) + 2 * (l & 3);
      if (row >= n) continue;
      float* p = dst + (size_t)row * ldo + col;
      if (pairs && col < F) {
        *reinterpret_cast<float2*>(p) = make_float2(acc[j][i], acc[j][i + 1]);
      } else {
        if (col < F) p[0] = acc[j][i];
        if (col + 1 < F) p[1] = acc[j][i + 1];
      }
    }
  }
}

// out[i] = sum over s of part[s * total + i], s in order (16 bytes a
// thread when total % 4 == 0)
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, size_t total,
                                  int splits) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  const size_t first = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (total % 4 == 0) {
    const size_t n4 = total / 4;
    const float4* p4 = reinterpret_cast<const float4*>(part);
    for (size_t i = first; i < n4; i += stride) {
      float4 a = __ldg(p4 + i);
      for (int s = 1; s < splits; ++s) {
        const float4 b = __ldg(p4 + s * n4 + i);
        a.x += b.x;
        a.y += b.y;
        a.z += b.z;
        a.w += b.w;
      }
      reinterpret_cast<float4*>(out)[i] = a;
    }
    return;
  }
  for (size_t i = first; i < total; i += stride) {
    float a = __ldg(part + i);
    for (int s = 1; s < splits; ++s) a += __ldg(part + s * total + i);
    out[i] = a;
  }
}

constexpr int kEpiRows = 32;      // rows of K3's epilogue per CTA
constexpr int kEpiThreads = 128;
constexpr int kEpiF = 32;         // rows of f staged at a time
constexpr int kEpiLd = kEpiRows + 4;   // transposed tile row, 16-byte aligned
constexpr int kEpiLoads = kEpiRows * kEpiF / kEpiThreads;  // loads a thread

// output columns of an epilogue CTA: 16 threads across, CW columns each
template <int CW>
__host__ __device__ constexpr int epilogue_cols() {
  return 16 * CW;
}

// K3's epilogue over rows [32 * blockIdx.x, +32) and output columns
// [HT * blockIdx.y, +HT), HT = 16 * CW: agg = the splits of part added in
// split order (part is agg itself when splits == 1; the CTAs of column
// block 0 write it), then out = relu((agg @ w + h @ root) + b), each sum a
// float32 FMA chain over f in order. f goes by in chunks of 32: the
// chunk's columns of the block's rows of agg and h are read 128 bytes a
// row, 8 loads in flight a thread, and stored transposed (a bf16 h
// widened to float32, as the JAX kernel's jnp.dot(hblk, root,
// preferred_element_type=f32) takes it), beside the chunk's rows of w and
// root for the CTA's columns. A thread takes 4 rows by CW columns (4 where
// H % 4 == 0) and keeps its sums in registers across the chunks, so that
// each step over f reads shared memory 16 bytes at a time for 8 * CW FMAs
// and every output's chain runs over f = 0, 1, ..., F - 1 whatever F is.
template <typename HIn, int CW>
__global__ void __launch_bounds__(kEpiThreads)
conv_epilogue_kernel(const float* part, const HIn* __restrict__ h,
                     const float* __restrict__ w,
                     const float* __restrict__ root,
                     const float* __restrict__ b, float* __restrict__ out,
                     float* agg, int n, int F, int H, int splits) {
  constexpr int HT = epilogue_cols<CW>();
  constexpr int kWLoads = 8;
  __shared__ __align__(16) float Ct[kEpiF][kEpiLd];  // agg, transposed
  __shared__ __align__(16) float Ht[kEpiF][kEpiLd];  // h, transposed
  __shared__ __align__(16) float Ws[kEpiF][HT];
  __shared__ __align__(16) float Rs[kEpiF][HT];
  const int row0 = blockIdx.x * kEpiRows, col0 = blockIdx.y * HT;
  const int rows = min(kEpiRows, n - row0), cols = min(HT, H - col0);
  const size_t total = (size_t)n * F;
  const bool write_agg = splits > 1 && blockIdx.y == 0;
  const int r0 = (threadIdx.x / 16) * 4, j0 = (threadIdx.x % 16) * CW;
  const bool mine = r0 < rows && j0 < cols;
  float s1[4][CW], s2[4][CW];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int j = 0; j < CW; ++j) s1[k][j] = s2[k][j] = 0.f;
  }
  for (int f0 = 0; f0 < F; f0 += kEpiF) {
    const int kf = min(kEpiF, F - f0);
    float a[kEpiLoads], hv[kEpiLoads];
    size_t at[kEpiLoads];
    bool ok[kEpiLoads];
#pragma unroll
    for (int u = 0; u < kEpiLoads; ++u) {
      const int q = threadIdx.x + u * kEpiThreads;
      const int r = q / kEpiF, fi = q % kEpiF;
      ok[u] = r < rows && fi < kf;
      at[u] = (size_t)(row0 + r) * F + f0 + fi;
      a[u] = ok[u] ? part[at[u]] : 0.f;
      hv[u] = ok[u] ? load_f(h + at[u]) : 0.f;
    }
    for (int s = 1; s < splits; ++s) {
#pragma unroll
      for (int u = 0; u < kEpiLoads; ++u) {
        if (ok[u]) a[u] += part[s * total + at[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < kEpiLoads; ++u) {
      const int q = threadIdx.x + u * kEpiThreads;
      if (write_agg && ok[u]) agg[at[u]] = a[u];
      Ct[q % kEpiF][q / kEpiF] = a[u];
      Ht[q % kEpiF][q / kEpiF] = hv[u];
    }
    for (int q0 = threadIdx.x; q0 < kEpiF * HT;
         q0 += kWLoads * kEpiThreads) {
      float wv[kWLoads], rv[kWLoads];
#pragma unroll
      for (int u = 0; u < kWLoads; ++u) {
        const int q = q0 + u * kEpiThreads;
        const int fi = q / HT, j = q % HT;
        const bool in = q < kEpiF * HT && fi < kf && j < cols;
        const size_t off = (size_t)(f0 + fi) * H + col0 + j;
        wv[u] = in ? __ldg(w + off) : 0.f;
        rv[u] = in ? __ldg(root + off) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kWLoads; ++u) {
        const int q = q0 + u * kEpiThreads;
        if (q < kEpiF * HT) {
          Ws[q / HT][q % HT] = wv[u];
          Rs[q / HT][q % HT] = rv[u];
        }
      }
    }
    __syncthreads();
    if (mine) {
#pragma unroll 4
      for (int fi = 0; fi < kf; ++fi) {
        const float4 c = *reinterpret_cast<const float4*>(&Ct[fi][r0]);
        const float4 hh = *reinterpret_cast<const float4*>(&Ht[fi][r0]);
        const float ca[4] = {c.x, c.y, c.z, c.w};
        const float ha[4] = {hh.x, hh.y, hh.z, hh.w};
        float wv[CW], rv[CW];
        if constexpr (CW == 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(&Ws[fi][j0]);
          const float4 r4 = *reinterpret_cast<const float4*>(&Rs[fi][j0]);
          wv[0] = w4.x, wv[1] = w4.y, wv[2] = w4.z, wv[3] = w4.w;
          rv[0] = r4.x, rv[1] = r4.y, rv[2] = r4.z, rv[3] = r4.w;
        } else {
          wv[0] = Ws[fi][j0];
          rv[0] = Rs[fi][j0];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int j = 0; j < CW; ++j) {
            s1[k][j] = fmaf(ca[k], wv[j], s1[k][j]);
            s2[k][j] = fmaf(ha[k], rv[j], s2[k][j]);
          }
        }
      }
    }
    __syncthreads();
  }
  if (!mine) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (r0 + k >= rows) break;
    float* o = out + (size_t)(row0 + r0 + k) * H + col0 + j0;
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      o[j] = fmaxf(s1[k][j] + s2[k][j] + __ldg(b + col0 + j0 + j), 0.f);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime so that
// the library needs no link against libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// a 2-D bf16 map of [rows, cols] with row stride `stride` elements, copied
// in boxes of [box_rows, 64] with the 128-byte swizzle
bool make_map(CUtensorMap* map, const void* base, int rows, int cols,
              int stride, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)stride * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the bf16 pre-pass and the main loop: A @ bf16(x) for x [n, F] (rows ldx
// apart) into dst (rows ldo apart, splits split_stride apart when
// splits > 1)
template <int FP, typename In>
int main_loop(const void* a, int lda, __nv_bfloat16* xt, const In* x,
              int ldx, float* dst, int ldo, size_t split_stride, int n,
              int F, int splits, cudaStream_t s) {
  const int np = (n + 7) / 8 * 8;
  const dim3 tgrid((np + 31) / 32, FP / 32);
  round_bf16_t_kernel<In><<<tgrid, dim3(32, 8), 0, s>>>(x, ldx, xt, n, F,
                                                        FP, np);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, a, n, n, lda, kBM) ||
      !make_map(&map_b, xt, FP, np, np, FP)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes<FP>();
  static_assert(smem_bytes<FP>() <= (size_t)kMaxSmem, "stages too large");
  err = cudaFuncSetAttribute(dense_matmul_kernel<FP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int k_tiles = (n + kBK - 1) / kBK;
  const dim3 grid((n + kBM - 1) / kBM, splits);
  dense_matmul_kernel<FP><<<grid, kThreads, smem, s>>>(
      map_a, map_b, dst, ldo, split_stride, n, F, k_tiles, splits);
  return (int)cudaGetLastError();
}

// F's tile width: one to four 64-wide wgmma products
template <typename Fn>
int by_width(int F, Fn&& fn) {
  if (F <= 64) return fn(std::integral_constant<int, 64>());
  if (F <= 128) return fn(std::integral_constant<int, 128>());
  if (F <= 192) return fn(std::integral_constant<int, 192>());
  return fn(std::integral_constant<int, 256>());
}

bool valid(const void* a, int lda, int n, int splits) {
  return lda >= n && lda % 8 == 0 &&
         reinterpret_cast<uintptr_t>(a) % 16 == 0 && splits >= 1 &&
         splits <= (n + kBK - 1) / kBK;
}

// K3 with h of type HIn (float32, or bf16 at the hop 0 of a bf16 run):
// the main loop once a slice of at most kMaxWidth columns of h, then the
// epilogue over every column
template <typename HIn>
int dense_conv(const void* a, int lda, void* xt, const HIn* h,
               const float* w, const float* root, const float* b, float* out,
               float* agg, float* part, int n, int F, int H, int splits,
               void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (F <= 0 || H <= 0 || !valid(a, lda, n, splits)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* xb = static_cast<__nv_bfloat16*>(xt);
  float* dst = splits > 1 ? part : agg;
  for (int c0 = 0; c0 < F; c0 += kMaxWidth) {
    const int fs = F - c0 < kMaxWidth ? F - c0 : kMaxWidth;
    const int err = by_width(fs, [&](auto fp) {
      return main_loop<decltype(fp)::value>(a, lda, xb, h + c0, F, dst + c0,
                                            F, (size_t)n * F, n, fs, splits,
                                            s);
    });
    if (err != 0) return err;
  }
  const bool quads = H % 4 == 0;
  const int cols = quads ? epilogue_cols<4>() : epilogue_cols<1>();
  const dim3 grid((n + kEpiRows - 1) / kEpiRows, (H + cols - 1) / cols);
  auto epilogue = quads ? conv_epilogue_kernel<HIn, 4>
                        : conv_epilogue_kernel<HIn, 1>;
  epilogue<<<grid, kEpiThreads, 0, s>>>(dst, h, w, root, b, out, agg, n, F,
                                        H, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a: [n, n] bf16 with row stride lda (a multiple of 8, 16-byte aligned
// base); xt: bf16 scratch [FP, np] (FP = F rounded up to 64, 128, 192 or
// 256, np = n rounded up to 8); x, out: [n, F] float32, contiguous;
// part: float32 scratch [splits, n, F], unused when splits == 1.
// 1 <= splits <= ceil(n / 64), F <= 256.
int mpgnn_dense_matmul(const void* a, int lda, void* xt, const float* x,
                       float* out, float* part, int n, int F, int splits,
                       void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (F <= 0 || F > kMaxWidth || !valid(a, lda, n, splits)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* xb = static_cast<__nv_bfloat16*>(xt);
  const int err = by_width(F, [&](auto fp) {
    return main_loop<decltype(fp)::value>(a, lda, xb, x, F,
                                          splits > 1 ? part : out, F,
                                          (size_t)n * F, n, F, splits, s);
  });
  if (err != 0 || splits == 1) return err;
  const size_t total = (size_t)n * F;
  const size_t blocks = (total / 4 + 255) / 256;
  sum_splits_kernel<<<(int)(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096),
                      256, 0, s>>>(part, out, total, splits);
  return (int)cudaGetLastError();
}

// K3. a: [n, n] bf16 with row stride lda, as for K4; xt: bf16 scratch
// [FP, np] of the widest slice (FP = min(F, 256) rounded up as for K4);
// part and splits as for K4; h, agg: [n, F]; w, root: [F, H]; b: [H];
// out: [n, H], all float32 and contiguous. Any F > 0 and H > 0.
int mpgnn_dense_conv(const void* a, int lda, void* xt, const float* h,
                     const float* w, const float* root, const float* b,
                     float* out, float* agg, float* part, int n, int F, int H,
                     int splits, void* stream) {
  return dense_conv(a, lda, xt, h, w, root, b, out, agg, part, n, F, H,
                    splits, stream);
}

// K3 with a bf16 h ([n, F], contiguous), everything else as above: agg and
// out float32, h @ root summed in float32 over the widened bf16 values.
int mpgnn_dense_conv_bf16h(const void* a, int lda, void* xt, const void* h,
                           const float* w, const float* root, const float* b,
                           float* out, float* agg, float* part, int n, int F,
                           int H, int splits, void* stream) {
  return dense_conv(a, lda, xt, static_cast<const __nv_bfloat16*>(h), w, root,
                    b, out, agg, part, n, F, H, splits, stream);
}

const char* mpgnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
