// K2: hub-skew mean aggregation over unique-column tiles.
//
//   out[r, :] = scale[r] * sum over edges (r, c) of x[c, :]
//
// Replaces mpgnn_tpu/ops/pallas_csr.py::_dedup_kernel (launched by
// _dedup_call and _dedup_apply), together with the XLA gather of each
// tile's unique rows that fed it.
//
// Layout (built by mpgnn_tpu_torch/ops/csr.py::_build_one_direction_dedup):
// rows are cut into blocks of `block_rows`. A block's edges are cut into
// tiles of at most `uniq` distinct gather columns; tile t lists its columns
// in uniq_col[tile_uniq_ptr[t] .. tile_uniq_ptr[t+1]) and every edge of the
// tile names its column by a slot into that list. Inside a tile the edges
// are sorted by output row and cut into segments (seg_row, seg_ptr): one per
// row, except that a long row is cut into up to 32 consecutive segments of
// at least 32 edges each. The tiles of block b are
// block_tile_ptr[b] .. block_tile_ptr[b+1].
//
// Bound on the H100: bytes. Each tile reads its unique rows once
// (sum over tiles of the unique count, times F*4 bytes) instead of one row
// per edge, plus 4 bytes of slot per edge and the segment tables, and
// writes N*F*4 bytes. The fan-out to edges reads shared memory, not device
// memory.
//
// Design. One CTA owns one row block and one chunk of at most kMaxCols
// columns, and walks the block's tiles in order:
//   1. it stages the tile's unique rows in shared memory
//      (uniq * 64 * 4 = 128 KB at the widest chunk, set with
//      cudaFuncSetAttribute), which is the TPU kernel's [U, F] VMEM operand;
//   2. in rounds, each group of `tpr` threads takes one segment, sums its
//      staged rows in registers (compensated) and leaves the sum in shared
//      memory; then the group holding a row's first segment of the round
//      adds that row's sums in order, times scale[row], into the output row.
// Cutting long rows spreads a hub row (80k edges in the power-law KG) over
// all groups instead of one. A row is written by one thread group per round
// and rounds and tiles are separated by __syncthreads: no atomics, and the
// sum order is fixed by the layout, so results are deterministic. The CTA
// zeroes its rows first, so rows without edges, and blocks without tiles,
// come out as 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxCols = 64;                 // columns per CTA chunk
constexpr int kCols = 4;                     // columns per thread

// compensated (Kahan) step acc += v: a segment of a hub row runs to
// thousands of edges, where a plain float32 sum drifts by more than 1e-5
__device__ __forceinline__ void kahan(float& acc, float& comp, float v) {
  const float y = v - comp;
  const float t = acc + y;
  comp = (t - acc) - y;
  acc = t;
}

__global__ void __launch_bounds__(kThreads)
csr_dedup_kernel(const int* __restrict__ block_tile_ptr,
                 const int* __restrict__ tile_uniq_ptr,
                 const int* __restrict__ uniq_col,
                 const int* __restrict__ tile_seg_ptr,
                 const int* __restrict__ seg_row,
                 const int* __restrict__ seg_ptr,
                 const int* __restrict__ slot,
                 const float* __restrict__ scale,
                 const float* __restrict__ x, float* __restrict__ out,
                 int num_rows, int block_rows, int F, int uniq, int fc_max,
                 int tpr) {
  extern __shared__ float smem[];
  float* staged = smem;                              // [uniq][fc_max]
  float* partial = smem + (size_t)uniq * fc_max;     // [groups][kCols][tpr]
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * fc_max;
  const int fc = min(fc_max, F - c0);
  const int r0 = b * block_rows;
  const int nr = min(block_rows, num_rows - r0);

  for (int i = threadIdx.x; i < nr * fc; i += blockDim.x) {
    out[(size_t)(r0 + i / fc) * F + c0 + i % fc] = 0.f;
  }
  __syncthreads();

  const int group = threadIdx.x / tpr;
  const int lane = threadIdx.x % tpr;
  const int ngroups = blockDim.x / tpr;
  float* mine = partial + group * kCols * tpr + lane;
  for (int t = block_tile_ptr[b]; t < block_tile_ptr[b + 1]; ++t) {
    const int u0 = tile_uniq_ptr[t];
    const int nu = tile_uniq_ptr[t + 1] - u0;
#pragma unroll 4
    for (int i = threadIdx.x; i < nu * fc; i += blockDim.x) {
      const int u = i / fc, c = i - u * fc;
      staged[u * fc_max + c] =
          __ldg(x + (size_t)__ldg(uniq_col + u0 + u) * F + c0 + c);
    }
    __syncthreads();
    const int s1 = tile_seg_ptr[t + 1];
    for (int base = tile_seg_ptr[t]; base < s1; base += ngroups) {
      // round: one segment per group, its partial sum to shared memory
      const int s = base + group;
      if (s < s1) {
        float acc[kCols], comp[kCols];
#pragma unroll
        for (int k = 0; k < kCols; ++k) acc[k] = comp[k] = 0.f;
        const int e1 = seg_ptr[s + 1];
        int e = seg_ptr[s];
        for (; e + 4 <= e1; e += 4) {            // four slot loads in flight
          const float* q0 = staged + __ldg(slot + e) * fc_max;
          const float* q1 = staged + __ldg(slot + e + 1) * fc_max;
          const float* q2 = staged + __ldg(slot + e + 2) * fc_max;
          const float* q3 = staged + __ldg(slot + e + 3) * fc_max;
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            const int c = lane + k * tpr;
            if (c < fc) {
              kahan(acc[k], comp[k], q0[c]);
              kahan(acc[k], comp[k], q1[c]);
              kahan(acc[k], comp[k], q2[c]);
              kahan(acc[k], comp[k], q3[c]);
            }
          }
        }
        for (; e < e1; ++e) {
          const float* q = staged + __ldg(slot + e) * fc_max;
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            const int c = lane + k * tpr;
            if (c < fc) kahan(acc[k], comp[k], q[c]);
          }
        }
#pragma unroll
        for (int k = 0; k < kCols; ++k) mine[k * tpr] = acc[k];
      }
      __syncthreads();
      // the group holding a row's first segment of the round adds the
      // round's partials of that row, in order, into the output row
      if (s < s1 && (s == base || seg_row[s - 1] != seg_row[s])) {
        const int row = seg_row[s];
        float sum[kCols];
#pragma unroll
        for (int k = 0; k < kCols; ++k) sum[k] = mine[k * tpr];
        for (int g = group + 1; g < ngroups && base + g < s1 &&
                                seg_row[base + g] == row; ++g) {
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            sum[k] += partial[(g * kCols + k) * tpr + lane];
          }
        }
        const float sc = scale != nullptr ? scale[r0 + row] : 1.f;
        float* orow = out + (size_t)(r0 + row) * F + c0;
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          const int c = lane + k * tpr;
          if (c < fc) orow[c] += sc * sum[k];
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" {

// scale may be null (no post-scale). Rows are [num_rows, F], x is
// [num_gather_rows, F], both float32 and contiguous.
int mpgnn_csr_dedup(const int* block_tile_ptr, const int* tile_uniq_ptr,
                    const int* uniq_col, const int* tile_seg_ptr,
                    const int* seg_row, const int* seg_ptr, const int* slot,
                    const float* scale, const float* x, float* out,
                    int num_rows, int block_rows, int F, int uniq,
                    void* stream) {
  if (num_rows <= 0 || F <= 0) return (int)cudaSuccess;
  const int fc_max = F < kMaxCols ? F : kMaxCols;
  int tpr = 1;                                 // tpr * kCols >= fc_max
  while (tpr * kCols < fc_max) tpr <<= 1;
  const size_t smem = ((size_t)uniq * fc_max + (size_t)kThreads * kCols) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      csr_dedup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((num_rows + block_rows - 1) / block_rows,
                  (F + fc_max - 1) / fc_max);
  csr_dedup_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      block_tile_ptr, tile_uniq_ptr, uniq_col, tile_seg_ptr, seg_row, seg_ptr,
      slot, scale, x, out, num_rows, block_rows, F, uniq, fc_max, tpr);
  return (int)cudaGetLastError();
}

const char* mpgnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
