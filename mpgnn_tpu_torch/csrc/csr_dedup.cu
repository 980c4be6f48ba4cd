// K2: hub-skew mean aggregation, load-balanced over edges.
//
//   out[r, :] = post[r] * sum over edges (r, c) of pre[c] * x[c, :]
//
// (forward: post = 1/deg(r), no pre; backward: pre = 1/deg(c), no post.)
// Replaces mpgnn_tpu/ops/pallas_csr.py::_dedup_kernel (launched by
// _dedup_call and _dedup_apply), together with the XLA gather of each
// tile's unique rows that fed it.
//
// Layout (built by mpgnn_tpu_torch/ops/csr.py::_build_one_direction_dedup):
// items are the edges [0, E), sorted by row and then column, whose gathered
// rows are x[col[i]], followed by partial sums E + s (row s of the scratch
// `part`). Piece p sums items piece_ptr[p] .. piece_ptr[p+1] (1 to 64 of
// them) and writes the sum to output row piece_dest[p] (scaled by post) if
// that is >= 0, else to partial slot -1 - piece_dest[p]. Pass 0's pieces cut
// the edges of every row that has any; a row of several pieces is cut
// again, over its partial slots, by pass 1, and so on until each row has
// one piece: a hub row of 80k edges takes three passes (80k -> 1,262 -> 20
// -> 1). Pass 0 also writes the rows without edges (zero_rows) as 0, so
// every row is written exactly once.
//
// Bound on the H100: bytes. Each edge reads one gathered row (E*F*4 bytes,
// mostly from the 50 MB L2, where x stays during a serve refresh), its
// column index and, with pre, one scale; each output row is written once
// (N*F*4 bytes). The partial sums of cut rows are a few MB at most.
//
// Design. The TPU kernel staged each tile's unique rows in VMEM to spare
// XLA's gather issue rate; one CTA per row block then walked the hub
// block's 26 tiles alone. Here the work is cut by edges, not by rows:
//   * one group of `tpr` threads (lanes over columns, 16 bytes each where F
//     is a multiple of 4) sums one piece: tens of thousands of groups are in
//     flight, and none waits on more than 64 items. It loads 8 rows at
//     once (predicated at the piece's end) while the next 8 column indices
//     load, into two independent compensated (Kahan) sums, so a piece
//     costs about one round trip to L2 per 8 edges;
//   * gathered rows are read through L1 and L2 directly, with no shared
//     memory: many CTAs fit on an SM, and repeats of a hub column inside a
//     CTA hit L1;
//   * extra CTAs of pass 0 write the rows without edges (most of a hub
//     relation's rows) alongside the pieces;
//   * a cut row's partials are added by the next pass in slot order, one
//     launch per pass on one stream: no atomics and no block-wide barrier,
//     and the sum order is fixed by the layout, so two launches on the same
//     input give bitwise-equal output.
//
// The bf16 form (mpgnn_csr_dedup_bf16) reads and writes bf16 rows for the
// JAX package's compute_dtype='bfloat16' csr hops (which cast to float32
// and back around the Pallas kernel): 8 bf16 values (16 bytes) a lane
// where F is a multiple of 8, widened to float32 exactly and summed as
// above (rows.cuh); the partial slots stay float32, and an output row is
// rounded to bf16 once, by the piece that writes it.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;          // items whose loads are in flight at once
constexpr int kMaxZeroCtas = 264;  // CTAs writing the rows without edges

// One pass: pieces p0 .. p1-1, one group each, in CTAs zero_ctas and up;
// CTAs below zero_ctas write the rows without edges. `part` is read (slots
// of the previous pass) and written (slots of this pass) through plain loads
// and stores: the two slot ranges are disjoint.
template <typename In, int VEC>
__global__ void __launch_bounds__(kThreads, 3)
csr_dedup_kernel(const int* __restrict__ piece_ptr,
                 const int* __restrict__ piece_dest,
                 const int* __restrict__ col, const float* __restrict__ pre,
                 const float* __restrict__ post, const In* __restrict__ x,
                 float* part, In* __restrict__ out,
                 const int* __restrict__ zero_rows, int num_zero,
                 int zero_ctas,
                 int p0, int p1, int num_edges, int F, int tpr) {
  using V = Row<In, VEC>;
  using T = typename V::T;
  using Raw = typename V::Raw;
  if ((int)blockIdx.x < zero_ctas) {
    const int slots = F / VEC;
    const size_t total = (size_t)num_zero * slots;
#pragma unroll 4
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
         i += (size_t)zero_ctas * blockDim.x) {
      const int r = __ldg(zero_rows + i / slots);
      V::store(out + (size_t)r * F + (i % slots) * VEC, V::zero());
    }
    return;
  }
  const int p = p0 + (blockIdx.x - zero_ctas) * (blockDim.x / tpr) +
                threadIdx.x / tpr;
  const int lane = threadIdx.x % tpr;
  if (p >= p1) return;
  const int i0 = __ldg(piece_ptr + p);
  const int i1 = __ldg(piece_ptr + p + 1);
  const int d = __ldg(piece_dest + p);
  const float sc = d >= 0 && post != nullptr ? __ldg(post + d) : 1.f;
  for (int c = lane * VEC; c < F; c += tpr * VEC) {
    T acc[2] = {V::zero(), V::zero()};
    T comp[2] = {V::zero(), V::zero()};
    if (i0 < num_edges) {                   // edges: gather x[col]
      int cc[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        cc[k] = i0 + k < i1 ? __ldg(col + i0 + k) : -1;
      }
      for (int i = i0; i < i1; i += kBatch) {
        float s[kBatch];
        Raw v[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          s[k] = 0.f;
          v[k] = V::raw_zero();
          if (cc[k] >= 0) {
            s[k] = pre != nullptr ? __ldg(pre + cc[k]) : 1.f;
            v[k] = V::load(x + (size_t)cc[k] * F + c);
          }
        }
        // the next batch's column indices load while these rows arrive
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int j = i + kBatch + k;
          cc[k] = j < i1 ? __ldg(col + j) : -1;
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          V::add(acc[k % 2], comp[k % 2], s[k], v[k]);
        }
      }
    } else {                                // partial sums, contiguous
      const float* src = part + (size_t)(i0 - num_edges) * F + c;
      const int m = i1 - i0;
      for (int i = 0; i < m; i += kBatch) {
        T v[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          v[k] = i + k < m ? V::load_f32_rw(src + (size_t)(i + k) * F)
                           : V::zero();
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          V::add_f32(acc[k % 2], comp[k % 2], 1.f, v[k]);
        }
      }
    }
    // an output row is written once, by its last piece; partial sums stay
    // float32
    if (d >= 0) {
      V::store(out + (size_t)d * F + c, V::sum2(acc, comp, sc));
    } else {
      V::store_f32(part + (size_t)(-1 - d) * F + c, V::sum2(acc, comp, sc));
    }
  }
}

int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// every pass of the layout, the kernel of form In at VEC
template <typename In, int VEC>
int passes(const int* piece_ptr, const int* piece_dest, const int* col,
           const float* pre, const float* post, const In* x, float* part,
           In* out, const int* zero_rows, int num_zero,
           const int* level_pieces, int num_levels, int num_edges, int F,
           cudaStream_t s) {
  const int chunks = F / VEC;
  const int tpr = chunks < 32 ? pow2_at_least(chunks) : 32;
  const int groups_per_cta = kThreads / tpr;
  for (int l = 0; l < num_levels; ++l) {
    const int p0 = level_pieces[l], p1 = level_pieces[l + 1];
    const long long zero_slots = l == 0 ? (long long)num_zero * chunks : 0;
    const int zero_ctas = (int)std::min<long long>(
        kMaxZeroCtas, (zero_slots + kThreads - 1) / kThreads);
    const int grid =
        zero_ctas + (p1 - p0 + groups_per_cta - 1) / groups_per_cta;
    if (grid == 0) continue;
    csr_dedup_kernel<In, VEC><<<grid, kThreads, 0, s>>>(
        piece_ptr, piece_dest, col, pre, post, x, part, out, zero_rows,
        num_zero, zero_ctas, p0, p1, num_edges, F, tpr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// level_pieces is a HOST array of num_levels + 1 piece offsets
// (num_levels >= 1); pass l runs pieces level_pieces[l] ..
// level_pieces[l+1], after pass l-1 on the same stream, and pass 0 also
// writes zero_rows.
// pre and post may be null. x is [num_gather_rows, F], out [num_rows, F],
// part [num_partials, F], all float32 and contiguous; vec is 4 when
// F % 4 == 0 and x is 16-byte aligned, else 1.
int mpgnn_csr_dedup(const int* piece_ptr, const int* piece_dest,
                    const int* col, const float* pre, const float* post,
                    const float* x, float* part, float* out,
                    const int* zero_rows, int num_zero,
                    const int* level_pieces, int num_levels, int num_edges,
                    int F, int vec, void* stream) {
  if (F <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4 && F % 4 == 0) {
    return passes<float, 4>(piece_ptr, piece_dest, col, pre, post, x, part,
                            out, zero_rows, num_zero, level_pieces,
                            num_levels, num_edges, F, s);
  }
  if (vec != 1) return (int)cudaErrorInvalidValue;
  return passes<float, 1>(piece_ptr, piece_dest, col, pre, post, x, part,
                          out, zero_rows, num_zero, level_pieces, num_levels,
                          num_edges, F, s);
}

// The bf16 form: x [num_gather_rows, F] and out [num_rows, F] bf16,
// contiguous; part float32 as above. vec: 8 when F % 8 == 0 and x is
// 16-byte aligned, else 4 when F % 4 == 0 and x is 8-byte aligned, else 1.
int mpgnn_csr_dedup_bf16(const int* piece_ptr, const int* piece_dest,
                         const int* col, const float* pre, const float* post,
                         const void* x, float* part, void* out,
                         const int* zero_rows, int num_zero,
                         const int* level_pieces, int num_levels,
                         int num_edges, int F, int vec, void* stream) {
  if (F <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
  if (vec == 8 && F % 8 == 0) {
    return passes<__nv_bfloat16, 8>(piece_ptr, piece_dest, col, pre, post,
                                    xb, part, ob, zero_rows, num_zero,
                                    level_pieces, num_levels, num_edges, F,
                                    s);
  }
  if (vec == 4 && F % 4 == 0) {
    return passes<__nv_bfloat16, 4>(piece_ptr, piece_dest, col, pre, post,
                                    xb, part, ob, zero_rows, num_zero,
                                    level_pieces, num_levels, num_edges, F,
                                    s);
  }
  if (vec != 1) return (int)cudaErrorInvalidValue;
  return passes<__nv_bfloat16, 1>(piece_ptr, piece_dest, col, pre, post, xb,
                                  part, ob, zero_rows, num_zero,
                                  level_pieces, num_levels, num_edges, F, s);
}

const char* mpgnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
