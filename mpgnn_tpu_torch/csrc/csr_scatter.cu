// K1: weighted sorted-CSR segment sum with an in-kernel row gather,
// balanced over edges by a merge-path partition.
//
//   out[r, :] = sum over e in [row_ptr[r], row_ptr[r+1]) of w[e] * x[col[e], :]
//
// Replaces mpgnn_tpu/ops/pallas_csr.py::_scatter_kernel (launched by
// _scatter_call and _segment_apply), together with the XLA row gather that
// fed it (_gather_weighted). With w = 1/deg(row) it is the mean over a
// node's out-edges; a row without edges gives 0.
//
// Bound on the H100: bytes. Every edge reads one gathered row of F floats
// (E*F*4 bytes), its column index and its weight (8 bytes), and every
// output row is written once (N*F*4 bytes); there is one FMA per gathered
// float, far below the card's compute rate. At 3.35 TB/s the gather of
// random rows is the cost.
//
// Design. The TPU kernel reduced [16,128] edge panels with one-hot MXU
// matmuls into a VMEM-resident row block. Here the work is the merged list
// of the num_rows row ends and the E edges, in CSR order (row r ends at item
// r + row_ptr[r+1]), cut into shares of S consecutive items, one group of
// TPR threads a share (merge-path: Merrill and Garland, "Merge-based
// Parallel Sparse Matrix-Vector Multiplication", SC16). TPR lanes cover
// the columns, 16 bytes a lane where F is a multiple of 4; S is 64 items,
// or 16 * TPR for narrow rows so that there are threads enough.
//   * a CTA finds where its run of shares starts and ends in the row list:
//     half its threads probe 128 evenly spaced rows of row_ptr for each end,
//     so that each round of loads narrows the range 128-fold (4 rounds for
//     millions of rows); it stages that stretch of row_ptr in shared memory,
//     and each group finds its share's start there. There is no host table:
//     the blocking is the plain CSR;
//   * a group walks its share's edges in CSR order, a batch at a time: its
//     lanes load the batch's column indices and weights once, coalesced,
//     and broadcast them with __shfl_sync while the previous batch's
//     gathered rows are in flight, 8 a lane (4 for groups of 16 lanes or
//     more, whose registers then leave room for more warps: on the H100 that
//     measured faster at F = 64, and slower at F = 16); each row's sum is
//     compensated (Kahan) in registers: a row of 80k edges summed plainly in
//     float32 drifts by more than 1e-5;
//   * a row of at most S edges is summed whole by the share where it begins
//     (which then walks past its own end by at most S edges) and skipped by
//     the next, so short rows are never cut; a row without edges is written
//     as 0 by the share that holds its end. The first pass writes every row
//     once;
//   * a longer row is cut by the shares: the share where it ends writes its
//     part to out, each earlier share that holds some of its edges writes
//     its part to carry slot s (row s of a scratch [shares, F]), and a
//     second kernel adds the carries in share order and then the part in
//     out, compensated, one group a row: a row of 60k edges is one chain of
//     about 940 carries. No atomics, and the order of every sum is fixed, so
//     two launches on one input are bitwise equal.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHalf = kThreads / 2;   // probes per end of a CTA's search
constexpr int kBatch = 8;             // carries in flight per lane

template <int TPR> struct Layout {
  static constexpr int share = TPR >= 4 ? 64 : 16 * TPR;  // items a share
  static constexpr int batch = TPR >= 16 ? 4 : 8;         // rows in flight
  static constexpr int groups = kThreads / TPR;
  static constexpr int items = groups * share;            // at most 4096
};

__device__ __forceinline__ void kahan(float& acc, float& comp, float w,
                                      float v) {
  const float y = fmaf(w, v, -comp);
  const float t = acc + y;
  comp = (t - acc) - y;
  acc = t;
}

template <int VEC> struct Vec;

template <> struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static T load_rw(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  // compensated (Kahan) step: acc += w * v, with the rounding error of
  // each add kept in comp
  __device__ static void add(T& acc, T& comp, float w, const T& v) {
    kahan(acc.x, comp.x, w, v.x);
    kahan(acc.y, comp.y, w, v.y);
    kahan(acc.z, comp.z, w, v.z);
    kahan(acc.w, comp.w, w, v.w);
  }
  __device__ static T sum(const T& a, const T& c) {
    return make_float4(a.x - c.x, a.y - c.y, a.z - c.z, a.w - c.w);
  }
  __device__ static void store(float* p, const T& v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <> struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static T load(const float* p) { return __ldg(p); }
  __device__ static T load_rw(const float* p) { return *p; }
  __device__ static void add(T& acc, T& comp, float w, const T& v) {
    kahan(acc, comp, w, v);
  }
  __device__ static T sum(const T& a, const T& c) { return a - c; }
  __device__ static void store(float* p, const T& v) { *p = v; }
};

// The merge-path coordinate of item d: how many rows end among the first d
// items, where row r ends at item r + ends[r - off] (ends[r - off] =
// row_ptr[r + 1]). lo and hi bound the answer.
__device__ __forceinline__ int path_search(const int* ends, int off, int d,
                                           int lo, int hi) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ends[mid - off] <= d - mid - 1) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The coordinates of items D0 and D1 into span[0] and span[1], by all the
// CTA's threads: kHalf of them probe evenly spaced rows for each item, and
// the count of probes that lie before it narrows the range kHalf-fold.
__device__ __forceinline__ void cta_span(const int* __restrict__ ends,
                                         int D0, int D1, int num_rows,
                                         int num_edges, int* span) {
  const int which = threadIdx.x / kHalf, t = threadIdx.x % kHalf;
  const int d = which ? D1 : D0;
  int lo = max(0, d - num_edges), hi = min(d, num_rows);
  int len = max(min(D0, num_rows) - max(0, D0 - num_edges),
                min(D1, num_rows) - max(0, D1 - num_edges));
  int rounds = 0;                 // the same count for both halves
  while (len > 0) {
    len = (len + kHalf - 1) / kHalf - 1;
    ++rounds;
  }
  for (int i = 0; i < rounds; ++i) {
    const int step = max(1, (hi - lo + kHalf - 1) / kHalf);
    const int m = lo + t * step;
    const bool before = m < hi && __ldg(ends + m) <= d - m - 1;
    const int c0 = __syncthreads_count(before && which == 0);
    const int c1 = __syncthreads_count(before && which == 1);
    const int c = which ? c1 : c0;
    if (hi > lo) {
      if (c == 0) {
        hi = lo;
      } else {
        const int next = lo + (c - 1) * step + 1;
        hi = min(hi, lo + c * step);
        lo = next;
      }
    }
  }
  if (t == 0) span[which] = lo;
}

// Shares of S = Layout<TPR>::share items, TPR lanes a share.
template <int VEC, int TPR>
__global__ void __launch_bounds__(kThreads)
csr_scatter_kernel(const int* __restrict__ row_ptr,
                   const int* __restrict__ col, const float* __restrict__ w,
                   const float* __restrict__ x, float* __restrict__ out,
                   float* __restrict__ carry, int* __restrict__ share_row,
                   int num_rows, int num_edges, int F) {
  using V = Vec<VEC>;
  using T = typename V::T;
  using L = Layout<TPR>;
  constexpr int S = L::share;
  constexpr int B = L::batch;
  constexpr int kPer = B / TPR > 0 ? B / TPR : 1;  // index loads a lane
  __shared__ int rp[L::items + 2];    // row_ptr[xc0 .. min(xc1 + 1, rows)]
  __shared__ int span[2];
  const int total = num_rows + num_edges;
  const int D0 = blockIdx.x * L::items;
  const int D1 = min(D0 + L::items, total);
  cta_span(row_ptr + 1, D0, D1, num_rows, num_edges, span);
  __syncthreads();
  const int xc0 = span[0], xc1 = span[1];
  const int staged = min(xc1 + 1, num_rows) - xc0 + 1;
  for (int i = threadIdx.x; i < staged; i += kThreads) {
    rp[i] = __ldg(row_ptr + xc0 + i);
  }
  __syncthreads();

  const int g = threadIdx.x / TPR, lane = threadIdx.x % TPR;
  const int d0 = D0 + g * S;
  if (d0 >= D1) return;
  const int d1 = min(d0 + S, D1);
  auto rs = [&](int r) { return rp[r - xc0]; };   // row_ptr[r], staged
  const int x0 = path_search(rp + 1, xc0, d0, max(xc0, d0 - num_edges),
                             min(d0, xc1));
  const int x1 = path_search(rp + 1, xc0, d1, max(xc0, d1 - num_edges),
                             min(d1, xc1));
  const int y0 = d0 - x0, y1 = d1 - x1;       // the share's edges
  // the first row began in an earlier share: a short one was summed there,
  // a long one ends here or later
  const bool began = x0 < num_rows && x0 + rs(x0) < d0;
  const bool first_done = began && rs(x0 + 1) - rs(x0) <= S;
  // the row open at the share's end began here: a short one is summed here
  const bool own_tail = x1 < num_rows && x1 + rs(x1) >= d0 && rs(x1) < y1 &&
                        rs(x1 + 1) - rs(x1) <= S;
  const int s = blockIdx.x * L::groups + g;
  if (lane == 0) share_row[s] = began && !first_done && x0 < x1 ? x0 : -1;
  const int r_end = own_tail ? x1 + 1 : x1;   // rows written: [r, r_end)
  const int y_end = own_tail ? rs(x1 + 1) : y1;
  const int r_begin = first_done ? x0 + 1 : x0;
  const int y_begin = first_done ? min(rs(x0 + 1), y1) : y0;
  const unsigned mask =
      TPR == 32 ? 0xffffffffu
                : ((1u << TPR) - 1) << (threadIdx.x % 32 / TPR * TPR);

  for (int c0 = 0; c0 < F; c0 += TPR * VEC) {
    const int c = c0 + lane * VEC;
    const bool on = c < F;                     // lanes past F only shuffle
    T acc = V::zero(), comp = V::zero();
    int r = r_begin;                           // the row being summed
    int end = r < r_end ? rs(r + 1) : y_end;   // its last edge here, + 1
    // lane l holds the indices and weights of batch entries l + m * TPR
    int lc[kPer];
    float lw[kPer];
    auto load_idx = [&](int yb) {
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int k = lane + m * TPR;
        const bool ok = k < B && yb + k < y_end;
        lc[m] = ok ? __ldg(col + yb + k) : 0;
        lw[m] = ok ? __ldg(w + yb + k) : 0.f;
      }
    };
    load_idx(y_begin);
    for (int yb = y_begin; yb < y_end; yb += B) {
      T v[B];
#pragma unroll
      for (int k = 0; k < B; ++k) {
        const int ck =
            TPR == 1 ? lc[k] : __shfl_sync(mask, lc[k / TPR], k % TPR, TPR);
        v[k] = on && yb + k < y_end ? V::load(x + (size_t)ck * F + c)
                                    : V::zero();
      }
      float wk[B];
#pragma unroll
      for (int k = 0; k < B; ++k) {
        wk[k] =
            TPR == 1 ? lw[k] : __shfl_sync(mask, lw[k / TPR], k % TPR, TPR);
      }
      load_idx(yb + B);   // the next batch's indices load meanwhile
#pragma unroll
      for (int k = 0; k < B; ++k) {
        const int e = yb + k;
        if (e < y_end) {
          while (e >= end) {       // rows that end before edge e
            if (on) V::store(out + (size_t)r * F + c, V::sum(acc, comp));
            acc = comp = V::zero();
            ++r;
            end = r < r_end ? rs(r + 1) : y_end;
          }
          V::add(acc, comp, wk[k], v[k]);
        }
      }
    }
    for (; r < r_end; ++r) {
      if (on) V::store(out + (size_t)r * F + c, V::sum(acc, comp));
      acc = comp = V::zero();
    }
    // a long row still open at the share's end, with some of its edges
    // here: its part goes to carry slot s
    if (!own_tail && x1 < num_rows && y1 > max(y_begin, rs(x1)) && on) {
      V::store(carry + (size_t)s * F + c, V::sum(acc, comp));
    }
  }
}

// For each share s where a long row r ends (share_row[s] = r): out[r] =
// the carry slots of the shares from r's first edge's to s - 1, in order,
// then the part that s wrote to out[r], compensated. TPR lanes a share.
template <int VEC, int TPR>
__global__ void __launch_bounds__(kThreads)
csr_carry_kernel(const int* __restrict__ row_ptr,
                 const int* __restrict__ share_row,
                 const float* __restrict__ carry, float* __restrict__ out,
                 int shares, int F) {
  using V = Vec<VEC>;
  using T = typename V::T;
  const int s = blockIdx.x * (kThreads / TPR) + threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;
  if (s >= shares) return;
  const int r = __ldg(share_row + s);
  if (r < 0) return;
  const int first = (r + __ldg(row_ptr + r)) / Layout<TPR>::share;
  const int m = s - first;
  float* dst = out + (size_t)r * F;
  for (int c = lane * VEC; c < F; c += TPR * VEC) {
    T acc = V::zero(), comp = V::zero();
    const float* src = carry + (size_t)first * F + c;
    for (int i = 0; i < m; i += kBatch) {
      T v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        v[k] = i + k < m ? V::load(src + (size_t)(i + k) * F) : V::zero();
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) V::add(acc, comp, 1.f, v[k]);
    }
    V::add(acc, comp, 1.f, V::load_rw(dst + c));  // share s's part, last
    V::store(dst + c, V::sum(acc, comp));
  }
}

int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

template <int VEC, int TPR>
int run(const int* row_ptr, const int* col, const float* w, const float* x,
        float* out, float* carry, int* share_row, int num_rows,
        int num_edges, int F, int share, cudaStream_t s) {
  using L = Layout<TPR>;
  if (share != L::share) return (int)cudaErrorInvalidValue;
  const int total = num_rows + num_edges;
  const int shares = (total + L::share - 1) / L::share;
  csr_scatter_kernel<VEC, TPR>
      <<<(total + L::items - 1) / L::items, kThreads, 0, s>>>(
          row_ptr, col, w, x, out, carry, share_row, num_rows, num_edges, F);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_edges <= L::share) return (int)err;
  constexpr int kPerCta = kThreads / TPR;
  csr_carry_kernel<VEC, TPR><<<(shares + kPerCta - 1) / kPerCta, kThreads, 0,
                               s>>>(row_ptr, share_row, carry, out, shares,
                                    F);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [num_cols, F], out: [num_rows, F], float32 and contiguous. vec: 4
// when F % 4 == 0 and x, out are 16-byte aligned, else 1. share: the items
// a share, as Layout gives it for F and vec (checked). carry: float32 scratch
// [shares, F] and share_row: int32 scratch [shares], shares =
// ceil((num_rows + num_edges) / share).
int mpgnn_csr_scatter(const int* row_ptr, const int* col, const float* w,
                      const float* x, float* out, float* carry,
                      int* share_row, int num_rows, int num_edges, int F,
                      int vec, int share, void* stream) {
  if (num_rows <= 0 || F <= 0) return (int)cudaSuccess;
  if (num_edges < 0 ||
      (long long)num_rows + num_edges > (long long)INT_MAX - 8192 ||
      (vec != 1 && (vec != 4 || F % 4 != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  const int chunks = vec == 4 ? F / 4 : F;
  const int tpr = chunks < 32 ? pow2_at_least(chunks) : 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MPGNN_RUN(VECV, TPRV)                                                 \
  if (vec == VECV && tpr == TPRV)                                             \
    return run<VECV, TPRV>(row_ptr, col, w, x, out, carry, share_row,         \
                           num_rows, num_edges, F, share, s);
#define MPGNN_TPR(VECV)                                                       \
  MPGNN_RUN(VECV, 1)                                                          \
  MPGNN_RUN(VECV, 2)                                                          \
  MPGNN_RUN(VECV, 4)                                                          \
  MPGNN_RUN(VECV, 8)                                                          \
  MPGNN_RUN(VECV, 16)                                                         \
  MPGNN_RUN(VECV, 32)
  MPGNN_TPR(1)
  MPGNN_TPR(4)
#undef MPGNN_TPR
#undef MPGNN_RUN
  return (int)cudaErrorInvalidValue;
}

const char* mpgnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
