// K1: weighted sorted-CSR segment sum with an in-kernel row gather.
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
// matmuls into a VMEM-resident row block; on the GPU a row is owned by a
// group of `tpr` threads that walks that row's edge list and keeps the sum
// in registers (float32), so:
//   * there are no atomics and the sum order is fixed (edges in CSR order):
//     results are deterministic;
//   * the sum is compensated (Kahan): a hub row of 80k edges summed plainly
//     in float32 drifts by more than 1e-5, and the extra adds cost nothing
//     in a kernel bound by bytes;
//   * every row, with or without edges, is written exactly once, so the
//     output needs no zeroing pass (the TPU kernel needed an all-pad tile
//     per empty block for that);
//   * each thread loads 16 bytes (float4) of a gathered row when F is a
//     multiple of 4, neighbouring threads on neighbouring addresses, and
//     the edge loop is unrolled by 4 so four row loads are in flight per
//     thread.
// Hub rows are walked by one group and are not load-balanced: that is left
// for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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
  // compensated (Kahan) step: acc += w * v, with the rounding error of
  // each add kept in comp
  __device__ static void add(T& acc, T& comp, float w, const T& v) {
    kahan(acc.x, comp.x, w, v.x);
    kahan(acc.y, comp.y, w, v.y);
    kahan(acc.z, comp.z, w, v.z);
    kahan(acc.w, comp.w, w, v.w);
  }
  __device__ static void store(float* p, const T& v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <> struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static T load(const float* p) { return __ldg(p); }
  __device__ static void add(T& acc, T& comp, float w, const T& v) {
    kahan(acc, comp, w, v);
  }
  __device__ static void store(float* p, const T& v) { *p = v; }
};

template <int VEC>
__global__ void __launch_bounds__(kThreads)
csr_scatter_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col,
                   const float* __restrict__ w, const float* __restrict__ x,
                   float* __restrict__ out, int num_rows, int F, int tpr) {
  using V = Vec<VEC>;
  const int group = threadIdx.x / tpr;
  const int lane = threadIdx.x % tpr;
  const int r = blockIdx.x * (blockDim.x / tpr) + group;
  if (r >= num_rows) return;
  const int e0 = row_ptr[r];
  const int e1 = row_ptr[r + 1];
  float* orow = out + (size_t)r * F;
  for (int c = lane * VEC; c < F; c += tpr * VEC) {
    typename V::T acc = V::zero(), comp = V::zero();
    int e = e0;
    for (; e + 4 <= e1; e += 4) {
      const int c0 = __ldg(col + e), c1 = __ldg(col + e + 1);
      const int c2 = __ldg(col + e + 2), c3 = __ldg(col + e + 3);
      const float w0 = __ldg(w + e), w1 = __ldg(w + e + 1);
      const float w2 = __ldg(w + e + 2), w3 = __ldg(w + e + 3);
      const typename V::T v0 = V::load(x + (size_t)c0 * F + c);
      const typename V::T v1 = V::load(x + (size_t)c1 * F + c);
      const typename V::T v2 = V::load(x + (size_t)c2 * F + c);
      const typename V::T v3 = V::load(x + (size_t)c3 * F + c);
      V::add(acc, comp, w0, v0);
      V::add(acc, comp, w1, v1);
      V::add(acc, comp, w2, v2);
      V::add(acc, comp, w3, v3);
    }
    for (; e < e1; ++e) {
      V::add(acc, comp, __ldg(w + e),
             V::load(x + (size_t)__ldg(col + e) * F + c));
    }
    V::store(orow + c, acc);
  }
}

int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// vec: 4 when F % 4 == 0 and x, out are 16-byte aligned, else 1.
int mpgnn_csr_scatter(const int* row_ptr, const int* col, const float* w,
                      const float* x, float* out, int num_rows, int F, int vec,
                      void* stream) {
  if (num_rows <= 0 || F <= 0) return (int)cudaSuccess;
  const int chunks = vec == 4 ? F / 4 : F;
  const int tpr = chunks < 32 ? pow2_at_least(chunks) : 32;
  const int rows_per_cta = kThreads / tpr;
  const dim3 grid((num_rows + rows_per_cta - 1) / rows_per_cta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    csr_scatter_kernel<4><<<grid, kThreads, 0, s>>>(row_ptr, col, w, x, out,
                                                    num_rows, F, tpr);
  } else {
    csr_scatter_kernel<1><<<grid, kThreads, 0, s>>>(row_ptr, col, w, x, out,
                                                    num_rows, F, tpr);
  }
  return (int)cudaGetLastError();
}

const char* mpgnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
