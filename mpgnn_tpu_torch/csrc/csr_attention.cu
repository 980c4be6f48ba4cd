// K6: softmax attention over a CSR, the message passing of HGT (Hu et al.
// 2020, arXiv:2003.01332, eq. 3-6), forward and backward.
//
//   s[e, h]   = q[t, h, :] . kt[c, h, :]            for edge e = (t, c)
//   out[t, h] = sum over e of t of softmax_e(s[e, h]) * vt[c, h, :]
//   lse[t, h] = log sum over e of t of exp(s[e, h])
//
// Row t is a target node; its edges, all relations together, are
// row_ptr[t] .. row_ptr[t + 1]; c = col[e] is a stacked source row: one
// row a (source node, relation) pair, whose kt and vt hold the node's K and
// V already multiplied by the relation's per-head matrices (W^ATT mu / sqrt
// d_k and W^MSG). So the softmax is over every relation of t at once, and
// the kernel knows nothing of relations.
//
// Replaces no TPU kernel: the JAX package has no attention. It was added
// because materialising a per-edge message ([E, 256] float32, 43 GB on
// ogbn-mag) does not fit on the card, and no K1/K2 path computes a weight
// per edge from the features or normalises over a node's edges.
//
// Bound on the H100: bytes. Every edge gathers a 1 KB row of kt and one of
// vt (E * 2 KB), against 1,024 flops; the rows are the stacked [M, 256]
// tensors, far past the 50 MB L2, so the gathers of random rows are the
// cost.
//
// Design. Width 256 in 8 heads of 32: one warp a chunk of a row's edges,
// each lane 8 consecutive floats (32 bytes, two float4 loads), so a head is
// 4 lanes and a warp reads a whole 1 KB row in one coalesced request.
//   * The forward is the online softmax of FlashAttention: a running max
//     and sum per head, the weighted sum of vt rescaled when the max grows.
//     A lane loads 32 edges' columns at once and broadcasts them; 4 edges'
//     rows are in flight at a time.
//   * A row is cut into chunks of at most CHUNK edges (ops/attention.py
//     chunk_rows): a power-law graph has rows of 10^5 edges, which one warp
//     would walk long after the rest of the card is idle. A row of one chunk
//     is written by it; each chunk of a longer row writes its partial
//     (max, sum, weighted sum) to a slot, and a second kernel folds a row's
//     slots in their order. No atomics: every sum has a fixed order, and two
//     launches on one input are bitwise equal.
//   * The backward keeps the per-edge, per-head probabilities p and their
//     score gradients ds ([E, 8] each) instead of any [E, 256] tensor. The
//     row pass recomputes s from lse, writes p and ds = p (dp - D) with
//     dp = do . vt and D = do . out, and sums dq = sum ds kt. The column
//     pass walks the transposed CSR (each stacked source row's edges, with
//     each edge's position in the row CSR) and sums dkt = sum ds q and
//     dvt = sum p do. Long rows and columns go through slots as above.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 256;             // row width
constexpr int kH = 8;               // heads
constexpr int kVpl = kD / 32;       // floats a lane: 8
constexpr int kLph = 32 / kH;       // lanes a head: 4
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kB = 4;               // edges whose rows are in flight
constexpr unsigned kFull = 0xffffffffu;

// chunk k of a CSR covers edges ptr[k] .. ptr[k + 1] of row row[k]; slot[k]
// is its partial slot, or -1 where it is its row's only chunk
struct Chunks {
  const int* ptr;
  const int* row;
  const int* slot;
  int count;
};

// the rows cut into several chunks: long_row[i]'s slots are slot_ptr[i] ..
// slot_ptr[i + 1], in edge order
struct Slots {
  const int* long_row;
  const int* slot_ptr;
  int count;
};

__device__ __forceinline__ void load8(const float* p, float (&v)[kVpl]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kVpl]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// the sum over the 4 lanes of a head, the same bits in each of them (each
// add is of the same two values, in either order)
__device__ __forceinline__ float head_sum(float s) {
#pragma unroll
  for (int o = 1; o < kLph; o <<= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

__device__ __forceinline__ float dot8(const float (&a)[kVpl],
                                      const float (&b)[kVpl]) {
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < kVpl; ++i) d = fmaf(a[i], b[i], d);
  return d;
}

__device__ __forceinline__ size_t at(int row, int lane) {
  return (size_t)row * kD + (size_t)lane * kVpl;
}

// ------------------------------------------------------------- forward
__global__ void __launch_bounds__(kThreads)
csr_attn_fwd_kernel(Chunks ch, const int* __restrict__ col,
                    const float* __restrict__ q, const float* __restrict__ kt,
                    const float* __restrict__ vt, float* __restrict__ out,
                    float* __restrict__ lse, float* __restrict__ part,
                    float* __restrict__ part_ml) {
  const int c = blockIdx.x * kWarps + threadIdx.x / 32;
  if (c >= ch.count) return;
  const int lane = threadIdx.x % 32, head = lane / kLph;
  const int e0 = ch.ptr[c], e1 = ch.ptr[c + 1], r = ch.row[c];
  float qv[kVpl], acc[kVpl];
  load8(q + at(r, lane), qv);
#pragma unroll
  for (int i = 0; i < kVpl; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;
  for (int base = e0; base < e1; base += 32) {
    const int n = min(32, e1 - base);
    const int mine = lane < n ? __ldg(col + base + lane) : 0;
    for (int j = 0; j < n; j += kB) {
      float kv[kB][kVpl], vv[kB][kVpl];
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        // past the chunk's end a lane reloads its last edge, masked below
        const int src = __shfl_sync(kFull, mine, min(j + b, n - 1));
        load8(kt + at(src, lane), kv[b]);
        load8(vt + at(src, lane), vv[b]);
      }
      float s[kB], mx = m;
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const float d = head_sum(dot8(qv, kv[b]));
        s[b] = j + b < n ? d : -INFINITY;
        mx = fmaxf(mx, s[b]);
      }
      const float scale = expf(m - mx);     // 0 while m is -inf
      l *= scale;
#pragma unroll
      for (int i = 0; i < kVpl; ++i) acc[i] *= scale;
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const float p = expf(s[b] - mx);
        l += p;
#pragma unroll
        for (int i = 0; i < kVpl; ++i) acc[i] = fmaf(p, vv[b][i], acc[i]);
      }
      m = mx;
    }
  }
  const int slot = ch.slot[c];
  if (slot < 0) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int i = 0; i < kVpl; ++i) acc[i] *= inv;
    store8(out + at(r, lane), acc);
    if (lane % kLph == 0) {
      lse[(size_t)r * kH + head] = l > 0.f ? m + logf(l) : -INFINITY;
    }
  } else {
    store8(part + at(slot, lane), acc);
    if (lane % kLph == 0) {
      part_ml[(size_t)slot * 2 * kH + head] = m;
      part_ml[(size_t)slot * 2 * kH + kH + head] = l;
    }
  }
}

// one warp a row cut into chunks: its partials rescaled to their common max
// and added in order
__global__ void __launch_bounds__(kThreads)
csr_attn_fold_kernel(Slots sl, const float* __restrict__ part,
                     const float* __restrict__ part_ml,
                     float* __restrict__ out, float* __restrict__ lse) {
  const int w = blockIdx.x * kWarps + threadIdx.x / 32;
  if (w >= sl.count) return;
  const int lane = threadIdx.x % 32, head = lane / kLph;
  const int r = sl.long_row[w], s0 = sl.slot_ptr[w], s1 = sl.slot_ptr[w + 1];
  float m = -INFINITY;
  for (int s = s0; s < s1; ++s) {
    m = fmaxf(m, __ldg(part_ml + (size_t)s * 2 * kH + head));
  }
  float l = 0.f, acc[kVpl], pv[kVpl];
#pragma unroll
  for (int i = 0; i < kVpl; ++i) acc[i] = 0.f;
  for (int s = s0; s < s1; ++s) {
    const float f = expf(__ldg(part_ml + (size_t)s * 2 * kH + head) - m);
    l = fmaf(__ldg(part_ml + (size_t)s * 2 * kH + kH + head), f, l);
    load8(part + at(s, lane), pv);
#pragma unroll
    for (int i = 0; i < kVpl; ++i) acc[i] = fmaf(f, pv[i], acc[i]);
  }
  const float inv = 1.f / l;
#pragma unroll
  for (int i = 0; i < kVpl; ++i) acc[i] *= inv;
  store8(out + at(r, lane), acc);
  if (lane % kLph == 0) lse[(size_t)r * kH + head] = m + logf(l);
}

// ------------------------------------------------------------ backward
// the row pass: p and ds of every edge, and dq = sum over t's edges of
// ds * kt (a long row's part to its slot)
__global__ void __launch_bounds__(kThreads)
csr_attn_bwd_rows_kernel(Chunks ch, const int* __restrict__ col,
                         const float* __restrict__ q,
                         const float* __restrict__ kt,
                         const float* __restrict__ vt,
                         const float* __restrict__ out,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         float* __restrict__ p_out,
                         float* __restrict__ ds_out, float* __restrict__ dq,
                         float* __restrict__ part) {
  const int c = blockIdx.x * kWarps + threadIdx.x / 32;
  if (c >= ch.count) return;
  const int lane = threadIdx.x % 32, head = lane / kLph;
  const int e0 = ch.ptr[c], e1 = ch.ptr[c + 1], r = ch.row[c];
  float qv[kVpl], dov[kVpl], acc[kVpl];
  load8(q + at(r, lane), qv);
  load8(dout + at(r, lane), dov);
  load8(out + at(r, lane), acc);
  const float dsum = head_sum(dot8(dov, acc));
  const float lh = e1 > e0 ? __ldg(lse + (size_t)r * kH + head) : 0.f;
#pragma unroll
  for (int i = 0; i < kVpl; ++i) acc[i] = 0.f;
  for (int base = e0; base < e1; base += 32) {
    const int n = min(32, e1 - base);
    const int mine = lane < n ? __ldg(col + base + lane) : 0;
    for (int j = 0; j < n; j += kB) {
      float kv[kB][kVpl], vv[kB][kVpl];
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const int src = __shfl_sync(kFull, mine, min(j + b, n - 1));
        load8(kt + at(src, lane), kv[b]);
        load8(vt + at(src, lane), vv[b]);
      }
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const float s = head_sum(dot8(qv, kv[b]));
        const float dp = head_sum(dot8(dov, vv[b]));
        const bool valid = j + b < n;
        const float p = valid ? expf(s - lh) : 0.f;
        const float ds = p * (dp - dsum);
        if (valid && lane % kLph == 0) {
          const size_t e = (size_t)(base + j + b) * kH + head;
          p_out[e] = p;
          ds_out[e] = ds;
        }
#pragma unroll
        for (int i = 0; i < kVpl; ++i) acc[i] = fmaf(ds, kv[b][i], acc[i]);
      }
    }
  }
  const int slot = ch.slot[c];
  store8(slot < 0 ? dq + at(r, lane) : part + at(slot, lane), acc);
}

// the column pass over the transposed CSR: for stacked source row c,
// dkt[c] = sum ds * q[t] and dvt[c] = sum p * dout[t] over its edges (a
// long row's two parts to its slot, dkt's then dvt's)
__global__ void __launch_bounds__(kThreads)
csr_attn_bwd_cols_kernel(Chunks ch, const int* __restrict__ tcol,
                         const int* __restrict__ eid,
                         const float* __restrict__ q,
                         const float* __restrict__ dout,
                         const float* __restrict__ p_in,
                         const float* __restrict__ ds_in,
                         float* __restrict__ dkt, float* __restrict__ dvt,
                         float* __restrict__ part) {
  const int c = blockIdx.x * kWarps + threadIdx.x / 32;
  if (c >= ch.count) return;
  const int lane = threadIdx.x % 32, head = lane / kLph;
  const int e0 = ch.ptr[c], e1 = ch.ptr[c + 1], r = ch.row[c];
  float dk[kVpl], dv[kVpl];
#pragma unroll
  for (int i = 0; i < kVpl; ++i) dk[i] = dv[i] = 0.f;
  for (int base = e0; base < e1; base += 32) {
    const int n = min(32, e1 - base);
    const int my_t = lane < n ? __ldg(tcol + base + lane) : 0;
    const int my_e = lane < n ? __ldg(eid + base + lane) : 0;
    for (int j = 0; j < n; j += kB) {
      float qv[kB][kVpl], dov[kB][kVpl], pw[kB], dw[kB];
#pragma unroll
      for (int b = 0; b < kB; ++b) {
        const int k = min(j + b, n - 1);
        const int t = __shfl_sync(kFull, my_t, k);
        const size_t e = (size_t)__shfl_sync(kFull, my_e, k) * kH + head;
        load8(q + at(t, lane), qv[b]);
        load8(dout + at(t, lane), dov[b]);
        const bool valid = j + b < n;
        pw[b] = valid ? __ldg(p_in + e) : 0.f;
        dw[b] = valid ? __ldg(ds_in + e) : 0.f;
      }
#pragma unroll
      for (int b = 0; b < kB; ++b) {
#pragma unroll
        for (int i = 0; i < kVpl; ++i) {
          dk[i] = fmaf(dw[b], qv[b][i], dk[i]);
          dv[i] = fmaf(pw[b], dov[b][i], dv[i]);
        }
      }
    }
  }
  const int slot = ch.slot[c];
  if (slot < 0) {
    store8(dkt + at(r, lane), dk);
    store8(dvt + at(r, lane), dv);
  } else {
    store8(part + at(2 * slot, lane), dk);
    store8(part + at(2 * slot + 1, lane), dv);
  }
}

// one warp a long row of a backward pass: its slots added in order; with
// out1, each slot holds two rows, out0's then out1's
__global__ void __launch_bounds__(kThreads)
csr_attn_sum_kernel(Slots sl, const float* __restrict__ part,
                    float* __restrict__ out0, float* __restrict__ out1) {
  const int w = blockIdx.x * kWarps + threadIdx.x / 32;
  if (w >= sl.count) return;
  const int lane = threadIdx.x % 32;
  const int r = sl.long_row[w], s0 = sl.slot_ptr[w], s1 = sl.slot_ptr[w + 1];
  const int per = out1 != nullptr ? 2 : 1;
  float a[kVpl], b[kVpl], v[kVpl];
#pragma unroll
  for (int i = 0; i < kVpl; ++i) a[i] = b[i] = 0.f;
  for (int s = s0; s < s1; ++s) {
    load8(part + at(per * s, lane), v);
#pragma unroll
    for (int i = 0; i < kVpl; ++i) a[i] += v[i];
    if (out1 != nullptr) {
      load8(part + at(per * s + 1, lane), v);
#pragma unroll
      for (int i = 0; i < kVpl; ++i) b[i] += v[i];
    }
  }
  store8(out0 + at(r, lane), a);
  if (out1 != nullptr) store8(out1 + at(r, lane), b);
}

int grid(int warps) { return (warps + kWarps - 1) / kWarps; }

}  // namespace

extern "C" {

// Every row tensor is float32, contiguous, 256 wide and 16-byte aligned;
// lse is [rows, 8]. The chunks and slots come from ops/attention.py
// chunk_rows (int32). part: float32 scratch [slots, 256], part_ml [slots,
// 16]. Rows of no edge get out 0 and lse -inf.
int mpgnn_attn_fwd(const int* chunk_ptr, const int* chunk_row,
                   const int* chunk_slot, int num_chunks,
                   const int* long_row, const int* slot_ptr, int num_long,
                   const int* col, const float* q, const float* kt,
                   const float* vt, float* out, float* lse, float* part,
                   float* part_ml, void* stream) {
  if (num_chunks <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Chunks ch{chunk_ptr, chunk_row, chunk_slot, num_chunks};
  csr_attn_fwd_kernel<<<grid(num_chunks), kThreads, 0, s>>>(
      ch, col, q, kt, vt, out, lse, part, part_ml);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_long <= 0) return (int)err;
  const Slots sl{long_row, slot_ptr, num_long};
  csr_attn_fold_kernel<<<grid(num_long), kThreads, 0, s>>>(
      sl, part, part_ml, out, lse);
  return (int)cudaGetLastError();
}

// The row pass: p and ds [E, 8] in the row CSR's edge order, dq [rows,
// 256]. part: float32 scratch [slots, 256].
int mpgnn_attn_bwd_rows(const int* chunk_ptr, const int* chunk_row,
                        const int* chunk_slot, int num_chunks,
                        const int* long_row, const int* slot_ptr,
                        int num_long, const int* col, const float* q,
                        const float* kt, const float* vt, const float* out,
                        const float* dout, const float* lse, float* p,
                        float* ds, float* dq, float* part, void* stream) {
  if (num_chunks <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Chunks ch{chunk_ptr, chunk_row, chunk_slot, num_chunks};
  csr_attn_bwd_rows_kernel<<<grid(num_chunks), kThreads, 0, s>>>(
      ch, col, q, kt, vt, out, dout, lse, p, ds, dq, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_long <= 0) return (int)err;
  const Slots sl{long_row, slot_ptr, num_long};
  csr_attn_sum_kernel<<<grid(num_long), kThreads, 0, s>>>(sl, part, dq,
                                                          nullptr);
  return (int)cudaGetLastError();
}

// The column pass over the transposed CSR (tcol: each edge's row, eid: its
// position in the row CSR): dkt and dvt [stacked rows, 256]. part: float32
// scratch [2 * slots, 256].
int mpgnn_attn_bwd_cols(const int* chunk_ptr, const int* chunk_row,
                        const int* chunk_slot, int num_chunks,
                        const int* long_row, const int* slot_ptr,
                        int num_long, const int* tcol, const int* eid,
                        const float* q, const float* dout, const float* p,
                        const float* ds, float* dkt, float* dvt, float* part,
                        void* stream) {
  if (num_chunks <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Chunks ch{chunk_ptr, chunk_row, chunk_slot, num_chunks};
  csr_attn_bwd_cols_kernel<<<grid(num_chunks), kThreads, 0, s>>>(
      ch, tcol, eid, q, dout, p, ds, dkt, dvt, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_long <= 0) return (int)err;
  const Slots sl{long_row, slot_ptr, num_long};
  csr_attn_sum_kernel<<<grid(num_long), kThreads, 0, s>>>(sl, part, dkt,
                                                          dvt);
  return (int)cudaGetLastError();
}

const char* mpgnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
