// Row slices for K1 (csr_scatter.cu) and K2 (csr_dedup.cu): loads of
// gathered rows, compensated (Kahan) float32 sums, and stores.
//
// Row<In, VEC> reads VEC consecutive values of a row of type In a lane:
//   * In = float, VEC = 4 or 1: 16- or 4-byte loads, float32 out;
//   * In = __nv_bfloat16, VEC = 8, 4 or 1: 16-, 8- or 2-byte loads of bf16
//     rows, each value widened to float32 exactly (a bf16 is the top half
//     of a float32), summed in float32 and rounded to bf16 once, round to
//     nearest even, where the row's sum is stored: the JAX package's
//     bf16(float32 sum of float32(x)) up to the order of the sum.
// Partial sums that a later pass or kernel adds (K1's carries, K2's
// partial slots) stay float32 in both forms (load_f32 / store_f32), so a
// row cut across pieces is rounded once, at its end.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// acc += w * v, with the rounding error of each add kept in comp
__device__ __forceinline__ void kahan(float& acc, float& comp, float w,
                                      float v) {
  const float y = fmaf(w, v, -comp);
  const float t = acc + y;
  comp = (t - acc) - y;
  acc = t;
}

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

template <int N> struct Floats {
  float v[N];
};

template <typename In, int VEC> struct Row;

// ---------------------------------------------------------------- float32
template <> struct Row<float, 4> {
  using In = float;
  using T = float4;     // the sums
  using Raw = float4;   // a load
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static Raw raw_zero() { return zero(); }
  __device__ static Raw load(const In* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static T load_f32(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static T load_f32_rw(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ static void add(T& acc, T& comp, float w, const Raw& v) {
    kahan(acc.x, comp.x, w, v.x);
    kahan(acc.y, comp.y, w, v.y);
    kahan(acc.z, comp.z, w, v.z);
    kahan(acc.w, comp.w, w, v.w);
  }
  __device__ static void add_f32(T& acc, T& comp, float w, const T& v) {
    add(acc, comp, w, v);
  }
  __device__ static T sum(const T& a, const T& c) {
    return make_float4(a.x - c.x, a.y - c.y, a.z - c.z, a.w - c.w);
  }
  // s * the two compensated sums, added
  __device__ static T sum2(const T (&a)[2], const T (&c)[2], float s) {
    return make_float4(s * ((a[0].x - c[0].x) + (a[1].x - c[1].x)),
                       s * ((a[0].y - c[0].y) + (a[1].y - c[1].y)),
                       s * ((a[0].z - c[0].z) + (a[1].z - c[1].z)),
                       s * ((a[0].w - c[0].w) + (a[1].w - c[1].w)));
  }
  __device__ static void store(In* p, const T& v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  __device__ static void store_f32(float* p, const T& v) { store(p, v); }
};

template <> struct Row<float, 1> {
  using In = float;
  using T = float;
  using Raw = float;
  __device__ static T zero() { return 0.f; }
  __device__ static Raw raw_zero() { return 0.f; }
  __device__ static Raw load(const In* p) { return __ldg(p); }
  __device__ static T load_f32(const float* p) { return __ldg(p); }
  __device__ static T load_f32_rw(const float* p) { return *p; }
  __device__ static void add(T& acc, T& comp, float w, const Raw& v) {
    kahan(acc, comp, w, v);
  }
  __device__ static void add_f32(T& acc, T& comp, float w, const T& v) {
    kahan(acc, comp, w, v);
  }
  __device__ static T sum(const T& a, const T& c) { return a - c; }
  __device__ static T sum2(const T (&a)[2], const T (&c)[2], float s) {
    return s * ((a[0] - c[0]) + (a[1] - c[1]));
  }
  __device__ static void store(In* p, const T& v) { *p = v; }
  __device__ static void store_f32(float* p, const T& v) { *p = v; }
};

// ------------------------------------------------------------------ bf16
// N = 8 (a 16-byte uint4 load) or 4 (an 8-byte uint2 load) bf16 values
template <int N> struct Bf16Raw;
template <> struct Bf16Raw<8> {
  using T = uint4;
  __device__ static T zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static uint32_t word(const T& r, int i) {
    return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
  }
  __device__ static T make(const uint32_t (&w)[4]) {
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <> struct Bf16Raw<4> {
  using T = uint2;
  __device__ static T zero() { return make_uint2(0u, 0u); }
  __device__ static uint32_t word(const T& r, int i) {
    return i == 0 ? r.x : r.y;
  }
  __device__ static T make(const uint32_t (&w)[2]) {
    return make_uint2(w[0], w[1]);
  }
};

template <int N> struct RowBf16 {
  using In = __nv_bfloat16;
  using T = Floats<N>;
  using R = Bf16Raw<N>;
  using Raw = typename R::T;
  __device__ static T zero() {
    T t;
#pragma unroll
    for (int i = 0; i < N; ++i) t.v[i] = 0.f;
    return t;
  }
  __device__ static Raw raw_zero() { return R::zero(); }
  __device__ static Raw load(const In* p) {
    return __ldg(reinterpret_cast<const Raw*>(p));
  }
  __device__ static T load_f32(const float* p) {
    T t;
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
      t.v[i] = q.x, t.v[i + 1] = q.y, t.v[i + 2] = q.z, t.v[i + 3] = q.w;
    }
    return t;
  }
  __device__ static T load_f32_rw(const float* p) {
    T t;
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      t.v[i] = q.x, t.v[i + 1] = q.y, t.v[i + 2] = q.z, t.v[i + 3] = q.w;
    }
    return t;
  }
  __device__ static void add(T& acc, T& comp, float w, const Raw& r) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const uint32_t u = R::word(r, i);
      kahan(acc.v[2 * i], comp.v[2 * i], w, bf16_lo(u));
      kahan(acc.v[2 * i + 1], comp.v[2 * i + 1], w, bf16_hi(u));
    }
  }
  __device__ static void add_f32(T& acc, T& comp, float w, const T& t) {
#pragma unroll
    for (int i = 0; i < N; ++i) kahan(acc.v[i], comp.v[i], w, t.v[i]);
  }
  __device__ static T sum(const T& a, const T& c) {
    T t;
#pragma unroll
    for (int i = 0; i < N; ++i) t.v[i] = a.v[i] - c.v[i];
    return t;
  }
  __device__ static T sum2(const T (&a)[2], const T (&c)[2], float s) {
    T t;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      t.v[i] = s * ((a[0].v[i] - c[0].v[i]) + (a[1].v[i] - c[1].v[i]));
    }
    return t;
  }
  __device__ static void store(In* p, const T& t) {
    uint32_t w[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) w[i] = pack_bf16(t.v[2 * i], t.v[2 * i + 1]);
    *reinterpret_cast<Raw*>(p) = R::make(w);
  }
  __device__ static void store_f32(float* p, const T& t) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      *reinterpret_cast<float4*>(p + i) =
          make_float4(t.v[i], t.v[i + 1], t.v[i + 2], t.v[i + 3]);
    }
  }
};

template <> struct Row<__nv_bfloat16, 8> : RowBf16<8> {};
template <> struct Row<__nv_bfloat16, 4> : RowBf16<4> {};

template <> struct Row<__nv_bfloat16, 1> {
  using In = __nv_bfloat16;
  using T = float;
  using Raw = unsigned short;
  __device__ static T zero() { return 0.f; }
  __device__ static Raw raw_zero() { return 0; }
  __device__ static Raw load(const In* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ static T load_f32(const float* p) { return __ldg(p); }
  __device__ static T load_f32_rw(const float* p) { return *p; }
  __device__ static void add(T& acc, T& comp, float w, const Raw& r) {
    kahan(acc, comp, w, bf16_lo(r));
  }
  __device__ static void add_f32(T& acc, T& comp, float w, const T& v) {
    kahan(acc, comp, w, v);
  }
  __device__ static T sum(const T& a, const T& c) { return a - c; }
  __device__ static T sum2(const T (&a)[2], const T (&c)[2], float s) {
    return s * ((a[0] - c[0]) + (a[1] - c[1]));
  }
  __device__ static void store(In* p, const T& v) {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)bf16_bits(v);
  }
  __device__ static void store_f32(float* p, const T& v) { *p = v; }
};

}  // namespace
