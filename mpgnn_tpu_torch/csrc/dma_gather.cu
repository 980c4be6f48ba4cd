// K5: row gather by runs, one bulk copy per run of rows.
//
//   out[k * R + j, :] = x[run_starts[k] + j, :]   for j < R (rows_per_run)
//
// Replaces benchmarks/bench_dma_gather.py:57, the Pallas kernel of
// _dma_gather_call: a probe of how fast rows can be gathered when every
// contiguous run of rows is one copy. The TPU kernel issues one async DMA
// per run from HBM into the output block, with a 16-slot semaphore ring
// (SEM_SLOTS) of copies in flight, tile by tile of runs_per_tile runs.
//
// Bound on the H100: bytes. Each gathered row is read once and written once
// (2 * R * F * 4 bytes a run) and each run start is read once (4 bytes); no
// arithmetic. At 3.35 TB/s, 2,097,152 rows of 512 bytes take 0.641 ms. At
// R = 1 and narrow rows the cost is the number of copies, not the bytes:
// the probe measures that rate (ns a descriptor).
//
// Design. Hopper's counterpart of a DMA per run is a 1-D bulk copy
// (cp.async.bulk, the Tensor Memory Accelerator without a tensor map): one
// instruction moves R * F * 4 bytes between global and shared memory and
// reports completion to an mbarrier. A CTA takes a tile of runs_per_tile
// runs; its warp stages the tile's run starts in shared memory, then one
// thread walks the runs through a ring of `slots` buffers of one run each:
//   * run r is loaded into slot r % slots (global to shared, completing on
//     that slot's mbarrier, whose phase is (r / slots) & 1);
//   * once it has landed, a bulk store (shared to global, one bulk group a
//     run) writes it to out[r * R];
//   * after the store of run r is committed, the thread waits until the
//     store of run r - 1 has read its slot (cp.async.bulk.wait_group.read 1)
//     and loads run r - 1 + slots into that slot. So slots - 1 loads and one
//     or two stores are in flight; with one slot, each run waits for its
//     own store's read.
// The ring holds 16 slots, as SEM_SLOTS, or as many runs as fit in 200 KB
// (6 at F = 128, R = 64: a run is 32 KB). A bulk copy needs 16-byte sizes
// and addresses: the wrapper refuses F that is not a multiple of 4 and x
// that is not 16-byte aligned. Nothing is summed, so the output is the
// input's bits: the wrapper's plain version is index_select, held bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr int kMaxSlots = 16;
constexpr int kRingBytes = 200 * 1024;
constexpr int kMaxRunsPerTile = 4096;

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

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// shared memory: [slots][run_bytes] ring, kMaxSlots mbarriers, the tile's
// run starts
__global__ void __launch_bounds__(kThreads)
    dma_gather_kernel(const float* __restrict__ x,
                      const int* __restrict__ run_starts,
                      float* __restrict__ out, int runs_per_tile,
                      int row_floats, int rows_per_run, int slots) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t run_bytes = (uint32_t)rows_per_run * row_floats * 4u;
  uint8_t* ring = smem;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + slots * run_bytes);
  int* starts = reinterpret_cast<int*>(bar + kMaxSlots);

  const long long first = (long long)blockIdx.x * runs_per_tile;
  const int runs = runs_per_tile;
  for (int i = threadIdx.x; i < runs; i += kThreads)
    starts[i] = run_starts[first + i];
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  const size_t row_bytes = (size_t)row_floats * 4;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(x);
  uint8_t* dst =
      reinterpret_cast<uint8_t*>(out) + (size_t)first * run_bytes;
  auto load = [&](int r) {
    const int s = r % slots;
    mbar_expect_tx(&bar[s], run_bytes);
    bulk_load(ring + (size_t)s * run_bytes,
              src + (size_t)starts[r] * row_bytes, run_bytes, &bar[s]);
  };
  const int ahead = runs < slots ? runs : slots;
  for (int r = 0; r < ahead; ++r) load(r);
  for (int r = 0; r < runs; ++r) {
    const int s = r % slots;
    mbar_wait(&bar[s], (uint32_t)(r / slots) & 1u);
    bulk_store(dst + (size_t)r * run_bytes, ring + (size_t)s * run_bytes,
               run_bytes);
    bulk_commit();
    if (slots > 1) {
      bulk_wait_read<1>();          // the store of run r - 1 has read its slot
      if (r >= 1 && r - 1 + slots < runs) load(r - 1 + slots);
    } else {
      bulk_wait_read<0>();          // one slot: wait for this run's store
      if (r + 1 < runs) load(r + 1);
    }
  }
  bulk_wait_all();
}

}  // namespace

extern "C" {

// x: [n, row_floats] float32, contiguous, 16-byte aligned, row_floats a
// multiple of 4; run_starts: [num_tiles, runs_per_tile] int32 (at most
// kMaxRunsPerTile runs a tile), each in [0, n - rows_per_run]; out:
// [num_tiles * runs_per_tile * rows_per_run, row_floats] float32. One CTA
// a tile. Returns a cudaError_t (0 on success).
int mpgnn_dma_gather(const void* x, const void* run_starts, void* out,
                     long long num_tiles, int runs_per_tile, int row_floats,
                     int rows_per_run, void* stream) {
  const long long run_bytes = (long long)rows_per_run * row_floats * 4;
  if (num_tiles <= 0) return (int)cudaSuccess;
  if (row_floats <= 0 || row_floats % 4 != 0 || rows_per_run <= 0 ||
      run_bytes > kRingBytes || runs_per_tile <= 0 ||
      runs_per_tile > kMaxRunsPerTile)
    return (int)cudaErrorInvalidValue;
  int slots = (int)(kRingBytes / run_bytes);
  if (slots > kMaxSlots) slots = kMaxSlots;
  const size_t smem = (size_t)slots * run_bytes + kMaxSlots * 8 +
                      (size_t)runs_per_tile * 4;
  cudaError_t err = cudaFuncSetAttribute(
      dma_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dma_gather_kernel<<<(unsigned)num_tiles, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(run_starts),
      static_cast<float*>(out), runs_per_tile, row_floats, rows_per_run,
      slots);
  return (int)cudaGetLastError();
}

const char* mpgnn_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
