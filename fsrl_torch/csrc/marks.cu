// Device marks: the card's half of fsrl_torch.utils.profiling's trace.
//
// A mark is a one-thread kernel launched on the current stream. It reads
// %globaltimer and appends (sequence number, time, mark id, cycle index) to
// a ring in this library's own __device__ memory, outside the torch
// allocator. The write index lives on the device and advances at every
// execution, so a mark recorded into a CUDA graph appends one entry at each
// replay with no host sync. The ring is copied to the host only when the
// trace is read.
//
// A second kernel writes %globaltimer into one word that the host reads
// after a synchronize: the calibration that maps the card's timer onto the
// host clock.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr unsigned long long CAPACITY = 1ull << 16;   // a power of two

struct Mark {
  unsigned long long seq;     // the mark's number since the process began
  unsigned long long time;    // %globaltimer, ns
  unsigned int id;
  unsigned int cycle;
};
static_assert(sizeof(Mark) == 24, "the host reads 24-byte entries");

__device__ Mark g_ring[CAPACITY];
__device__ unsigned long long g_count;
__device__ unsigned long long g_clock;

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__global__ void mark_kernel(unsigned int id, unsigned int cycle) {
  const unsigned long long t = globaltimer();
  const unsigned long long i = atomicAdd(&g_count, 1ull);
  Mark& m = g_ring[i & (CAPACITY - 1)];
  m.seq = i;
  m.time = t;
  m.id = id;
  m.cycle = cycle;
}

__global__ void clock_kernel() { g_clock = globaltimer(); }

}  // namespace

extern "C" int fsrl_mark(int id, int cycle, void* stream) {
  mark_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((unsigned int)id,
                                                 (unsigned int)cycle);
  return (int)cudaGetLastError();
}

extern "C" long fsrl_marks_capacity() { return (long)CAPACITY; }

// The ring and the number of marks written so far; the caller has drained
// the device first.
extern "C" int fsrl_marks_read(void* ring, unsigned long long* count) {
  cudaError_t e = cudaMemcpyFromSymbol(count, g_count, sizeof(*count));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(ring, g_ring, sizeof(g_ring));
  return (int)e;
}

extern "C" int fsrl_marks_clock(void* stream) {
  clock_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// The word the last clock kernel wrote; the caller has synchronized.
extern "C" int fsrl_marks_clock_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_clock, sizeof(*out));
}
