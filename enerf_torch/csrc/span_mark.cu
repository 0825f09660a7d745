// Device marks of the span registry (utils/profiling.py): one thread stamps
// the card's global nanosecond timer into a ring in device memory.
//
// A span launches one mark on the current stream at its start and one at
// its end, so the two stamps bracket the span's work on that stream.  Under
// a CUDA graph capture the launch becomes a graph node: every replay of the
// graph stamps again, into the next free slots, and the host reads the ring
// only when it drains it (one synchronize and one copy).
//
// A slot is two 64-bit words, the time in ns and the tag (span id * 2 +
// 0 at the start, 1 at the end).  The slot is taken with an atomic add on
// a 64-bit counter that only grows, so the host knows how many marks were
// written and where the newest ones lie (counter mod capacity).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void span_mark_kernel(unsigned long long* ring, unsigned long long* head,
                                 unsigned long long capacity, unsigned long long tag) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned long long slot = atomicAdd(head, 1ULL) % capacity;
  ring[2 * slot] = t;
  ring[2 * slot + 1] = tag;
}

}  // namespace

// Launch one mark on `stream`; returns the launch's cudaError_t.
extern "C" int span_mark_launch(void* ring, void* head, unsigned long long capacity,
                                unsigned long long tag, void* stream) {
  span_mark_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(ring), static_cast<unsigned long long*>(head),
      capacity, tag);
  return static_cast<int>(cudaGetLastError());
}
