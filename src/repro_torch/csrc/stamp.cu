// A device stamp for Hopper (sm_90a): %globaltimer between two kernels.
//
// Replaces no TPU kernel.  The port's tracing (obs/stamps.py) launches one
// at each module boundary of a prefill or decode graph that it captures
// with a recorder: a replay runs none of the model's Python, so the only
// record of where a replay's time went is written on the device.  One
// thread reads %globaltimer (ns) and stores it into
//     buf[(replay % capacity) * n_slots + slot],
// replay being a counter on the device that the graph's last stamp
// advances by one, so the host reads the stamps once per batch and not
// once per replay.  Every kernel of the port is ordered on the stream it
// is launched on (no programmatic dependent launch), so a stamp starts
// after the kernel before it has ended and ends before the kernel after
// it starts.
//
// What bounds it: one launch; its work is one 4-byte load and one 8-byte
// store.  Its cost is the gap a graph leaves around a node (obs/stamps.py
// and PERF.md give it measured).
//
// Plain C interface, loaded with ctypes; the entry returns
// cudaGetLastError() right after its launch.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

__global__ void stamp_kernel(unsigned long long* buf, unsigned int* counter,
                             unsigned int capacity, unsigned int n_slots,
                             unsigned int slot, int last) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const unsigned int replay = *counter;
  buf[static_cast<size_t>(replay % capacity) * n_slots + slot] = t;
  if (last) *counter = replay + 1;
}

}  // namespace

extern "C" int stamp_launch(void* buf, void* counter, int capacity,
                            int n_slots, int slot, int last, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(buf),
      static_cast<unsigned int*>(counter),
      static_cast<unsigned int>(capacity),
      static_cast<unsigned int>(n_slots), static_cast<unsigned int>(slot),
      last);
  return static_cast<int>(cudaGetLastError());
}
