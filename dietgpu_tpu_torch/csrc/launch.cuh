// The launch path of every source here: a kernel's launch shape, what the
// CUDA runtime says of the kernel at that shape, and the report of its
// resources that each dtt_*_resources entry point returns.
//
// A source describes each kernel once (dtt::Kernel) and puts its own grid
// formula on top. The runtime is asked once a kernel and device, at its
// first launch or report there: the function attributes are set, and the
// device's SM count, the kernel's CTAs per SM and its attributes are read
// and kept. A later launch asks only for the current device, so a launch
// inside a CUDA graph capture (which follows an eager launch of the same
// kernel: _build.py loads no kernel inside a capture) makes no other
// query. A failed query is the launch's error and is asked again next time.
// ctypes releases the interpreter lock during a call, so two threads may
// launch at once: a Fit is filled under the kernel's lock and published by
// a release store, which a launch reads with an acquire load.

#pragma once

#include <atomic>
#include <mutex>

#include <cuda_runtime.h>

namespace dtt {

constexpr int kMaxDevices = 64;  // devices a process may launch a kernel on

// What the runtime says of a kernel on one device, at its launch shape.
struct Fit {
  int sms;                  // the device's SMs
  int per_sm;               // CTAs of the kernel an SM holds
  cudaFuncAttributes attr;  // its registers, static shared and local bytes
};

// A kernel and its launch shape: threads a CTA, dynamic shared bytes a CTA
// (the attribute that allows more than 48 KiB is set where it has any), and
// whether it prefers shared memory to L1, so that the CTAs its shared bytes
// allow fit on an SM.
class Kernel {
 public:
  template <class F>
  Kernel(F* fn, int threads, int smem, bool max_shared)
      : threads(threads), smem(smem), fn_(reinterpret_cast<const void*>(fn)),
        max_shared_(max_shared) {}

  const int threads;
  const int smem;

  // The kernel's Fit on the current device, into *out.
  cudaError_t fit(const Fit** out) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!ready_[dev].load(std::memory_order_acquire)) {
      std::lock_guard<std::mutex> hold(mu_);
      if (!ready_[dev].load(std::memory_order_relaxed)) {
        if ((e = ask(dev, &fits_[dev])) != cudaSuccess) return e;
        ready_[dev].store(true, std::memory_order_release);
      }
    }
    *out = &fits_[dev];
    return cudaSuccess;
  }

  // `want` CTAs, at most one wave of them on the current device (a CTA an
  // SM where the runtime says none fits) and at least 1, into *grid.
  cudaError_t wave(long long want, unsigned* grid) {
    const Fit* f = nullptr;
    const cudaError_t e = fit(&f);
    if (e != cudaSuccess) return e;
    const long long cap = (long long)f->sms * (f->per_sm > 0 ? f->per_sm : 1);
    const long long g = want > cap ? cap : want;
    *grid = (unsigned)(g < 1 ? 1 : g);
    return cudaSuccess;
  }

  // Registers a thread, static and dynamic shared bytes a CTA, local
  // (spilled) bytes a thread, threads a CTA and CTAs per SM at the launch
  // shape, into out[0..5].
  int report(int* out) {
    const Fit* f = nullptr;
    const cudaError_t e = fit(&f);
    if (e != cudaSuccess) return (int)e;
    out[0] = f->attr.numRegs;
    out[1] = (int)f->attr.sharedSizeBytes;
    out[2] = smem;
    out[3] = (int)f->attr.localSizeBytes;
    out[4] = threads;
    out[5] = f->per_sm;
    return (int)cudaSuccess;
  }

 private:
  cudaError_t ask(int dev, Fit* f) const {
    cudaError_t e = cudaSuccess;
    if (smem > 0) {
      e = cudaFuncSetAttribute(fn_, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    if (e == cudaSuccess && max_shared_) {
      e = cudaFuncSetAttribute(fn_, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    }
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&f->sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f->per_sm, fn_, threads, smem);
    }
    return e == cudaSuccess ? cudaFuncGetAttributes(&f->attr, fn_) : e;
  }

  const void* fn_;
  const bool max_shared_;
  std::mutex mu_;
  std::atomic<bool> ready_[kMaxDevices] = {};
  Fit fits_[kMaxDevices] = {};
};

}  // namespace dtt
