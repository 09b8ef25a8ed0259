// The library's current device.
//
// The library links the CUDA runtime statically, so it keeps its own current
// device, apart from PyTorch's: every entry launches on the device current
// in this runtime, which is device 0 until it is set. The wrappers set it to
// the device of their tensors before each launch (ops/cuda/build.py:stream),
// so that a kernel on a tensor of cuda:1 launches on cuda:1. A kernel's
// per-device state, such as the scratch kernel's shared-memory grant
// (cudaFuncSetAttribute in scratch.cu), then lands on that device as well.

#include <cuda_runtime.h>

// Make `device` current in this runtime. Returns the CUDA error.
extern "C" int polar_set_device(int device) {
  return (int)cudaSetDevice(device);
}

// Write this runtime's current device to *device. Returns the CUDA error.
extern "C" int polar_get_device(int* device) {
  return (int)cudaGetDevice(device);
}
