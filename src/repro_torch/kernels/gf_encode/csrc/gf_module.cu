// Load and launch the per-matrix gf_encode kernels (gf_encode.cu, compiled
// at first use of a matrix by kernel.py) through the CUDA driver API, and
// copy wire rows between cards on a stream the caller names.
//
// The cubin is loaded into the current device's primary context (the one
// PyTorch uses), and each launch goes on the caller's stream with a grid of
// as many blocks as the card holds at once (or fewer, if the work is
// smaller): the kernel's grid-stride loop does the rest. Every function
// returns the driver's CUresult (0 on success).

#include <cuda.h>
#include <cuda_runtime.h>

extern "C" int gf_module_load(const void* cubin, const char* name, void** fn_out) {
  cudaFree(nullptr);  // makes the device's primary context current on this thread
  CUmodule mod;
  CUresult rc = cuModuleLoadData(&mod, cubin);
  if (rc != CUDA_SUCCESS) return static_cast<int>(rc);
  CUfunction fn;
  rc = cuModuleGetFunction(&fn, mod, name);
  if (rc != CUDA_SUCCESS) return static_cast<int>(rc);
  *fn_out = fn;
  return 0;
}

// gf_encode_kernel(data, out, Bp, O) of a loaded module, over `groups`
// thread tasks per object.
extern "C" int gf_module_launch_encode(void* fn, const void* data, void* out, long long Bp, int O,
                                       long long groups, int threads, void* stream) {
  const CUfunction f = static_cast<CUfunction>(fn);
  int per_sm = 0, dev = 0, sms = 0;
  CUresult rc = cuOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, f, threads, 0);
  if (rc != CUDA_SUCCESS) return static_cast<int>(rc);
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long grid = (groups + threads - 1) / threads;
  const long long resident = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > resident) grid = resident;
  if (grid < 1) grid = 1;
  void* args[] = {&data, &out, &Bp, &O};
  return static_cast<int>(cuLaunchKernel(f, static_cast<unsigned>(grid), 1, 1, threads, 1, 1, 0,
                                         static_cast<CUstream>(stream), args, nullptr));
}

// `bytes` bytes from `src` to `dst` on the caller's stream, which may belong
// to either pointer's card: with unified addressing the driver finds both
// cards, and between two cards it is a peer copy (over NVLink where the
// stream's card may access the other's memory).
extern "C" int gf_copy_async(void* dst, const void* src, long long bytes, void* stream) {
  return static_cast<int>(cuMemcpyAsync(reinterpret_cast<CUdeviceptr>(dst),
                                        reinterpret_cast<CUdeviceptr>(src),
                                        static_cast<size_t>(bytes),
                                        static_cast<CUstream>(stream)));
}
