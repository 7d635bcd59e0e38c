// A host stand-in for the CUDA runtime, so that the port's kernel headers
// (windflow_tpu_torch/kernels/*.cuh) build with g++ and run on the CPU
// (tests/torch_kernel_host.py converts a translation unit for it: a launch
// <<<grid, block, smem, stream>>> becomes wf_emul_launch, the inline PTX
// of the look-back's acquire / release becomes __atomic builtins, and
// `extern __shared__` arrays point into one host buffer). Blocks run one
// after another, the threads of a block as OS threads: __syncthreads is a
// block barrier, a warp shuffle or vote an exchange through a per-warp
// buffer between two warp barriers. Blocks in sequence still see every
// earlier block's writes, so a decoupled look-back and a last-block
// counter run as on the card, though without their races.
#pragma once
#include <stdint.h>
#include <string.h>
#include <math.h>
#include <algorithm>
#include <atomic>
#include <barrier>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __shared__ static
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __grid_constant__
#define __align__(n) __attribute__((aligned(n)))
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaDevAttrMultiProcessorCount = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 2 };
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
    return {a, b, c, d};
}
struct WfDim { unsigned x = 0, y = 0, z = 0; };
inline thread_local WfDim threadIdx;
inline WfDim blockIdx, gridDim, blockDim;
inline std::mutex wf_atomic_mu;
inline std::unique_ptr<std::barrier<>> wf_block_bar;
inline std::vector<std::unique_ptr<std::barrier<>>> wf_warp_bar;
inline uint64_t wf_xchg[64][32];
alignas(16) inline unsigned char wf_emul_dyn_smem[1 << 20];

template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcg(const T* p) {
    return __atomic_load_n(p, __ATOMIC_ACQUIRE);
}
template <class T> void __stcg(T* p, T v) {
    __atomic_store_n(p, v, __ATOMIC_RELEASE);
}
inline void __syncthreads() { wf_block_bar->arrive_and_wait(); }
inline void __syncwarp() { wf_warp_bar[threadIdx.x / 32]->arrive_and_wait(); }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }

template <class T>
T wf_exchange(T v, int src) {
    const int w = threadIdx.x / 32, l = threadIdx.x % 32;
    uint64_t bits = 0;
    memcpy(&bits, &v, sizeof(T));
    wf_xchg[w][l] = bits;
    wf_warp_bar[w]->arrive_and_wait();
    T out;
    const uint64_t got = wf_xchg[w][src];
    memcpy(&out, &got, sizeof(T));
    wf_warp_bar[w]->arrive_and_wait();
    return out;
}
template <class T> T __shfl_sync(unsigned, T v, int src, int width = 32) {
    const int l = threadIdx.x % 32;
    return wf_exchange(v, (l / width) * width + src % width);
}
template <class T> T __shfl_up_sync(unsigned, T v, unsigned d, int width = 32) {
    const int l = threadIdx.x % 32;
    return wf_exchange(v, (l % width) >= (int)d ? l - (int)d : l);
}
template <class T> T __shfl_down_sync(unsigned, T v, unsigned d, int width = 32) {
    const int l = threadIdx.x % 32;
    return wf_exchange(v, (l % width) + (int)d < width ? l + (int)d : l);
}
inline unsigned __ballot_sync(unsigned, int p) {
    const int w = threadIdx.x / 32, l = threadIdx.x % 32;
    wf_xchg[w][l] = p ? 1u : 0u;
    wf_warp_bar[w]->arrive_and_wait();
    unsigned m = 0;
    for (int s = 0; s < 32; ++s) m |= (wf_xchg[w][s] ? 1u : 0u) << s;
    wf_warp_bar[w]->arrive_and_wait();
    return m;
}
inline int __all_sync(unsigned mask, int p) { return __ballot_sync(mask, p) == 0xffffffffu; }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
    std::lock_guard<std::mutex> g(wf_atomic_mu);
    const unsigned o = *p; *p = o + v; return o;
}
inline unsigned atomicExch(unsigned* p, unsigned v) {
    std::lock_guard<std::mutex> g(wf_atomic_mu);
    const unsigned o = *p; *p = v; return o;
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __clz(int x) { return x ? __builtin_clz(x) : 32; }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
inline float __uint_as_float(uint32_t w) { float f; memcpy(&f, &w, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t w; memcpy(&w, &f, 4); return w; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return 0; }
template <class K> cudaError_t cudaFuncSetAttribute(K, int, int) { return 0; }
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, int) {
    *n = 1; return 0;
}
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }

template <class F>
void wf_emul_launch(unsigned grid, unsigned block, size_t smem, cudaStream_t,
                    F f) {
    (void)smem;
    gridDim.x = grid;
    blockDim.x = block;
    for (unsigned b = 0; b < grid; ++b) {
        blockIdx.x = b;
        wf_block_bar = std::make_unique<std::barrier<>>(block);
        wf_warp_bar.clear();
        for (unsigned w = 0; w < (block + 31) / 32; ++w)
            wf_warp_bar.push_back(std::make_unique<std::barrier<>>(
                std::min(32u, block - 32 * w)));
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < block; ++t)
            ts.emplace_back([&, t] { threadIdx.x = t; f(); });
        for (auto& t : ts) t.join();
    }
}
