// The keyed grid scan (K8) for NVIDIA Hopper (sm_90a), templated on a
// step policy: a stateful Map_GPU / Filter_GPU step compiled in.
//
// Replaces the XLA program of windflow_tpu/tpu/ops_tpu.py:_grid_scan_core
// (:212; also reached from tpu/fused_ops.py:207 and mesh/core.py:762-795),
// no Pallas kernel. There, rows scatter to a (KB x M) grid of (key slot,
// per-key position) and a lax.scan walks the M positions with the user's
// step vmapped over the KB keys. Here, as in the original WindFlow
// (Stateful_MAPGPU_Kernel, map_gpu.hpp:80-102), one thread walks one
// touched key's rows in arrival order with the key's state in registers:
// the batch arrives as a CSR built on the host (or, on the mesh, on the
// device): `order`, the rows grouped by the key's local slot in arrival
// order, and `starts`, KB + 1 offsets into it; `touched[k]` is key k's row
// of the state table. Thread k loads table[touched[k]], walks
// order[starts[k] : starts[k + 1]], applies the step to every row `valid`
// admits (a row it excludes, padding or dropped by a fused filter earlier
// in the chain, leaves the state as it is) and writes the computed output
// columns at the row's own position (a row `valid` excludes gets zeros:
// in filter mode, the keep byte is keep & valid), then stores the state
// back and sets dirty[touched[k]] for every touched key, as the JAX
// bitmap does (conservative). The rows past the walked ones,
// order[starts[n_touched] :], get zeros too (padding lanes; on the mesh,
// the invalid received lanes), so every output row is written. One launch
// a batch on the current stream.
//
// The step policy S (combine_codegen.py: step_source):
//   S::NIN, S::NOUT, S::NST    row columns read, computed output columns
//                              (filter mode: one, the keep byte) and state
//                              leaves; S::RIN, S::ROUT, S::RST the same,
//                              at least 1 (array sizes);
//   S::in_bytes(c), S::out_bytes(j), S::st_bytes(l)
//                              4, or 1 for a bool column or leaf;
//   S::step(r, s, o)           the step on one row's words r and the
//                              state's words s: o the computed outputs, s
//                              the new state, each in its column's dtype.
// Pass-through columns (an input column returned unchanged) are not the
// kernel's: the wrapper returns the input tensor itself.
//
// What bounds it: the chain of dependent steps. A key's rows are a serial
// dependence through the state, so one thread per key is the parallelism
// there is; with few keys (64 keys, 1,024 rows each) the card holds 64
// threads and the time is the longest key's chain of loads and steps.
// Row loads do not depend on the state: the walk takes WF_SCAN_UNROLL rows
// at a time (fewer when a row has many columns, to stay in registers),
// issues their valid bytes and column loads together, and the order
// indices of the next group before it steps the current one, so a group
// costs about one round trip to memory, not one per row. Bytes: each row's
// columns, valid byte and order index read once, the outputs written once,
// each touched key's state read and written once. Index math is 32-bit:
// the wrapper refuses n, KB + 1 or a table of 2^31 - 1 rows or more.
//
// Include after combine_codegen.py's prelude (WFG_HD). Outside nvcc the
// same code compiles with g++ into a serial host walk (the CPU tests run
// it); only the kernel and its launch need the CUDA toolkit.

#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#endif

#define WF_SCAN_THREADS 128
#define WF_SCAN_UNROLL 8

namespace wf_scan {

// the kernel's arguments, one struct passed by value (column pointers
// read at constant offsets once the field loops unroll)
template <class S>
struct ScanArgs {
    const void* in[S::RIN];
    void* out[S::ROUT];
    void* table[S::RST];
    uint8_t* dirty;
    const uint8_t* valid;
    const int32_t* order;
    const int32_t* starts;
    const int32_t* touched;
    int n_touched;
    int n_rows;
};

WFG_HD uint32_t load_word(const void* p, int i, int bytes) {
    return bytes == 1 ? (uint32_t)(static_cast<const uint8_t*>(p)[i] != 0)
                      : static_cast<const uint32_t*>(p)[i];
}

WFG_HD void store_word(void* p, int i, int bytes, uint32_t w) {
    if (bytes == 1)
        static_cast<uint8_t*>(p)[i] = (uint8_t)(w != 0u);
    else
        static_cast<uint32_t*>(p)[i] = w;
}

// rows a walk takes at a time: their columns stay in registers
template <class S>
WFG_HDC constexpr int unroll() {
    return S::NIN <= 4 ? WF_SCAN_UNROLL : S::NIN <= 8 ? 4
                                        : S::NIN <= 16 ? 2 : 1;
}

// one touched key's walk: what thread k of wf_grid_scan does
template <class S>
WFG_HD void scan_key(const ScanArgs<S>& a, int k) {
    constexpr int U = unroll<S>();
    const int slot = a.touched[k];
    uint32_t s[S::RST];
#pragma unroll
    for (int l = 0; l < S::NST; ++l)
        s[l] = load_word(a.table[l], slot, S::st_bytes(l));
    const int lo = a.starts[k], hi = a.starts[k + 1];
    int cur[U];
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = lo + u < hi ? a.order[lo + u] : 0;
    for (int base = lo; base < hi; base += U) {
        // this group's rows: valid bytes and columns, all issued at once
        uint32_t r[U][S::RIN];
        bool ok[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const bool live = base + u < hi;
            ok[u] = live && a.valid[cur[u]] != 0;
#pragma unroll
            for (int c = 0; c < S::RIN; ++c)
                r[u][c] = live && c < S::NIN
                              ? load_word(a.in[c], cur[u], S::in_bytes(c))
                              : 0u;
        }
        // the next group's order indices, in flight while this one steps
        int nxt[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int i = base + U + u;
            nxt[u] = i < hi ? a.order[i] : 0;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (base + u < hi) {
                uint32_t o[S::ROUT];
#pragma unroll
                for (int j = 0; j < S::ROUT; ++j) o[j] = 0u;
                if (ok[u]) S::step(r[u], s, o);
#pragma unroll
                for (int j = 0; j < S::NOUT; ++j)
                    store_word(a.out[j], cur[u], S::out_bytes(j), o[j]);
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) cur[u] = nxt[u];
    }
#pragma unroll
    for (int l = 0; l < S::NST; ++l)
        store_word(a.table[l], slot, S::st_bytes(l), s[l]);
    a.dirty[slot] = 1;
}

// tail position t: a row no key walks gets zeros in every output column
template <class S>
WFG_HD void zero_tail(const ScanArgs<S>& a, int t) {
    const long long p = (long long)a.starts[a.n_touched] + t;
    if (p >= a.n_rows) return;
    const int row = a.order[p];
#pragma unroll
    for (int j = 0; j < S::NOUT; ++j)
        store_word(a.out[j], row, S::out_bytes(j), 0u);
}

// thread t: key t's walk (t < n_touched) and tail position t
template <class S>
WFG_HD void scan_thread(const ScanArgs<S>& a, int t) {
    if (t < a.n_touched) scan_key<S>(a, t);
    if (S::NOUT > 0) zero_tail<S>(a, t);
}

inline bool bad_args(int n_touched, int n_rows, int n_threads) {
    return n_touched < 0 || n_rows < 0 || n_threads < 0 ||
           n_threads < n_touched;
}

inline const char* error_string(int code) {
    if (code == -1) return "invalid arguments";
#if defined(__CUDACC__)
    return cudaGetErrorString(static_cast<cudaError_t>(code));
#else
    return "error";
#endif
}

#if defined(__CUDACC__)
template <class S>
__global__ void __launch_bounds__(WF_SCAN_THREADS)
    wf_grid_scan(const __grid_constant__ ScanArgs<S> a, int n_threads) {
    const int t = blockIdx.x * WF_SCAN_THREADS + threadIdx.x;
    if (t < n_threads) scan_thread<S>(a, t);
}

// One launch of n_threads threads (at least n_touched, and enough for the
// tail). Returns 0, a cudaError_t, or -1 for arguments it does not take.
template <class S>
int run_grid_scan(const ScanArgs<S>& a, int n_threads, cudaStream_t st) {
    if (bad_args(a.n_touched, a.n_rows, n_threads)) return -1;
    if (n_threads == 0) return 0;
    const unsigned blocks =
        (unsigned)((n_threads + WF_SCAN_THREADS - 1) / WF_SCAN_THREADS);
    wf_grid_scan<S><<<blocks, WF_SCAN_THREADS, 0, st>>>(a, n_threads);
    return (int)cudaGetLastError();
}
#else
// the same threads, one after the other, on the host (the CPU tests)
template <class S>
int run_grid_scan(const ScanArgs<S>& a, int n_threads, void*) {
    if (bad_args(a.n_touched, a.n_rows, n_threads)) return -1;
    for (int t = 0; t < n_threads; ++t) scan_thread<S>(a, t);
    return 0;
}
#endif

template <class S>
ScanArgs<S> scan_args(void** in, void** out, void** table, void* dirty,
                      const void* valid, const void* order,
                      const void* starts, const void* touched, int n_touched,
                      int n_rows) {
    ScanArgs<S> a;
    for (int c = 0; c < S::RIN; ++c) a.in[c] = c < S::NIN ? in[c] : nullptr;
    for (int j = 0; j < S::ROUT; ++j)
        a.out[j] = j < S::NOUT ? out[j] : nullptr;
    for (int l = 0; l < S::RST; ++l) a.table[l] = table[l];
    a.dirty = static_cast<uint8_t*>(dirty);
    a.valid = static_cast<const uint8_t*>(valid);
    a.order = static_cast<const int32_t*>(order);
    a.starts = static_cast<const int32_t*>(starts);
    a.touched = static_cast<const int32_t*>(touched);
    a.n_touched = n_touched;
    a.n_rows = n_rows;
    return a;
}

}  // namespace wf_scan

#if defined(__CUDACC__)
#define WF_SCAN_STREAM(s) static_cast<cudaStream_t>(s)
#else
#define WF_SCAN_STREAM(s) (s)
#endif

// The C entry points of a step's library: `Step` is its policy, which
// takes exactly Step::NIN input columns, Step::NOUT output columns and
// Step::NST state leaves.
#define WF_GRID_SCAN_ENTRY_POINTS(Step)                                      \
    extern "C" {                                                             \
    int wf_grid_scan(void** in, int n_in, void** out, int n_out,            \
                     void** table, int n_state, void* dirty,                 \
                     const void* valid, const void* order,                   \
                     const void* starts, const void* touched, int n_touched, \
                     int n_rows, int n_threads, void* stream) {              \
        if (n_in != Step::NIN || n_out != Step::NOUT ||                      \
            n_state != Step::NST)                                            \
            return -1;                                                       \
        return wf_scan::run_grid_scan<Step>(                                 \
            wf_scan::scan_args<Step>(in, out, table, dirty, valid, order,    \
                                     starts, touched, n_touched, n_rows),    \
            n_threads, WF_SCAN_STREAM(stream));                              \
    }                                                                        \
    const char* wf_error_string(int code) {                                  \
        return wf_scan::error_string(code);                                  \
    }                                                                        \
    }
