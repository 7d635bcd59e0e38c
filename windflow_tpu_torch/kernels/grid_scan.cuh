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
// of the state table. The walker of key k loads table[touched[k]], walks
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
// dependence through the state, so one walker per key is the parallelism
// there is, and a key's walk must keep arrival order (the float adds land
// as the plain version's do). The loads do not depend on the state, so
// the design takes them off the chain, in two regimes of one launch,
// chosen per key by its run length against `heavy_rows` (one runtime
// argument, so the regimes never disagree on a key):
// - The thread regime (runs shorter than heavy_rows): one thread a key
//   (scan_key). The walk takes WF_SCAN_UNROLL rows at a time (fewer when
//   a row has many columns, to stay in registers), issues their valid
//   bytes and column loads together, and the order indices of the next
//   group before it steps the current one, so a group costs about one
//   round trip to memory, not one per row. The threads also zero the
//   rows no key walks (zero_tail). A thread whose key is heavy returns.
// - The block regime (runs of heavy_rows or more; the wrapper lists them
//   in `heavy`: longest first from the host, or every key with -1 for a
//   light one from the mesh's cards): one block of 128 threads a heavy key,
//   warp-specialised. Three producer warps gather the key's rows a tile
//   of `tile_rows` at a time into a ring of WF_SCAN_STAGES tiles in
//   dynamic shared memory: each row's order index (coalesced), then
//   through it the 4-byte columns the step reads by cp.async, and the
//   valid byte and 1-byte columns through a register; each tile is
//   signalled full on an mbarrier (the cp.async arrive tracks the
//   copies, a plain arrive releases the stores). Lane 0 of the fourth
//   warp walks each full tile from shared memory, the state in
//   registers: a group of rows' shared loads issued ahead of their steps,
//   the steps back to back, then their outputs stored straight to their
//   rows (a store waiting on a step's result would stall the chain); it
//   releases the tile on the tile's empty mbarrier. So a row costs the walker a few shared
//   loads and the step, not a round trip to device memory. A launch with
//   fewer blocks than list entries strides over the list, loading
//   WF_SCAN_LIST_UNROLL of its entries at a time, so the -1 entries of a
//   sparse list cost a round trip a group (next_heavy); a block that
//   finds no heavy key exits.
// Bytes: each row's columns, valid byte and order index read once, the
// outputs written once, each touched key's state read and written once.
// Index math is 32-bit: the wrapper refuses n, KB + 1 or a table of
// 2^31 - 1 rows or more.
//
// Include after combine_codegen.py's prelude (WFG_HD). Outside nvcc the
// same code compiles with g++ into a serial host walk (the CPU tests run
// it): each block's tiles staged by its producer threads one after the
// other into a ring in host memory, then walked; only the kernel, its
// barriers and copies, and its launch need the CUDA toolkit.

#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#else
#include <vector>
#endif

#define WF_SCAN_THREADS 128
#define WF_SCAN_UNROLL 8
#define WF_SCAN_PRODUCERS 96  // three producer warps; lane 0 of the 4th walks
#define WF_SCAN_STAGES 4      // tiles in the ring
#define WF_SCAN_STAGE_UNROLL 4  // rows a producer thread issues at a time
#define WF_SCAN_LIST_UNROLL 8   // heavy-list entries a block loads at a time
// the ring's barriers (full and empty, one each a stage) ahead of it
#define WF_SCAN_BARRIER_BYTES (16 * WF_SCAN_STAGES)
// the most dynamic shared memory a launch gets without opting in
#define WF_SCAN_MAX_SMEM 49152

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
    const int32_t* heavy;  // the block regime's keys; -1 for none
    int n_touched;
    int n_rows;
    int n_heavy;     // entries of `heavy`
    int heavy_rows;  // a run this long or longer takes the block regime
    int tile_rows;   // rows of a ring tile
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

template <class S>
WFG_HD void load_state(const ScanArgs<S>& a, int slot, uint32_t (&s)[S::RST]) {
#pragma unroll
    for (int l = 0; l < S::NST; ++l)
        s[l] = load_word(a.table[l], slot, S::st_bytes(l));
}

template <class S>
WFG_HD void store_state(const ScanArgs<S>& a, int slot,
                        const uint32_t (&s)[S::RST]) {
#pragma unroll
    for (int l = 0; l < S::NST; ++l)
        store_word(a.table[l], slot, S::st_bytes(l), s[l]);
    a.dirty[slot] = 1;
}

// one row's step and its outputs at the row's position (zeros where
// `valid` excludes the row)
template <class S>
WFG_HD void step_row(const ScanArgs<S>& a, int row, bool ok,
                     const uint32_t (&r)[S::RIN], uint32_t (&s)[S::RST]) {
    uint32_t o[S::ROUT];
#pragma unroll
    for (int j = 0; j < S::ROUT; ++j) o[j] = 0u;
    if (ok) S::step(r, s, o);
#pragma unroll
    for (int j = 0; j < S::NOUT; ++j)
        store_word(a.out[j], row, S::out_bytes(j), o[j]);
}

// ------------------------------------------------------- thread regime ---
// one touched key's walk: what thread k of wf_grid_scan does (BLOCKS:
// the launch holds block-regime blocks, and a heavy key's walk is theirs)
template <class S, bool BLOCKS>
WFG_HD void scan_key(const ScanArgs<S>& a, int k) {
    constexpr int U = unroll<S>();
    const int slot = a.touched[k];
    uint32_t s[S::RST];
    load_state<S>(a, slot, s);
    // a heavy key walks no row here; the state's load is issued above
    // with the run's, not after it (a heavy key's is read, never written)
    const int lo = a.starts[k], end = a.starts[k + 1];
    const bool heavy = BLOCKS && end - lo >= a.heavy_rows;
    const int hi = heavy ? lo : end;
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
        for (int u = 0; u < U; ++u)
            if (base + u < hi) step_row<S>(a, cur[u], ok[u], r[u], s);
#pragma unroll
        for (int u = 0; u < U; ++u) cur[u] = nxt[u];
    }
    if (!heavy) store_state<S>(a, slot, s);
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
template <class S, bool BLOCKS>
WFG_HD void scan_thread(const ScanArgs<S>& a, int t) {
    if (t < a.n_touched) scan_key<S, BLOCKS>(a, t);
    if (S::NOUT > 0) zero_tail<S>(a, t);
}

// -------------------------------------------------------- block regime ---
// a row's bytes in a tile: its order index, valid byte, read columns
template <class S>
WFG_HDC constexpr int row_bytes() {
    int b = 4 + 1;
    for (int c = 0; c < S::NIN; ++c) b += S::in_bytes(c);
    return b;
}

// a tile's bytes, rounded to 16 so every tile's words stay aligned
template <class S>
WFG_HD int tile_bytes(int tile_rows) {
    return (row_bytes<S>() * tile_rows + 15) & ~15;
}

// the ring's dynamic shared memory: its barriers, then its tiles
template <class S>
WFG_HD long long ring_bytes(int tile_rows) {
    return WF_SCAN_BARRIER_BYTES +
           (long long)WF_SCAN_STAGES * tile_bytes<S>(tile_rows);
}

// One tile of the ring: the rows' order indices and the 4-byte columns,
// then the valid bytes and the 1-byte columns, each an array of
// tile_rows.
template <class S>
struct Tile {
    int32_t* idx;
    uint8_t* ok;
    uint8_t* col[S::RIN];
};

template <class S>
WFG_HD Tile<S> tile_at(uint8_t* ring, int tile_rows, int stage) {
    Tile<S> t;
    uint8_t* p = ring + (long long)stage * tile_bytes<S>(tile_rows);
    t.idx = reinterpret_cast<int32_t*>(p);
    p += 4 * tile_rows;
#pragma unroll
    for (int c = 0; c < S::RIN; ++c)
        if (c < S::NIN && S::in_bytes(c) == 4) {
            t.col[c] = p;
            p += 4 * tile_rows;
        }
    t.ok = p;
    p += tile_rows;
#pragma unroll
    for (int c = 0; c < S::RIN; ++c)
        if (c >= S::NIN || S::in_bytes(c) == 1) {
            t.col[c] = p;
            p += c < S::NIN ? tile_rows : 0;
        }
    return t;
}

#if defined(__CUDACC__)
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

// an arrive on `bar` once this thread's cp.async copies so far have
// landed (the barrier's count includes it)
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    }
}
#endif

// a 4-byte word from device memory into the ring (cp.async on the card)
WFG_HD void copy_word(uint8_t* dst, const void* src) {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
#else
    *reinterpret_cast<uint32_t*>(dst) = *static_cast<const uint32_t*>(src);
#endif
}

// Producer thread `pt`'s share of a tile, rows order[p : p + n]: rows pt,
// pt + 96, ...; WF_SCAN_STAGE_UNROLL of them issued at a time.
template <class S>
WFG_HD void stage_rows(const ScanArgs<S>& a, const Tile<S>& t, int p, int n,
                       int pt) {
    constexpr int U = WF_SCAN_STAGE_UNROLL;
    constexpr int P = WF_SCAN_PRODUCERS;
    for (int base = pt; base < n; base += U * P) {
        int i[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int q = base + u * P;
            i[u] = q < n ? a.order[p + q] : 0;
        }
        uint8_t b[U][S::RIN + 1];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int q = base + u * P;
            if (q >= n) continue;
            t.idx[q] = i[u];
#pragma unroll
            for (int c = 0; c < S::RIN; ++c)
                if (c < S::NIN && S::in_bytes(c) == 4)
                    copy_word(t.col[c] + 4 * q,
                              static_cast<const uint32_t*>(a.in[c]) + i[u]);
            b[u][S::RIN] = a.valid[i[u]];
#pragma unroll
            for (int c = 0; c < S::RIN; ++c)
                if (c < S::NIN && S::in_bytes(c) == 1)
                    b[u][c] = static_cast<const uint8_t*>(a.in[c])[i[u]];
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int q = base + u * P;
            if (q >= n) continue;
            t.ok[q] = b[u][S::RIN];
#pragma unroll
            for (int c = 0; c < S::RIN; ++c)
                if (c < S::NIN && S::in_bytes(c) == 1) t.col[c][q] = b[u][c];
        }
    }
}

// rows the block walker steps between its stores: their ring words and
// outputs stay in registers
template <class S>
WFG_HDC constexpr int walk_unroll() {
    return S::NIN + S::NOUT <= 4 ? 8 : S::NIN + S::NOUT <= 8 ? 4
                                     : S::NIN + S::NOUT <= 16 ? 2 : 1;
}

// the walker over rows [base, base + U) of a staged tile of n rows (FULL:
// all U are in it, so no row needs a check): their ring words loaded
// together, the steps back to back (the state's chain), then the stores,
// so no store stalls the chain
template <class S, bool FULL>
WFG_HD void walk_group(const ScanArgs<S>& a, const Tile<S>& t, int base,
                       int n, uint32_t (&s)[S::RST]) {
    constexpr int U = walk_unroll<S>();
    uint32_t r[U][S::RIN];
    uint32_t o[U][S::ROUT];
    bool ok[U];
    int row[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int q = base + u;
        const bool live = FULL || q < n;
        ok[u] = live && t.ok[q] != 0;
        row[u] = live ? t.idx[q] : 0;
#pragma unroll
        for (int c = 0; c < S::RIN; ++c)
            r[u][c] = live && c < S::NIN
                          ? load_word(t.col[c], q, S::in_bytes(c))
                          : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int j = 0; j < S::ROUT; ++j) o[u][j] = 0u;
        if (ok[u]) S::step(r[u], s, o[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
        if (FULL || base + u < n) {
#pragma unroll
            for (int j = 0; j < S::NOUT; ++j)
                store_word(a.out[j], row[u], S::out_bytes(j), o[u][j]);
        }
}

// the walker over a staged tile of n rows, the state in registers
template <class S>
WFG_HD void walk_tile(const ScanArgs<S>& a, const Tile<S>& t, int n,
                      uint32_t (&s)[S::RST]) {
    constexpr int U = walk_unroll<S>();
    int base = 0;
    for (; base + U <= n; base += U) walk_group<S, true>(a, t, base, n, s);
    if (base < n) walk_group<S, false>(a, t, base, n, s);
}

// The first entry of the heavy list at or after e, stepping by nb, that
// names a heavy key (k, its run [lo, hi)), or n_heavy where none is left.
// The entries load WF_SCAN_LIST_UNROLL at a time, all issued together: a
// -1 entry (or, defensively, a key out of range or not heavy) is skipped.
// int arithmetic (64-bit indices cost the tier step's walker a spill):
// bad_args keeps n_heavy + WF_SCAN_LIST_UNROLL * nb inside int.
template <class S>
WFG_HD int next_heavy(const ScanArgs<S>& a, int e, int nb, int& k, int& lo,
                      int& hi) {
    for (; e < a.n_heavy; e += WF_SCAN_LIST_UNROLL * nb) {
        int ks[WF_SCAN_LIST_UNROLL];
#pragma unroll
        for (int u = 0; u < WF_SCAN_LIST_UNROLL; ++u) {
            const int f = e + u * nb;
            ks[u] = f < a.n_heavy ? a.heavy[f] : -1;
        }
#pragma unroll
        for (int u = 0; u < WF_SCAN_LIST_UNROLL; ++u) {
            if (ks[u] < 0 || ks[u] >= a.n_touched) continue;
            lo = a.starts[ks[u]];
            hi = a.starts[ks[u] + 1];
            if (hi - lo >= a.heavy_rows) {
                k = ks[u];
                return e + u * nb;
            }
        }
    }
    return a.n_heavy;
}

inline bool bad_args(int n_touched, int n_rows, int n_threads, int n_heavy,
                     int heavy_blocks, int heavy_rows, int tile_rows,
                     long long ring) {
    return n_touched < 0 || n_rows < 0 || n_threads < 0 ||
           n_threads < n_touched || n_heavy < 0 || heavy_blocks < 0 ||
           heavy_rows < 1 ||
           (long long)n_heavy + (long long)WF_SCAN_LIST_UNROLL * heavy_blocks >
               2147483647LL ||
           (heavy_blocks > 0 &&
            (tile_rows < 1 || ring > WF_SCAN_MAX_SMEM || n_heavy == 0));
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
// Block b of heavy_blocks: list entries b, b + heavy_blocks, ...
template <class S>
__device__ void heavy_block(const ScanArgs<S>& a, int b, int nb) {
    extern __shared__ __align__(16) uint8_t smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* empty = full + WF_SCAN_STAGES;
    uint8_t* ring = smem + WF_SCAN_BARRIER_BYTES;
    const int tid = threadIdx.x;
    if (tid == 0) {
        for (int s = 0; s < WF_SCAN_STAGES; ++s) {
            // each producer thread arrives twice: copies landed, stores done
            mbar_init(&full[s], 2 * WF_SCAN_PRODUCERS);
            mbar_init(&empty[s], 1);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    int g = 0;  // tiles of this block so far: stage g % STAGES
    int k, lo, hi;
    if (tid < WF_SCAN_PRODUCERS) {
        for (int e = next_heavy<S>(a, b, nb, k, lo, hi); e < a.n_heavy;
             e = next_heavy<S>(a, e + nb, nb, k, lo, hi)) {
            for (int p = lo; p < hi; p += a.tile_rows, ++g) {
                const int s = g % WF_SCAN_STAGES;
                // the tile's previous use walked (the first use passes)
                mbar_wait(&empty[s], ((g / WF_SCAN_STAGES) & 1) ^ 1);
                const int n = min(a.tile_rows, hi - p);
                stage_rows<S>(a, tile_at<S>(ring, a.tile_rows, s), p, n, tid);
                mbar_arrive_copies(&full[s]);
                mbar_arrive(&full[s]);
            }
        }
    } else if (tid == WF_SCAN_PRODUCERS) {
        for (int e = next_heavy<S>(a, b, nb, k, lo, hi); e < a.n_heavy;
             e = next_heavy<S>(a, e + nb, nb, k, lo, hi)) {
            const int slot = a.touched[k];
            uint32_t st[S::RST];
            load_state<S>(a, slot, st);
            for (int p = lo; p < hi; p += a.tile_rows, ++g) {
                const int s = g % WF_SCAN_STAGES;
                mbar_wait(&full[s], (g / WF_SCAN_STAGES) & 1);
                walk_tile<S>(a, tile_at<S>(ring, a.tile_rows, s),
                             min(a.tile_rows, hi - p), st);
                mbar_arrive(&empty[s]);
            }
            store_state<S>(a, slot, st);
        }
    }
}

// BLOCKS: the launch holds block-regime blocks, the first heavy_blocks
// (else the thread regime alone, with none of the block regime's code)
template <class S, bool BLOCKS>
__global__ void __launch_bounds__(WF_SCAN_THREADS)
    wf_grid_scan(const __grid_constant__ ScanArgs<S> a, int n_threads,
                 int heavy_blocks) {
    int b = blockIdx.x;
    if (BLOCKS) {
        if (b < heavy_blocks) {
            heavy_block<S>(a, b, heavy_blocks);
            return;
        }
        b -= heavy_blocks;
    }
    const int t = b * WF_SCAN_THREADS + threadIdx.x;
    if (t < n_threads) scan_thread<S, BLOCKS>(a, t);
}

// One launch: heavy_blocks blocks of the block regime (first, so the
// longest chains start first), then the thread regime's n_threads
// threads (at least n_touched, and enough for the tail). The ring's
// shared memory is asked for only when a block-regime block runs.
// Returns 0, a cudaError_t, or -1 for arguments it does not take.
template <class S>
int run_grid_scan(const ScanArgs<S>& a, int n_threads, int heavy_blocks,
                  cudaStream_t st) {
    const long long ring = ring_bytes<S>(a.tile_rows);
    if (bad_args(a.n_touched, a.n_rows, n_threads, a.n_heavy, heavy_blocks,
                 a.heavy_rows, a.tile_rows, ring))
        return -1;
    if (n_threads == 0 && heavy_blocks == 0) return 0;
    const unsigned blocks =
        (unsigned)heavy_blocks +
        (unsigned)((n_threads + WF_SCAN_THREADS - 1) / WF_SCAN_THREADS);
    if (heavy_blocks == 0) {
        wf_grid_scan<S, false><<<blocks, WF_SCAN_THREADS, 0, st>>>(
            a, n_threads, 0);
        return (int)cudaGetLastError();
    }
    wf_grid_scan<S, true><<<blocks, WF_SCAN_THREADS, (size_t)ring, st>>>(
        a, n_threads, heavy_blocks);
    return (int)cudaGetLastError();
}
#else
// The same launch on the host, one block and one thread after the other:
// each block-regime block stages a tile with its producer threads in turn
// into a ring in host memory, then walks it.
template <class S>
int run_grid_scan(const ScanArgs<S>& a, int n_threads, int heavy_blocks,
                  void*) {
    const long long ring_size = ring_bytes<S>(a.tile_rows);
    if (bad_args(a.n_touched, a.n_rows, n_threads, a.n_heavy, heavy_blocks,
                 a.heavy_rows, a.tile_rows, ring_size))
        return -1;
    if (heavy_blocks > 0) {
        std::vector<uint64_t> mem((ring_size + 7) / 8);
        uint8_t* ring = reinterpret_cast<uint8_t*>(mem.data()) +
                        WF_SCAN_BARRIER_BYTES;
        for (int b = 0; b < heavy_blocks; ++b) {
            int g = 0;
            int k, lo, hi;
            for (int e = next_heavy<S>(a, b, heavy_blocks, k, lo, hi);
                 e < a.n_heavy;
                 e = next_heavy<S>(a, e + heavy_blocks, heavy_blocks, k,
                                   lo, hi)) {
                const int slot = a.touched[k];
                uint32_t st[S::RST];
                load_state<S>(a, slot, st);
                for (int p = lo; p < hi; p += a.tile_rows, ++g) {
                    const Tile<S> t =
                        tile_at<S>(ring, a.tile_rows, g % WF_SCAN_STAGES);
                    const int n = a.tile_rows < hi - p ? a.tile_rows : hi - p;
                    for (int pt = 0; pt < WF_SCAN_PRODUCERS; ++pt)
                        stage_rows<S>(a, t, p, n, pt);
                    walk_tile<S>(a, t, n, st);
                }
                store_state<S>(a, slot, st);
            }
        }
    }
    for (int t = 0; t < n_threads; ++t)
        if (heavy_blocks > 0)
            scan_thread<S, true>(a, t);
        else
            scan_thread<S, false>(a, t);
    return 0;
}
#endif

template <class S>
ScanArgs<S> scan_args(void** in, void** out, void** table, void* dirty,
                      const void* valid, const void* order,
                      const void* starts, const void* touched,
                      const void* heavy, int n_touched, int n_rows,
                      int n_heavy, int heavy_rows, int tile_rows) {
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
    a.heavy = static_cast<const int32_t*>(heavy);
    a.n_touched = n_touched;
    a.n_rows = n_rows;
    a.n_heavy = n_heavy;
    a.heavy_rows = heavy_rows;
    a.tile_rows = tile_rows;
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
// Step::NST state leaves. wf_ring_bytes(tile_rows) is the block regime's
// dynamic shared memory at that tile size.
#define WF_GRID_SCAN_ENTRY_POINTS(Step)                                      \
    extern "C" {                                                             \
    int wf_grid_scan(void** in, int n_in, void** out, int n_out,            \
                     void** table, int n_state, void* dirty,                 \
                     const void* valid, const void* order,                   \
                     const void* starts, const void* touched,                \
                     const void* heavy, int n_touched, int n_rows,           \
                     int n_threads, int n_heavy, int heavy_blocks,           \
                     int heavy_rows, int tile_rows, void* stream) {          \
        if (n_in != Step::NIN || n_out != Step::NOUT ||                      \
            n_state != Step::NST)                                            \
            return -1;                                                       \
        return wf_scan::run_grid_scan<Step>(                                 \
            wf_scan::scan_args<Step>(in, out, table, dirty, valid, order,    \
                                     starts, touched, heavy, n_touched,      \
                                     n_rows, n_heavy, heavy_rows,            \
                                     tile_rows),                             \
            n_threads, heavy_blocks, WF_SCAN_STREAM(stream));                \
    }                                                                        \
    long long wf_ring_bytes(int tile_rows) {                                 \
        return wf_scan::ring_bytes<Step>(tile_rows);                         \
    }                                                                        \
    const char* wf_error_string(int code) {                                  \
        return wf_scan::error_string(code);                                  \
    }                                                                        \
    }
