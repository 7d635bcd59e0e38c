// The FFAT step's device programs for NVIDIA Hopper (sm_90a), templated on
// K1's combine policy (forest_rebuild.cuh: C::NF, C::bytes(f), and
// cb.node(l, r, vl, vr, o), the FlatFAT node rule: combine(l, r) when both
// sides are valid, else the valid side, the right one when neither is).
//
// Replaces two device programs of the JAX package's FFAT step, which XLA
// compiles there (no Pallas kernel):
//
// - K2+K3, wf_ffat_ingest: the segmented scan and the leaf scatter-combine
//   of windflow_tpu/tpu/ffat_tpu.py:_make_step.step (:409; the
//   associative_scan at :454, the tail merge at :458-469). The wrapper
//   sorts the packed composite key (slot * F + leaf, sentinel K_cap * F
//   for late and padding rows) with torch.sort(stable=True); one launch
//   then folds each run of equal sorted keys, in row order, and merges the
//   fold into its leaf at (key / F) * 2F + F + key % F: combine(leaf,
//   fold) if the leaf was valid, else the fold; the leaf becomes valid.
//   Only a run's tail is merged, as the JAX step uses
//   only the scan's segment tails; tails are unique per (slot, leaf), so
//   no write needs an atomic.
//   Design: a warp takes 32 sorted rows at a time and finds the runs that
//   start there (a ballot); it folds each such run in chunks of 32 rows,
//   one row a lane, read through the sort's order (the value columns stay
//   unsorted), with an in-order shuffle tree (the left operand is always
//   the lower lane) and a running fold in lane 0 across chunks. The
//   combine is associative but not commutative (ysb_last keeps the later
//   side), so every node keeps (earlier, later) order; float sums are
//   grouped as a tree, not as the plain version's Hillis-Steele scan.
//   What bounds it: memory, each row's value planes, key and order read
//   once, each tail's leaf and validity byte read and written once; a run
//   is folded by one warp, so a few long runs leave the card idle.
// - K4, wf_ffat_query: the window query with eviction of _make_step.step
//   steps 4-6 and _make_fire_step.fire (:547): for each fire lane the
//   ordered combine with validity of the ring range [start, start + len)
//   of its slot's tree row, at most two physical leaf ranges, each walked
//   bottom-up with a left and a right accumulator exactly as
//   windflow_tpu/tpu/ffat_tpu.py:_query_fns range_query (:302) and the
//   port's plain version do: the same nodes in the same order, every node
//   read (a node that is not taken still passes its value through an
//   invalid accumulator), so the kernel is bit-identical to its plain
//   version, floats included. It writes the values, valid & mask and the
//   key column, then clears the validity of the evicted leaves.
//   Design: one thread a window. A fire step evicts leaves that later
//   windows of the same slot still read (win > slide), so no eviction may
//   land before every query of its slot: the host lays the fire and evict
//   lanes out chunk by chunk, one chunk a slot, and gives each block whole
//   chunks (`bounds`); a block evicts after a __syncthreads(). Lanes with
//   mask 0 (padding) read slot 0 only through invalid ranges, whose
//   validity bytes never reach the result. What bounds it: memory, each
//   window's taken nodes and their validity, its output row and one byte
//   an eviction; at the main path's few hundred windows a step, latency.
//
// Index math is 32-bit: the wrappers refuse planes of 2^31 - 1 nodes or
// more (kernels/ffat_step.py).

#pragma once

#include "forest_rebuild.cuh"

#define WF_INGEST_THREADS 256
#define WF_QUERY_THREADS 128

namespace wf {

template <class C>
__device__ __forceinline__ void load_row(const Planes<C::NF>& pl, int at,
                                         uint32_t (&w)[C::NF]) {
#pragma unroll
    for (int f = 0; f < C::NF; ++f) w[f] = ld_node<C>(pl, f, at);
}

template <class C>
__device__ __forceinline__ void store_row(const Planes<C::NF>& pl, int at,
                                          const uint32_t (&w)[C::NF]) {
#pragma unroll
    for (int f = 0; f < C::NF; ++f) st_node<C>(pl, f, at, w[f]);
}

template <int NF>
__device__ __forceinline__ void copy_row(uint32_t (&d)[NF],
                                         const uint32_t (&s)[NF]) {
#pragma unroll
    for (int f = 0; f < NF; ++f) d[f] = s[f];
}

// a <- node(a, b): the accumulator on the left (earlier) side
template <class C>
__device__ __forceinline__ void fold_right(const C& cb,
                                           uint32_t (&a)[C::NF], bool& va,
                                           const uint32_t (&b)[C::NF],
                                           bool vb) {
    uint32_t m[C::NF];
    cb.node(a, b, va, vb, m);
    copy_row<C::NF>(a, m);
    va = va || vb;
}

// a <- node(b, a): the accumulator on the right (later) side
template <class C>
__device__ __forceinline__ void fold_left(const C& cb,
                                          uint32_t (&a)[C::NF], bool& va,
                                          const uint32_t (&b)[C::NF],
                                          bool vb) {
    uint32_t m[C::NF];
    cb.node(b, a, vb, va, m);
    copy_row<C::NF>(a, m);
    va = va || vb;
}

}  // namespace wf

// ------------------------------------------------------------ K2 + K3 ---
template <class C, typename CT>
__global__ void __launch_bounds__(WF_INGEST_THREADS)
wf_ffat_ingest(Planes<C::NF> forest, Planes<C::NF> vals, const C cb,
               uint8_t* __restrict__ valid, const CT* __restrict__ comp,
               const int32_t* __restrict__ order, int n, int log2F,
               int sentinel) {
    constexpr int NF = C::NF;
    constexpr int WARPS = WF_INGEST_THREADS / 32;
    const int lane = threadIdx.x & 31;
    const int F = 1 << log2F;
    const int n_warps = gridDim.x * WARPS;
    for (int w = blockIdx.x * WARPS + (threadIdx.x >> 5); w < (n + 31) >> 5;
         w += n_warps) {
        const int i = (w << 5) + lane;
        int key = i < n ? (int)comp[order[i]] : sentinel;
        int prev = __shfl_up_sync(WF_FULL, key, 1);
        if (lane == 0) prev = i > 0 ? (int)comp[order[i - 1]] : -1;
        uint32_t starts = __ballot_sync(
            WF_FULL, i < n && key >= 0 && key < sentinel && key != prev);
        while (starts) {
            const int s_lane = __ffs(starts) - 1;
            starts &= starts - 1;
            const int k = __shfl_sync(WF_FULL, key, s_lane);
            uint32_t acc[NF];
#pragma unroll
            for (int f = 0; f < NF; ++f) acc[f] = 0;
            bool acc_v = false;
            for (int row = (w << 5) + s_lane;; row += 32) {
                const int j = row + lane;
                bool in = false;
                uint32_t v[NF];
#pragma unroll
                for (int f = 0; f < NF; ++f) v[f] = 0;
                if (j < n) {
                    const int src = order[j];
                    in = (int)comp[src] == k;
                    if (in) wf::load_row<C>(vals, src, v);
                }
                // the rows of a run are consecutive: `in` is a prefix of
                // the lanes, so lane 0 ends with the chunk's ordered fold
                bool b = in;
#pragma unroll
                for (int o = 1; o < 32; o <<= 1) {
                    uint32_t y[NF];
#pragma unroll
                    for (int f = 0; f < NF; ++f)
                        y[f] = __shfl_down_sync(WF_FULL, v[f], o);
                    const bool yb =
                        (__shfl_down_sync(WF_FULL, b ? 1 : 0, o) != 0) &&
                        lane + o < 32;
                    wf::fold_right<C>(cb, v, b, y, yb);
                }
                if (lane == 0) wf::fold_right<C>(cb, acc, acc_v, v, b);
                if (__ballot_sync(WF_FULL, in) != WF_FULL) break;
            }
            if (lane == 0) {
                const int at =
                    ((k >> log2F) << (log2F + 1)) + F + (k & (F - 1));
                uint32_t cur[NF];
                wf::load_row<C>(forest, at, cur);
                bool lv = valid[at] != 0;
                wf::fold_right<C>(cb, cur, lv, acc, true);
                wf::store_row<C>(forest, at, cur);
                valid[at] = 1;
            }
        }
    }
}

// ------------------------------------------------------------------ K4 ---
// The ordered combine with validity of physical leaves [lo, lo + len) of
// the tree row at `base`: the plain version's walk, node for node.
template <class C>
__device__ __forceinline__ void range_walk(const C& cb,
                                           const Planes<C::NF>& tr,
                                           const uint8_t* valid, int base,
                                           int lo, int len, int F, int logq,
                                           uint32_t (&out)[C::NF], bool& ov) {
    constexpr int NF = C::NF;
    const int nn = 2 * F;
    uint32_t la[NF], ra[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) la[f] = ra[f] = 0;
    bool lv = false, rv = false;
    int l = lo + F, r = lo + len + F;
    for (int it = 0; it < logq; ++it) {
        uint32_t x[NF];
        const bool take_l = (l & 1) && l < r;
        const int il = base + min(max(l, 0), nn - 1);
        wf::load_row<C>(tr, il, x);
        wf::fold_right<C>(cb, la, lv, x, valid[il] != 0 && take_l);
        if (take_l) ++l;
        const bool take_r = (r & 1) && l < r;
        const int ir = base + min(max(r - 1, 0), nn - 1);
        wf::load_row<C>(tr, ir, x);
        wf::fold_left<C>(cb, ra, rv, x, valid[ir] != 0 && take_r);
        if (take_r) --r;
        l >>= 1;
        r >>= 1;
    }
    cb.node(la, ra, lv, rv, out);
    ov = lv || rv;
}

// fpack: (5, W) int32 rows slot, start, len, wid, mask; epack: (3, E)
// rows slot, leaf, mask; bounds: (2, B + 1), block b's fire lanes
// [bounds[b], bounds[b + 1]) and evict lanes [bounds[B + 1 + b],
// bounds[B + 2 + b]) (fire_blocks in kernels/ffat_step.py). ktable: a
// per-slot key table of key_bytes-byte keys (null: no key column).
template <class C>
__global__ void __launch_bounds__(WF_QUERY_THREADS)
wf_ffat_query(Planes<C::NF> tr, const C cb, uint8_t* valid, int n_rows,
              int log2F, const int32_t* __restrict__ fpack, int W,
              const int32_t* __restrict__ epack, int E,
              const int32_t* __restrict__ bounds, int B, Planes<C::NF> out,
              uint8_t* __restrict__ qv, const uint8_t* __restrict__ ktable,
              uint8_t* __restrict__ kout, int key_bytes) {
    constexpr int NF = C::NF;
    const int F = 1 << log2F;
    const int logq = log2F + 2;  // (2F).bit_length()
    const int f0 = bounds[blockIdx.x], f1 = bounds[blockIdx.x + 1];
    const int e0 = bounds[B + 1 + blockIdx.x], e1 = bounds[B + 2 + blockIdx.x];
    for (int i = f0 + threadIdx.x; i < f1; i += WF_QUERY_THREADS) {
        const int slot = min(max(fpack[i], 0), n_rows - 1);
        const int start = fpack[W + i], len = fpack[2 * W + i];
        const bool mask = fpack[4 * W + i] != 0;
        const int base = slot << (log2F + 1);
        const int len1 = min(len, F - start);
        uint32_t r1[NF], r2[NF], res[NF];
        bool v1, v2;
        range_walk<C>(cb, tr, valid, base, start, len1, F, logq, r1, v1);
        range_walk<C>(cb, tr, valid, base, 0, len - len1, F, logq, r2, v2);
        cb.node(r1, r2, v1, v2, res);
        wf::store_row<C>(out, i, res);
        qv[i] = (v1 || v2) && mask ? 1 : 0;
        if (kout != nullptr) {
            const uint8_t* src = ktable + (size_t)slot * key_bytes;
            for (int b = 0; b < key_bytes; ++b)
                kout[(size_t)i * key_bytes + b] = mask ? src[b] : 0;
        }
    }
    if (e1 > e0) {
        // block-uniform: every query of this block's slots has read
        __syncthreads();
        for (int i = e0 + threadIdx.x; i < e1; i += WF_QUERY_THREADS)
            if (epack[2 * E + i] != 0)
                valid[(epack[i] << (log2F + 1)) + F + epack[E + i]] = 0;
    }
}

// ---------------------------------------------------------------- host ---
namespace wf {

inline int log2_of(int F) {
    int l = 0;
    while ((1 << l) < F) ++l;
    return l;
}

// One launch of K2+K3 over n sorted rows. Returns 0, a cudaError_t, or -1
// for arguments the kernel does not take (the wrapper checks first).
template <class C>
int run_ingest(const Planes<C::NF>& forest, const Planes<C::NF>& vals,
               const C& cb, uint8_t* valid, const void* comp, int comp_bytes,
               const int32_t* order, int n, int F, int sentinel,
               cudaStream_t st) {
    if (n < 1 || F < 2 || (F & (F - 1)) != 0 || sentinel < 0 ||
        (comp_bytes != 2 && comp_bytes != 4))
        return -1;
    const int log2F = log2_of(F);
    const long long warps = ((long long)n + 31) / 32;
    const int per_block = WF_INGEST_THREADS / 32;
    const unsigned blocks = (unsigned)((warps + per_block - 1) / per_block);
    if (comp_bytes == 2)
        wf_ffat_ingest<C, int16_t><<<blocks, WF_INGEST_THREADS, 0, st>>>(
            forest, vals, cb, valid, static_cast<const int16_t*>(comp), order,
            n, log2F, sentinel);
    else
        wf_ffat_ingest<C, int32_t><<<blocks, WF_INGEST_THREADS, 0, st>>>(
            forest, vals, cb, valid, static_cast<const int32_t*>(comp), order,
            n, log2F, sentinel);
    return (int)cudaGetLastError();
}

// One launch of K4 over W fire lanes in B blocks (`bounds`).
template <class C>
int run_query(const Planes<C::NF>& tr, const C& cb, uint8_t* valid,
              int n_rows, int F, const int32_t* fpack, int W,
              const int32_t* epack, int E, const int32_t* bounds, int B,
              const Planes<C::NF>& out, uint8_t* qv, const void* ktable,
              void* kout, int key_bytes, cudaStream_t st) {
    if (W < 1 || n_rows < 1 || F < 2 || (F & (F - 1)) != 0 || E < 0 ||
        (E > 0 && epack == nullptr) || bounds == nullptr || B < 1 ||
        ((kout != nullptr) &&
         (key_bytes != 1 && key_bytes != 2 && key_bytes != 4 &&
          key_bytes != 8)))
        return -1;
    wf_ffat_query<C><<<(unsigned)B, WF_QUERY_THREADS, 0, st>>>(
        tr, cb, valid, n_rows, log2_of(F), fpack, W, epack, E, bounds, B, out,
        qv, static_cast<const uint8_t*>(ktable), static_cast<uint8_t*>(kout),
        key_bytes);
    return (int)cudaGetLastError();
}

template <int NF>
Planes<NF> planes_of(void** p) {
    Planes<NF> pl;
    for (int f = 0; f < NF; ++f) pl.ptr[f] = p[f];
    return pl;
}

}  // namespace wf

// The C entry points of K2+K3 and K4 for a traced variant, beside
// WF_REBUILD_ENTRY_POINTS: `Comb` takes exactly Comb::NF planes (`kinds`
// is not read). forest_rebuild.cu defines the fieldwise library's own.
#define WF_FFAT_ENTRY_POINTS(Comb)                                           \
    extern "C" {                                                             \
    int wf_ffat_ingest(void** planes, void** vals, const int* kinds,         \
                       int n_fields, void* valid, const void* comp,          \
                       int comp_bytes, const void* order, int n, int F,      \
                       int sentinel, void* stream) {                         \
        (void)kinds;                                                         \
        if (n_fields != Comb::NF) return -1;                                 \
        return wf::run_ingest<Comb>(                                         \
            wf::planes_of<Comb::NF>(planes), wf::planes_of<Comb::NF>(vals),  \
            Comb{}, static_cast<uint8_t*>(valid), comp, comp_bytes,          \
            static_cast<const int32_t*>(order), n, F, sentinel,              \
            static_cast<cudaStream_t>(stream));                              \
    }                                                                        \
    int wf_ffat_query(void** planes, const int* kinds, int n_fields,         \
                      void* valid, int n_rows, int F, const void* fpack,     \
                      int W, const void* epack, int E, const void* bounds,   \
                      int B, void** out, void* qv, const void* ktable,       \
                      void* kout, int key_bytes, void* stream) {             \
        (void)kinds;                                                         \
        if (n_fields != Comb::NF) return -1;                                 \
        return wf::run_query<Comb>(                                          \
            wf::planes_of<Comb::NF>(planes), Comb{},                         \
            static_cast<uint8_t*>(valid), n_rows, F,                         \
            static_cast<const int32_t*>(fpack), W,                           \
            static_cast<const int32_t*>(epack), E,                           \
            static_cast<const int32_t*>(bounds), B,                          \
            wf::planes_of<Comb::NF>(out), static_cast<uint8_t*>(qv), ktable, \
            kout, key_bytes, static_cast<cudaStream_t>(stream));             \
    }                                                                        \
    }
