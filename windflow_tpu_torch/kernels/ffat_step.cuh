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
//   for late and padding rows) with torch.sort(stable=True) and passes
//   the sorted keys with the order; one launch then folds each run of
//   equal sorted keys, in row order, and merges the fold into its leaf at
//   (key / F) * 2F + F + key % F: combine(leaf, fold) if the leaf was
//   valid, else the fold; the leaf becomes valid. Only a run's tail is
//   merged, as the JAX step uses only the scan's segment tails; tails are
//   unique per (slot, leaf), so no write needs an atomic.
//   Design: a tiled segmented fold with a decoupled look-back. A block
//   of 128 threads takes a tile of ITEMS sorted rows a thread (4, 2 or 1
//   as NF grows, so every library builds with no spill), its index a
//   ticket in arrival order. Each thread issues its loads before it
//   combines anything: the sorted keys (and the two beside its rows, for
//   the run edges) and the order, contiguous; then, together, the value
//   rows through the order (the value columns stay unsorted; rows on the
//   sentinel read none) and the leaves of the runs whose last row it
//   holds (only that thread writes them). It folds its rows in order,
//   then a segmented inclusive scan over the block (shuffles within a
//   warp, shared memory across warps) combines the threads' trailing
//   folds with (ha, a) + (hb, b) = (ha | hb, hb ? b : a . b), the earlier
//   side always the left operand (ysb_last and argmax_ts do not commute).
//   Across tiles: a tile that holds a run head publishes its inclusive
//   prefix (its trailing fold) at once, a tile inside one run its
//   aggregate first; when a live run reaches into a tile, the tile's last
//   warp walks back over the earlier tiles, 32 a round (one status word a
//   lane, an ordered shuffle fold), to the first prefix, and that carry
//   is the left operand of the run's fold. Status words carry the
//   launch's sequence number (the wrapper's, per device and stream), so
//   no launch clears them; they live in a buffer of their own, one word
//   a tile at a place fixed by the tile's index, apart from the
//   published rows, so no value of an earlier launch can read as a
//   status; the last ticket resets the ticket counter. The
//   thread holding a run's last row merges it into its leaf; tails that
//   need no carry merge while the look-back runs. What bounds it: memory,
//   each row's value planes, key and order read once, each tail's leaf
//   and validity byte read and written once; at the main path's 65,536
//   rows, the chain of dependent round trips (ticket; keys and order;
//   values and leaves; look-back; stores), whatever the run lengths.
//   Float sums group by tile, warp and thread, not as the plain version's
//   Hillis-Steele scan. The tiled fold itself is tile_fold, over an IO
//   policy that loads a row and stores a run's fold.
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
//   Design: eight lanes a window, four windows a warp. The nodes of the
//   walk depend only on (start, len, F), so the lanes compute them up
//   front and load them together: lane 4h + c of a window's group holds,
//   for q = 0-3, the node of step 2q + h of chain c (range 1 left, range
//   1 right, range 2 left, range 2 right), a round of eight steps (32
//   nodes) in one trip to memory; F <= 64 takes one round, F 1,024 two.
//   The chains fold at once, chain c in lanes c and c + 4, each in the
//   plain walk's order, the nodes shuffled in; then node(la, ra) for each
//   range and node(r1, r2), as the plain version joins them. A fire step
//   evicts leaves that later windows of the same slot still read (win >
//   slide), so no eviction may land before every query of its slot: the
//   host lays the fire and evict lanes out chunk by chunk, one chunk a
//   slot, and gives each block whole chunks (`bounds`, WF_QUERY_WINDOWS
//   windows a block); a block evicts after a __syncthreads(). Lanes with
//   mask 0 (padding) read slot 0 only through invalid ranges, whose
//   validity bytes never reach the result. What bounds it: memory, each
//   window's taken nodes and their validity, its output row and one byte
//   an eviction; at the main path's 64 to 8,192 windows a step, the chain
//   of round trips (pack, nodes, output).
//
// Index math is 32-bit: the wrappers refuse planes of 2^31 - 1 nodes or
// more (kernels/ffat_step.py).

#pragma once

#include "forest_rebuild.cuh"

#define WF_INGEST_THREADS 128
#define WF_QUERY_GROUP 8      // lanes a window
#define WF_QUERY_WINDOWS 32   // windows a block (ffat_step.py: QUERY_LANES)
#define WF_QUERY_THREADS (WF_QUERY_GROUP * WF_QUERY_WINDOWS)
// Both kernels declare one block an SM as their minimum: with the block
// size alone, ptxas trims registers to the next resident-block threshold
// and spilled K4's 8-field fieldwise instance to stay at 64.

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

// b <- a . b: the combine of two valid rows, a the earlier one
template <class C>
__device__ __forceinline__ void fold_into(const C& cb,
                                          const uint32_t (&a)[C::NF],
                                          uint32_t (&b)[C::NF]) {
    uint32_t m[C::NF];
    cb.node(a, b, true, true, m);
    copy_row<C::NF>(b, m);
}

// rows a thread of K2+K3 folds: its values stay in registers
template <int NF>
__host__ __device__ constexpr int ingest_items() {
    return NF <= 2 ? 4 : NF <= 4 ? 2 : 1;
}

// K2+K3's look-back status: the launch's sequence number << 2 | state
constexpr uint32_t ST_AGGREGATE = 1, ST_PREFIX = 2;

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
    uint32_t v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_release(uint32_t* p, uint32_t v) {
    asm volatile("st.release.gpu.global.u32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
}

// one tile's published row: NF words in L2 (never a stale L1 line)
template <int NF>
__device__ __forceinline__ void publish(uint32_t* dst, uint32_t* status,
                                        const uint32_t (&w)[NF],
                                        uint32_t word) {
#pragma unroll
    for (int f = 0; f < NF; ++f) __stcg(dst + f, w[f]);
    st_release(status, word);
}

}  // namespace wf

// ------------------------------------------------------------ K2 + K3 ---
namespace wf {

// (acc_h, acc) <- (acc_h, acc) + (bh, b): the segmented scan's operator,
// acc the earlier side
template <class C>
__device__ __forceinline__ void seg_fold(const C& cb, uint32_t (&acc)[C::NF],
                                         bool& acc_h,
                                         const uint32_t (&b)[C::NF],
                                         bool bh) {
    uint32_t m[C::NF];
    cb.node(acc, b, true, true, m);
#pragma unroll
    for (int f = 0; f < C::NF; ++f) acc[f] = bh ? b[f] : m[f];
    acc_h = acc_h || bh;
}

// a run's fold merged into its leaf `at`, read before (`cur`, `lv`)
template <class C>
__device__ __forceinline__ void merge_leaf(const C& cb,
                                           const Planes<C::NF>& forest,
                                           uint8_t* valid, int at,
                                           const uint32_t (&cur)[C::NF],
                                           bool lv,
                                           const uint32_t (&fold)[C::NF]) {
    uint32_t m[C::NF];
    cb.node(cur, fold, lv, true, m);
    store_row<C>(forest, at, m);
    valid[at] = 1;
}

// K2+K3's rows: each value row read through the order, each run tail's
// leaf read with the rows (only the tail's own thread writes it) and the
// run's fold merged into it. The IO policy of the tiled fold (tile_fold):
// load(k, src, key, live, tail, v) fills row k of the thread (`v`, zeros
// unless `live`), store(cb, k, key, v) takes the fold of a run whose last
// row is row k.
template <class C, int ITEMS>
struct LeafIO {
    Planes<C::NF> forest, vals;
    uint8_t* valid;
    int log2F;
    int at[ITEMS];
    uint32_t cur[ITEMS][C::NF];
    bool lv[ITEMS];

    __device__ __forceinline__ void load(int k, int src, int key, bool live,
                                         bool tail, uint32_t (&v)[C::NF]) {
#pragma unroll
        for (int f = 0; f < C::NF; ++f) v[f] = cur[k][f] = 0;
        if (live) load_row<C>(vals, src, v);
        at[k] = ((key >> log2F) << (log2F + 1)) + (1 << log2F)
            + (key & ((1 << log2F) - 1));
        lv[k] = false;
        if (tail) {
            load_row<C>(forest, at[k], cur[k]);
            lv[k] = valid[at[k]] != 0;
        }
    }

    __device__ __forceinline__ void store(const C& cb, int k, int,
                                          const uint32_t (&v)[C::NF]) {
        merge_leaf<C>(cb, forest, valid, at[k], cur[k], lv[k], v);
    }
};

// A thread's rows from sorted row r0: the sorted keys (and the two beside
// them) and the order, then, together, the live rows through the IO
// policy; the rows' run heads and tails as bits.
template <class C, typename KT, int ITEMS, class IO>
__device__ __forceinline__ void load_tile(
    IO& io, const KT* skeys, const int32_t* order, int n, int sentinel,
    int r0, int (&key)[ITEMS], uint32_t (&v)[ITEMS][C::NF], uint32_t& heads,
    uint32_t& tails) {
    int src[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        const int row = r0 + k;
        key[k] = row < n ? (int)skeys[row] : sentinel;
        src[k] = row < n ? order[row] : 0;
    }
    // the keys beside the thread's rows; none past the last row (the
    // last tile's threads past n read nothing)
    const int kprev = r0 > 0 && r0 - 1 < n ? (int)skeys[r0 - 1] : sentinel;
    const int knext = r0 + ITEMS < n ? (int)skeys[r0 + ITEMS] : 0;
    heads = tails = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        const bool first = k == 0 && r0 == 0;
        const bool last = k == ITEMS - 1 && r0 + ITEMS >= n;
        if (first || key[k] != (k == 0 ? kprev : key[k - 1]))
            heads |= 1u << k;
        if ((last || key[k] != (k == ITEMS - 1 ? knext : key[k + 1])) &&
            key[k] >= 0 && key[k] < sentinel)
            tails |= 1u << k;
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
        io.load(k, src[k], key[k], key[k] >= 0 && key[k] < sentinel,
                (tails >> k & 1u) != 0, v[k]);
}

// The tiled segmented fold with its look-back (see the header comment):
// one tile of WF_INGEST_THREADS threads x ITEMS sorted rows, its index a
// ticket in arrival order (returned). Each run of equal keys below the
// sentinel folds in row order with cb.node(earlier, later, true, true),
// and the thread holding its last row hands the fold to io.store.
// status: [0] the tile ticket, [1, 1 + T) the tiles' status words; rows:
// the tiles' aggregates, then their inclusive prefixes, NF words a tile.
// A status word sits at the same place whatever n and NF are, and no
// value is ever written to the status buffer, so an earlier launch leaves
// only status words of other sequence numbers there.
template <class C, typename KT, int ITEMS, class IO>
__device__ __forceinline__ int tile_fold(const C& cb, IO& io,
                                         const KT* skeys,
                                         const int32_t* order, int n,
                                         int sentinel, uint32_t* ticket,
                                         uint32_t* rows, int n_tiles,
                                         uint32_t seq) {
    constexpr int NF = C::NF;
    constexpr int TILE = WF_INGEST_THREADS * ITEMS;
    constexpr int WARPS = WF_INGEST_THREADS / 32;
    __shared__ int s_tile;
    __shared__ bool s_open;
    __shared__ bool s_wh[WARPS];
    __shared__ uint32_t s_wv[WARPS][NF];
    __shared__ uint32_t s_carry[NF];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    uint32_t* status = ticket + 1;
    uint32_t* aggs = rows;
    uint32_t* pres = rows + n_tiles * NF;

    // the tile: a ticket in arrival order (loads started on the block's
    // index while the ticket is in flight, redone where they differ, ran
    // 0.7 us slower on the H100: scripts/bench_torch_step.py, PERF.md)
    if (tid == 0) {
        const int t = (int)atomicAdd(ticket, 1u);
        if (t == n_tiles - 1) atomicExch(ticket, 0u);  // every ticket taken
        s_tile = t;
    }
    __syncthreads();
    const int tile = s_tile;
    int key[ITEMS];
    uint32_t v[ITEMS][NF], heads, tails;
    load_tile<C, KT, ITEMS>(io, skeys, order, n, sentinel,
                            tile * TILE + tid * ITEMS, key, v, heads, tails);

    // ---- the thread's rows, folded in order ------------------------------
#pragma unroll
    for (int k = 1; k < ITEMS; ++k)
        if (!(heads >> k & 1u)) fold_into<C>(cb, v[k - 1], v[k]);
    // the rows of the thread's first run (up to its first head past row 0)
    const uint32_t later = heads & ~1u;
    const uint32_t first_run = later ? (later & (0u - later)) - 1u
                                     : (1u << ITEMS) - 1u;
    // a run that reaches into this tile from an earlier one, and is live
    if (tid == 0)
        s_open = tile > 0 && !(heads & 1u) && key[0] >= 0 && key[0] < sentinel;

    // ---- segmented inclusive scan of the threads' trailing folds --------
    uint32_t x[NF];
    copy_row<NF>(x, v[ITEMS - 1]);
    bool h = heads != 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        uint32_t y[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) y[f] = __shfl_up_sync(WF_FULL, x[f], o);
        const bool yh = __shfl_up_sync(WF_FULL, h ? 1 : 0, o) != 0;
        if (lane >= o) {
            bool ah = yh;
            seg_fold<C>(cb, y, ah, x, h);
            copy_row<NF>(x, y);
            h = ah;
        }
    }
    if (lane == 31) {
#pragma unroll
        for (int f = 0; f < NF; ++f) s_wv[warp][f] = x[f];
        s_wh[warp] = h;
    }
    // the lane's exclusive prefix within its warp (none in lane 0)
    uint32_t ev[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) ev[f] = __shfl_up_sync(WF_FULL, x[f], 1);
    bool eh = __shfl_up_sync(WF_FULL, h ? 1 : 0, 1) != 0;
    __syncthreads();
    // the earlier warps' fold (wv, wh), then the thread's exclusive prefix
    // within the tile (ev, eh), none in thread 0
    uint32_t wv[NF];
    bool wh = false;
#pragma unroll
    for (int f = 0; f < NF; ++f) wv[f] = s_wv[0][f];
    if (warp > 0) {
        wh = s_wh[0];
#pragma unroll 1
        for (int w = 1; w < warp; ++w) {
            uint32_t a[NF];
#pragma unroll
            for (int f = 0; f < NF; ++f) a[f] = s_wv[w][f];
            seg_fold<C>(cb, wv, wh, a, s_wh[w]);
        }
        if (lane == 0) {
            copy_row<NF>(ev, wv);
            eh = wh;
        } else {
            uint32_t a[NF];
            copy_row<NF>(a, wv);
            bool ah = wh;
            seg_fold<C>(cb, a, ah, ev, eh);
            copy_row<NF>(ev, a);
            eh = ah;
        }
    }
    const bool has_ex = tid > 0;

    // ---- the last warp: the tile's aggregate, published; the look-back,
    // 32 earlier tiles a round, to the first inclusive prefix ------------
    if (warp == WARPS - 1) {
        const uint32_t tag = seq << 2;
        uint32_t ta[NF];  // lane 31: the tile's aggregate
        bool th = wh;
        copy_row<NF>(ta, wv);
        seg_fold<C>(cb, ta, th, x, h);
        if (lane == 31)
            publish<NF>((th ? pres : aggs) + tile * NF, status + tile, ta,
                        tag | (th ? ST_PREFIX : ST_AGGREGATE));
        if (s_open) {
            uint32_t c[NF];
#pragma unroll
            for (int f = 0; f < NF; ++f) c[f] = 0;
#pragma unroll 1
            for (int j0 = tile - 1;; j0 -= 32) {
                // lane l reads tile j0 - l (tile 0 is a prefix: no lane
                // that counts reads before it)
                const int j = j0 - lane;
                uint32_t st = tag | ST_PREFIX;
                bool ready;
                do {
                    if (j >= 0) st = ld_acquire(status + j);
                    ready = (st & ~3u) == tag && (st & 3u) != 0u;
                } while (!__all_sync(WF_FULL, ready));
                const bool pre = (st & 3u) == ST_PREFIX;
                const uint32_t pres_in = __ballot_sync(WF_FULL, pre);
                const int last = pres_in ? __ffs(pres_in) - 1 : 31;
                uint32_t a[NF];
#pragma unroll
                for (int f = 0; f < NF; ++f) a[f] = 0;
                if (lane <= last && j >= 0) {
                    const uint32_t* p = (pre ? pres : aggs) + j * NF;
#pragma unroll
                    for (int f = 0; f < NF; ++f) a[f] = __ldcg(p + f);
                }
                // lane 0 <- a[last] . ... . a[0]: a higher lane is earlier
#pragma unroll
                for (int o = 1; o < 32; o <<= 1) {
                    uint32_t y[NF];
#pragma unroll
                    for (int f = 0; f < NF; ++f)
                        y[f] = __shfl_down_sync(WF_FULL, a[f], o);
                    if (lane + o <= last) fold_into<C>(cb, y, a);
                }
#pragma unroll
                for (int f = 0; f < NF; ++f)
                    a[f] = __shfl_sync(WF_FULL, a[f], 0);
                if (j0 < tile - 1) fold_into<C>(cb, a, c);
                else copy_row<NF>(c, a);
                if (pres_in) break;
            }
            if (lane == 31) {
#pragma unroll
                for (int f = 0; f < NF; ++f) s_carry[f] = c[f];
                if (!th) {
                    fold_into<C>(cb, c, ta);
                    publish<NF>(pres + tile * NF, status + tile, ta,
                                tag | ST_PREFIX);
                }
            }
        }
    }

    // ---- the run tails: the thread holding a run's last row --------------
    // a tail of a first run that began in an earlier thread of the tile
    // folds the exclusive prefix in first; one that began in an earlier
    // tile (`late`) also the carry, after the look-back
    const bool wants_carry = tile > 0 && !(heads & 1u) && !(has_ex && eh);
    const uint32_t late = wants_carry ? tails & first_run : 0u;
    const uint32_t prefixed = !(heads & 1u) && has_ex ? first_run : 0u;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        if (!(tails >> k & 1u) || (late >> k & 1u)) continue;
        if (prefixed >> k & 1u) fold_into<C>(cb, ev, v[k]);
        io.store(cb, k, key[k], v[k]);
    }
    __syncthreads();  // the carry is in shared memory
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        if (!(late >> k & 1u)) continue;
        uint32_t c[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) c[f] = s_carry[f];
        if (prefixed >> k & 1u) fold_into<C>(cb, ev, v[k]);
        fold_into<C>(cb, c, v[k]);
        io.store(cb, k, key[k], v[k]);
    }
    return tile;
}

}  // namespace wf

// K2+K3 (see the header comment): the tiled fold with LeafIO.
template <class C, typename KT>
__global__ void __launch_bounds__(WF_INGEST_THREADS, 1)
wf_ffat_ingest(Planes<C::NF> forest, Planes<C::NF> vals, const C cb,
               uint8_t* __restrict__ valid, const KT* __restrict__ skeys,
               const int32_t* __restrict__ order, int n, int log2F,
               int sentinel, uint32_t* __restrict__ ticket,
               uint32_t* __restrict__ rows, int n_tiles, uint32_t seq) {
    constexpr int ITEMS = wf::ingest_items<C::NF>();
    wf::LeafIO<C, ITEMS> io;
    io.forest = forest;
    io.vals = vals;
    io.valid = valid;
    io.log2F = log2F;
    wf::tile_fold<C, KT, ITEMS>(cb, io, skeys, order, n, sentinel, ticket,
                                rows, n_tiles, seq);
}

// ------------------------------------------------------------------ K4 ---
// One step of a walk over a range, as the plain version takes it: the left
// end moves past a taken left node, then the right end past a taken right
// node, then both go up a level.
__device__ __forceinline__ void walk_step(int& l, int& r) {
    if ((l & 1) && l < r) ++l;
    if ((r & 1) && l < r) --r;
    l >>= 1;
    r >>= 1;
}

// fpack: (5, W) int32 rows slot, start, len, wid, mask; epack: (3, E)
// rows slot, leaf, mask; bounds: (2, B + 1), block b's fire lanes
// [bounds[b], bounds[b + 1]) and evict lanes [bounds[B + 1 + b],
// bounds[B + 2 + b]) (fire_blocks in kernels/ffat_step.py). ktable: a
// per-slot key table of key_bytes-byte keys (null: no key column).
// A window takes a group of 8 lanes (WF_QUERY_GROUP): lane g = 4h + c of
// the group holds, in round k, the nodes of chain c at steps 8k + 2q + h
// (q = 0-3), so a round's 32 nodes of a window arrive together.
template <class C>
__global__ void __launch_bounds__(WF_QUERY_THREADS, 1)
wf_ffat_query(Planes<C::NF> tr, const C cb, uint8_t* valid, int n_rows,
              int log2F, const int32_t* __restrict__ fpack, int W,
              const int32_t* __restrict__ epack, int E,
              const int32_t* __restrict__ bounds, int B, Planes<C::NF> out,
              uint8_t* __restrict__ qv, const uint8_t* __restrict__ ktable,
              uint8_t* __restrict__ kout, int key_bytes) {
    constexpr int NF = C::NF;
    constexpr int G = WF_QUERY_GROUP, PER_WARP = 32 / G;
    const int F = 1 << log2F;
    const int logq = log2F + 2;  // (2F).bit_length(): steps of a walk
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane & (G - 1), c = g & 3, half = g >> 2;
    const bool right = (c & 1) != 0;  // chains: range 1 left, right, range 2
    const int f0 = bounds[blockIdx.x], f1 = bounds[blockIdx.x + 1];
    const int e0 = bounds[B + 1 + blockIdx.x], e1 = bounds[B + 2 + blockIdx.x];
    for (int i0 = f0 + warp * PER_WARP; i0 < f1; i0 += WF_QUERY_WINDOWS) {
        const int i = i0 + lane / G;  // this group's window
        const bool on = i < f1;
        const int slot = on ? min(max(fpack[i], 0), n_rows - 1) : 0;
        const int start = on ? fpack[W + i] : 0;
        const int len = on ? fpack[2 * W + i] : 0;
        const bool mask = on && fpack[4 * W + i] != 0;
        const int base = slot << (log2F + 1);
        const int len1 = min(len, F - start);
        const int lo = c < 2 ? start : 0;
        // the walk of this lane's chain, at step `ws`
        int wl = lo + F, wr = lo + (c < 2 ? len1 : len - len1) + F, ws = 0;
        uint32_t acc[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) acc[f] = 0;
        bool av = false;
#pragma unroll 1
        for (int k = 0; 8 * k < logq; ++k) {
            // this round's nodes, loaded before anything is folded
            uint32_t x[4][NF];
            bool xv[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int st = 8 * k + 2 * q + half;
#pragma unroll
                for (int f = 0; f < NF; ++f) x[q][f] = 0;
                xv[q] = false;
                if (st < logq) {
                    for (; ws < st; ++ws) walk_step(wl, wr);
                    const bool tl = (wl & 1) && wl < wr;
                    const bool take =
                        right ? (wr & 1) && (tl ? wl + 1 : wl) < wr : tl;
                    const int at =
                        base + min(max(right ? wr - 1 : wl, 0), 2 * F - 1);
                    wf::load_row<C>(tr, at, x[q]);
                    xv[q] = take && valid[at] != 0;
                }
            }
            // the key column, one store a window, while the nodes arrive
            if (k == 0 && kout != nullptr && on && g == 0) {
                const uint8_t* ks = ktable + (size_t)slot * key_bytes;
                uint8_t* kd = kout + (size_t)i * key_bytes;
                if (key_bytes == 8)
                    *reinterpret_cast<uint64_t*>(kd) =
                        mask ? *reinterpret_cast<const uint64_t*>(ks) : 0;
                else if (key_bytes == 4)
                    *reinterpret_cast<uint32_t*>(kd) =
                        mask ? *reinterpret_cast<const uint32_t*>(ks) : 0;
                else if (key_bytes == 2)
                    *reinterpret_cast<uint16_t*>(kd) =
                        mask ? *reinterpret_cast<const uint16_t*>(ks) : 0;
                else
                    *kd = mask ? *ks : 0;
            }
            // the four chains fold this round's steps in order, each in
            // lanes c and c + 4 of the group: left chains acc <- node(acc,
            // z), right chains acc <- node(z, acc)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    if (8 * k + 2 * q + hh >= logq) continue;  // uniform
                    uint32_t l[NF], r[NF];
#pragma unroll
                    for (int f = 0; f < NF; ++f) {
                        const uint32_t z =
                            __shfl_sync(WF_FULL, x[q][f], 4 * hh + c, G);
                        l[f] = right ? z : acc[f];
                        r[f] = right ? acc[f] : z;
                    }
                    const bool zv =
                        __shfl_sync(WF_FULL, xv[q] ? 1 : 0, 4 * hh + c, G) != 0;
                    cb.node(l, r, right ? zv : av, right ? av : zv, acc);
                    av = av || zv;
                }
            }
        }
        // each range: node(la, ra) in lanes 0 and 2; then node(r1, r2)
        uint32_t y[NF], rr[NF], res[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f)
            y[f] = __shfl_down_sync(WF_FULL, acc[f], 1, G);
        bool yv = __shfl_down_sync(WF_FULL, av ? 1 : 0, 1, G) != 0;
        cb.node(acc, y, av, yv, rr);
        const bool rv = av || yv;
#pragma unroll
        for (int f = 0; f < NF; ++f)
            y[f] = __shfl_down_sync(WF_FULL, rr[f], 2, G);
        yv = __shfl_down_sync(WF_FULL, rv ? 1 : 0, 2, G) != 0;
        cb.node(rr, y, rv, yv, res);
        if (on && g == 0) {
            wf::store_row<C>(out, i, res);
            qv[i] = (rv || yv) && mask ? 1 : 0;
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

// One launch of K2+K3 over n sorted rows (`skeys`, key_bytes 2 or 4, and
// their `order`). `status`: status_words words, zeroed when made, its
// status words tagged with `seq` (1 to 2^30 - 1, a new one each launch on
// the same buffer); `rows`: row_words words, never read before a launch
// writes them (ffat_step.py: ingest_scratch). Returns 0, a cudaError_t,
// or -1 for arguments the kernel does not take (the wrapper checks
// first).
template <class C>
int run_ingest(const Planes<C::NF>& forest, const Planes<C::NF>& vals,
               const C& cb, uint8_t* valid, const void* skeys, int key_bytes,
               const int32_t* order, int n, int F, int sentinel,
               uint32_t* status, int status_words, uint32_t* rows,
               int row_words, unsigned seq, cudaStream_t st) {
    constexpr int TILE = WF_INGEST_THREADS * ingest_items<C::NF>();
    if (n < 1 || F < 2 || (F & (F - 1)) != 0 || sentinel < 0 ||
        (key_bytes != 2 && key_bytes != 4) || status == nullptr ||
        rows == nullptr || seq == 0u || seq >= (1u << 30))
        return -1;
    const long long tiles = ((long long)n + TILE - 1) / TILE;
    if (1 + tiles > (long long)status_words ||
        2LL * tiles * C::NF > (long long)row_words)
        return -1;
    const int log2F = log2_of(F);
    if (key_bytes == 2)
        wf_ffat_ingest<C, int16_t><<<(unsigned)tiles, WF_INGEST_THREADS, 0,
                                     st>>>(
            forest, vals, cb, valid, static_cast<const int16_t*>(skeys), order,
            n, log2F, sentinel, status, rows, (int)tiles, seq);
    else
        wf_ffat_ingest<C, int32_t><<<(unsigned)tiles, WF_INGEST_THREADS, 0,
                                     st>>>(
            forest, vals, cb, valid, static_cast<const int32_t*>(skeys), order,
            n, log2F, sentinel, status, rows, (int)tiles, seq);
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
Planes<NF> planes_of(void* const* p) {
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
                       int n_fields, void* valid, const void* skeys,         \
                       int key_bytes, const void* order, int n, int F,       \
                       int sentinel, void* status, int status_words,         \
                       void* rows, int row_words, unsigned seq,              \
                       void* stream) {                                       \
        (void)kinds;                                                         \
        if (n_fields != Comb::NF) return -1;                                 \
        return wf::run_ingest<Comb>(                                         \
            wf::planes_of<Comb::NF>(planes), wf::planes_of<Comb::NF>(vals),  \
            Comb{}, static_cast<uint8_t*>(valid), skeys, key_bytes,          \
            static_cast<const int32_t*>(order), n, F, sentinel,              \
            static_cast<uint32_t*>(status), status_words,                    \
            static_cast<uint32_t*>(rows), row_words, seq,                    \
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
