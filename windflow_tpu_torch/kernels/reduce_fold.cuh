// The reduce operators' folds for NVIDIA Hopper (sm_90a), templated on
// K1's combine policy (forest_rebuild.cuh), as K2-K4 are.
//
// Replaces two device programs of the JAX package's Reduce_TPU, which XLA
// compiles there (no Pallas kernel):
//
// - K7, wf_keyed_fold: the keyed reduce's segmented scan and tail gather
//   (windflow_tpu/tpu/ops_tpu.py:1238-1259 ReduceTPUReplica.run), with
//   validity as an Option as the fused keyed terminator scans
//   (windflow_tpu/tpu/fused_ops.py:237-250 seg_op) and with the mesh's
//   sentinel lanes (windflow_tpu/mesh/core.py:843 sharded_keyed_reduce).
//   The wrapper passes the rows' slots sorted ascending (`skeys`, a slot
//   at or past `sentinel` skips its row) with their int32 `order`; one
//   launch folds each run of equal slots in row order and writes the
//   run's fold to out[slot], its validity (any valid row) and its source
//   row. Design: K2+K3's tiled segmented fold and decoupled look-back
//   (ffat_step.cuh: tile_fold), shared, not copied, over SlotPolicy<C>:
//   C's fields and two more words a row, the source row and the validity,
//   so the scan's operator node(a, b) is the plain version's Option rule
//   (both valid: combine; one valid: that side; neither: the later) for
//   every field at once, and a field the combine does not return follows
//   the same selects as the source row. The look-back's scratch is
//   K2+K3's (per device and stream, sequence-tagged status words), so the
//   two kernels interleave on one stream. The thread holding a run's last
//   row stores it (SlotIO); each tile then zeroes the output rows of its
//   slot range that no run holds (gap rows: slots with no row), and the
//   blocks share the rows past the last slot, so every output row is
//   written once and no memset is needed. What bounds it: memory, each
//   live row's value planes and validity byte, every row's slot and
//   order read once, each output row written once.
// - K6, wf_tree_reduce: the global reduce's masked halving tree
//   (windflow_tpu/tpu/ops_tpu.py:280 masked_tree_reduce): the n rows
//   padded with invalid zero rows to a power of two m, then passes of
//   position i with i + half, the earlier side left, under the Option
//   rule. Restricted to the positions of one residue class mod P (P a
//   power of two), the halving tree is that class's own halving tree, so
//   block c folds class c of the P = m / L classes (L rows, staged in
//   shared memory, halved there in the plain version's order) and
//   publishes its partial; the last block to arrive at a counter folds
//   the partials of its class at the next level the same way, until one
//   remains. The kernel is bit-identical to the plain version, floats
//   included, in one launch. What bounds it: memory, each row's value
//   planes and validity byte read once.
//
// Index math is 32-bit: the wrapper refuses rows, slots or output rows of
// 2^31 - 1 or more (kernels/reduce_fold.py).

#pragma once

#include "ffat_step.cuh"

#define WF_TREE_THREADS 256
// a tree block's staged rows, at most: within the 48 KB a launch gets
// unasked, with its static shared memory
#define WF_TREE_SMEM 32768

namespace wf {

// C's fields, then the source row and the validity (0 or 1) as words:
// node() ignores the flags it is given and applies the Option rule with
// the rows' own validity words, so K2+K3's scan (which folds with
// node(a, b, true, true)) folds Options.
template <class C>
struct SlotPolicy {
    static constexpr int NF = C::NF + 2;
    static constexpr int SRC = C::NF, VAL = C::NF + 1;
    C cb;

    __device__ __forceinline__ void node(const uint32_t (&l)[NF],
                                         const uint32_t (&r)[NF], bool,
                                         bool, uint32_t (&o)[NF]) const {
        const bool vl = l[VAL] != 0u, vr = r[VAL] != 0u;
        uint32_t a[C::NF], b[C::NF], m[C::NF];
#pragma unroll
        for (int f = 0; f < C::NF; ++f) {
            a[f] = l[f];
            b[f] = r[f];
        }
        cb.node(a, b, vl, vr, m);
#pragma unroll
        for (int f = 0; f < C::NF; ++f) o[f] = m[f];
        // a field the combine does not return: the later side where both
        // are valid, else the valid side (the later one when neither is)
        o[SRC] = vl && !vr ? l[SRC] : r[SRC];
        o[VAL] = vl || vr ? 1u : 0u;
    }
};

// One row of SlotPolicy<C> from input row `src`: C's planes of `vals`,
// the row itself, its validity (1 without a validity plane).
template <class C>
__device__ __forceinline__ void load_slot_row(const Planes<C::NF>& vals,
                                              const uint8_t* valid, int src,
                                              uint32_t (&w)[C::NF + 2]) {
#pragma unroll
    for (int f = 0; f < C::NF; ++f) w[f] = ld_node<C>(vals, f, src);
    w[C::NF] = (uint32_t)src;
    w[C::NF + 1] = valid == nullptr || valid[src] != 0 ? 1u : 0u;
}

template <class C>
__device__ __forceinline__ void store_slot_row(const Planes<C::NF>& out,
                                               uint8_t* out_valid,
                                               int32_t* out_src, int at,
                                               const uint32_t (&w)[C::NF + 2]) {
#pragma unroll
    for (int f = 0; f < C::NF; ++f) st_node<C>(out, f, at, w[f]);
    out_src[at] = (int32_t)w[C::NF];
    out_valid[at] = w[C::NF + 1] != 0u ? 1 : 0;
}

// K7's rows (the IO policy of tile_fold): value rows and validity read
// through the order, a run's fold stored at its slot.
template <class C, int ITEMS>
struct SlotIO {
    Planes<C::NF> vals, out;
    const uint8_t* valid;
    uint8_t* out_valid;
    int32_t* out_src;

    __device__ __forceinline__ void load(int, int src, int, bool live, bool,
                                         uint32_t (&v)[C::NF + 2]) {
#pragma unroll
        for (int f = 0; f < C::NF + 2; ++f) v[f] = 0;
        if (live) load_slot_row<C>(vals, valid, src, v);
    }

    __device__ __forceinline__ void store(const SlotPolicy<C>&, int, int key,
                                          const uint32_t (&v)[C::NF + 2]) {
        store_slot_row<C>(out, out_valid, out_src, key, v);
    }
};

// K6's fold of the L rows staged in shared memory (plane-major, NF planes
// of L words): the halving passes j <- node(j, j + h), h = L/2 .. 1;
// the result in row 0.
template <class P>
__device__ __forceinline__ void halve_staged(const P& pol, uint32_t* s,
                                             int L) {
    constexpr int NF = P::NF;
    for (int h = L >> 1; h >= 1; h >>= 1) {
        __syncthreads();
        for (int j = threadIdx.x; j < h; j += WF_TREE_THREADS) {
            uint32_t l[NF], r[NF], o[NF];
#pragma unroll
            for (int f = 0; f < NF; ++f) {
                l[f] = s[f * L + j];
                r[f] = s[f * L + j + h];
            }
            pol.node(l, r, true, true, o);
#pragma unroll
            for (int f = 0; f < NF; ++f) s[f * L + j] = o[f];
        }
    }
    __syncthreads();
}

}  // namespace wf

// K7 (see above): the tiled fold with SlotIO, then the gap rows. Below
// the sentinel a tile owns the slots after the last slot of the tile
// before it, up to its own last slot (the last tile: up to the
// sentinel); a slot of that range is a run of this tile or of no tile.
// The rows from the sentinel to out_rows hold no run: the blocks stride
// over them.
template <class C, typename KT>
__global__ void __launch_bounds__(WF_INGEST_THREADS, 1)
wf_keyed_fold(Planes<C::NF> vals, const C cb,
              const uint8_t* __restrict__ valid, const KT* __restrict__ skeys,
              const int32_t* __restrict__ order, int n, int sentinel,
              Planes<C::NF> out, uint8_t* __restrict__ out_valid,
              int32_t* __restrict__ out_src, int out_rows,
              uint32_t* __restrict__ ticket, uint32_t* __restrict__ rows,
              int n_tiles, uint32_t seq) {
    using P = wf::SlotPolicy<C>;
    constexpr int ITEMS = wf::ingest_items<P::NF>();
    constexpr int TILE = WF_INGEST_THREADS * ITEMS;
    __shared__ int s_keys[TILE];
    wf::SlotIO<C, ITEMS> io;
    io.vals = vals;
    io.out = out;
    io.valid = valid;
    io.out_valid = out_valid;
    io.out_src = out_src;
    const P pol{cb};
    const int tile = wf::tile_fold<P, KT, ITEMS>(
        pol, io, skeys, order, n, sentinel, ticket, rows, n_tiles, seq);

    uint32_t z[P::NF];
#pragma unroll
    for (int f = 0; f < P::NF; ++f) z[f] = 0;
    // the rows past the last slot hold no run: every block takes a share
    for (int s = sentinel + tile * WF_INGEST_THREADS + (int)threadIdx.x;
         s < out_rows; s += n_tiles * WF_INGEST_THREADS)
        wf::store_slot_row<C>(out, out_valid, out_src, s, z);
    const int r0 = tile * TILE;
    const int cnt = min(TILE, n - r0);
    for (int i = threadIdx.x; i < cnt; i += WF_INGEST_THREADS)
        s_keys[i] = min((int)skeys[r0 + i], sentinel);
    const int lo = tile == 0 ? 0 : min((int)skeys[r0 - 1], sentinel) + 1;
    const int hi = tile == n_tiles - 1
        ? sentinel : min((int)skeys[r0 + cnt - 1], sentinel - 1) + 1;
    __syncthreads();
    for (int s = lo + (int)threadIdx.x; s < hi; s += WF_INGEST_THREADS) {
        // the tile's slots are sorted: a search
        int a = 0, b = cnt;
        while (a < b) {
            const int m = (a + b) >> 1;
            if (s_keys[m] < s) a = m + 1;
            else b = m;
        }
        if (a == cnt || s_keys[a] != s)
            wf::store_slot_row<C>(out, out_valid, out_src, s, z);
    }
}

// K6 (see above). Level 1: block c of gridDim.x = P classes folds rows
// c + P * j, j < 2^log2L (rows n and past: invalid zeros). Each level's
// partials go to `parts` (NF words a class), the classes of the next
// level (Lu = min(P, 2^log2Lu) partials each) to `counters` (one word a
// class, zero before the launch and again after it).
template <class C>
__global__ void __launch_bounds__(WF_TREE_THREADS, 1)
wf_tree_reduce(Planes<C::NF> vals, const C cb,
               const uint8_t* __restrict__ valid, int n, int log2L,
               int log2Lu, Planes<C::NF> out, uint8_t* __restrict__ out_valid,
               int32_t* __restrict__ out_src, uint32_t* __restrict__ counters,
               uint32_t* __restrict__ parts) {
    using P = wf::SlotPolicy<C>;
    constexpr int NF = P::NF;
    extern __shared__ __align__(16) uint32_t s_rows[];
    __shared__ bool s_last;
    const P pol{cb};
    int L = 1 << log2L;
    int classes = gridDim.x;
    int cls = blockIdx.x;
    for (int j = threadIdx.x; j < L; j += WF_TREE_THREADS) {
        const int i = cls + classes * j;
        uint32_t w[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) w[f] = 0;
        if (i < n) wf::load_slot_row<C>(vals, valid, i, w);
        else w[P::SRC] = (uint32_t)(n - 1);  // padding: a row in range
#pragma unroll
        for (int f = 0; f < NF; ++f) s_rows[f * L + j] = w[f];
    }
    wf::halve_staged<P>(pol, s_rows, L);
    uint32_t* part = parts;
    uint32_t* cnt = counters;
    while (classes > 1) {
        const int Lu = min(classes, 1 << log2Lu);
        const int up = classes / Lu;  // the next level's classes
        const int ucls = cls & (up - 1);
        if (threadIdx.x == 0) {
#pragma unroll
            for (int f = 0; f < NF; ++f)
                __stcg(part + cls * NF + f, s_rows[f * L]);
            __threadfence();
            const uint32_t arrived = atomicAdd(cnt + ucls, 1u);
            s_last = arrived == (uint32_t)(Lu - 1);
            if (s_last) atomicExch(cnt + ucls, 0u);  // for the next launch
        }
        __syncthreads();
        if (!s_last) return;
        __threadfence();
        // the class's partials, in the order of their classes
        for (int j = threadIdx.x; j < Lu; j += WF_TREE_THREADS)
#pragma unroll
            for (int f = 0; f < NF; ++f)
                s_rows[f * Lu + j] = __ldcg(part + (ucls + up * j) * NF + f);
        L = Lu;
        wf::halve_staged<P>(pol, s_rows, L);
        part += classes * NF;
        cnt += up;
        classes = up;
        cls = ucls;
    }
    if (threadIdx.x == 0) {
        uint32_t w[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) w[f] = s_rows[f * L];
        wf::store_slot_row<C>(out, out_valid, out_src, 0, w);
    }
}

// ---------------------------------------------------------------- host ---
namespace wf {

// One launch of K7 over n sorted rows (`skeys`, key_bytes 2 or 4, and
// their `order`) into out_rows output rows; `valid` may be null. The
// scratch is K2+K3's (run_ingest), sized for SlotPolicy<C>::NF words a
// row. Returns 0, a cudaError_t, or -1 for arguments the kernel does not
// take (the wrapper checks first).
template <class C>
int run_keyed_fold(const Planes<C::NF>& vals, const C& cb,
                   const uint8_t* valid, const void* skeys, int key_bytes,
                   const int32_t* order, int n, int sentinel,
                   const Planes<C::NF>& out, uint8_t* out_valid,
                   int32_t* out_src, int out_rows, uint32_t* status,
                   int status_words, uint32_t* rows, int row_words,
                   unsigned seq, cudaStream_t st) {
    constexpr int NF = SlotPolicy<C>::NF;
    constexpr int TILE = WF_INGEST_THREADS * ingest_items<NF>();
    if (n < 1 || sentinel < 0 || out_rows < 1 || out_rows < sentinel ||
        (key_bytes != 2 && key_bytes != 4) || status == nullptr ||
        rows == nullptr || out_valid == nullptr || out_src == nullptr ||
        seq == 0u || seq >= (1u << 30))
        return -1;
    const long long tiles = ((long long)n + TILE - 1) / TILE;
    if (1 + tiles > (long long)status_words ||
        2LL * tiles * NF > (long long)row_words)
        return -1;
    if (key_bytes == 2)
        wf_keyed_fold<C, int16_t><<<(unsigned)tiles, WF_INGEST_THREADS, 0,
                                    st>>>(
            vals, cb, valid, static_cast<const int16_t*>(skeys), order, n,
            sentinel, out, out_valid, out_src, out_rows, status, rows,
            (int)tiles, seq);
    else
        wf_keyed_fold<C, int32_t><<<(unsigned)tiles, WF_INGEST_THREADS, 0,
                                    st>>>(
            vals, cb, valid, static_cast<const int32_t*>(skeys), order, n,
            sentinel, out, out_valid, out_src, out_rows, status, rows,
            (int)tiles, seq);
    return (int)cudaGetLastError();
}

// Rows a K6 block stages: the most that fit WF_TREE_SMEM at NF words a
// row, a power of two (reduce_fold.py: tree_plan).
template <int NF>
constexpr int tree_rows_max() {
    int r = 1;
    while (2 * r * NF * 4 <= WF_TREE_SMEM) r *= 2;
    return r;
}

// One launch of K6 over n rows: 2^log2P level-1 blocks of 2^log2L rows
// (2^(log2P + log2L) >= n), later levels of at most 2^log2Lu partials a
// block. `counters`: counter_words words, zero; `parts`: part_words.
template <class C>
int run_tree_reduce(const Planes<C::NF>& vals, const C& cb,
                    const uint8_t* valid, int n, int log2P, int log2L,
                    int log2Lu, const Planes<C::NF>& out, uint8_t* out_valid,
                    int32_t* out_src, uint32_t* counters, int counter_words,
                    uint32_t* parts, int part_words, cudaStream_t st) {
    constexpr int NF = SlotPolicy<C>::NF;
    constexpr int LMAX = tree_rows_max<NF>();
    if (n < 1 || log2P < 0 || log2L < 0 || log2Lu < 1 || log2P > 30 ||
        log2L > 30 || (1 << log2L) > LMAX || (1 << log2Lu) > LMAX ||
        log2P + log2L > 31 || (1LL << (log2P + log2L)) < (long long)n ||
        out_valid == nullptr || out_src == nullptr)
        return -1;
    // the levels' classes and partials
    long long c = 1LL << log2P, need_c = 0, need_p = 0;
    while (c > 1) {
        const long long lu = c < (1LL << log2Lu) ? c : (1LL << log2Lu);
        need_p += c * NF;
        c /= lu;
        need_c += c;
    }
    if ((need_c > 0 && (counters == nullptr || need_c > counter_words)) ||
        (need_p > 0 && (parts == nullptr || need_p > part_words)))
        return -1;
    const int L = 1 << log2L, Lu = 1 << log2Lu;
    const int smem = (L > Lu ? L : Lu) * NF * 4;
    wf_tree_reduce<C><<<1u << log2P, WF_TREE_THREADS, smem, st>>>(
        vals, cb, valid, n, log2L, log2Lu, out, out_valid, out_src, counters,
        parts);
    return (int)cudaGetLastError();
}

}  // namespace wf

// The C entry points of K7 and K6 for a traced variant, beside
// WF_REBUILD_ENTRY_POINTS and WF_FFAT_ENTRY_POINTS: `Comb` takes exactly
// Comb::NF planes (`kinds` is not read). forest_rebuild.cu defines the
// fieldwise library's own.
#define WF_REDUCE_ENTRY_POINTS(Comb)                                         \
    extern "C" {                                                             \
    int wf_keyed_fold(void** vals, const int* kinds, int n_fields,           \
                      const void* valid, const void* skeys, int key_bytes,   \
                      const void* order, int n, int sentinel, void** out,    \
                      void* out_valid, void* out_src, int out_rows,          \
                      void* status, int status_words, void* rows,            \
                      int row_words, unsigned seq, void* stream) {           \
        (void)kinds;                                                         \
        if (n_fields != Comb::NF) return -1;                                 \
        return wf::run_keyed_fold<Comb>(                                     \
            wf::planes_of<Comb::NF>(vals), Comb{},                           \
            static_cast<const uint8_t*>(valid), skeys, key_bytes,            \
            static_cast<const int32_t*>(order), n, sentinel,                 \
            wf::planes_of<Comb::NF>(out), static_cast<uint8_t*>(out_valid),  \
            static_cast<int32_t*>(out_src), out_rows,                        \
            static_cast<uint32_t*>(status), status_words,                    \
            static_cast<uint32_t*>(rows), row_words, seq,                    \
            static_cast<cudaStream_t>(stream));                              \
    }                                                                        \
    int wf_tree_reduce(void** vals, const int* kinds, int n_fields,          \
                       const void* valid, int n, int log2P, int log2L,       \
                       int log2Lu, void** out, void* out_valid,              \
                       void* out_src, void* counters, int counter_words,     \
                       void* parts, int part_words, void* stream) {          \
        (void)kinds;                                                         \
        if (n_fields != Comb::NF) return -1;                                 \
        return wf::run_tree_reduce<Comb>(                                    \
            wf::planes_of<Comb::NF>(vals), Comb{},                           \
            static_cast<const uint8_t*>(valid), n, log2P, log2L, log2Lu,     \
            wf::planes_of<Comb::NF>(out), static_cast<uint8_t*>(out_valid),  \
            static_cast<int32_t*>(out_src), static_cast<uint32_t*>(counters),\
            counter_words, static_cast<uint32_t*>(parts), part_words,        \
            static_cast<cudaStream_t>(stream));                              \
    }                                                                        \
    }
