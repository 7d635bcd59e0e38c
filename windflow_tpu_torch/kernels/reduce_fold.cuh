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
//   at or past `sentinel` skips its row), their int32 `order` and each
//   slot's first sorted row (`starts`, sentinel + 1 of them); one launch
//   folds each run of equal slots in row order and writes the run's fold
//   to out[slot], its validity (any valid row) and its source row. The
//   fold is over SlotPolicy<C>: C's fields and two more words a row, the
//   source row and the validity, so node(a, b) is the plain version's
//   Option rule (both valid: combine; one valid: that side; neither: the
//   later) for every field at once, and a field the combine does not
//   return follows the same selects as the source row.
//   Design: the unit of work is a run, owned by the sorted row that heads
//   it, so no block waits on another. A light block's thread takes one
//   sorted row (a warp 32 consecutive ones): it reads its slot and the
//   one before it, and the thread heading a run reads the run's end from
//   `starts`. A run of fewer than WF_FOLD_WARP_ROWS rows is folded by
//   that thread in row order, its loads issued fold_items rows at a time
//   (the first row's order and value words before the end is known); a
//   run of up to `block_rows` rows by its warp (a warp heads at most one:
//   lane l folds the l-th of 32 contiguous chunks, then a shuffle tree
//   joins the lanes, the lower lane always on the left); a longer run by
//   the chunk blocks, which come first in the grid: block b takes the
//   sorted rows of chunk b and folds, with the whole block, the piece of
//   the long run that holds its first row and the piece of the one that
//   holds its last (a long run covers at least a chunk, so every chunk
//   it reaches holds one of them), publishes the piece's fold and counts
//   it at the run's counter; the last block to arrive folds the pieces in
//   chunk order and resets the counter (no block spins). The same light
//   thread writes the zero row of its slot index where the slot has no
//   run or lies past the sentinel, so every output row is written once
//   and nothing is cleared first. Up to WF_MAX_GATHER 4-byte
//   pass-through columns are gathered at the source row in the same
//   store. What bounds it: memory, each live row's slot, order, value
//   planes and validity byte read once, each output row written once; at
//   the main paths' batches, the chain of dependent loads (slot; run end
//   and first row; rows; source row) and, for a long run, the counter.
// - K6, wf_tree_reduce: the global reduce's masked halving tree
//   (windflow_tpu/tpu/ops_tpu.py:280 masked_tree_reduce): the n rows
//   padded with invalid zero rows to a power of two m (rows at or past
//   `size` invalid too), then passes of position i with i + half, the
//   earlier side left, under the Option rule. Restricted to the positions
//   of one residue class mod T (T a power of two), the halving tree is
//   that class's own halving tree, and its passes of half below T are the
//   tree of the T class results. Design: a stage of B blocks of 128
//   threads over Q positions has T = 128B classes; lane l of warp w of
//   block b takes class 32b + l + 32Bw, so a warp's loads of its j-th
//   entries (position class + Tj) are one line, and folds its Q / T
//   entries in registers in the tree's order, with no barrier. The next
//   two passes pair the block's warps (classes T/2 and T/4 apart): one
//   shared-memory stage. Block b then publishes its 32 partials
//   (positions 32b + l) and counts itself at its next-stage counter; the
//   last block to arrive (no spinning) runs the next stage over the
//   partials, R / E entries a thread (tree_rows / tree_parts), until one
//   block is left, whose lanes finish with shuffles (lane j takes lane
//   j + h as node(mine, theirs)). Bit-identical to the plain version,
//   floats included, in one launch. What bounds it: memory, each row's
//   value planes and validity byte read once (none past `size`); at the
//   main paths' batches, the chain of loads, the counter and the partials'
//   loads.
//
// Index math is 32-bit: the wrapper refuses rows, slots or output rows of
// 2^31 - 256 or more (kernels/reduce_fold.py).

#pragma once

#include "ffat_step.cuh"

#define WF_FOLD_THREADS 128
// K7: a run of this many rows or more takes a warp (at most one run a
// warp heads); a run of `block_rows` or more takes the chunk blocks
#define WF_FOLD_WARP_ROWS 32
// 4-byte pass-through columns gathered in the kernel, at most
#define WF_MAX_GATHER 8

namespace wf {

// C's fields, then the source row and the validity (0 or 1) as words:
// node() ignores the flags it is given and applies the Option rule with
// the rows' own validity words.
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

// rows a K6 thread folds in registers at the first stage, partials at the
// later ones, and rows a K7 thread loads at once: fewer as NF grows, so
// every library builds with no spill
template <int NF>
__host__ __device__ constexpr int tree_rows() {
    return NF <= 6 ? 4 : NF <= 12 ? 2 : 1;
}

template <int NF>
__host__ __device__ constexpr int tree_parts() {
    return NF <= 3 ? 32 : NF <= 6 ? 16 : NF <= 12 ? 8 : NF <= 24 ? 4 : 2;
}

template <int NF>
__host__ __device__ constexpr int fold_items() {
    return NF <= 6 ? 8 : NF <= 12 ? 4 : 2;
}

// The 4-byte pass-through columns the kernel gathers at each output's
// source row.
struct Gathers {
    const uint32_t* in[WF_MAX_GATHER];
    uint32_t* out[WF_MAX_GATHER];
    int n;
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

// Output row `at`: the planes, validity and source row of `w`, and the
// gathered columns at the source row (zeros unless `live`).
template <class C>
__device__ __forceinline__ void store_out(const Planes<C::NF>& out,
                                          uint8_t* out_valid,
                                          int32_t* out_src, const Gathers& g,
                                          int at,
                                          const uint32_t (&w)[C::NF + 2],
                                          bool live) {
    const int src = (int)w[C::NF];
    uint32_t x[WF_MAX_GATHER];
#pragma unroll
    for (int i = 0; i < WF_MAX_GATHER; ++i)
        x[i] = live && i < g.n ? __ldg(g.in[i] + src) : 0u;
#pragma unroll
    for (int f = 0; f < C::NF; ++f) st_node<C>(out, f, at, w[f]);
    out_src[at] = src;
    out_valid[at] = w[C::NF + 1] != 0u ? 1 : 0;
#pragma unroll
    for (int i = 0; i < WF_MAX_GATHER; ++i)
        if (i < g.n) g.out[i][at] = x[i];
}

// ------------------------------------------------------------------ K6 ---
// The halving passes over the first `cnt` (a power of two, at most K)
// entries a thread holds: j <- node(j, j + h), h = cnt/2 .. 1. One pass a
// template level, so every index is a constant and the entries stay in
// registers (a loop over h left ptxas a stack frame at K 16 and 32).
template <class P, int K, int H>
struct Halve {
    static __device__ __forceinline__ void run(const P& pol,
                                               uint32_t (&v)[K][P::NF],
                                               int cnt) {
        if (H < cnt) {
#pragma unroll
            for (int j = 0; j < H; ++j) {
                uint32_t o[P::NF];
                pol.node(v[j], v[j + H], true, true, o);
                copy_row<P::NF>(v[j], o);
            }
        }
        Halve<P, K, H / 2>::run(pol, v, cnt);
    }
};

template <class P, int K>
struct Halve<P, K, 0> {
    static __device__ __forceinline__ void run(const P&,
                                               uint32_t (&)[K][P::NF], int) {}
};

template <class P, int K>
__device__ __forceinline__ void halve_regs(const P& pol,
                                           uint32_t (&v)[K][P::NF], int cnt) {
    Halve<P, K, K / 2>::run(pol, v, cnt);
}

// One K6 stage (see the header comment): block b of B over Q positions,
// ld(p, w) loading position p. Warp 0's lane l returns position 32b + l
// in `r`; where B is 1 (the last stage), lane 0 returns the tree's root.
// `s`: 4 * 32 * NF words of shared memory.
template <class P, int K, class Ld>
__device__ __forceinline__ void tree_stage(const P& pol, const Ld& ld, int Q,
                                           int b, int B, uint32_t* s,
                                           uint32_t (&r)[P::NF]) {
    constexpr int NF = P::NF;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int T = WF_FOLD_THREADS * B;
    const int span = Q < T ? Q : T;  // positions left after the registers
    const int c = 32 * b + lane + 32 * B * warp;
    const int cnt = Q >= T ? Q / T : (c < Q ? 1 : 0);
    uint32_t v[K][NF];
#pragma unroll
    for (int j = 0; j < K; ++j) {
        if (j < cnt) {
            ld(c + T * j, v[j]);
        } else {
#pragma unroll
            for (int f = 0; f < NF; ++f) v[j][f] = 0u;
        }
    }
    halve_regs<P, K>(pol, v, cnt);
    // passes T/2 and T/4: warps w, w + 2, then w, w + 1
    __syncthreads();  // an earlier stage's reads of `s` are done
#pragma unroll
    for (int f = 0; f < NF; ++f) s[(f * 4 + warp) * 32 + lane] = v[0][f];
    __syncthreads();
    if (warp != 0) return;
    const int nw = span >= 128 ? 4 : span >= 64 ? 2 : 1;
    uint32_t u[4][NF];
#pragma unroll
    for (int w = 0; w < 4; ++w)
#pragma unroll
        for (int f = 0; f < NF; ++f) u[w][f] = s[(f * 4 + w) * 32 + lane];
    halve_regs<P, 4>(pol, u, nw);
    copy_row<NF>(r, u[0]);
    if (B > 1) return;
    // the last passes, 16 .. 1, over the lanes
    const int nl = span < 32 ? span : 32;
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) {
        uint32_t o[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) o[f] = __shfl_down_sync(WF_FULL, r[f], h);
        if (h < nl && lane < h) {
            uint32_t m[NF];
            pol.node(r, o, true, true, m);
            copy_row<NF>(r, m);
        }
    }
}

// The next stage's blocks after a stage of B blocks (32B partials).
template <int NF>
__host__ __device__ inline int tree_next(int B) {
    const int Q = 32 * B, per = WF_FOLD_THREADS * tree_parts<NF>();
    return Q > per ? Q / per : 1;
}

// The first stage's blocks over m (a power of two) rows.
template <int NF>
__host__ __device__ inline int tree_first(long long m) {
    const long long per = WF_FOLD_THREADS * tree_rows<NF>();
    return m > per ? (int)(m / per) : 1;
}

// K6's first stage: row i of the batch (invalid zeros at or past `size`,
// none read; the padding's source row is the last row).
template <class C>
struct TreeRows {
    Planes<C::NF> vals;
    const uint8_t* valid;
    int n, size;
    __device__ __forceinline__ void operator()(
        int i, uint32_t (&w)[C::NF + 2]) const {
        if (i < size) {
            load_slot_row<C>(vals, valid, i, w);
        } else {
#pragma unroll
            for (int f = 0; f < C::NF + 2; ++f) w[f] = 0u;
            w[C::NF] = (uint32_t)(i < n ? i : n - 1);
        }
    }
};

// K6's later stages: the partials, plane-major, Q a plane.
template <int NF>
struct TreeParts {
    const uint32_t* part;
    int Q;
    __device__ __forceinline__ void operator()(int p,
                                               uint32_t (&w)[NF]) const {
#pragma unroll
        for (int f = 0; f < NF; ++f) w[f] = __ldcg(part + f * Q + p);
    }
};

// ------------------------------------------------------------------ K7 ---
// K7's rows: the order entry, then the row's words.
template <class C>
struct FoldRows {
    Planes<C::NF> vals;
    const uint8_t* valid;
    const int32_t* order;
    __device__ __forceinline__ int pre(int i) const {
        return __ldg(order + i);
    }
    __device__ __forceinline__ void load(int src,
                                         uint32_t (&w)[C::NF + 2]) const {
        load_slot_row<C>(vals, valid, src, w);
    }
};

// A long run's pieces, in chunk order: the piece of chunk cf + i sits at
// partial 2 (cf + i) (+ 1 for the first chunk when the run starts inside
// it: there the piece holds the chunk's last row, not its first).
template <int NF>
struct FoldPieces {
    const uint32_t* parts;
    int cf, first;
    __device__ __forceinline__ int pre(int i) const {
        return 2 * (cf + i) + (i == 0 ? first : 0);
    }
    __device__ __forceinline__ void load(int p, uint32_t (&w)[NF]) const {
#pragma unroll
        for (int f = 0; f < NF; ++f) w[f] = __ldcg(parts + p * NF + f);
    }
};

// acc <- the fold of items [lo, hi) in order after acc (with `any`, whether
// acc holds a row yet), ITEMS items loaded at a time: their pre() first,
// then their rows. Returns whether acc holds a row.
template <class P, int ITEMS, class L>
__device__ __forceinline__ bool fold_seq(const P& pol, const L& ld, int lo,
                                         int hi, uint32_t (&acc)[P::NF],
                                         bool any) {
    constexpr int NF = P::NF;
    for (int base = lo; base < hi; base += ITEMS) {
        int at[ITEMS];
#pragma unroll
        for (int j = 0; j < ITEMS; ++j)
            at[j] = base + j < hi ? ld.pre(base + j) : 0;
        uint32_t w[ITEMS][NF];
#pragma unroll
        for (int j = 0; j < ITEMS; ++j)
            if (base + j < hi) ld.load(at[j], w[j]);
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
            if (base + j >= hi) break;
            if (any) {
                uint32_t m[NF];
                pol.node(acc, w[j], true, true, m);
                copy_row<NF>(acc, m);
            } else {
                copy_row<NF>(acc, w[j]);
                any = true;
            }
        }
    }
    return any;
}

// The lanes' folds of consecutive chunks (the lanes holding a row a
// prefix of the warp) joined in lane order: lane 0 gets the warp's fold.
template <class P>
__device__ __forceinline__ bool warp_join(const P& pol,
                                          uint32_t (&acc)[P::NF], bool any) {
    constexpr int NF = P::NF;
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int h = 1; h < 32; h <<= 1) {
        uint32_t o[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f)
            o[f] = __shfl_down_sync(WF_FULL, acc[f], h);
        const bool oany = __shfl_down_sync(WF_FULL, any ? 1 : 0, h) != 0;
        if ((lane & (2 * h - 1)) == 0 && oany) {
            uint32_t m[NF];
            pol.node(acc, o, true, true, m);
            copy_row<NF>(acc, m);
        }
    }
    return any;
}

// The same over the block: thread 0 gets the block's fold. `s`: 4 * NF
// words and `s_any` 4 flags of shared memory.
template <class P>
__device__ __forceinline__ bool block_join(const P& pol,
                                           uint32_t (&acc)[P::NF], bool any,
                                           uint32_t* s, bool* s_any) {
    constexpr int NF = P::NF;
    any = warp_join<P>(pol, acc, any);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    __syncthreads();  // an earlier join's reads of `s` are done
    if (lane == 0) {
#pragma unroll
        for (int f = 0; f < NF; ++f) s[f * 4 + warp] = acc[f];
        s_any[warp] = any;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll
        for (int w = 1; w < 4; ++w) {
            if (!s_any[w]) break;
            uint32_t o[NF], m[NF];
#pragma unroll
            for (int f = 0; f < NF; ++f) o[f] = s[f * 4 + w];
            pol.node(acc, o, true, true, m);
            copy_row<NF>(acc, m);
        }
    }
    return any;
}

}  // namespace wf

// K7 (see above). Blocks [0, chunk_blocks) are the chunk blocks, the
// rest light blocks, one thread a sorted row and a slot index. counters:
// a word a slot, zero before the launch and again after it; parts: two
// partials of NF words a chunk.
template <class C, typename KT>
__global__ void __launch_bounds__(WF_FOLD_THREADS, 1)
wf_keyed_fold(Planes<C::NF> vals, const C cb,
              const uint8_t* __restrict__ valid, const KT* __restrict__ skeys,
              const int32_t* __restrict__ order,
              const int32_t* __restrict__ starts, int n, int sentinel,
              Planes<C::NF> out, uint8_t* __restrict__ out_valid,
              int32_t* __restrict__ out_src, int out_rows, wf::Gathers g,
              int block_rows, int log2chunk, int chunk_blocks,
              uint32_t* __restrict__ counters, uint32_t* __restrict__ parts) {
    using P = wf::SlotPolicy<C>;
    constexpr int NF = P::NF;
    constexpr int ITEMS = wf::fold_items<NF>();
    __shared__ uint32_t s_rows[4 * NF];
    __shared__ bool s_any[4];
    __shared__ bool s_last;
    const P pol{cb};
    const wf::FoldRows<C> rows{vals, valid, order};
    const int lane = threadIdx.x & 31;
    uint32_t acc[NF];

    if ((int)blockIdx.x < chunk_blocks) {
        const int chunk = 1 << log2chunk;
        const int c0 = (int)blockIdx.x << log2chunk;
        const int c1 = min(n, c0 + chunk);
        const int kf = (int)skeys[c0], kl = (int)skeys[c1 - 1];
        for (int which = 0; which < 2; ++which) {
            const int k = which == 0 ? kf : kl;
            if ((which == 1 && k == kf) || k < 0 || k >= sentinel) continue;
            const int a = __ldg(starts + k), e = __ldg(starts + k + 1);
            if (e - a < block_rows) continue;
            // the piece: the block's threads take consecutive parts of it
            const int lo = max(a, c0), hi = min(e, c1);
            const int q = (hi - lo + WF_FOLD_THREADS - 1) / WF_FOLD_THREADS;
            const int t0 = lo + (int)threadIdx.x * q;
            bool any = wf::fold_seq<P, ITEMS>(pol, rows, t0, min(hi, t0 + q),
                                              acc, false);
            wf::block_join<P>(pol, acc, any, s_rows, s_any);
            if (threadIdx.x == 0) {
                uint32_t* dst = parts + (2 * (int)blockIdx.x +
                                         (lo == c0 ? 0 : 1)) * NF;
#pragma unroll
                for (int f = 0; f < NF; ++f) __stcg(dst + f, acc[f]);
                __threadfence();
                const int cf = a >> log2chunk;
                const uint32_t pieces = (uint32_t)(((e - 1) >> log2chunk)
                                                   - cf + 1);
                const uint32_t arrived = atomicAdd(counters + k, 1u);
                s_last = arrived == pieces - 1u;
                if (s_last) atomicExch(counters + k, 0u);  // next launch
            }
            __syncthreads();
            if (!s_last) continue;
            __threadfence();
            // the last piece in: the pieces in chunk order
            const int cf = a >> log2chunk;
            const int np = ((e - 1) >> log2chunk) - cf + 1;
            const wf::FoldPieces<NF> pcs{parts, cf, (a & (chunk - 1)) != 0};
            const int qp = (np + WF_FOLD_THREADS - 1) / WF_FOLD_THREADS;
            const int p0 = (int)threadIdx.x * qp;
            any = wf::fold_seq<P, ITEMS>(pol, pcs, p0, min(np, p0 + qp), acc,
                                         false);
            wf::block_join<P>(pol, acc, any, s_rows, s_any);
            if (threadIdx.x == 0)
                wf::store_out<C>(out, out_valid, out_src, g, k, acc, true);
        }
        return;
    }

    // a light block: sorted row r, slot index r
    const int r = ((int)blockIdx.x - chunk_blocks) * WF_FOLD_THREADS
        + (int)threadIdx.x;
    const bool slot_row = r < out_rows;
    int za = 0, ze = 0;  // slot r's run, for its zero row
    if (slot_row && r < sentinel) {
        za = __ldg(starts + r);
        ze = __ldg(starts + r + 1);
    }
    const int k = r < n ? (int)skeys[r] : -1;
    const int kprev = lane == 0 && r > 0 && r - 1 < n ? (int)skeys[r - 1] : -1;
    const int src0 = r < n ? __ldg(order + r) : 0;
    const int kup = __shfl_up_sync(WF_FULL, k, 1);
    const bool head = k >= 0 && k < sentinel
        && (r == 0 || (lane == 0 ? kprev : kup) != k);
    int e = r;
    if (head) {  // the run's end, and its first row with it
        e = __ldg(starts + k + 1);
        rows.load(src0, acc);
    }
    const int len = e - r;
    // the warp regime: a warp heads at most one such run
    const unsigned mw = __ballot_sync(
        WF_FULL, head && len >= WF_FOLD_WARP_ROWS && len < block_rows);
    if (mw != 0u) {
        const int hl = __ffs((int)mw) - 1;
        const int a = __shfl_sync(WF_FULL, r, hl);
        const int ea = __shfl_sync(WF_FULL, e, hl);
        const int ka = __shfl_sync(WF_FULL, k, hl);
        const int q = (ea - a + 31) >> 5;
        const int t0 = a + lane * q;
        uint32_t w[NF];
        bool any = wf::fold_seq<P, ITEMS>(pol, rows, t0, min(ea, t0 + q), w,
                                          false);
        wf::warp_join<P>(pol, w, any);
        if (lane == 0)
            wf::store_out<C>(out, out_valid, out_src, g, ka, w, true);
    }
    // the thread regime
    if (head && len < WF_FOLD_WARP_ROWS) {
        wf::fold_seq<P, ITEMS>(pol, rows, r + 1, e, acc, true);
        wf::store_out<C>(out, out_valid, out_src, g, k, acc, true);
    }
    if (slot_row && (r >= sentinel || za == ze)) {
        uint32_t z[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) z[f] = 0u;
        wf::store_out<C>(out, out_valid, out_src, g, r, z, false);
    }
}

// K6 (see above): the first stage's blocks; the last block at each
// counter runs the next stage. counters: a word a block of each stage
// after the first, zero before the launch and again after it; parts: each
// stage's partials, NF planes of 32 a block.
template <class C>
__global__ void __launch_bounds__(WF_FOLD_THREADS, 1)
wf_tree_reduce(Planes<C::NF> vals, const C cb,
               const uint8_t* __restrict__ valid, int n, int size, int log2m,
               Planes<C::NF> out, uint8_t* __restrict__ out_valid,
               int32_t* __restrict__ out_src, wf::Gathers g,
               uint32_t* __restrict__ counters, uint32_t* __restrict__ parts) {
    using P = wf::SlotPolicy<C>;
    constexpr int NF = P::NF;
    constexpr int R = wf::tree_rows<NF>(), E = wf::tree_parts<NF>();
    __shared__ uint32_t s_rows[4 * 32 * NF];
    __shared__ bool s_last;
    const P pol{cb};
    uint32_t r[NF];
    int Q = 1 << log2m, B = (int)gridDim.x, b = (int)blockIdx.x;
    wf::tree_stage<P, R>(pol, wf::TreeRows<C>{vals, valid, n, size}, Q, b,
                         B, s_rows, r);
    uint32_t* part = parts;
    uint32_t* cnt = counters;
    while (B > 1) {
        const int Qn = 32 * B, Bn = wf::tree_next<NF>(B);
        if (threadIdx.x < 32) {
#pragma unroll
            for (int f = 0; f < NF; ++f)
                __stcg(part + f * Qn + 32 * b + (int)threadIdx.x, r[f]);
            __threadfence();
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            const uint32_t arrived = atomicAdd(cnt + (b & (Bn - 1)), 1u);
            s_last = arrived == (uint32_t)(B / Bn - 1);
            if (s_last) atomicExch(cnt + (b & (Bn - 1)), 0u);  // next launch
        }
        __syncthreads();
        if (!s_last) return;
        __threadfence();
        b &= Bn - 1;
        wf::tree_stage<P, E>(pol, wf::TreeParts<NF>{part, Qn}, Qn, b, Bn,
                             s_rows, r);
        part += NF * Qn;
        cnt += Bn;
        Q = Qn;
        B = Bn;
    }
    if (threadIdx.x == 0)
        wf::store_out<C>(out, out_valid, out_src, g, 0, r, true);
}

// ---------------------------------------------------------------- host ---
namespace wf {

inline Gathers gathers_of(void* const* in, void* const* out, int n) {
    Gathers g;
    for (int i = 0; i < WF_MAX_GATHER; ++i) {
        g.in[i] = i < n ? static_cast<const uint32_t*>(in[i]) : nullptr;
        g.out[i] = i < n ? static_cast<uint32_t*>(out[i]) : nullptr;
    }
    g.n = n;
    return g;
}

// K6's scratch over m rows (a power of two): (counter words, part words).
template <int NF>
void tree_words(long long m, long long& counters, long long& parts) {
    counters = parts = 0;
    int B = tree_first<NF>(m);
    while (B > 1) {
        parts += (long long)NF * 32 * B;
        B = tree_next<NF>(B);
        counters += B;
    }
}

// The kernels' host sides, over the wrappers' packed arguments
// (reduce_fold.py: launch_keyed_fold, launch_tree_reduce): `p` the
// pointers, `a` the ints, in the orders below. Each returns 0, a
// cudaError_t, or -1 for arguments its kernel does not take (the wrapper
// checks first).
//
// K7: p = the nf planes, the nf output planes, the ng gathered columns
// and their ng outputs, then valid (may be null), skeys (key_bytes 2 or
// 4), order, starts, out_valid, out_src, counters (counter_words words,
// zero), parts (part_words), stream. chunk_blocks: 0 where no run is
// block_rows long, else one a chunk of 2^log2chunk sorted rows.
enum { KF_NF, KF_NG, KF_KEY_BYTES, KF_N, KF_SENTINEL, KF_OUT_ROWS,
       KF_BLOCK_ROWS, KF_LOG2CHUNK, KF_CHUNK_BLOCKS, KF_COUNTER_WORDS,
       KF_PART_WORDS, KF_INTS };

template <class C>
int keyed_fold_call(void* const* p, const int* a, const C& cb) {
    constexpr int NF = SlotPolicy<C>::NF;
    const int nf = a[KF_NF], ng = a[KF_NG], key_bytes = a[KF_KEY_BYTES];
    const int n = a[KF_N], sentinel = a[KF_SENTINEL];
    const int out_rows = a[KF_OUT_ROWS], block_rows = a[KF_BLOCK_ROWS];
    const int log2chunk = a[KF_LOG2CHUNK], chunk_blocks = a[KF_CHUNK_BLOCKS];
    if (nf != C::NF || ng < 0 || ng > WF_MAX_GATHER) return -1;
    void* const* q = p + 2 * nf + 2 * ng;
    if (n < 1 || sentinel < 0 || out_rows < 1 || out_rows < sentinel ||
        (key_bytes != 2 && key_bytes != 4) || q[3] == nullptr ||
        q[4] == nullptr || q[5] == nullptr || log2chunk < 5 ||
        log2chunk > 24 || block_rows < (1 << log2chunk) || chunk_blocks < 0)
        return -1;
    const long long chunks = ((long long)n + (1 << log2chunk) - 1)
        >> log2chunk;
    if (chunk_blocks != 0 &&
        (chunk_blocks != chunks || q[6] == nullptr ||
         a[KF_COUNTER_WORDS] < sentinel || q[7] == nullptr ||
         2LL * chunks * NF > (long long)a[KF_PART_WORDS]))
        return -1;
    const long long span = n > out_rows ? n : out_rows;
    const long long blocks = chunk_blocks
        + (span + WF_FOLD_THREADS - 1) / WF_FOLD_THREADS;
    if (span + WF_FOLD_THREADS > 0x7fffffffLL || blocks > 0x7fffffffLL)
        return -1;
    const Planes<C::NF> vals = planes_of<C::NF>(p);
    const Planes<C::NF> out = planes_of<C::NF>(p + nf);
    const Gathers g = gathers_of(p + 2 * nf, p + 2 * nf + ng, ng);
    const uint8_t* valid = static_cast<const uint8_t*>(q[0]);
    const int32_t* order = static_cast<const int32_t*>(q[2]);
    const int32_t* starts = static_cast<const int32_t*>(q[3]);
    uint8_t* out_valid = static_cast<uint8_t*>(q[4]);
    int32_t* out_src = static_cast<int32_t*>(q[5]);
    uint32_t* counters = static_cast<uint32_t*>(q[6]);
    uint32_t* parts = static_cast<uint32_t*>(q[7]);
    cudaStream_t st = static_cast<cudaStream_t>(q[8]);
    if (key_bytes == 2)
        wf_keyed_fold<C, int16_t><<<(unsigned)blocks, WF_FOLD_THREADS, 0,
                                    st>>>(
            vals, cb, valid, static_cast<const int16_t*>(q[1]), order,
            starts, n, sentinel, out, out_valid, out_src, out_rows, g,
            block_rows, log2chunk, chunk_blocks, counters, parts);
    else
        wf_keyed_fold<C, int32_t><<<(unsigned)blocks, WF_FOLD_THREADS, 0,
                                    st>>>(
            vals, cb, valid, static_cast<const int32_t*>(q[1]), order,
            starts, n, sentinel, out, out_valid, out_src, out_rows, g,
            block_rows, log2chunk, chunk_blocks, counters, parts);
    return (int)cudaGetLastError();
}

// K6: p = the nf planes, the nf output planes, the ng gathered columns
// and their ng outputs, then valid (may be null; row i is valid iff
// i < size and valid[i]), out_valid, out_src, counters (counter_words
// words, zero), parts (part_words), stream.
enum { TR_NF, TR_NG, TR_N, TR_SIZE, TR_COUNTER_WORDS, TR_PART_WORDS,
       TR_INTS };

template <class C>
int tree_reduce_call(void* const* p, const int* a, const C& cb) {
    constexpr int NF = SlotPolicy<C>::NF;
    const int nf = a[TR_NF], ng = a[TR_NG], n = a[TR_N], size = a[TR_SIZE];
    if (nf != C::NF || ng < 0 || ng > WF_MAX_GATHER) return -1;
    void* const* q = p + 2 * nf + 2 * ng;
    if (n < 1 || size < 1 || size > n || n > 0x40000000 ||
        q[1] == nullptr || q[2] == nullptr)
        return -1;
    int log2m = 0;
    while ((1 << log2m) < n) ++log2m;
    long long need_c, need_p;
    tree_words<NF>(1LL << log2m, need_c, need_p);
    if ((need_c > 0 && (q[3] == nullptr || need_c > a[TR_COUNTER_WORDS])) ||
        (need_p > 0 && (q[4] == nullptr || need_p > a[TR_PART_WORDS])))
        return -1;
    wf_tree_reduce<C><<<(unsigned)tree_first<NF>(1LL << log2m),
                        WF_FOLD_THREADS, 0,
                        static_cast<cudaStream_t>(q[5])>>>(
        planes_of<C::NF>(p), cb, static_cast<const uint8_t*>(q[0]), n, size,
        log2m, planes_of<C::NF>(p + nf), static_cast<uint8_t*>(q[1]),
        static_cast<int32_t*>(q[2]),
        gathers_of(p + 2 * nf, p + 2 * nf + ng, ng),
        static_cast<uint32_t*>(q[3]), static_cast<uint32_t*>(q[4]));
    return (int)cudaGetLastError();
}

}  // namespace wf

// The C entry points of K7 and K6 for a traced variant, beside
// WF_REBUILD_ENTRY_POINTS and WF_FFAT_ENTRY_POINTS, over the packed
// arguments: `Comb` takes exactly Comb::NF planes (`kinds` is not read).
// forest_rebuild.cu defines the fieldwise library's own.
#define WF_REDUCE_ENTRY_POINTS(Comb)                                         \
    extern "C" {                                                             \
    int wf_keyed_fold(void* const* p, const int* a, const int* kinds) {      \
        (void)kinds;                                                         \
        return wf::keyed_fold_call<Comb>(p, a, Comb{});                      \
    }                                                                        \
    int wf_tree_reduce(void* const* p, const int* a, const int* kinds) {     \
        (void)kinds;                                                         \
        return wf::tree_reduce_call<Comb>(p, a, Comb{});                     \
    }                                                                        \
    }
