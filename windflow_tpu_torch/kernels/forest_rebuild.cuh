// FlatFAT forest rebuild for NVIDIA Hopper (sm_90a): the three regimes,
// templated on a combine policy.
//
// Replaces the Pallas TPU kernel windflow_tpu/tpu/pallas_kernels.py:
// make_forest_rebuild (body :41-79, pallas_call :94), reached from
// windflow_tpu/tpu/ffat_tpu.py:_rebuild_fn. The forest holds K_cap
// per-key segment trees, one row of 2F nodes per key and per lift field,
// plus a validity plane (bool, one byte per node). For every row the
// internal nodes [1, F) are recomputed bottom-up from the leaves [F, 2F):
// node i = combine(node 2i, node 2i+1) when both children are valid,
// else the valid child passes through (the right one when neither is);
// valid(i) = valid(2i) | valid(2i+1). Child order is kept: the left
// operand is always the lower node, also across the shuffles (the left
// child is the lower lane). Node 0 keeps its value. The update is in
// place (the port's counterpart of the JAX package donating the forest).
//
// The combine policy C folds one node from every field of its two
// children at once, as the Pallas kernel's inlined combine does:
//   C::NF                  fields (planes), a template constant;
//   C::WORDS               every plane is 32-bit (int32 or float32);
//   C::bytes(f)            4, or 1 for a bool plane (one byte a node);
//   C::CTA_MIN_BLOCKS      blocks per SM the cta regime is bounded for;
//   cb.node(l, r, vl, vr, o)
//                          o[f] = the node's 32-bit word of field f from
//                          the children's words l[f], r[f] and validity
//                          (a bool plane's word is 0 or 1).
// forest_rebuild.cu instantiates it with the per-field op codes of
// fieldwise(...); a traced combine's translation unit (generated by
// combine_codegen.py) with its own policy and field count.
//
// What bounds it: memory. Each leaf is read once and each internal node
// written once, K_cap * (2F - 1) * (sum of plane bytes + 1) bytes, against
// one combine per internal node. The launch plan comes from the Python
// wrapper (forest_rebuild.py: launch_plan); each call of wf::run_pass runs
// one pass of it, in one of three regimes:
//
// - warp (rows of up to 512 leaves; 32-bit planes only): a group of L
//   lanes owns a row, E leaves per lane (4, 8 or 16; at most 64 values
//   per lane over all fields, so they stay in registers), 32 / L rows per
//   warp. Leaves arrive as 16-byte loads and validity as one 32-bit word
//   per four leaves. The log2(E) lower levels fold in registers, the
//   log2(L) upper ones across lanes with __shfl_down_sync: every field of
//   the partner is shuffled in before the node is combined. The internal
//   nodes are staged in the warp's slice of shared memory and leave as
//   16-byte stores, node 0 with its own value. No block barrier.
// - cta (rows that fill shared memory; 32-bit planes, up to 8 fields):
//   persistent blocks walk tiles of R whole rows. Thread 0 brings each
//   tile's leaves in with cp.async.bulk, completing on an mbarrier, into
//   a two-stage ring, so tile t+1 lands while tile t folds. The fold
//   reuses the warp regime's register and shuffle fold on chunks of 128
//   nodes read from shared memory, one step per 7 levels; the internal
//   nodes leave as 16-byte stores.
// - chunk (rows beyond the cta regime's shared memory, forests with a
//   bool plane or more fields than the vector regimes hold, unaligned
//   planes): blocks fold chunks of S nodes of level W level by level in
//   shared memory (each plane at its own width), writing the log2(S)
//   levels above them; a row too large for one block is folded in
//   several passes.
//
// Every field loop is unrolled over the template field count, so plane
// pointers are read from the kernel's parameters at constant offsets and
// no kernel has a stack frame. Index math is 32-bit: the wrapper refuses
// forests with K_cap * 2F >= 2^31 - 1.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#define WF_MAX_DEVICES 64
#define WF_WARP_THREADS 128
#define WF_CTA_THREADS 256
#define WF_CHUNK_THREADS 256
#define WF_CTA_STEP 128         // nodes of a level folded by one warp
#define WF_SMEM_MAX 232448      // H100: 227 KB of shared memory per block
#define WF_SMEM_DEFAULT 49152   // above this, opt in per kernel
#define WF_FULL 0xffffffffu

template <int NF>
struct Planes {
    void* ptr[NF];
};

template <int NF>
__device__ __forceinline__ uint32_t* plane32(const Planes<NF>& pl, int f) {
    return static_cast<uint32_t*>(pl.ptr[f]);
}

// byte offset of plane f in a layout of `n` nodes per plane, divided by n
template <class C>
__host__ __device__ constexpr int plane_offset(int f) {
    int o = 0;
    for (int g = 0; g < f; ++g) o += C::bytes(g);
    return o;
}

template <class C>
__host__ __device__ constexpr int node_bytes() {
    return plane_offset<C>(C::NF) + 1;  // every plane, then validity
}

// ---- vector moves of N consecutive 32-bit words (N = 1, 2 or 4k) -------
template <int N>
__device__ __forceinline__ void ldg_words(const uint32_t* p, uint32_t* w) {
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
            const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + q);
            w[4 * q] = x.x; w[4 * q + 1] = x.y;
            w[4 * q + 2] = x.z; w[4 * q + 3] = x.w;
        }
    } else if constexpr (N == 2) {
        const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
        w[0] = x.x; w[1] = x.y;
    } else {
        w[0] = __ldg(p);
    }
}

template <int N>
__device__ __forceinline__ void ld_words(const uint32_t* p, uint32_t* w) {
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
            const uint4 x = reinterpret_cast<const uint4*>(p)[q];
            w[4 * q] = x.x; w[4 * q + 1] = x.y;
            w[4 * q + 2] = x.z; w[4 * q + 3] = x.w;
        }
    } else if constexpr (N == 2) {
        const uint2 x = *reinterpret_cast<const uint2*>(p);
        w[0] = x.x; w[1] = x.y;
    } else {
        w[0] = *p;
    }
}

template <int N>
__device__ __forceinline__ void st_words(uint32_t* p, const uint32_t* w) {
    if constexpr (N % 4 == 0) {
#pragma unroll
        for (int q = 0; q < N / 4; ++q)
            reinterpret_cast<uint4*>(p)[q] =
                make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
    } else if constexpr (N == 2) {
        *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
        *p = w[0];
    }
}

// N validity bytes (0/1) at p (N-byte aligned) from the low N bits of m
template <int N>
__device__ __forceinline__ void st_flags(uint8_t* p, uint32_t m) {
    if constexpr (N >= 4) {
        uint32_t w[N / 4];
#pragma unroll
        for (int q = 0; q < N / 4; ++q) {
            w[q] = 0;
#pragma unroll
            for (int b = 0; b < 4; ++b)
                w[q] |= ((m >> (4 * q + b)) & 1u) << (8 * b);
        }
        st_words<N / 4>(reinterpret_cast<uint32_t*>(p), w);
    } else if constexpr (N == 2) {
        *reinterpret_cast<uint16_t*>(p) =
            (uint16_t)((m & 1u) | ((m & 2u) << 7));
    } else {
        *p = (uint8_t)(m & 1u);
    }
}

// the low N bits of the result: byte e of p non-zero
template <int N>
__device__ __forceinline__ uint32_t flags_to_mask(const uint32_t* w) {
    uint32_t m = 0;
#pragma unroll
    for (int e = 0; e < N; ++e)
        m |= (((w[e / 4] >> (8 * (e % 4))) & 0xffu) != 0u ? 1u : 0u) << e;
    return m;
}

template <int N, bool GLOBAL>
__device__ __forceinline__ uint32_t ld_flags(const uint8_t* p) {
    if constexpr (N >= 4) {
        uint32_t w[N / 4];
        if constexpr (GLOBAL)
            ldg_words<N / 4>(reinterpret_cast<const uint32_t*>(p), w);
        else
            ld_words<N / 4>(reinterpret_cast<const uint32_t*>(p), w);
        return flags_to_mask<N>(w);
    } else {
        static_assert(N == 1, "1, or a multiple of 4, flags per lane");
        return *p != 0 ? 1u : 0u;
    }
}

// In-lane level D of a warp fold: E >> D nodes per lane, folded in place
// into v[f][0, E >> D) and written out; recurses to the next level.
template <class C, int E, int D>
__device__ __forceinline__ void fold_in_lane(uint32_t (&v)[C::NF][E],
                                             uint32_t& vm, const C& cb,
                                             int W, int S, int c, int sub,
                                             uint32_t* dst, int fstride,
                                             uint8_t* dstv, bool live) {
    constexpr int NF = C::NF;
    if constexpr ((E >> D) >= 1) {
        constexpr int n = E >> D;
        uint32_t nm = 0;
#pragma unroll
        for (int k = 0; k < n; ++k) {
            const bool vl = (vm >> (2 * k)) & 1u, vr = (vm >> (2 * k + 1)) & 1u;
            uint32_t l[NF], r[NF], o[NF];
#pragma unroll
            for (int f = 0; f < NF; ++f) {
                l[f] = v[f][2 * k];
                r[f] = v[f][2 * k + 1];
            }
            cb.node(l, r, vl, vr, o);
#pragma unroll
            for (int f = 0; f < NF; ++f) v[f][k] = o[f];
            nm |= (vl || vr ? 1u : 0u) << k;
        }
        vm = nm;
        if (live) {
            const int node = (W >> D) + c * (S >> D) + sub * n;
#pragma unroll
            for (int f = 0; f < NF; ++f)
                st_words<n>(dst + f * fstride + node, v[f]);
            st_flags<n>(dstv + node, vm);
        }
        fold_in_lane<C, E, D + 1>(v, vm, cb, W, S, c, sub, dst, fstride,
                                  dstv, live);
    }
}

// One lane's share of a warp fold. A chunk of S = L * E consecutive nodes
// of level W (row-relative heap indices [W + c*S, W + (c+1)*S)) is held by
// L consecutive lanes, E nodes each (v, validity bits in vm); lane `sub`
// holds [W + c*S + sub*E, +E). Every internal node the chunk determines
// (log2(S) levels) is written to dst[f * fstride + node] and dstv[node]:
// in-lane level d has E >> d nodes per lane at (W >> d) + c*(S >> d) +
// sub*(E >> d); cross-lane step s leaves node (W >> (log2 E + s)) +
// c*(L >> s) + (sub >> s) on the lanes whose sub is a multiple of 2^s.
// Every lane of the warp calls it (the shuffles), `live` ones write.
template <class C, int E>
__device__ __forceinline__ void fold_chunk(uint32_t (&v)[C::NF][E],
                                           uint32_t vm, const C& cb, int W,
                                           int S, int c, int sub, int L,
                                           uint32_t* dst, int fstride,
                                           uint8_t* dstv, bool live) {
    constexpr int NF = C::NF;
    constexpr int LE = E >= 16 ? 4 : E >= 8 ? 3 : E >= 4 ? 2 : E >= 2 ? 1 : 0;
    fold_in_lane<C, E, 1>(v, vm, cb, W, S, c, sub, dst, fstride, dstv, live);
    bool b = vm & 1u;
    int s = 1;
    for (int o = 1; o < L; o <<= 1, ++s) {
        const bool yb = __shfl_down_sync(WF_FULL, b ? 1 : 0, o) != 0;
        // every field of the partner (the upper node) first, then the node
        uint32_t x[NF], y[NF], m[NF];
#pragma unroll
        for (int f = 0; f < NF; ++f) {
            x[f] = v[f][0];
            y[f] = __shfl_down_sync(WF_FULL, v[f][0], o);
        }
        cb.node(x, y, b, yb, m);
#pragma unroll
        for (int f = 0; f < NF; ++f) v[f][0] = m[f];
        b = b || yb;
        if (live && (sub & (2 * o - 1)) == 0) {
            const int node = (W >> (LE + s)) + c * (L >> s) + (sub >> s);
#pragma unroll
            for (int f = 0; f < NF; ++f) dst[f * fstride + node] = v[f][0];
            dstv[node] = b ? 1 : 0;
        }
    }
}

// ---------------------------------------------------------------- warp ---
// Row r is held by lanes [(r mod 32/L) * L, +L) of warp r / (32/L), L =
// F / E. Shared memory per warp: 32*E words per field, then 32*E flags.
template <class C, int E>
__global__ void __launch_bounds__(WF_WARP_THREADS)
wf_rebuild_warp(Planes<C::NF> pl, const C cb, uint8_t* __restrict__ valid,
                int n_rows, int F, int log2_L) {
    constexpr int NF = C::NF;
    extern __shared__ __align__(16) uint8_t smem[];
    constexpr int WN = 32 * E;  // nodes staged per warp
    constexpr int WARPS = WF_WARP_THREADS / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int L = 1 << log2_L;
    const int sub = lane & (L - 1), rw = lane >> log2_L;
    const int row = ((blockIdx.x * WARPS + warp) << (5 - log2_L)) + rw;
    const bool live = row < n_rows;
    const int base = live ? row * 2 * F : 0;
    uint32_t* st = reinterpret_cast<uint32_t*>(smem) + warp * WN * NF + rw * F;
    uint8_t* stv = smem + WARPS * WN * NF * 4 + warp * WN + rw * F;

    uint32_t v[NF][E];
    uint32_t vm = 0, n0[NF] = {};
    uint8_t v0 = 0;
    if (live) {
        const int leaf = base + F + sub * E;
#pragma unroll
        for (int f = 0; f < NF; ++f) ldg_words<E>(plane32(pl, f) + leaf, v[f]);
        vm = ld_flags<E, true>(valid + leaf);
        if (sub == 0) {
#pragma unroll
            for (int f = 0; f < NF; ++f) n0[f] = plane32(pl, f)[base];
            v0 = valid[base];
        }
    } else {
#pragma unroll
        for (int f = 0; f < NF; ++f)
#pragma unroll
            for (int e = 0; e < E; ++e) v[f][e] = 0;
    }
    fold_chunk<C, E>(v, vm, cb, F, F, 0, sub, L, st, WN, stv, live);
    if (live && sub == 0) {
#pragma unroll
        for (int f = 0; f < NF; ++f) st[f * WN] = n0[f];
        stv[0] = v0;
    }
    __syncwarp();
    if (live) {
        // nodes [sub*E, sub*E + E) of the row: node 0 with its own value
        const int at = sub * E;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
            uint32_t w[E];
            ld_words<E>(st + f * WN + at, w);
            st_words<E>(plane32(pl, f) + base + at, w);
        }
        uint32_t w[E / 4];
        ld_words<E / 4>(reinterpret_cast<const uint32_t*>(stv + at), w);
        st_words<E / 4>(reinterpret_cast<uint32_t*>(valid + base + at), w);
    }
}

// ----------------------------------------------------------------- cta ---
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
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

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// Shared memory of a cta block, T = R * F nodes per tile: the fold's
// buffer (NF planes of T words, then T flags; row r's node j at r*F + j),
// two stages of the same size holding the tile's leaves (row r's leaf
// F + j at r*F + j), then the stages' two mbarriers.
template <class C>
__device__ __forceinline__ void cta_issue(const Planes<C::NF>& pl,
                                          const uint8_t* valid, int n_rows,
                                          int F, int R, int tile,
                                          uint8_t* stage, uint64_t* bar) {
    constexpr int NF = C::NF;
    const int T = R * F;
    const int row0 = tile * R;
    const int rows = min(R, n_rows - row0);
    mbar_expect_tx(bar, (uint32_t)(rows * F * (4 * NF + 1)));
    for (int r = 0; r < rows; ++r) {
        const int leaf = (row0 + r) * 2 * F + F;
#pragma unroll
        for (int f = 0; f < NF; ++f)
            bulk_load(reinterpret_cast<uint32_t*>(stage) + f * T + r * F,
                      plane32(pl, f) + leaf, (uint32_t)F * 4, bar);
        bulk_load(stage + NF * T * 4 + r * F, valid + leaf, (uint32_t)F, bar);
    }
}

// One warp-fold step of a tile: chunks of S nodes of level W (src: row
// r's node j at src[r*F + j - src_first]) folded into out. Warp w takes
// groups of 32 / L chunks, L = S / E lanes per chunk.
template <class C, int E>
__device__ __forceinline__ void cta_step(const C& cb, const uint32_t* src,
                                         const uint8_t* srcv, int src_first,
                                         uint32_t* out, uint8_t* outv, int T,
                                         int F, int rows, int W, int S) {
    constexpr int NF = C::NF;
    const int L = S / E, log2_L = __ffs(L) - 1;
    const int per_row = W / S, log2_pr = __ffs(per_row) - 1;
    const int chunks = rows << log2_pr;
    const int per_warp = 32 >> log2_L;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int sub = lane & (L - 1);
    for (int q0 = warp * per_warp; q0 < chunks;
         q0 += per_warp * (WF_CTA_THREADS / 32)) {
        const int q = q0 + (lane >> log2_L);
        const bool live = q < chunks;
        const int r = live ? q >> log2_pr : 0;
        const int c = live ? q & (per_row - 1) : 0;
        uint32_t v[NF][E];
        uint32_t vm = 0;
        if (live) {
            const int at = r * F + W + c * S + sub * E - src_first;
#pragma unroll
            for (int f = 0; f < NF; ++f) ld_words<E>(src + f * T + at, v[f]);
            vm = ld_flags<E, false>(srcv + at);
        } else {
#pragma unroll
            for (int f = 0; f < NF; ++f)
#pragma unroll
                for (int e = 0; e < E; ++e) v[f][e] = 0;
        }
        fold_chunk<C, E>(v, vm, cb, W, S, c, sub, L, out + r * F, T,
                         outv + r * F, live);
    }
}

// The policy sets the occupancy bound: the fieldwise fold fits 64
// registers up to five fields (four blocks share an SM); more fields, and
// traced combines, take the registers they need (no spills).
template <class C>
__global__ void __launch_bounds__(WF_CTA_THREADS, C::CTA_MIN_BLOCKS)
wf_rebuild_cta(Planes<C::NF> pl, const C cb, uint8_t* __restrict__ valid,
               int n_rows, int F, int R, int n_tiles) {
    constexpr int NF = C::NF;
    extern __shared__ __align__(16) uint8_t smem[];
    const int T = R * F;
    const int tile_bytes = T * (4 * NF + 1);
    uint32_t* out = reinterpret_cast<uint32_t*>(smem);
    uint8_t* outv = smem + NF * T * 4;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 3 * tile_bytes);

    if (threadIdx.x == 0) {
        mbar_init(&bar[0]);
        mbar_init(&bar[1]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int s = 0; s < 2; ++s) {
            const int tile = blockIdx.x + s * gridDim.x;
            if (tile < n_tiles)
                cta_issue<C>(pl, valid, n_rows, F, R, tile,
                             smem + (1 + s) * tile_bytes, &bar[s]);
        }
    }
    __syncthreads();

    for (int i = 0;; ++i) {
        const int tile = blockIdx.x + i * gridDim.x;
        if (tile >= n_tiles) break;
        const int s = i & 1;
        uint8_t* stage = smem + (1 + s) * tile_bytes;
        const int row0 = tile * R;
        const int rows = min(R, n_rows - row0);
        // node 0 of each row goes back out with its own value
        for (int r = threadIdx.x; r < rows; r += WF_CTA_THREADS) {
            const int at = (row0 + r) * 2 * F;
#pragma unroll
            for (int f = 0; f < NF; ++f) out[f * T + r * F] = plane32(pl, f)[at];
            outv[r * F] = valid[at];
        }
        mbar_wait(&bar[s], (uint32_t)(i >> 1) & 1u);
        int W = F, S = min(F, WF_CTA_STEP);
        cta_step<C, 4>(cb, reinterpret_cast<const uint32_t*>(stage),
                       stage + NF * T * 4, F, out, outv, T, F, rows, W, S);
        __syncthreads();  // the stage is read: refill it with tile i + 2
        if (threadIdx.x == 0 && tile + 2 * gridDim.x < n_tiles) {
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            cta_issue<C>(pl, valid, n_rows, F, R, tile + 2 * gridDim.x,
                         stage, &bar[s]);
        }
        for (W /= S; W > 1; W /= S) {
            S = min(W, WF_CTA_STEP);
            if (S >= 4)
                cta_step<C, 4>(cb, out, outv, 0, out, outv, T, F, rows, W, S);
            else
                cta_step<C, 1>(cb, out, outv, 0, out, outv, T, F, rows, W, S);
            __syncthreads();
        }
        // rows [row0, row0 + rows), nodes [0, F): 16-byte stores
        const int lq = __ffs(F) - 1 - 2;  // log2(F / 4)
#pragma unroll
        for (int f = 0; f < NF; ++f) {
            for (int q = threadIdx.x; q < rows << lq; q += WF_CTA_THREADS) {
                const int r = q >> lq, j = (q & ((1 << lq) - 1)) * 4;
                *reinterpret_cast<uint4*>(plane32(pl, f) + (row0 + r) * 2 * F
                                          + j) =
                    *reinterpret_cast<const uint4*>(out + f * T + r * F + j);
            }
        }
        const int lv = lq - 2;  // log2(F / 16)
        for (int q = threadIdx.x; q < rows << lv; q += WF_CTA_THREADS) {
            const int r = q >> lv, j = (q & ((1 << lv) - 1)) * 16;
            *reinterpret_cast<uint4*>(valid + (row0 + r) * 2 * F + j) =
                *reinterpret_cast<const uint4*>(outv + r * F + j);
        }
        __syncthreads();  // out is free for the next tile
    }
}

// --------------------------------------------------------------- chunk ---
// A node of plane f: in global memory (`at`) and in a shared-memory heap
// whose planes hold `n` nodes each at their own width (`i`).
template <class C>
__device__ __forceinline__ uint32_t ld_node(const Planes<C::NF>& pl, int f,
                                            int at) {
    if (C::bytes(f) == 1)
        return static_cast<const uint8_t*>(pl.ptr[f])[at] != 0 ? 1u : 0u;
    return static_cast<const uint32_t*>(pl.ptr[f])[at];
}

template <class C>
__device__ __forceinline__ void st_node(const Planes<C::NF>& pl, int f,
                                        int at, uint32_t w) {
    if (C::bytes(f) == 1)
        static_cast<uint8_t*>(pl.ptr[f])[at] = w != 0u ? 1 : 0;
    else
        static_cast<uint32_t*>(pl.ptr[f])[at] = w;
}

template <class C>
__device__ __forceinline__ uint32_t ld_heap(const uint8_t* h, int n, int f,
                                            int i) {
    const uint8_t* p = h + n * plane_offset<C>(f);
    if (C::bytes(f) == 1) return p[i];
    return reinterpret_cast<const uint32_t*>(p)[i];
}

template <class C>
__device__ __forceinline__ void st_heap(uint8_t* h, int n, int f, int i,
                                        uint32_t w) {
    uint8_t* p = h + n * plane_offset<C>(f);
    if (C::bytes(f) == 1)
        p[i] = (uint8_t)w;
    else
        reinterpret_cast<uint32_t*>(p)[i] = w;
}

// Blocks of cpb chunks; chunk g = (row g >> log2_C, index g & (C - 1)) of
// level W, C = W / S. Local heap index j in [1, 2S) of a chunk sits at
// depth d = floor(log2 j) and maps to row node ((W/S + c) << d) + j - 2^d.
template <class C>
__global__ void __launch_bounds__(WF_CHUNK_THREADS)
wf_rebuild_chunk(Planes<C::NF> pl, const C cb, uint8_t* __restrict__ valid,
                 int n_rows, int F, int W, int log2_S, int log2_C, int cpb) {
    constexpr int NF = C::NF;
    extern __shared__ __align__(16) uint8_t smem[];
    const int S = 1 << log2_S, heap = 2 * S;
    const int n = cpb * heap;  // nodes of one plane's heaps
    uint8_t* vsm = smem + n * plane_offset<C>(NF);
    const int total = n_rows << log2_C;
    const int chunk0 = blockIdx.x * cpb;
    const int cmask = (1 << log2_C) - 1;

    for (int t = threadIdx.x; t < cpb << log2_S; t += WF_CHUNK_THREADS) {
        const int lc = t >> log2_S, j = t & (S - 1), g = chunk0 + lc;
        if (g >= total) continue;
        const int at = (g >> log2_C) * 2 * F + W + ((g & cmask) << log2_S) + j;
#pragma unroll
        for (int f = 0; f < NF; ++f)
            st_heap<C>(smem, n, f, lc * heap + S + j, ld_node<C>(pl, f, at));
        vsm[lc * heap + S + j] = valid[at] != 0;
    }
    __syncthreads();
    for (int lw = log2_S - 1; lw >= 0; --lw) {
        const int w = 1 << lw;
        for (int t = threadIdx.x; t < cpb << lw; t += WF_CHUNK_THREADS) {
            const int lc = t >> lw, j = w + (t & (w - 1));
            const int vb = lc * heap;
            const bool vl = vsm[vb + 2 * j], vr = vsm[vb + 2 * j + 1];
            uint32_t l[NF], r[NF], o[NF];
#pragma unroll
            for (int f = 0; f < NF; ++f) {
                l[f] = ld_heap<C>(smem, n, f, vb + 2 * j);
                r[f] = ld_heap<C>(smem, n, f, vb + 2 * j + 1);
            }
            cb.node(l, r, vl, vr, o);
#pragma unroll
            for (int f = 0; f < NF; ++f) st_heap<C>(smem, n, f, vb + j, o[f]);
            vsm[vb + j] = vl || vr;
        }
        __syncthreads();
    }
    for (int t = threadIdx.x; t < cpb << log2_S; t += WF_CHUNK_THREADS) {
        const int lc = t >> log2_S, j = t & (S - 1), g = chunk0 + lc;
        if (j == 0 || g >= total) continue;
        const int d = 31 - __clz(j);
        const int node = (((W >> log2_S) + (g & cmask)) << d) + j - (1 << d);
        const int at = (g >> log2_C) * 2 * F + node;
#pragma unroll
        for (int f = 0; f < NF; ++f)
            st_node<C>(pl, f, at, ld_heap<C>(smem, n, f, lc * heap + j));
        valid[at] = vsm[lc * heap + j];
    }
}

// ---------------------------------------------------------------- host ---
namespace wf {

inline int device_sms(int dev, cudaError_t* err) {
    static std::atomic<int> sms[WF_MAX_DEVICES];
    int n = sms[dev].load();
    if (n == 0) {
        *err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        sms[dev].store(n);
    }
    return n;
}

// Opt the kernel in to `bytes` of dynamic shared memory once per size and
// device, not on every launch.
template <typename K>
cudaError_t allow_smem(K kernel, std::atomic<int>* allowed, int dev,
                       int bytes) {
    if (bytes <= WF_SMEM_DEFAULT || allowed[dev].load() >= bytes)
        return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess) allowed[dev].store(bytes);
    return e;
}

struct Pass {
    int regime, W, S, E, rows, smem;
};

template <class C, int E>
cudaError_t launch_warp(const Planes<C::NF>& pl, const C& cb, uint8_t* valid,
                        int n_rows, int F, const Pass& ps, cudaStream_t st) {
    int log2_L = 0;
    while ((E << log2_L) < F) ++log2_L;
    const int rows_per_block = (WF_WARP_THREADS / 32) << (5 - log2_L);
    const int blocks = (n_rows + rows_per_block - 1) / rows_per_block;
    wf_rebuild_warp<C, E><<<blocks, WF_WARP_THREADS, ps.smem, st>>>(
        pl, cb, valid, n_rows, F, log2_L);
    return cudaGetLastError();
}

// Runs one pass of the wrapper's launch plan: regime 0 warp (W = S = F, E
// nodes per lane), 1 cta (W = S = F, `rows` rows per tile), 2 chunk
// (chunks of S nodes of level W, `rows` chunks per block); `smem` is the
// plan's dynamic shared memory, checked against the regime's layout.
// Returns 0, a cudaError_t from the launch, or -1 for arguments the
// kernel does not take (the Python wrapper validates them first).
template <class C>
int run_pass(const Planes<C::NF>& pl, const C& cb, uint8_t* valid,
             int n_rows, int F, const Pass& ps, cudaStream_t st) {
    constexpr int NF = C::NF;
    const int nb = node_bytes<C>();
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= WF_MAX_DEVICES) return -1;
    if (ps.regime == 0) {  // warp (register limits: forest_rebuild.py)
        if constexpr (C::WORDS && NF <= 8) {
            if (ps.W != F || ps.S != F || F < 4 || F % ps.E != 0 ||
                F / ps.E > 32 || ps.smem != WF_WARP_THREADS * ps.E * nb)
                return -1;
            switch (ps.E) {
            case 4: e = launch_warp<C, 4>(pl, cb, valid, n_rows, F, ps, st);
                break;
            case 8: e = launch_warp<C, 8>(pl, cb, valid, n_rows, F, ps, st);
                break;
            case 16:
                if constexpr (NF <= 4) {
                    e = launch_warp<C, 16>(pl, cb, valid, n_rows, F, ps, st);
                    break;
                }
                return -1;
            default: return -1;
            }
            return (int)e;
        }
        return -1;
    }
    if (ps.regime == 1) {  // cta
        if constexpr (C::WORDS && NF <= 8) {
            static std::atomic<int> allowed[WF_MAX_DEVICES];
            static std::atomic<int> occ_smem[WF_MAX_DEVICES];
            static std::atomic<int> occ_blocks[WF_MAX_DEVICES];
            const int R = ps.rows;
            if (ps.W != F || ps.S != F || F < 16 || R < 1 ||
                ps.smem != 3 * R * F * nb + 16 || ps.smem > WF_SMEM_MAX)
                return -1;
            e = allow_smem(wf_rebuild_cta<C>, allowed, dev, ps.smem);
            if (e != cudaSuccess) return (int)e;
            // persistent: as many blocks as fit on the card at once
            if (occ_smem[dev].load() != ps.smem) {
                int per_sm = 0;
                e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, wf_rebuild_cta<C>, WF_CTA_THREADS, ps.smem);
                if (e != cudaSuccess) return (int)e;
                occ_blocks[dev].store(per_sm);
                occ_smem[dev].store(ps.smem);
            }
            const int sms = device_sms(dev, &e);
            if (e != cudaSuccess) return (int)e;
            const int n_tiles = (n_rows + R - 1) / R;
            int blocks = sms * (occ_blocks[dev].load() > 0
                                    ? occ_blocks[dev].load() : 1);
            if (blocks > n_tiles) blocks = n_tiles;
            wf_rebuild_cta<C><<<blocks, WF_CTA_THREADS, ps.smem, st>>>(
                pl, cb, valid, n_rows, F, R, n_tiles);
            return (int)cudaGetLastError();
        }
        return -1;
    }
    if (ps.regime == 2) {  // chunk
        static std::atomic<int> allowed[WF_MAX_DEVICES];
        const int S = ps.S, W = ps.W, cpb = ps.rows;
        if (S < 2 || W < S || W > F || W % S != 0 || cpb < 1 ||
            ps.smem != cpb * 2 * S * nb || ps.smem > WF_SMEM_MAX)
            return -1;
        int log2_S = 0, log2_C = 0;
        while ((1 << log2_S) < S) ++log2_S;
        while ((S << log2_C) < W) ++log2_C;
        e = allow_smem(wf_rebuild_chunk<C>, allowed, dev, ps.smem);
        if (e != cudaSuccess) return (int)e;
        const long long total = (long long)n_rows << log2_C;
        const long long blocks = (total + cpb - 1) / cpb;
        wf_rebuild_chunk<C><<<(unsigned)blocks, WF_CHUNK_THREADS, ps.smem,
                              st>>>(pl, cb, valid, n_rows, F, W, log2_S,
                                    log2_C, cpb);
        return (int)cudaGetLastError();
    }
    return -1;
}

inline bool bad_geometry(int n_rows, int F, int S) {
    return n_rows < 1 || F < 2 || (F & (F - 1)) != 0 || S < 1 ||
           (S & (S - 1)) != 0;
}

inline const char* error_string(int code) {
    if (code == -1) return "invalid arguments";
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace wf

// The C entry points of a traced variant: `Comb` is its policy, which
// takes exactly Comb::NF planes (`kinds` is not read). Every variant's
// policy sits in a namespace of its own (combine_codegen.py): the
// dynamic linker unifies the static locals of identical template
// instantiations across loaded libraries (GNU unique symbols), so two
// variants sharing one policy name would share run_pass's per-kernel
// settings (the shared-memory opt-in) though not their kernels.
#define WF_REBUILD_ENTRY_POINTS(Comb)                                        \
    extern "C" {                                                             \
    int wf_rebuild_pass(void** planes, const int* kinds, int n_fields,      \
                        void* valid, int n_rows, int F, int regime, int W,  \
                        int S, int E, int rows, int smem, void* stream) {   \
        (void)kinds;                                                         \
        if (n_fields != Comb::NF || wf::bad_geometry(n_rows, F, S))          \
            return -1;                                                       \
        Planes<Comb::NF> pl;                                                 \
        for (int f = 0; f < Comb::NF; ++f) pl.ptr[f] = planes[f];            \
        return wf::run_pass<Comb>(pl, Comb{}, static_cast<uint8_t*>(valid),  \
                                  n_rows, F,                                 \
                                  wf::Pass{regime, W, S, E, rows, smem},     \
                                  static_cast<cudaStream_t>(stream));        \
    }                                                                        \
    const char* wf_error_string(int code) { return wf::error_string(code); } \
    }
