// FlatFAT forest rebuild for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel windflow_tpu/tpu/pallas_kernels.py:
// make_forest_rebuild (body :41-79, pallas_call :94), reached from
// windflow_tpu/tpu/ffat_tpu.py:_rebuild_fn. The forest holds K_cap
// per-key segment trees, one row of 2F nodes per key and per lift field,
// plus a validity plane (bool, one byte per node). For every row the
// internal nodes [1, F) are recomputed bottom-up from the leaves [F, 2F):
// node i = combine(node 2i, node 2i+1) when both children are valid,
// else the valid child passes through (the right one when neither is);
// valid(i) = valid(2i) | valid(2i+1). Child order is kept; node 0 is
// never touched. The update is in place (the port's counterpart of the
// JAX package donating the forest).
//
// What bounds it: memory. Each leaf is read once and each internal node
// written once, (K_cap * F * (sum of field bytes + 1)) * 2 bytes, against
// log2(F) cheap operations per leaf. The design therefore touches device
// memory exactly once per node: a block loads a chunk of S consecutive
// nodes of one level (the leaves, on the first pass) into shared memory,
// folds all log2(S) levels above them there, and writes each internal
// node out once. When a row fits in shared memory (S = F, the main path)
// one launch does the whole forest and a block holds several rows. A row
// too large for one block's shared memory (227 KB) is folded in several
// launches: each folds chunks of S nodes into the F/S nodes of a higher
// level, which the next launch takes as its leaves.
//
// Fields are int32 or float32 with a per-field op code (0 sum, 1 min,
// 2 max). Every value is kept as a 32-bit word in shared memory. Float
// sums use __fadd_rn, so no FMA contraction changes a result, and
// min/max propagate NaN like torch.minimum/torch.maximum: the kernel is
// bit-identical to the plain PyTorch level loop (kernels/reference.py).

#include <cuda_runtime.h>
#include <stdint.h>

#define WF_MAX_FIELDS 8
#define WF_THREADS 256
#define WF_SMEM_MAX 232448      // H100: 227 KB of shared memory per block
#define WF_SMEM_DEFAULT 49152   // above this, opt in per kernel
#define WF_LEAVES_PER_BLOCK 1024

struct Planes {
    uint32_t* ptr[WF_MAX_FIELDS];
    int is_float[WF_MAX_FIELDS];
    int op[WF_MAX_FIELDS];
};

__device__ __forceinline__ uint32_t combine_word(uint32_t a, uint32_t b,
                                                 int op, int is_float) {
    if (is_float) {
        float x = __uint_as_float(a), y = __uint_as_float(b);
        float r;
        if (op == 0) {
            r = __fadd_rn(x, y);
        } else if (x != x) {
            r = x;
        } else if (y != y) {
            r = y;
        } else {
            r = (op == 1) ? fminf(x, y) : fmaxf(x, y);
        }
        return __float_as_uint(r);
    }
    int x = (int)a, y = (int)b;
    if (op == 0) return a + b;  // two's-complement wrap, as torch int32
    return (uint32_t)((op == 1) ? min(x, y) : max(x, y));
}

// One pass: chunks of S consecutive nodes of level W (global heap indices
// [W + c*S, W + (c+1)*S) of each row) are folded into their log2(S)
// upper levels. Local heap index j in [1, 2S) of chunk c sits at depth
// d = floor(log2 j) and maps to global node (W/S + c) * 2^d + (j - 2^d).
__global__ void __launch_bounds__(WF_THREADS)
fold_levels(Planes planes, int n_fields, uint8_t* __restrict__ valid,
            int n_rows, int row_len, int W, int S, int chunks_per_row,
            int chunks_per_block) {
    extern __shared__ uint32_t smem[];
    const int heap = 2 * S;
    const int cpb = chunks_per_block;
    uint8_t* vsm = reinterpret_cast<uint8_t*>(smem + (size_t)n_fields * cpb * heap);
    const long long total_chunks = (long long)n_rows * chunks_per_row;
    const long long chunk0 = (long long)blockIdx.x * cpb;

    // load the chunk's nodes of level W into local heap slots [S, 2S)
    for (int t = threadIdx.x; t < cpb * S; t += blockDim.x) {
        const int lc = t / S, j = t - lc * S;
        const long long g = chunk0 + lc;
        if (g >= total_chunks) continue;
        const long long row = g / chunks_per_row;
        const int c = (int)(g - row * chunks_per_row);
        const long long at = row * row_len + W + (long long)c * S + j;
        for (int f = 0; f < n_fields; ++f)
            smem[((size_t)f * cpb + lc) * heap + S + j] = planes.ptr[f][at];
        vsm[(size_t)lc * heap + S + j] = valid[at];
    }
    __syncthreads();

    // fold level by level inside shared memory
    for (int w = S >> 1; w >= 1; w >>= 1) {
        for (int t = threadIdx.x; t < cpb * w; t += blockDim.x) {
            const int lc = t / w;
            const int j = w + (t - lc * w);
            const size_t vb = (size_t)lc * heap;
            const uint8_t vl = vsm[vb + 2 * j], vr = vsm[vb + 2 * j + 1];
            for (int f = 0; f < n_fields; ++f) {
                uint32_t* h = smem + ((size_t)f * cpb + lc) * heap;
                const uint32_t l = h[2 * j], r = h[2 * j + 1];
                h[j] = (vl && vr) ? combine_word(l, r, planes.op[f],
                                                 planes.is_float[f])
                                  : (vl ? l : r);
            }
            vsm[vb + j] = vl | vr;
        }
        __syncthreads();
    }

    // write every internal node of the chunk once
    for (int t = threadIdx.x; t < cpb * (S - 1); t += blockDim.x) {
        const int lc = t / (S - 1), j = 1 + (t - lc * (S - 1));
        const long long g = chunk0 + lc;
        if (g >= total_chunks) continue;
        const long long row = g / chunks_per_row;
        const int c = (int)(g - row * chunks_per_row);
        const int d = 31 - __clz(j);
        const long long node = ((long long)(W / S) + c) * (1LL << d) + (j - (1 << d));
        const long long at = row * row_len + node;
        for (int f = 0; f < n_fields; ++f)
            planes.ptr[f][at] = smem[((size_t)f * cpb + lc) * heap + j];
        valid[at] = vsm[(size_t)lc * heap + j];
    }
}

extern "C" {

// Rebuilds the internal levels of every row in place, on `stream`.
// Returns 0, a cudaError_t from the launch, or -1 for arguments the
// kernel does not take (the Python wrapper validates them first).
int wf_forest_rebuild(void** planes, const int* is_float, const int* ops,
                      int n_fields, void* valid, int n_rows, int F,
                      void* stream) {
    if (n_fields < 1 || n_fields > WF_MAX_FIELDS || n_rows < 1 || F < 2 ||
        (F & (F - 1)) != 0)
        return -1;
    Planes p;
    for (int f = 0; f < WF_MAX_FIELDS; ++f) {
        p.ptr[f] = f < n_fields ? static_cast<uint32_t*>(planes[f]) : nullptr;
        p.is_float[f] = f < n_fields ? is_float[f] : 0;
        p.op[f] = f < n_fields ? ops[f] : 0;
    }
    const size_t node_bytes = 4 * (size_t)n_fields + 1;
    int s_max = 1;  // largest chunk whose heap fits the shared memory
    while ((size_t)(4 * s_max) * node_bytes <= WF_SMEM_MAX) s_max <<= 1;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    for (int W = F; W > 1;) {
        const int S = W < s_max ? W : s_max;
        const int chunks_per_row = W / S;
        int cpb = WF_LEAVES_PER_BLOCK / S;
        if (cpb < 1) cpb = 1;
        while (cpb > 1 && (size_t)cpb * 2 * S * node_bytes > WF_SMEM_DEFAULT)
            cpb >>= 1;
        const size_t words = (size_t)n_fields * cpb * 2 * S;
        const size_t smem = words * 4 + (size_t)cpb * 2 * S;
        if (smem > WF_SMEM_DEFAULT) {
            cudaError_t e = cudaFuncSetAttribute(
                fold_levels, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)smem);
            if (e != cudaSuccess) return (int)e;
        }
        const long long total = (long long)n_rows * chunks_per_row;
        const long long blocks = (total + cpb - 1) / cpb;
        fold_levels<<<(unsigned)blocks, WF_THREADS, smem, st>>>(
            p, n_fields, static_cast<uint8_t*>(valid), n_rows, 2 * F, W, S,
            chunks_per_row, cpb);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        W = chunks_per_row;
    }
    return 0;
}

const char* wf_error_string(int code) {
    if (code == -1) return "invalid arguments";
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
