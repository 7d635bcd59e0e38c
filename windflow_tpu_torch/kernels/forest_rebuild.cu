// FlatFAT forest rebuild for NVIDIA Hopper (sm_90a): the fieldwise
// instantiation.
//
// Replaces the Pallas TPU kernel windflow_tpu/tpu/pallas_kernels.py:
// make_forest_rebuild (body :41-79, pallas_call :94); the regimes and
// what bounds them are described in forest_rebuild.cuh. This library
// folds the combines of fieldwise(...): 1-8 int32 or float32 planes, each
// with its own op (kind 0-2 int32 sum, min, max; 3-5 float32 sum, min,
// max), read from the kernel's parameters. Any other combine the Pallas
// kernel would inline (a traced torch combine, bool planes, more fields)
// runs in a library of its own, generated from the trace
// (combine_codegen.py) and built against the same header.
//
// Float sums use __fadd_rn, so no FMA contraction changes a result, and
// min/max propagate NaN like torch.minimum/torch.maximum: the kernel is
// bit-identical to the plain PyTorch level loop (kernels/reference.py).
//
// The same library holds the fieldwise instantiation of the FFAT step's
// kernels (ffat_step.cuh: K2+K3 wf_ffat_ingest and K4 wf_ffat_query) and
// of the reduce folds (reduce_fold.cuh: K7 wf_keyed_fold and K6
// wf_tree_reduce) over the same per-field ops (MaskCombine), so one
// combine is one library.

#include "ffat_step.cuh"
#include "reduce_fold.cuh"

#define WF_MAX_FIELDS 8

__device__ __forceinline__ uint32_t combine_word(uint32_t a, uint32_t b,
                                                 int kind) {
    const float x = __uint_as_float(a), y = __uint_as_float(b);
    switch (kind) {
    case 0: return a + b;  // two's-complement wrap, as torch int32
    case 1: return (uint32_t)min((int)a, (int)b);
    case 2: return (uint32_t)max((int)a, (int)b);
    case 3: return __float_as_uint(__fadd_rn(x, y));
    case 4: return x != x ? a : y != y ? b : __float_as_uint(fminf(x, y));
    default: return x != x ? a : y != y ? b : __float_as_uint(fmaxf(x, y));
    }
}

// The fieldwise policy of K1: each field folds on its own, by its kind;
// node = combine(l, r) when both are valid, else the valid one (r if none).
template <int N>
struct KindsCombine {
    static constexpr int NF = N;
    static constexpr bool WORDS = true;
    static constexpr int CTA_MIN_BLOCKS = N <= 5 ? 4 : 1;
    __host__ __device__ static constexpr int bytes(int) { return 4; }
    int kind[N];
    __device__ __forceinline__ void node(const uint32_t (&l)[N],
                                         const uint32_t (&r)[N], bool vl,
                                         bool vr, uint32_t (&o)[N]) const {
#pragma unroll
        for (int f = 0; f < N; ++f) {
            const uint32_t m = combine_word(l[f], r[f], kind[f]);
            o[f] = vl ? (vr ? m : l[f]) : r[f];
        }
    }
};

template <int N>
int run_fieldwise(void** planes, const int* kinds, uint8_t* valid,
                  int n_rows, int F, const wf::Pass& ps, cudaStream_t st) {
    KindsCombine<N> cb;
    for (int f = 0; f < N; ++f) cb.kind[f] = kinds[f];
    return wf::run_pass(wf::planes_of<N>(planes), cb, valid, n_rows, F, ps,
                        st);
}

// The fieldwise policy of the FFAT step's kernels: KindsCombine's ops,
// with no branch on the op. Each field's op is held as full-word masks (0
// or ~0), and every op's result is selected by them. With KindsCombine's
// switch, the per-field op tests that the compiler hoists out of these
// kernels' loops (the walk, the run loop) stay live as predicates, and
// ptxas spilled them (at 2, 7 and 8 fields, on the H100's toolchain); the
// masks are plain words read from the parameters. K1 keeps the switch:
// on this policy it ran 13-29% slower at one field (3-8% faster at four)
// at the main path's forests (PERF.md; scripts/bench_torch_k1.py
// --policy).
template <int N>
struct MaskCombine {
    static constexpr int NF = N;
    static constexpr bool WORDS = true;
    static constexpr int CTA_MIN_BLOCKS = 1;
    __host__ __device__ static constexpr int bytes(int) { return 4; }
    uint32_t is_min[N], is_max[N], is_float[N];
    __device__ __forceinline__ void node(const uint32_t (&l)[N],
                                         const uint32_t (&r)[N], bool vl,
                                         bool vr, uint32_t (&o)[N]) const {
#pragma unroll
        for (int f = 0; f < N; ++f) {
            const uint32_t a = l[f], b = r[f];
            const float x = __uint_as_float(a), y = __uint_as_float(b);
            const uint32_t mn = is_min[f], mx = is_max[f];
            const uint32_t sum = ~(mn | mx);
            const uint32_t iv = ((a + b) & sum)
                | ((uint32_t)min((int)a, (int)b) & mn)
                | ((uint32_t)max((int)a, (int)b) & mx);
            const uint32_t fmn = x != x ? a : y != y ? b
                : __float_as_uint(fminf(x, y));
            const uint32_t fmx = x != x ? a : y != y ? b
                : __float_as_uint(fmaxf(x, y));
            const uint32_t fv = (__float_as_uint(__fadd_rn(x, y)) & sum)
                | (fmn & mn) | (fmx & mx);
            const uint32_t m = (fv & is_float[f]) | (iv & ~is_float[f]);
            o[f] = vl ? (vr ? m : a) : b;
        }
    }
};

// kinds 0-2: int32 sum, min, max; 3-5: float32 sum, min, max
template <int N>
MaskCombine<N> mask_combine(const int* kinds) {
    MaskCombine<N> cb;
    for (int f = 0; f < N; ++f) {
        cb.is_min[f] = kinds[f] % 3 == 1 ? ~0u : 0u;
        cb.is_max[f] = kinds[f] % 3 == 2 ? ~0u : 0u;
        cb.is_float[f] = kinds[f] >= 3 ? ~0u : 0u;
    }
    return cb;
}

template <int N>
int ingest_fieldwise(void** planes, void** vals, const int* kinds,
                     uint8_t* valid, const void* skeys, int key_bytes,
                     const int32_t* order, int n, int F, int sentinel,
                     uint32_t* status, int status_words, uint32_t* rows,
                     int row_words, unsigned seq, cudaStream_t st) {
    return wf::run_ingest(wf::planes_of<N>(planes), wf::planes_of<N>(vals),
                          mask_combine<N>(kinds), valid, skeys, key_bytes,
                          order, n, F, sentinel, status, status_words, rows,
                          row_words, seq, st);
}

template <int N>
int query_fieldwise(void** planes, const int* kinds, uint8_t* valid,
                    int n_rows, int F, const int32_t* fpack, int W,
                    const int32_t* epack, int E, const int32_t* bounds, int B,
                    void** out, uint8_t* qv, const void* ktable, void* kout,
                    int key_bytes, cudaStream_t st) {
    return wf::run_query(wf::planes_of<N>(planes), mask_combine<N>(kinds),
                         valid, n_rows, F, fpack, W, epack, E, bounds, B,
                         wf::planes_of<N>(out), qv, ktable, kout, key_bytes,
                         st);
}

template <int N>
int keyed_fold_fieldwise(void* const* p, const int* a, const int* kinds) {
    return wf::keyed_fold_call(p, a, mask_combine<N>(kinds));
}

template <int N>
int tree_reduce_fieldwise(void* const* p, const int* a, const int* kinds) {
    return wf::tree_reduce_call(p, a, mask_combine<N>(kinds));
}

static bool bad_kinds(const int* kinds, int n_fields) {
    if (n_fields < 1 || n_fields > WF_MAX_FIELDS) return true;
    for (int f = 0; f < n_fields; ++f)
        if (kinds[f] < 0 || kinds[f] > 5) return true;
    return false;
}

#define WF_FIELDWISE_SWITCH(fn, ...)          \
    switch (n_fields) {                       \
    case 1: return fn<1>(__VA_ARGS__);        \
    case 2: return fn<2>(__VA_ARGS__);        \
    case 3: return fn<3>(__VA_ARGS__);        \
    case 4: return fn<4>(__VA_ARGS__);        \
    case 5: return fn<5>(__VA_ARGS__);        \
    case 6: return fn<6>(__VA_ARGS__);        \
    case 7: return fn<7>(__VA_ARGS__);        \
    default: return fn<8>(__VA_ARGS__);       \
    }

extern "C" {

// One pass of the wrapper's launch plan (see wf::run_pass) over n_fields
// planes with kinds 0-2 int32 sum/min/max, 3-5 float32.
int wf_rebuild_pass(void** planes, const int* kinds, int n_fields,
                    void* valid, int n_rows, int F, int regime, int W, int S,
                    int E, int rows, int smem, void* stream) {
    if (bad_kinds(kinds, n_fields) || wf::bad_geometry(n_rows, F, S))
        return -1;
    const wf::Pass ps{regime, W, S, E, rows, smem};
    uint8_t* v = static_cast<uint8_t*>(valid);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    WF_FIELDWISE_SWITCH(run_fieldwise, planes, kinds, v, n_rows, F, ps, st)
}

// K2+K3 over n sorted rows (ffat_step.cuh: wf::run_ingest).
int wf_ffat_ingest(void** planes, void** vals, const int* kinds,
                   int n_fields, void* valid, const void* skeys, int key_bytes,
                   const void* order, int n, int F, int sentinel,
                   void* status, int status_words, void* rows,
                   int row_words, unsigned seq, void* stream) {
    if (bad_kinds(kinds, n_fields)) return -1;
    uint8_t* v = static_cast<uint8_t*>(valid);
    const int32_t* o = static_cast<const int32_t*>(order);
    uint32_t* ss = static_cast<uint32_t*>(status);
    uint32_t* rs = static_cast<uint32_t*>(rows);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    WF_FIELDWISE_SWITCH(ingest_fieldwise, planes, vals, kinds, v, skeys,
                        key_bytes, o, n, F, sentinel, ss, status_words, rs,
                        row_words, seq, st)
}

// K4 over W fire lanes (ffat_step.cuh: wf::run_query).
int wf_ffat_query(void** planes, const int* kinds, int n_fields, void* valid,
                  int n_rows, int F, const void* fpack, int W,
                  const void* epack, int E, const void* bounds, int B,
                  void** out, void* qv, const void* ktable, void* kout,
                  int key_bytes, void* stream) {
    if (bad_kinds(kinds, n_fields)) return -1;
    uint8_t* v = static_cast<uint8_t*>(valid);
    const int32_t* fp = static_cast<const int32_t*>(fpack);
    const int32_t* ep = static_cast<const int32_t*>(epack);
    const int32_t* bd = static_cast<const int32_t*>(bounds);
    uint8_t* q = static_cast<uint8_t*>(qv);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    WF_FIELDWISE_SWITCH(query_fieldwise, planes, kinds, v, n_rows, F, fp, W,
                        ep, E, bd, B, out, q, ktable, kout, key_bytes, st)
}

// K7 over n sorted rows, its arguments packed (reduce_fold.cuh:
// wf::keyed_fold_call).
int wf_keyed_fold(void* const* p, const int* a, const int* kinds) {
    const int n_fields = a[wf::KF_NF];
    if (bad_kinds(kinds, n_fields)) return -1;
    WF_FIELDWISE_SWITCH(keyed_fold_fieldwise, p, a, kinds)
}

// K6 over n rows, its arguments packed (reduce_fold.cuh:
// wf::tree_reduce_call).
int wf_tree_reduce(void* const* p, const int* a, const int* kinds) {
    const int n_fields = a[wf::TR_NF];
    if (bad_kinds(kinds, n_fields)) return -1;
    WF_FIELDWISE_SWITCH(tree_reduce_fieldwise, p, a, kinds)
}

const char* wf_error_string(int code) { return wf::error_string(code); }

}  // extern "C"
