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

#include "forest_rebuild.cuh"

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

// node = combine(l, r) when both are valid, else the valid one (r if none)
__device__ __forceinline__ uint32_t pick(uint32_t l, uint32_t r, bool vl,
                                         bool vr, int kind) {
    const uint32_t m = combine_word(l, r, kind);
    return vl ? (vr ? m : l) : r;
}

// The fieldwise policy: each field folds on its own, by its kind.
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
        for (int f = 0; f < N; ++f) o[f] = pick(l[f], r[f], vl, vr, kind[f]);
    }
};

template <int N>
int run_fieldwise(void** planes, const int* kinds, uint8_t* valid,
                  int n_rows, int F, const wf::Pass& ps, cudaStream_t st) {
    Planes<N> pl;
    KindsCombine<N> cb;
    for (int f = 0; f < N; ++f) {
        pl.ptr[f] = planes[f];
        cb.kind[f] = kinds[f];
    }
    return wf::run_pass(pl, cb, valid, n_rows, F, ps, st);
}

extern "C" {

// One pass of the wrapper's launch plan (see wf::run_pass) over n_fields
// planes with kinds 0-2 int32 sum/min/max, 3-5 float32.
int wf_rebuild_pass(void** planes, const int* kinds, int n_fields,
                    void* valid, int n_rows, int F, int regime, int W, int S,
                    int E, int rows, int smem, void* stream) {
    if (n_fields < 1 || n_fields > WF_MAX_FIELDS ||
        wf::bad_geometry(n_rows, F, S))
        return -1;
    for (int f = 0; f < n_fields; ++f)
        if (kinds[f] < 0 || kinds[f] > 5) return -1;
    const wf::Pass ps{regime, W, S, E, rows, smem};
    uint8_t* v = static_cast<uint8_t*>(valid);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (n_fields) {
    case 1: return run_fieldwise<1>(planes, kinds, v, n_rows, F, ps, st);
    case 2: return run_fieldwise<2>(planes, kinds, v, n_rows, F, ps, st);
    case 3: return run_fieldwise<3>(planes, kinds, v, n_rows, F, ps, st);
    case 4: return run_fieldwise<4>(planes, kinds, v, n_rows, F, ps, st);
    case 5: return run_fieldwise<5>(planes, kinds, v, n_rows, F, ps, st);
    case 6: return run_fieldwise<6>(planes, kinds, v, n_rows, F, ps, st);
    case 7: return run_fieldwise<7>(planes, kinds, v, n_rows, F, ps, st);
    default: return run_fieldwise<8>(planes, kinds, v, n_rows, F, ps, st);
    }
}

const char* wf_error_string(int code) { return wf::error_string(code); }

}  // extern "C"
