// wfruntime: host-side native runtime of the port (built with g++, not a
// device kernel).
//
// Two parts, both driven through ctypes from native/__init__.py:
//
//  - wf_queue: a bounded MPSC ring of (channel index, PyObject*) pairs,
//    guarded by a mutex and two condition variables, for the single
//    consumer of a worker's input channel (one worker thread per replica
//    chain). Push and pop are called through ctypes.CDLL, which releases
//    the GIL, so a blocked worker never holds the interpreter. The Python
//    wrapper owns one strong reference per queued message (taken at push,
//    handed to the consumer at pop). wf_queue_close poisons the ring for
//    a supervised teardown: every blocked and later push fails, and a pop
//    fails once the ring is empty. The ring counts what the autoscaler
//    and the overload governor read from a channel: the deepest
//    occupancy, the nanoseconds producers spent blocked on a full ring and
//    the consumer on an empty one, and the number of blocked pushes.
//  - wf_encode_*: the row -> column staging encoders, called WITH the GIL
//    through ctypes.PyDLL. One C pass reads a named attribute (or dict
//    item) from every payload of a list straight into a numpy buffer, in
//    place of the per-row, per-field Python loop of the staging edge. The
//    int32 encoder refuses a value outside int32 with OverflowError, as a
//    numpy int32 store does: a key that does not fit is an error, never a
//    silent wrap.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -I<Python include> (see
// native/__init__.py). No dependency beyond Python.h.

#include <Python.h>

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <mutex>
#include <new>

extern "C" {

struct WfItem {
    int64_t tag;       // producer-side channel index
    uintptr_t handle;  // PyObject* kept alive by the wrapper's incref
};

struct WfQueue {
    WfItem* buf;
    size_t capacity;
    size_t head;
    size_t tail;
    size_t count;
    bool closed;
    size_t depth_max;
    int64_t blocked_put_ns;
    int64_t blocked_get_ns;
    int64_t puts_blocked;
    std::mutex m;
    std::condition_variable not_full;
    std::condition_variable not_empty;
};

static inline int64_t wf_now_ns() {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}

void* wf_queue_create(size_t capacity) {
    if (capacity == 0) capacity = 1;
    WfQueue* q = new (std::nothrow) WfQueue();
    if (!q) return nullptr;
    q->buf = new (std::nothrow) WfItem[capacity];
    if (!q->buf) {
        delete q;
        return nullptr;
    }
    q->capacity = capacity;
    q->head = q->tail = q->count = 0;
    q->closed = false;
    q->depth_max = 0;
    q->blocked_put_ns = q->blocked_get_ns = q->puts_blocked = 0;
    return q;
}

void wf_queue_destroy(void* h) {
    WfQueue* q = static_cast<WfQueue*>(h);
    if (!q) return;
    delete[] q->buf;
    delete q;
}

// Blocking push. Returns 1 when queued, 0 when the ring is (or becomes)
// closed: the caller still owns the reference it meant to hand over.
int wf_queue_push(void* h, int64_t tag, uintptr_t handle) {
    WfQueue* q = static_cast<WfQueue*>(h);
    std::unique_lock<std::mutex> lk(q->m);
    if (q->closed) return 0;
    if (q->count >= q->capacity) {
        int64_t t0 = wf_now_ns();
        q->puts_blocked++;
        q->not_full.wait(lk, [q] { return q->closed || q->count < q->capacity; });
        q->blocked_put_ns += wf_now_ns() - t0;
        if (q->closed) return 0;
    }
    q->buf[q->tail] = WfItem{tag, handle};
    q->tail = (q->tail + 1) % q->capacity;
    q->count++;
    if (q->count > q->depth_max) q->depth_max = q->count;
    lk.unlock();
    q->not_empty.notify_one();
    return 1;
}

// Pop. timeout_ms < 0 waits until an item or a close. Returns 1 with an
// item, 0 on timeout, -1 when the ring is closed and empty. A closed ring
// still hands out what it holds.
int wf_queue_pop(void* h, int64_t* tag, uintptr_t* handle, long timeout_ms) {
    WfQueue* q = static_cast<WfQueue*>(h);
    std::unique_lock<std::mutex> lk(q->m);
    if (q->count == 0) {
        if (q->closed) return -1;
        int64_t t0 = wf_now_ns();
        auto ready = [q] { return q->closed || q->count > 0; };
        if (timeout_ms < 0) {
            q->not_empty.wait(lk, ready);
        } else if (!q->not_empty.wait_for(
                       lk, std::chrono::milliseconds(timeout_ms), ready)) {
            q->blocked_get_ns += wf_now_ns() - t0;
            return 0;
        }
        q->blocked_get_ns += wf_now_ns() - t0;
        if (q->count == 0) return -1;  // woken by a close
    }
    WfItem it = q->buf[q->head];
    q->head = (q->head + 1) % q->capacity;
    q->count--;
    lk.unlock();
    q->not_full.notify_one();
    *tag = it.tag;
    *handle = it.handle;
    return 1;
}

void wf_queue_close(void* h) {
    WfQueue* q = static_cast<WfQueue*>(h);
    {
        std::lock_guard<std::mutex> lk(q->m);
        q->closed = true;
    }
    q->not_full.notify_all();
    q->not_empty.notify_all();
}

size_t wf_queue_len(void* h) {
    WfQueue* q = static_cast<WfQueue*>(h);
    std::lock_guard<std::mutex> lk(q->m);
    return q->count;
}

// out[0..3] = depth_max, blocked_put_ns, blocked_get_ns, puts_blocked
void wf_queue_gauges(void* h, int64_t* out) {
    WfQueue* q = static_cast<WfQueue*>(h);
    std::lock_guard<std::mutex> lk(q->m);
    out[0] = (int64_t)q->depth_max;
    out[1] = q->blocked_put_ns;
    out[2] = q->blocked_get_ns;
    out[3] = q->puts_blocked;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Staging encoders (called WITH the GIL through ctypes.PyDLL). rows: a list
// of payloads; attr: the field name; out: a buffer of at least len(rows)
// elements. Return 0, or -1 with a Python exception set.
// ---------------------------------------------------------------------------
static inline PyObject* wf_get_field(PyObject* row, PyObject* attr) {
    if (PyDict_Check(row)) {
        PyObject* v = PyDict_GetItemWithError(row, attr);  // borrowed
        if (v) {
            Py_INCREF(v);
        } else if (!PyErr_Occurred()) {
            PyErr_SetObject(PyExc_KeyError, attr);
        }
        return v;
    }
    return PyObject_GetAttr(row, attr);
}

template <typename T, bool kInt, bool kCheck32>
static int wf_encode(PyObject* rows, PyObject* attr, T* out) {
    if (!PyList_Check(rows)) {
        PyErr_SetString(PyExc_TypeError, "wf_encode: rows must be a list");
        return -1;
    }
    Py_ssize_t n = PyList_GET_SIZE(rows);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* v = wf_get_field(PyList_GET_ITEM(rows, i), attr);
        if (!v) return -1;
        if (kInt) {
            long long x = PyLong_AsLongLong(v);
            Py_DECREF(v);
            if (x == -1 && PyErr_Occurred()) return -1;
            if (kCheck32 && (x < INT32_MIN || x > INT32_MAX)) {
                PyErr_Format(PyExc_OverflowError,
                             "Python integer %lld out of bounds for int32", x);
                return -1;
            }
            out[i] = (T)x;
        } else {
            double x = PyFloat_AsDouble(v);
            Py_DECREF(v);
            if (x == -1.0 && PyErr_Occurred()) return -1;
            out[i] = (T)x;
        }
    }
    return 0;
}

extern "C" {

int wf_encode_i64(PyObject* rows, PyObject* attr, int64_t* out) {
    return wf_encode<int64_t, true, false>(rows, attr, out);
}

int wf_encode_i32(PyObject* rows, PyObject* attr, int32_t* out) {
    return wf_encode<int32_t, true, true>(rows, attr, out);
}

int wf_encode_f64(PyObject* rows, PyObject* attr, double* out) {
    return wf_encode<double, false, false>(rows, attr, out);
}

int wf_encode_f32(PyObject* rows, PyObject* attr, float* out) {
    return wf_encode<float, false, false>(rows, attr, out);
}

}  // extern "C"
