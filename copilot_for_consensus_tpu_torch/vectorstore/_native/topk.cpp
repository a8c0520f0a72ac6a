// Host-side exact-search core: dot-product scoring + top-k selection.
//
// The role FAISS's C++ core plays for the reference
// (adapters/copilot_vectorstore/copilot_vectorstore/faiss_store.py:18,
// IndexFlatL2 at :101) — first-party, C ABI only (loaded via ctypes; no
// pybind11 in the image). Vectors are L2-normalized by the Python layer,
// so dot == cosine. Selection is a bounded min-heap, O(n log k).
//
// NO -ffast-math: gcc links crtfastmath.o into shared objects built with
// it, and dlopen'ing that sets FTZ/DAZ in MXCSR for the WHOLE process —
// silently breaking subnormals for the embedding JAX code (and anything
// else) in the host. The dot product instead uses 4 independent
// accumulators so -O3 can vectorize the reduction under strict IEEE
// ordering.
//
// Build: compiled on demand by vectorstore/native.py with g++ into a
// cached shared object; the Python driver falls back to NumPy when no
// compiler is available.

#include <cstdint>
#include <vector>
#include <algorithm>

extern "C" {

static inline float dot(const float* row, const float* q, int64_t dim) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    int64_t j = 0;
    for (; j + 4 <= dim; j += 4) {
        a0 += row[j] * q[j];
        a1 += row[j + 1] * q[j + 1];
        a2 += row[j + 2] * q[j + 2];
        a3 += row[j + 3] * q[j + 3];
    }
    for (; j < dim; ++j) a0 += row[j] * q[j];
    return (a0 + a1) + (a2 + a3);
}

// scores[i] = dot(vecs[i], q); vecs is row-major [n, dim].
void dot_scores(const float* vecs, int64_t n, int64_t dim,
                const float* q, float* scores) {
    for (int64_t i = 0; i < n; ++i)
        scores[i] = dot(vecs + i * dim, q, dim);
}

// Top-k by score over rows[0..n): writes k (idx, score) pairs sorted
// descending. rows==nullptr means identity (all n rows).
void topk_dot(const float* vecs, int64_t n, int64_t dim,
              const float* q, const int64_t* rows, int64_t n_rows,
              int64_t k, int64_t* out_idx, float* out_score) {
    const int64_t total = rows ? n_rows : n;
    if (k > total) k = total;
    if (k <= 0) return;
    using Pair = std::pair<float, int64_t>;  // (score, row)
    std::vector<Pair> heap;                  // min-heap of the best k
    heap.reserve(k);
    auto cmp = [](const Pair& a, const Pair& b) { return a.first > b.first; };
    for (int64_t t = 0; t < total; ++t) {
        const int64_t i = rows ? rows[t] : t;
        const float acc = dot(vecs + i * dim, q, dim);
        if ((int64_t)heap.size() < k) {
            heap.emplace_back(acc, i);
            std::push_heap(heap.begin(), heap.end(), cmp);
        } else if (acc > heap.front().first) {
            std::pop_heap(heap.begin(), heap.end(), cmp);
            heap.back() = Pair(acc, i);
            std::push_heap(heap.begin(), heap.end(), cmp);
        }
    }
    // sort_heap on a greater-comparator min-heap leaves descending score.
    std::sort_heap(heap.begin(), heap.end(), cmp);
    for (int64_t t = 0; t < k; ++t) {
        out_idx[t] = heap[t].second;
        out_score[t] = heap[t].first;
    }
}

}  // extern "C"
