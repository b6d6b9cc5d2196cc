// Host soft-NMS and hard NMS (the port's copy of the JAX package's
// `native/host_nms.cpp`; the algorithms and their float arithmetic are
// unchanged, line for line).
//
// Greedy hard NMS and Bodla et al. soft-NMS with the legacy +1 box
// extents of the reference's Cython extension (ext/nms/nms/cpu_nms.pyx).
// The evaluator's host merge (`val.auto_test=False`) and the auto-eval
// threshold grid call it through `rrnet_torch/evallib/host_nms.py`.
//
// Build (by `rrnet_torch/utils/native.py`, at first use):
//   g++ -O3 -shared -fPIC -o libhost_nms-<hash>.so host_nms.cpp
// No -march flag: without one no fused multiply-add is contracted, so the
// library rounds as the JAX package's build does, bit for bit.
//
// ABI (ctypes):
//   soft_nms(float* dets /* n x 5: x1,y1,x2,y2,score (row-major) */,
//            int n, float sigma, float Nt, float threshold, int method,
//            int* order_out /* n */) -> int kept
//     Mutates scores in place (decay); writes selection order (original
//     row indices, best-first) into order_out; returns the kept count.
//   hard_nms(const float* dets, int n, float thresh, int plus_one,
//            int suppress_equal, int* keep_out) -> int kept

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

inline float iou_plus1(const float* a, const float* b) {
    float iw = std::min(a[2], b[2]) - std::max(a[0], b[0]) + 1.0f;
    if (iw <= 0) return 0.0f;
    float ih = std::min(a[3], b[3]) - std::max(a[1], b[1]) + 1.0f;
    if (ih <= 0) return 0.0f;
    float area_a = (a[2] - a[0] + 1.0f) * (a[3] - a[1] + 1.0f);
    float area_b = (b[2] - b[0] + 1.0f) * (b[3] - b[1] + 1.0f);
    float inter = iw * ih;
    return inter / (area_a + area_b - inter);
}

inline float iou_raw(const float* a, const float* b) {
    float iw = std::min(a[2], b[2]) - std::max(a[0], b[0]);
    if (iw <= 0) return 0.0f;
    float ih = std::min(a[3], b[3]) - std::max(a[1], b[1]);
    if (ih <= 0) return 0.0f;
    float area_a = (a[2] - a[0]) * (a[3] - a[1]);
    float area_b = (b[2] - b[0]) * (b[3] - b[1]);
    float inter = iw * ih;
    return inter / (area_a + area_b - inter);
}

}  // namespace

extern "C" {

// Soft-NMS: iterated max-score selection with IoU-weighted score decay.
// method: 1 = linear, 2 = gaussian, else = hard.
// Matches the published algorithm with the reference's conventions:
// +1 extents; a box is only threshold-dropped when it overlaps the
// selected box (iw > 0 && ih > 0).
int soft_nms(float* dets, int n, float sigma, float Nt, float threshold,
             int method, int* order_out) {
    std::vector<uint8_t> active(n, 1), selected(n, 0);
    int kept = 0;
    for (int step = 0; step < n; ++step) {
        int m = -1;
        float best = -1.0f;
        for (int i = 0; i < n; ++i) {
            if (active[i] && !selected[i] && dets[i * 5 + 4] > best) {
                best = dets[i * 5 + 4];
                m = i;
            }
        }
        if (m < 0) break;
        selected[m] = 1;
        order_out[kept++] = m;
        const float* bm = dets + m * 5;
        for (int j = 0; j < n; ++j) {
            if (!active[j] || selected[j]) continue;
            float* bj = dets + j * 5;
            float iw = std::min(bm[2], bj[2]) - std::max(bm[0], bj[0]) + 1.0f;
            if (iw <= 0) continue;
            float ih = std::min(bm[3], bj[3]) - std::max(bm[1], bj[1]) + 1.0f;
            if (ih <= 0) continue;
            float area_m = (bm[2] - bm[0] + 1.0f) * (bm[3] - bm[1] + 1.0f);
            float area_j = (bj[2] - bj[0] + 1.0f) * (bj[3] - bj[1] + 1.0f);
            float inter = iw * ih;
            float ov = inter / (area_m + area_j - inter);
            float w;
            if (method == 1) {
                w = (ov > Nt) ? 1.0f - ov : 1.0f;
            } else if (method == 2) {
                w = std::exp(-(ov * ov) / sigma);
            } else {
                w = (ov > Nt) ? 0.0f : 1.0f;
            }
            bj[4] *= w;
            if (bj[4] < threshold) active[j] = 0;
        }
    }
    return kept;
}

int hard_nms(const float* dets, int n, float thresh, int plus_one,
             int suppress_equal, int* keep_out) {
    std::vector<int> order(n);
    for (int i = 0; i < n; ++i) order[i] = i;
    std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
        return dets[a * 5 + 4] > dets[b * 5 + 4];
    });
    std::vector<uint8_t> suppressed(n, 0);
    int kept = 0;
    for (int oi = 0; oi < n; ++oi) {
        int i = order[oi];
        if (suppressed[i]) continue;
        keep_out[kept++] = i;
        for (int oj = oi + 1; oj < n; ++oj) {
            int j = order[oj];
            if (suppressed[j]) continue;
            float ov = plus_one ? iou_plus1(dets + i * 5, dets + j * 5)
                                : iou_raw(dets + i * 5, dets + j * 5);
            bool hit = suppress_equal ? (ov >= thresh) : (ov > thresh);
            if (hit) suppressed[j] = 1;
        }
    }
    return kept;
}

}  // extern "C"
