// Fast COCO evaluation core: C++ implementation of the greedy
// detection<->ground-truth matcher, the O(T*D*G) hot loop of COCO AP (the
// one-cell matcher of eop_tpu/layers/csrc/cocoeval.cpp, copied; its batched
// variant has no caller).  The reference's counterpart is the
// pybind11 extension yolox/layers/csrc/cocoeval/cocoeval.cpp).  A flat
// extern "C" ABI, bound with ctypes: no pybind11 or PyTorch headers.  Built
// for the host by eop_tpu_torch/_build.py with the host's C++ compiler.
//
// Matching semantics follow COCOeval exactly:
//  * detections pre-sorted by descending score, GTs with ignores last;
//  * for each IoU threshold t and each detection d (best first): pick the
//    unmatched GT with the highest IoU >= t, preferring non-ignored GTs —
//    once a non-ignored candidate exists, an ignored GT can only take the
//    match if no non-ignored GT clears the threshold;
//  * crowd ("ignore") GTs may be matched by multiple detections;
//  * a detection matched to an ignored GT, or unmatched with an
//    out-of-area-range area, is marked ignored.

#include <cstdint>

extern "C" {

// One (image, category) cell.
//   T: number of IoU thresholds; D: detections; G: ground truths.
//   iou:        [D, G] row-major IoU matrix (dt-major)
//   gt_ignore:  [G]    1 if this GT is ignored for the current area range
//   gt_iscrowd: [G]    1 if crowd (multi-match allowed)
//   dt_out_of_range: [D] 1 if the detection's area falls outside the range
// Outputs (caller-allocated):
//   dt_matches: [T, D] matched gt index + 1, 0 = unmatched
//   gt_matches: [T, G] matched dt index + 1, 0 = unmatched
//   dt_ignores: [T, D] 1 if the detection does not count for PR curves
void cocoeval_match_image(
    int64_t num_thresholds,
    int64_t num_dt,
    int64_t num_gt,
    const double* iou_thresholds,
    const double* iou,
    const int32_t* gt_ignore,
    const int32_t* gt_iscrowd,
    const int32_t* dt_out_of_range,
    int64_t* dt_matches,
    int64_t* gt_matches,
    int32_t* dt_ignores) {
  for (int64_t t = 0; t < num_thresholds; ++t) {
    const double thr = iou_thresholds[t];
    int64_t* dtm = dt_matches + t * num_dt;
    int64_t* gtm = gt_matches + t * num_gt;
    int32_t* dti = dt_ignores + t * num_dt;
    for (int64_t d = 0; d < num_dt; ++d) {
      // pycocotools: initial acceptance bar is min(t, 1 - 1e-10)
      double best_iou = thr < 1.0 - 1e-10 ? thr : 1.0 - 1e-10;
      int64_t best_g = -1;
      for (int64_t g = 0; g < num_gt; ++g) {
        // GT already claimed by a better detection (crowds can re-match)
        if (gtm[g] > 0 && !gt_iscrowd[g]) continue;
        // GTs are sorted ignores-last: once we hold a non-ignored match,
        // stop at the first ignored GT — it cannot improve the match.
        if (best_g >= 0 && !gt_ignore[best_g] && gt_ignore[g]) break;
        const double v = iou[d * num_gt + g];
        if (v < best_iou) continue;
        best_iou = v;
        best_g = g;
      }
      if (best_g >= 0) {
        dtm[d] = best_g + 1;
        gtm[best_g] = d + 1;
        dti[d] = gt_ignore[best_g];
      } else {
        dtm[d] = 0;
        dti[d] = 0;
      }
    }
    // unmatched detections outside the area range are ignored
    for (int64_t d = 0; d < num_dt; ++d) {
      if (dtm[d] == 0 && dt_out_of_range[d]) dti[d] = 1;
    }
  }
}

}  // extern "C"
