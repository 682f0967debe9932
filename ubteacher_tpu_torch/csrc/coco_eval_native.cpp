// COCO bbox evaluation hot loops in C++ (a copy of
// ubteacher_tpu/evaluation/coco_eval_native.cpp; the port keeps its own).
//
// The counterpart of detectron2's COCOeval_opt C++ extension (reference
// dependency: ubteacher/evaluation/coco_evaluation.py:20,579), with a plain
// C ABI loaded via ctypes by evaluation/native.py, which builds it with g++.
// The python evaluator (evaluation/coco_eval.py) falls back to a numpy
// implementation when the shared object is unavailable.
//
// Semantics follow the COCO protocol exactly:
//   * detections visited in score order (caller pre-sorts);
//   * each det matches the unmatched gt with the highest IoU >= threshold;
//   * crowd gts can match repeatedly; once a det has a real (non-ignored)
//     candidate it never downgrades to an ignored gt;
//   * matched-to-ignored and area-range-excluded unmatched dets are marked
//     ignored.

#include <cstdint>

extern "C" {

// IoU between det (xywh) and gt (xywh); crowd gts use inter / det_area.
void bbox_iou(int n_det, int n_gt, const double* dets, const double* gts,
              const uint8_t* iscrowd, double* out /* (n_det, n_gt) */) {
  for (int d = 0; d < n_det; ++d) {
    const double dx1 = dets[d * 4 + 0];
    const double dy1 = dets[d * 4 + 1];
    const double dw = dets[d * 4 + 2];
    const double dh = dets[d * 4 + 3];
    const double dx2 = dx1 + dw;
    const double dy2 = dy1 + dh;
    const double darea = dw * dh;
    for (int g = 0; g < n_gt; ++g) {
      const double gx1 = gts[g * 4 + 0];
      const double gy1 = gts[g * 4 + 1];
      const double gw = gts[g * 4 + 2];
      const double gh = gts[g * 4 + 3];
      const double gx2 = gx1 + gw;
      const double gy2 = gy1 + gh;
      const double ix1 = dx1 > gx1 ? dx1 : gx1;
      const double iy1 = dy1 > gy1 ? dy1 : gy1;
      const double ix2 = dx2 < gx2 ? dx2 : gx2;
      const double iy2 = dy2 < gy2 ? dy2 : gy2;
      const double iw = ix2 - ix1 > 0 ? ix2 - ix1 : 0;
      const double ih = iy2 - iy1 > 0 ? iy2 - iy1 : 0;
      const double inter = iw * ih;
      const double uni = iscrowd[g] ? darea : darea + gw * gh - inter;
      out[d * n_gt + g] = uni > 0 ? inter / uni : 0.0;
    }
  }
}

// Greedy matching for one (image, category, area-range) cell across all IoU
// thresholds. dets are score-sorted; gts are sorted non-ignored-first.
void match_dets(int n_thr, int n_det, int n_gt, const double* iou_thrs,
                const double* ious /* (n_det, n_gt) */,
                const uint8_t* g_ignore, const uint8_t* iscrowd,
                const uint8_t* d_out_of_area,
                int64_t* dt_match /* (n_thr, n_det): 1 + gt idx or 0 */,
                uint8_t* dt_ignore /* (n_thr, n_det) */,
                int64_t* gt_match /* (n_thr, n_gt) */) {
  for (int t = 0; t < n_thr; ++t) {
    const double thr = iou_thrs[t];
    int64_t* dmatch = dt_match + (int64_t)t * n_det;
    uint8_t* dign = dt_ignore + (int64_t)t * n_det;
    int64_t* gmatch = gt_match + (int64_t)t * n_gt;
    for (int d = 0; d < n_det; ++d) {
      double best_iou = thr < 1.0 - 1e-10 ? thr : 1.0 - 1e-10;
      int best_g = -1;
      const double* iou_row = ious + (int64_t)d * n_gt;
      for (int g = 0; g < n_gt; ++g) {
        if (gmatch[g] > 0 && !iscrowd[g]) continue;
        // gts are sorted non-ignored first: once we have a real match and
        // reach the ignored section, stop
        if (best_g > -1 && !g_ignore[best_g] && g_ignore[g]) break;
        if (iou_row[g] < best_iou) continue;
        best_iou = iou_row[g];
        best_g = g;
      }
      if (best_g == -1) {
        // unmatched det out of area range -> ignored
        if (d_out_of_area[d]) dign[d] = 1;
        continue;
      }
      dign[d] = g_ignore[best_g];
      dmatch[d] = best_g + 1;
      gmatch[best_g] = d + 1;
    }
  }
}

}  // extern "C"
