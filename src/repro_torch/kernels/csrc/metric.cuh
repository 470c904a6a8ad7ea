// The per-value term of the plain distance scans K4 (pdx_scan.cu) and K5
// (nary_scan.cu), shared so that the two layouts compute one function.
// Codes match kernels/pdx_scan.py:METRIC_CODES.  The caller sums the terms
// in f32 and negates the sum for ip.
#pragma once

enum Metric { kL2 = 0, kIP = 1, kL1 = 2 };

template <int kMetric>
__device__ __forceinline__ float term(float x, float qv) {
  if constexpr (kMetric == kL2) {
    const float d = x - qv;
    return d * d;
  } else if constexpr (kMetric == kL1) {
    return fabsf(x - qv);
  } else {
    return x * qv;
  }
}
