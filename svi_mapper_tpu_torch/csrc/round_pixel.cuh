// The nearest pixel index of a coordinate: the port's one rounding rule in
// CUDA, shared by K1 (track_scores.cu) and K2 (stereo_profiles.cu).
//
// NaN and +-inf read 0; finite values are rounded half to even and clamped
// to [0, hi] in float before the cast. That is ops/descriptors.py
// round_pixel after nan_to_num (the PyTorch copy of this rule), and equals
// the JAX package's round -> saturating cast -> clip for every input.

#pragma once

__device__ __forceinline__ int pixel_index(float a, int hi) {
    a = isfinite(a) ? a : 0.0f;
    a = fminf(fmaxf(rintf(a), 0.0f), (float)hi);
    return (int)a;
}
